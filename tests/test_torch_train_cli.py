"""``python -m ucnerf_torch.train`` as users chain it, on the CPU at the
small shape of ``tests/test_train_e2e.py``: kill and resume against an
uninterrupted run (bitwise), the mvs_only -> full -> finetune hand-offs
with ``--ckpt_params_only`` (as ``tests/test_train_e2e.py:408-487`` holds
the JAX package's trainer), the validation of the whole val split and its
files, and the trainer's writer, prefetcher and trace."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.eval.metrics import DEPTH_METRICS
from ucnerf_torch.train import __main__ as train_cli
from ucnerf_torch import render_path, serve
from ucnerf_torch.utils.checkpoint_io import load_params_npz
from ucnerf_torch.utils.platform import deterministic_kernels
from ucnerf_torch.utils.png import read_png
from ucnerf_torch.utils.prefetch import ThreadPrefetcher
from ucnerf_torch.utils.profiling import TRACE_FILE, trace
from ucnerf_torch.utils.viz import PAD, STRIP
from ucnerf_torch.utils.writer import MetricWriter

from test_torch_train import ARGS

torch.set_num_threads(1)

# one tile per 32x64 view; two samples per epoch; no periodic validation
CLI = [*ARGS, "--device", "cpu", "--chunk", "2048", "--samples_per_scene",
       "2", "--val_every_epochs", "9"]
RGB_KEYS = ["psnr", "ssim", "lpips", *DEPTH_METRICS]


def run(*argv):
    """(summary, JSON lines) of one trainer run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = train_cli.main([*CLI, *argv])
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    return summary, lines


def steps(lines):
    return [ln for ln in lines if "step" in ln]


def vals(lines):
    return [ln for ln in lines if "val_step" in ln]


def ckpt_dir(base, expname, step):
    return os.path.join(base, expname, "ckpts", f"step_{step:08d}")


def params(path):
    return load_params_npz(os.path.join(path, "params.npz"))


def assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_kill_resume_bitwise(tmp_path):
    """6 uninterrupted steps (store-fed, the default) against a run stopped
    at step 3, mid-epoch, and resumed from its checkpoint host-fed: the
    same losses at steps 4-6 and the same weights, Adam moments and step,
    bit for bit.  A stopped run checkpoints and does not validate."""
    base = str(tmp_path)
    off = tmp_path / "host_fed.json"
    off.write_text(json.dumps({"device_dataset": False}))
    _, w_lines = run("--basedir", base, "--expname", "whole",
                     "--num_epochs", "3", "--stop_after_steps", "6")
    part, p_lines = run("--basedir", base, "--expname", "part",
                        "--num_epochs", "3", "--stop_after_steps", "3")
    assert part["stopped"] and part["val"] is None and not vals(p_lines)
    assert part["ckpt"] == ckpt_dir(base, "part", 3)
    assert any("store_mb" in ln for ln in w_lines)
    _, r_lines = run("--basedir", base, "--expname", "resumed",
                     "--num_epochs", "3", "--stop_after_steps", "6",
                     "--ckpt", part["ckpt"], "--config", str(off))
    assert not any("store_mb" in ln for ln in r_lines)
    assert {"resumed": 3, "epoch": 1, "skip": 1} in r_lines
    assert [ln["step"] for ln in steps(r_lines)] == [4, 5, 6]
    assert steps(r_lines) == [
        dict(ln, ms=r["ms"]) for ln, r in zip(steps(w_lines)[3:],
                                              steps(r_lines))]
    a, b = ckpt_dir(base, "whole", 6), ckpt_dir(base, "resumed", 6)
    assert_trees_equal(params(a), params(b))
    sa, sb = (torch.load(os.path.join(p, "train_state.pt"),
                         weights_only=True) for p in (a, b))
    assert sa["step"] == sb["step"] == 6
    assert sa["objective"] == sb["objective"] == "full"
    for i, st in sa["optimizer"]["state"].items():
        for k, t in st.items():
            assert torch.equal(t, sb["optimizer"]["state"][i][k]), (i, k)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The three phases chained by --ckpt_params_only, one epoch of two
    steps each; the full phase validates every epoch."""
    base = str(tmp_path_factory.mktemp("chain"))
    common = ["--basedir", base, "--num_epochs", "1"]
    out = {"base": base}
    out["boot"] = run(*common, "--expname", "boot", "--mvs_only")
    out["full"] = run(*common, "--expname", "full", "--val_every_epochs",
                      "1", "--ckpt", out["boot"][0]["ckpt"],
                      "--ckpt_params_only")
    out["refine"] = run(*common, "--expname", "refine", "--finetune",
                        "synth0", "--ckpt", out["full"][0]["ckpt"],
                        "--ckpt_params_only")
    return out


def test_chained_phase_handoffs(chain):
    """Each hand-off trains its own steps from the previous phase's
    weights; the finetune keeps the cascade bit for bit and moves the
    NeRF; without --ckpt_params_only the hand-off trains no step and the
    error names the flag."""
    ck = {k: chain[k][0]["ckpt"] for k in ("boot", "full", "refine")}
    for k in ck:
        assert chain[k][0]["steps"] == 2 and ck[k].endswith("step_00000002")
    p = {k: params(v) for k, v in ck.items()}
    assert [ln["step"] for ln in steps(chain["full"][1])] == [1, 2]
    assert not all(np.array_equal(p["boot"]["nerf"]["nerf"][k]["Dense_0"]
                                  ["kernel"], v["Dense_0"]["kernel"])
                   for k, v in p["full"]["nerf"]["nerf"].items())
    assert_trees_equal(p["full"]["mvs"], p["refine"]["mvs"])
    assert not np.array_equal(
        p["full"]["nerf"]["nerf"]["rgb_linear"]["Dense_0"]["kernel"],
        p["refine"]["nerf"]["nerf"]["rgb_linear"]["Dense_0"]["kernel"])
    with pytest.raises(ValueError, match="--ckpt_params_only"):
        run("--basedir", chain["base"], "--expname", "noflag",
            "--num_epochs", "1", "--ckpt", ck["boot"])
    assert not os.path.exists(os.path.join(chain["base"], "noflag", "ckpts"))


def test_mvs_only_validation_writes_depth_metrics(chain):
    """--mvs_only validates the cascade alone over the val split: the 7
    depth metrics, in its JSON line and ``mvs_evaluation.txt``."""
    summary, lines = chain["boot"]
    [val] = vals(lines)
    assert val["views"] == 6 and "psnr" not in val
    with open(os.path.join(chain["base"], "boot", "test_results",
                           "mvs_evaluation.txt")) as fh:
        metrics = json.load(fh)
    assert list(metrics) == list(DEPTH_METRICS) == list(summary["val"])
    assert np.isfinite(list(metrics.values())).all()
    assert not os.path.exists(os.path.join(chain["base"], "boot",
                                           "test_results",
                                           "rgb_evaluation.txt"))


def test_last_epoch_validates(chain):
    """With --val_every_epochs 1 the only epoch validates, and the run
    validates once more at its end; with ``--val_panels final`` (the
    default) only that last validation writes panels."""
    assert [ln["val_step"] for ln in vals(chain["full"][1])] == [2, 2]
    assert [ln.get("panels") for ln in vals(chain["full"][1])] == [None, 6]
    out = os.path.join(chain["base"], "full", "test_results")
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == [
        f"00000002_{i:02d}.png" for i in range(6)]


def test_eval_writes_rgb_evaluation(chain, tmp_path):
    """--eval of the finetune phase's checkpoint renders the whole val
    split and writes ``rgb_evaluation.txt`` with the JAX package's keys:
    PSNR, SSIM, LPIPS (nan without its weights) and the depth metrics;
    with ``--val_panels all`` a panel per view."""
    summary, lines = run("--basedir", str(tmp_path), "--expname", "ev",
                         "--eval", "--ckpt", chain["refine"][0]["ckpt"],
                         "--val_panels", "all")
    assert not steps(lines)
    [val] = vals(lines)
    assert val["views"] == 6 and val["ms_per_view"] > 0
    assert val["panels"] == 6 and val["panel_ms_per_view"] > 0
    for i in range(6):
        panel = read_png(str(tmp_path / "ev" / "test_results"
                             / f"00000000_{i:02d}.png"))
        assert panel.shape == (2 * (STRIP + 32) + PAD, 2 * 64 + PAD, 3)
    with open(tmp_path / "ev" / "test_results" / "rgb_evaluation.txt") as fh:
        metrics = json.load(fh)
    assert list(metrics) == RGB_KEYS
    assert np.isnan(metrics["lpips"])
    assert np.isfinite([metrics[k] for k in RGB_KEYS if k != "lpips"]).all()
    assert 0 < metrics["ssim"] <= 1 and metrics["psnr"] > 5
    assert summary["val"].keys() == metrics.keys()
    # the same weights validated at the end of their own run
    with open(os.path.join(chain["base"], "refine", "test_results",
                           "rgb_evaluation.txt")) as fh:
        assert json.load(fh)["psnr"] == metrics["psnr"]


def test_eval_renders_shapes_the_kernel_does_not_take(tmp_path, capsys):
    """--eval at --netwidth 64, a width the fused MLP kernel does not
    take, renders with the plain MLP after one stderr line naming the
    reason, and ends with finite metrics."""
    summary, _ = run("--basedir", str(tmp_path), "--netwidth", "64",
                     "--eval", "--val_panels", "none")
    assert capsys.readouterr().err.count("plain UCNeRFMLP") == 1
    assert np.isfinite([summary["val"][k] for k in RGB_KEYS
                        if k != "lpips"]).all()


def _entry_point(entry, tmp_path):
    """``main(argv)`` of one entry point at the small shape on the CPU: a
    train run stopped after 2 steps, one serve request, a 2-frame
    render_path."""
    c2w = np.asarray(build_dataset(parse_config(ARGS), "val")[0]["c2ws"][0])
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps({"c2w": c2w.tolist(),
                                "out": str(tmp_path / "f.npz")}) + "\n")
    return {"train": lambda a: train_cli.main(
                [*CLI, "--basedir", str(tmp_path), "--stop_after_steps", "2",
                 *a]),
            "serve": lambda a: serve.main(["--requests", str(reqs),
                                           "--device", "cpu", *ARGS, *a]),
            "render_path": lambda a: render_path.main(
                ["--device", "cpu", "--out", str(tmp_path / "p.npz"),
                 "--n_frames", "2", *ARGS, *a])}[entry]


@pytest.mark.parametrize("entry", ["train", "serve", "render_path"])
@pytest.mark.parametrize("option", ["mesh_shape"])
def test_unported_options_raise(entry, option, tmp_path):
    """--mesh_shape > 1 is refused by every entry point, not ignored."""
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        _entry_point(entry, tmp_path)(["--mesh_shape", "2"])


@pytest.mark.parametrize("entry,option", [
    ("train", "literal_featurization"), ("serve", "literal_featurization"),
    ("render_path", "literal_featurization"), ("serve", "use_color_volume"),
    ("train", "mvs_dtype_bfloat16")])
def test_options_run_in_every_entry_point(entry, option, tmp_path):
    """The cascade's and the renderer's options run in the entry points
    (each held to the JAX package in ``tests/test_torch_{ops,options,
    mvs,train}.py``): fast_featurization false (set with --config) in
    train, serve and render_path, --use_color_volume in serve and
    --mvs_dtype bfloat16 in train, each to finite output."""
    if option == "literal_featurization":
        cfg = tmp_path / "literal.json"
        cfg.write_text(json.dumps({"fast_featurization": False}))
        argv = ["--config", str(cfg)]
    else:
        argv = {"use_color_volume": ["--use_color_volume",
                                     "--color_volume_depths", "8"],
                "mvs_dtype_bfloat16": ["--mvs_dtype", "bfloat16"]}[option]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _entry_point(entry, tmp_path)(argv)
    if entry == "train":
        losses = [ln["loss"] for ln in steps(
            [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")])]
        assert out["steps"] == 2 and np.isfinite(losses).all()
        return
    frames = (np.load(tmp_path / "f.npz") if entry == "serve"
              else np.load(out["out"]))
    assert entry != "serve" or out == 1
    assert all(np.isfinite(frames[k]).all() for k in ("rgb", "depth"))


def test_deterministic_flag(monkeypatch):
    """--deterministic runs the trainer on deterministic kernels and puts
    the previous settings back after; without it nothing changes."""
    seen = []
    monkeypatch.setattr(train_cli, "run", lambda cfg, ns: seen.append(
        (torch.are_deterministic_algorithms_enabled(),
         torch.backends.cudnn.deterministic)))
    train_cli.main([*CLI, "--deterministic"])
    train_cli.main(CLI)
    assert seen == [(True, True), (False, False)]
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(KeyError):
        with deterministic_kernels():
            assert torch.are_deterministic_algorithms_enabled()
            raise KeyError("inside")
    assert not torch.backends.cudnn.deterministic


def test_writer_prefetcher_and_trace(tmp_path, monkeypatch):
    # TensorBoard absent: the writer keeps to metrics.jsonl
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    w = MetricWriter(str(tmp_path / "tb"))
    w.write(50, {"train/loss": 0.5})
    w.close()
    rows = [json.loads(ln) for ln in
            (tmp_path / "tb" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["train/loss"]) for r in rows] == [(50, 0.5)]

    assert list(ThreadPrefetcher((lambda i=i: i * i for i in range(5)))) \
        == [0, 1, 4, 9, 16]

    def boom():
        raise KeyError("loader")
    with pytest.raises(KeyError, match="loader"):
        list(ThreadPrefetcher(iter([lambda: 1, boom])))
    with ThreadPrefetcher((lambda i=i: i for i in range(100))) as pf:
        assert next(iter(pf)) == 0
    assert not pf._thread.is_alive()

    with trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    with open(tmp_path / "prof" / TRACE_FILE) as fh:
        assert "traceEvents" in json.load(fh)
