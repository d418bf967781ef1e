"""``python -m ucnerf_torch.train`` on the CPU at the small shape of
``tests/test_train_e2e.py``: kill and resume against an uninterrupted run
(bitwise), and ``--eval`` at a width the fused MLP kernel does not take.
(The phase hand-offs and the trainer's writer, prefetcher and trace are
in ``tests/test_torch_train_cli.py``, whose helpers these use.)  Two
tests, so that pytest-xdist's ``--dist loadfile`` queues this file after
the suite's long JAX files."""

import json
import os

import numpy as np
import torch

from test_torch_train_cli import (RGB_KEYS, assert_trees_equal, ckpt_dir,
                                  params, run, steps, vals)

torch.set_num_threads(1)


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


def test_eval_renders_shapes_the_kernel_does_not_take(tmp_path, capsys):
    """--eval at --netwidth 64, a width the fused MLP kernel does not
    take, renders with the plain MLP after one stderr line naming the
    reason, and ends with finite metrics."""
    summary, _ = run("--basedir", str(tmp_path), "--netwidth", "64",
                     "--eval", "--val_panels", "none")
    assert capsys.readouterr().err.count("plain UCNeRFMLP") == 1
    assert np.isfinite([summary["val"][k] for k in RGB_KEYS
                        if k != "lpips"]).all()
