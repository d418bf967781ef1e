"""The entry points of ucnerf_torch on a mesh of CPU ranks (gloo), as
users call them: ``python -m ucnerf_torch.train --eval``, ``serve``'s
batch mode and ``render_path`` with ``--mesh_shape 2`` against their
single-device output (bit for bit: each rank renders the same tiles),
and the JAX trainer's refusals of a multi-device configuration.  No JAX:
``tests/test_torch_parallel*.py`` hold the modes against the JAX package,
``tests/test_torch_parallel_http.py`` serve's HTTP mode."""

import json

import numpy as np
import pytest
import torch

from ucnerf_torch import render_path, serve
from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.parallel import launch
from ucnerf_torch.train import __main__ as train_cli

from test_torch_train import ARGS
from test_torch_train_cli import CLI

torch.set_num_threads(1)

TIMEOUT = 60          # s for each set of spawned ranks
FRAME_KEYS = ("rgb", "depth", "confidence")


def _poses(n):
    ds = build_dataset(parse_config(ARGS), "val")
    return [np.asarray(ds[i]["c2ws"][0], np.float32) for i in range(n)]


def test_eval_on_a_mesh_equals_one_device(tmp_path):
    """``--eval --mesh_shape 2``: the validator renders every val view's
    8 tiles over 2 ranks, with ``--eval_jitter`` (rank 1 draws after the
    tiles of rank 0); the metrics equal the single-device ``--eval``'s
    exactly, and the summary names the mesh and its backend."""
    argv = [*CLI, "--basedir", str(tmp_path), "--eval", "--val_panels",
            "none", "--chunk", "256", "--eval_jitter"]
    one = train_cli.main(argv)
    two = train_cli.main([*argv, "--expname", "mesh", "--mesh_shape", "2"],
                         timeout=TIMEOUT)
    assert (two["mesh_shape"], two["world_size"], two["backend"]) == (
        [2], 2, "gloo")
    assert sorted(one["val"]) == sorted(two["val"])
    np.testing.assert_array_equal([one["val"][k] for k in sorted(one["val"])],
                                  [two["val"][k] for k in sorted(one["val"])])
    assert (tmp_path / "mesh" / "test_results" / "rgb_evaluation.txt"
            ).is_file()
    assert [s["rank"] for s in launch.last_stats] == [0, 1]


def test_serve_and_render_path_on_a_mesh(tmp_path):
    """serve's batch mode and render_path with ``--mesh_shape 2``: rank 0
    writes every frame, each bit for bit the single-device one; a
    malformed line is reported once and skipped."""
    for tag in ("one", "two"):
        lines = [json.dumps({"c2w": c2w.tolist(),
                             "out": str(tmp_path / f"{tag}{i}.npz")})
                 for i, c2w in enumerate(_poses(2))]
        (tmp_path / f"{tag}.jsonl").write_text("\n".join(
            [lines[0], '{"c2w": [[1]], "out": "bad.npz"}', lines[1]]) + "\n")
    base = ["--device", "cpu", *ARGS]
    assert serve.main(["--requests", str(tmp_path / "one.jsonl"), *base]) == 2
    assert serve.main(["--requests", str(tmp_path / "two.jsonl"), *base,
                       "--mesh_shape", "2"], timeout=TIMEOUT) == 2
    for i in range(2):
        a, b = (np.load(tmp_path / f"{t}{i}.npz") for t in ("one", "two"))
        for k in FRAME_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    paths = [render_path.main([*base, "--out", str(tmp_path / f"p{n}.npz"),
                               "--n_frames", "3", *extra],
                              timeout=TIMEOUT)["out"]
             for n, extra in ((1, []), (2, ["--mesh_shape", "2"]))]
    a, b = (np.load(p) for p in paths)
    for k in ("rgb", "depth"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_refusals_match_jax(tmp_path):
    """What the JAX trainer refuses, the port refuses with its message: a
    grid on a 1-D mesh and ``--mvs_only`` outside scene-DP before any
    rank starts, and scene-DP with fewer train samples than scenes a step
    from its rank (the launcher raises the rank's ValueError in the
    caller, its traceback in the notes)."""
    argv = [*CLI, "--basedir", str(tmp_path)]
    with pytest.raises(ValueError, match="2D mesh"):
        train_cli.main([*argv, "--mesh_shape", "2", "--parallel_mode",
                        "grid"])
    with pytest.raises(ValueError, match="no rays to shard"):
        train_cli.main([*argv, "--mesh_shape", "2", "--mvs_only"])
    with pytest.raises(ValueError,
                       match="1 train samples < 2 scenes/step") as e:
        train_cli.main([*argv, "--mesh_shape", "2", "--parallel_mode",
                        "scenes", "--samples_per_scene", "1"],
                       timeout=TIMEOUT)
    assert any("raised on rank" in n for n in e.value.__notes__)
