"""Kill-and-resume of ``python -m ucnerf_torch.train`` under each
``--parallel_mode``, bit for bit on the CPU."""

import os

import pytest
import torch

from ucnerf_torch.utils.checkpoint_io import load_params_npz

from test_torch_parallel import spawn_both
from test_torch_train_cli import CLI, assert_trees_equal

RESUME = {"rays": ["--mesh_shape", "2"],
          "scenes": ["--mesh_shape", "2", "--parallel_mode", "scenes",
                     "--samples_per_scene", "3"],
          "grid": ["--mesh_shape", "2", "2", "--mesh_axes", "data", "rays",
                   "--parallel_mode", "grid", "--samples_per_scene", "3"]}
TOTAL, STOP = 2, 1


def _ckpt(base, name, step):
    return os.path.join(base, name, "ckpts", f"step_{step:08d}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mode: its directory and the summaries of the uninterrupted run,
    the run stopped at step 1 and its resume, each ``main(argv)`` on the
    ranks of a 2-rank set (ray-DP, scene-DP) or a 2x2 grid, the two sets
    at once."""
    jobs = {}
    for mode, flags in RESUME.items():
        d = str(tmp_path_factory.mktemp(mode))
        jobs[mode] = (d, dict(kind="train", runs=[
            [*CLI, *flags, "--basedir", d, "--expname", name,
             "--stop_after_steps", str(n), *extra]
            for name, n, extra in (
                ("whole", TOTAL, []), ("part", STOP, []),
                ("resumed", TOTAL, ["--ckpt", _ckpt(d, "part", STOP)]))]))
    two, four = spawn_both(
        ((2,), ("data",), [jobs["rays"][1], jobs["scenes"][1]]),
        ((2, 2), ("data", "rays"), [jobs["grid"][1]]))
    return {m: (jobs[m][0], r) for m, r in
            (("rays", two[0]), ("scenes", two[1]), ("grid", four[0]))}


@pytest.mark.parametrize("mode", ["rays", "scenes", "grid"])
def test_kill_resume_bitwise(runs, mode):
    """``python -m ucnerf_torch.train`` under each mode (ray-DP store-fed
    and stopped mid-epoch; scene-DP and the grid with 3 samples an epoch,
    so each epoch skips its one-sample tail): a run stopped at a
    checkpoint and resumed ends with the uninterrupted run's weights,
    Adam moments and step, bit for bit."""
    base, (whole, part, resumed) = runs[mode]
    assert part["stopped"] and whole["steps"] == resumed["steps"] == TOTAL
    assert resumed["world_size"] == whole["world_size"] == (
        4 if mode == "grid" else 2)
    a, b = _ckpt(base, "whole", TOTAL), _ckpt(base, "resumed", TOTAL)
    assert_trees_equal(*(load_params_npz(os.path.join(p, "params.npz"))
                         for p in (a, b)))
    sa, sb = (torch.load(os.path.join(p, "train_state.pt"),
                         weights_only=True) for p in (a, b))
    assert sa["step"] == sb["step"] == TOTAL
    for i, st in sa["optimizer"]["state"].items():
        for k, t in st.items():
            assert torch.equal(t, sb["optimizer"]["state"][i][k]), (i, k)
