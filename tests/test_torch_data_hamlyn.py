"""``python -m ucnerf_torch.train --preset train_hamlyn`` on the CPU, on a
fabricated Hamlyn-layout scan (``tests/test_torch_data.py::_write_scene``,
JPEG frames, 8-bit GT depth): a step to a checkpoint, then ``--eval`` of
it.  One test, so that pytest-xdist's ``--dist loadfile`` queues this file
after the suite's long JAX files."""

import contextlib
import io
import json

import numpy as np
import torch

from ucnerf_torch.train import __main__ as train_cli

from test_torch_data import _write_scene

torch.set_num_threads(1)


def test_train_hamlyn_cli_step_and_eval(tmp_path):
    """``python -m ucnerf_torch.train --preset train_hamlyn --device cpu`` at
    160x128 (imgScale 0.5): one store-fed step to a checkpoint, then
    ``--eval`` of it over the val split with finite PSNR, SSIM and depth
    metrics against the GT depth."""
    # the Hamlyn scan of tests/test_torch_data.py's ``scenes``
    _write_scene(tmp_path / "hamlyn" / "scene0", 9, "jpg", (320, 256), 6)
    args = ["--preset", "train_hamlyn", "--device", "cpu", "--datadir",
            str(tmp_path / "hamlyn"), "--imgScale_train", "0.5", "--imgScale_test",
            "0.5", "--view_num", "3", "--N_samples", "3", "--batch_size",
            "80", "--patch_size", "4", "--patch_num", "4", "--n_depth_rays",
            "32", "--ndepths", "8", "8", "8", "--samples_per_scene", "1",
            "--chunk", "20480", "--nerf_dtype", "float32", "--basedir",
            str(tmp_path), "--val_panels", "none"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = train_cli.main([*args, "--expname", "t",
                                  "--stop_after_steps", "1"])
        assert summary["steps"] == 1 and summary["stopped"]
        ckpt = tmp_path / "t" / "ckpts" / "step_00000001"
        ev = train_cli.main([*args, "--expname", "e", "--eval", "--ckpt",
                             str(ckpt)])
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    [step] = [ln for ln in lines if "step" in ln]
    assert np.isfinite(step["loss"])
    [val] = [ln for ln in lines if "val_step" in ln]
    assert val["views"] == 3
    m = ev["val"]
    assert all(np.isfinite(m[k]) for k in ("psnr", "ssim", "abs_rel", "rmse"))
    assert (tmp_path / "e" / "test_results" / "rgb_evaluation.txt").is_file()
