"""``python -m ucnerf_torch.preprocess`` and the modules it drives, against
the JAX package: the CLI's routing and files beside ``preprocess.py``'s
with the model loaders stubbed (PNG frames written by ``utils/png.py``),
the card rule of ``dpt`` and ``seg``, ``blend_segmentation`` and the ADE20K
palette bit for bit, ``colmap_dense``'s bytes, and ``colmap_wrapper``'s
command sequence, missing binary and environment override."""

import os
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

import preprocess as j_preprocess
import ucnerf_tpu.data.colmap_wrapper as j_cw
import ucnerf_tpu.models.dpt as j_dpt
from ucnerf_tpu.data import colmap_dense as j_dense
from ucnerf_tpu.utils.viz import ADE20K_PALETTE as J_PALETTE
from ucnerf_tpu.utils.viz import blend_segmentation as j_blend

import ucnerf_torch.data.colmap_wrapper as cw
import ucnerf_torch.data.llff as llff
import ucnerf_torch.models.dpt as dpt
from ucnerf_torch import preprocess
from ucnerf_torch.data import colmap_dense
from ucnerf_torch.utils.png import read_png, write_png
from ucnerf_torch.utils.viz import ADE20K_PALETTE, blend_segmentation

torch.set_num_threads(1)


def _scene(root, sizes, seed):
    """<root>/images/{a,b,...}.png, 8-bit RGB from a seed."""
    rng = np.random.default_rng(seed)
    os.makedirs(root / "images")
    frames = {}
    for name, (h, w) in zip("abc", sizes):
        frames[name] = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        write_png(str(root / "images" / f"{name}.png"), frames[name])
    return frames


def _stub_loaders(monkeypatch, weights):
    """The model loaders of both packages as cheap functions of the frame:
    the CLIs' contract is routing, reading and the files they write."""
    def fake_dpt(w, dtype=None, device=None):
        assert w == weights and dtype == "bfloat16"
        return lambda img: img.mean(axis=-1) * 3.0 + 0.5

    def fake_seg(w, dtype=None, device=None):
        assert w == weights and dtype is None

        def predict(img):
            labels = (img[..., 0] * 150).astype(np.int32) + 1
            return labels, np.zeros(labels.shape + (150,), np.float32)
        return predict

    for mod in (dpt, j_dpt):
        monkeypatch.setattr(mod, "load_dpt", fake_dpt)
        monkeypatch.setattr(mod, "load_dpt_seg", fake_seg)


def test_dpt_and_seg_write_the_jax_cli_files(tmp_path, monkeypatch):
    """Both subcommands through the port and through ``preprocess.py``
    on copies of one scene: the same files, ``dpt/<stem>.npz{pred}`` at
    the frame's size, ``seg/<stem>.npz{labels}`` bit for bit, and the
    overlay PNG with PIL's pixels of the JAX CLI's."""
    frames = _scene(tmp_path / "port", [(32, 40), (24, 30)], 0)
    _scene(tmp_path / "jax", [(32, 40), (24, 30)], 0)
    _stub_loaders(monkeypatch, "w.npz")
    for cmd, extra in (("dpt", ["--bf16"]), ("seg", [])):
        out = preprocess.main([cmd, str(tmp_path / "port"), "--weights",
                               "w.npz", "--device", "cpu", *extra])
        assert out["frames"] == 2 and len(out["ms_per_frame"]) == 2
        j_preprocess.main([cmd, str(tmp_path / "jax"), "--weights", "w.npz",
                           *extra])
    for sub in ("dpt", "seg"):
        assert sorted(os.listdir(tmp_path / "port" / sub)) == \
            sorted(os.listdir(tmp_path / "jax" / sub))
    for name, img in frames.items():
        for sub, key in (("dpt", "pred"), ("seg", "labels")):
            with np.load(tmp_path / "port" / sub / f"{name}.npz") as got, \
                    np.load(tmp_path / "jax" / sub / f"{name}.npz") as want:
                assert got.files == want.files == [key]
                assert got[key].shape == img.shape[:2]
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
        png = read_png(str(tmp_path / "port" / "seg" / f"{name}.png"))
        np.testing.assert_array_equal(png, np.asarray(Image.open(
            tmp_path / "jax" / "seg" / f"{name}.png")))
        np.testing.assert_array_equal(png, np.asarray(Image.open(
            tmp_path / "port" / "seg" / f"{name}.png")))


@pytest.mark.parametrize("cmd", ["dpt", "seg"])
def test_the_net_runs_on_the_card_unless_told(cmd, tmp_path, monkeypatch):
    """Without ``--device cpu`` the subcommands ask for the card, and
    without one they raise before reading any weights."""
    _scene(tmp_path, [(8, 8)], 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        preprocess.main([cmd, str(tmp_path), "--weights", "missing.npz"])
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        preprocess.main([cmd, str(tmp_path), "--weights", "missing.npz",
                         "--device", "cpu"])


def test_colmap_subcommand_routes_to_imgs2poses(tmp_path, monkeypatch):
    calls = {}
    monkeypatch.setattr(cw, "imgs2poses",
                        lambda d, m: calls.setdefault("args", (d, m)))
    out = preprocess.main(["colmap", str(tmp_path), "--match",
                           "sequential_matcher"])
    assert calls["args"] == (str(tmp_path), "sequential_matcher")
    assert out["poses_bounds"] == str(tmp_path / "poses_bounds.npy")


def test_blend_segmentation_bit_for_bit():
    np.testing.assert_array_equal(ADE20K_PALETTE, J_PALETTE)
    assert ADE20K_PALETTE.shape == (151, 3)
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (33, 47, 3)).astype(np.float32)
    labels = rng.integers(-3, 160, (33, 47))         # clipped to the table
    for alpha in (0.5, 0.3):
        got = blend_segmentation(img, labels, alpha)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, j_blend(img, labels, alpha))


def test_colmap_dense_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(4)
    arrays = {"depth": rng.uniform(0.5, 3.0, (17, 23)).astype(np.float32),
              "normal": rng.normal(size=(9, 13, 3)).astype(np.float32)}
    for name, arr in arrays.items():
        ours, theirs = tmp_path / f"{name}.bin", tmp_path / f"{name}_j.bin"
        colmap_dense.write_array(arr, ours)
        j_dense.write_array(arr, theirs)
        assert ours.read_bytes() == theirs.read_bytes()
        np.testing.assert_array_equal(colmap_dense.read_array(theirs), arr)
    n = 11
    pts = dict(xyz=rng.normal(size=(n, 3)).astype(np.float32),
               normals=rng.normal(size=(n, 3)).astype(np.float32),
               rgb=rng.integers(0, 256, (n, 3)).astype(np.uint8),
               visible_image_idxs=[rng.integers(0, 40, rng.integers(0, 6))
                                   .astype(np.uint32) for _ in range(n)])
    colmap_dense.write_fused(pts, tmp_path / "f.ply", tmp_path / "f.ply.vis")
    j_dense.write_fused(pts, tmp_path / "j.ply", tmp_path / "j.ply.vis")
    for ext in (".ply", ".ply.vis"):
        assert (tmp_path / f"f{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    back = colmap_dense.read_fused(tmp_path / "j.ply", tmp_path / "j.ply.vis")
    for k in ("xyz", "normals", "rgb"):
        np.testing.assert_array_equal(back[k], pts[k])
    for a, b in zip(back["visible_image_idxs"], pts["visible_image_idxs"]):
        np.testing.assert_array_equal(a, b)


def test_colmap_missing_binary_and_env_override(monkeypatch):
    monkeypatch.delenv("COLMAP_BIN", raising=False)
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(cw.ColmapNotFound, match="COLMAP_BIN"):
        cw.run_colmap("/nonexistent")
    custom = "/usr/local/bin/colmap-custom"
    monkeypatch.setenv("COLMAP_BIN", custom)
    assert cw._colmap_bin() == j_cw._colmap_bin() == custom


def test_run_colmap_command_sequence_is_the_jax_one(tmp_path, monkeypatch):
    monkeypatch.setenv("COLMAP_BIN", "colmap-fake")
    calls = []
    monkeypatch.setattr(subprocess, "check_call",
                        lambda args, stdout=None, stderr=None:
                        calls.append(args))
    kw = dict(match_type="sequential_matcher", camera_model="PINHOLE",
              single_camera=False)
    out = cw.run_colmap(str(tmp_path / "s"), **kw)
    ours, calls[:] = list(calls), []
    assert j_cw.run_colmap(str(tmp_path / "s"), **kw) == out
    assert ours == calls and len(ours) == 3
    assert [c[1] for c in ours] == ["feature_extractor", "sequential_matcher",
                                    "mapper"]
    assert out == str(tmp_path / "s" / "sparse" / "0")
    assert (tmp_path / "s" / "colmap_output.txt").exists()


def test_imgs2poses_skips_sfm_when_model_exists(tmp_path, monkeypatch):
    (tmp_path / "sparse" / "0").mkdir(parents=True)
    (tmp_path / "sparse" / "0" / "images.bin").write_bytes(b"")
    monkeypatch.setattr(cw, "run_colmap",
                        lambda *a, **k: pytest.fail("SfM rerun"))
    sentinel = object()
    monkeypatch.setattr(llff, "gen_poses", lambda d: sentinel)
    assert cw.imgs2poses(str(tmp_path)) is sentinel
