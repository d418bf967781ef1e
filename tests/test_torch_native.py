"""The port's native COLMAP sparse-depth loader
(``ucnerf_torch/data/native.py`` over ``csrc/colmap_fast.cpp``) against
the Python loaders of both packages, on the fabricated COLMAP model of
``tests/test_colmap_io.py``: every output bit for bit.  It builds with
the host C++ compiler at first use; a compiler that fails makes it raise,
with no fallback to the Python loader."""

import os

import numpy as np
import pytest
import torch

from ucnerf_tpu.data import colmap as j_colmap
from ucnerf_tpu.data.base import (load_colmap_sparse_depth as
                                  j_load_colmap_sparse_depth)

from ucnerf_torch.data import native
from ucnerf_torch.data.base import load_colmap_sparse_depth
from ucnerf_torch.data.llff import gen_poses, load_poses_bounds
from ucnerf_torch.kernels import build

from test_colmap_io import _make_model

torch.set_num_threads(1)

KEYS = ("depth_img", "weight_img", "coords", "depths", "weights")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cams, images, points = _make_model(np.random.default_rng(5))
    d = tmp_path_factory.mktemp("scene")
    sparse = d / "sparse" / "0"
    os.makedirs(sparse)
    j_colmap.write_cameras_binary(cams, sparse / "cameras.bin")
    j_colmap.write_images_binary(images, sparse / "images.bin")
    j_colmap.write_points3d_binary(points, sparse / "points3D.bin")
    gen_poses(str(d))
    return str(d)


@pytest.mark.parametrize("factor, img_wh", [(1.0, (64, 48)),
                                            (2.0, (32, 24))])
def test_native_loader_matches_both_python_loaders(model_dir, factor,
                                                   img_wh):
    """Per image, in name order: the name and every array (depth and
    weight images, coords, depths, weights) equal bit for bit to the
    port's Python loader and to the JAX package's, at the full size and
    splatted at half size."""
    _, bds = load_poses_bounds(os.path.join(model_dir, "poses_bounds.npy"))
    got = native.load_colmap_sparse_depth_native(model_dir, img_wh, factor,
                                                 bds)
    assert len(got) == 4 and sum(len(e["coords"]) for e in got) > 100
    for want in (load_colmap_sparse_depth(model_dir, img_wh, factor, bds),
                 j_load_colmap_sparse_depth(model_dir, img_wh, factor,
                                            bds)):
        assert [e["name"] for e in got] == [e["name"] for e in want]
        for a, b in zip(got, want):
            for k in KEYS:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_a_failed_build_raises(model_dir, tmp_path, monkeypatch):
    """With no library built and a compiler that fails, the loader raises
    the compiler's error and ``available()`` is False: nothing falls back
    to the Python loader."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", "false")
    build.load.cache_clear()
    native._lib.cache_clear()
    try:
        _, bds = load_poses_bounds(os.path.join(model_dir,
                                                "poses_bounds.npy"))
        with pytest.raises(RuntimeError, match="false failed for "
                           "colmap_fast.cpp"):
            native.load_colmap_sparse_depth_native(model_dir, (64, 48), 1.0,
                                                   bds)
        assert not native.available()
        assert not (tmp_path / "_build").exists() or not any(
            (tmp_path / "_build").glob("*.so"))
    finally:
        build.load.cache_clear()
        native._lib.cache_clear()
