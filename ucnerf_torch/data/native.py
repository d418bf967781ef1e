"""The native COLMAP sparse-depth loader: ``csrc/colmap_fast.cpp`` bound
with ctypes (the JAX package's ``data/native.py``).

``load_colmap_sparse_depth_native`` is a drop-in for
``data/base.py::load_colmap_sparse_depth``: a C++ parser of
``sparse/0/{images,points3D}.bin`` and a splatter, equal to the Python
loader bit for bit on the float32 outputs.  No entry point calls it.  The
library builds at first use with the host C++ compiler into
``ucnerf_torch/_build/`` (``kernels/build.py``); a failed build raises,
and nothing falls back to the Python loader.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List

import numpy as np

from ucnerf_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("colmap_fast")
    lib.colmap_fast_load.restype = ctypes.c_void_p
    lib.colmap_fast_load.argtypes = [ctypes.c_char_p]
    lib.colmap_fast_free.argtypes = [ctypes.c_void_p]
    lib.colmap_fast_num_images.restype = ctypes.c_int
    lib.colmap_fast_num_images.argtypes = [ctypes.c_void_p]
    lib.colmap_fast_image_name.restype = ctypes.c_int
    lib.colmap_fast_image_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.colmap_fast_splat.restype = ctypes.c_int
    lib.colmap_fast_splat.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, f32p, f32p, ctypes.c_int]
    return lib


def available() -> bool:
    """Whether the library builds and loads here (a host C++ compiler)."""
    try:
        _lib()
    except (OSError, RuntimeError):
        return False
    return True


def load_colmap_sparse_depth_native(scene_dir, img_wh, factor, bds_raw,
                                    bd_factor=0.75,
                                    max_pts: int = 65536) -> List[dict]:
    """``data/base.py::load_colmap_sparse_depth`` through the C++ loader:
    per image, sorted by name, {'name', 'depth_img', 'weight_img',
    'coords', 'depths', 'weights'}, at most ``max_pts`` points each."""
    lib = _lib()
    sparse_dir = os.path.join(scene_dir, "sparse", "0")
    handle = lib.colmap_fast_load(sparse_dir.encode())
    if not handle:
        raise RuntimeError(f"failed to load COLMAP model at {sparse_dir}")
    try:
        n = lib.colmap_fast_num_images(handle)
        w_img, h_img = img_wh
        sc = 1.0 / (float(np.min(bds_raw)) * bd_factor)
        bds = np.asarray(bds_raw, np.float64)
        if bds.ndim == 1:
            bds = np.broadcast_to(bds, (n, 2))
        # bds_raw rows follow the name-sorted order (LLFF's save order),
        # as the entries do
        entries = []
        for i in range(n):
            name_buf = ctypes.create_string_buffer(512)
            lib.colmap_fast_image_name(handle, i, name_buf, 512)
            depth_img = np.zeros((h_img, w_img), np.float32)
            weight_img = np.zeros((h_img, w_img), np.float32)
            coords = np.zeros((max_pts, 2), np.int32)
            depths = np.zeros((max_pts,), np.float32)
            weights = np.zeros((max_pts,), np.float32)
            lo, hi = (float(b) for b in bds[min(i, len(bds) - 1)])
            cnt = lib.colmap_fast_splat(
                handle, i, float(factor), sc, lo, hi, w_img, h_img,
                depth_img, weight_img, coords, depths, weights, max_pts)
            entries.append(dict(
                name=name_buf.value.decode(),
                depth_img=depth_img, weight_img=weight_img,
                coords=coords[:cnt].copy(), depths=depths[:cnt].copy(),
                weights=weights[:cnt].copy()))
        return entries
    finally:
        lib.colmap_fast_free(handle)
