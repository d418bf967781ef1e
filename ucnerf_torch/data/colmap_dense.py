"""COLMAP dense-workspace I/O, the port of ``ucnerf_tpu.data.colmap_dense``
(reference ``colmapUtils/read_write_dense.py`` and
``read_write_fused_vis.py``): photometric/geometric depth & normal maps
(``*.bin`` with a text header) and fused point clouds with visibility
(``fused.ply`` + ``fused.ply.vis``)."""

from __future__ import annotations

import struct

import numpy as np


def read_array(path):
    """COLMAP dense map: 'width&height&channels&' text header + f32 data,
    stored row-major per channel plane ([c][h][w], w fastest — reference
    ``read_write_dense.py:40``: F-order reshape to (W,H,C) then (1,0,2)
    transpose)."""
    with open(path, "rb") as fh:
        header = b""
        amps = 0
        while amps < 3:
            c = fh.read(1)
            header += c
            if c == b"&":
                amps += 1
        width, height, channels = map(int, header[:-1].split(b"&"))
        data = np.fromfile(fh, np.float32)
    arr = data.reshape((width, height, channels), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_array(arr, path):
    """Inverse of :func:`read_array` (reference ``read_write_dense.py:58``:
    transpose to (W,H,C) then F-order flatten — i.e. the stream walks w
    fastest, then h, then c == C-order flatten of (C,H,W))."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    with open(path, "wb") as fh:
        fh.write(f"{w}&{h}&{c}&".encode())
        np.ascontiguousarray(np.transpose(arr, (2, 0, 1))).tofile(fh)


def read_fused(ply_path, vis_path=None):
    """fused.ply (binary_little_endian, x y z nx ny nz r g b) +
    optional .vis visibility lists (reference ``read_write_fused_vis.py:47``).

    Returns dict with xyz [N,3], normals [N,3], rgb [N,3] uint8,
    visible_image_idxs (list of int arrays or None).
    """
    with open(ply_path, "rb") as fh:
        n_points = 0
        while True:
            line = fh.readline().decode("ascii", errors="replace").strip()
            if line.startswith("element vertex"):
                n_points = int(line.split()[-1])
            if line == "end_header":
                break
        rec = np.dtype([("xyz", "<f4", 3), ("n", "<f4", 3),
                        ("rgb", "u1", 3)])
        data = np.fromfile(fh, dtype=rec, count=n_points)
    vis = None
    if vis_path is not None:
        with open(vis_path, "rb") as fh:
            (n,) = struct.unpack("<Q", fh.read(8))
            vis = []
            for _ in range(n):
                (k,) = struct.unpack("<I", fh.read(4))
                vis.append(np.frombuffer(fh.read(4 * k), np.uint32).copy())
    return dict(xyz=data["xyz"].copy(), normals=data["n"].copy(),
                rgb=data["rgb"].copy(), visible_image_idxs=vis)


def write_fused(points, ply_path, vis_path=None):
    xyz = np.asarray(points["xyz"], np.float32)
    normals = np.asarray(points.get("normals",
                                    np.zeros_like(xyz)), np.float32)
    rgb = np.asarray(points.get("rgb",
                                np.zeros(xyz.shape, np.uint8)), np.uint8)
    n = len(xyz)
    with open(ply_path, "wb") as fh:
        hdr = ("ply\nformat binary_little_endian 1.0\n"
               f"element vertex {n}\n"
               "property float x\nproperty float y\nproperty float z\n"
               "property float nx\nproperty float ny\nproperty float nz\n"
               "property uchar red\nproperty uchar green\n"
               "property uchar blue\nend_header\n")
        fh.write(hdr.encode("ascii"))
        rec = np.empty(n, dtype=np.dtype([("xyz", "<f4", 3), ("n", "<f4", 3),
                                          ("rgb", "u1", 3)]))
        rec["xyz"] = xyz
        rec["n"] = normals
        rec["rgb"] = rgb
        rec.tofile(fh)
    if vis_path is not None and points.get("visible_image_idxs") is not None:
        with open(vis_path, "wb") as fh:
            vis = points["visible_image_idxs"]
            fh.write(struct.pack("<Q", len(vis)))
            for v in vis:
                fh.write(struct.pack("<I", len(v)))
                fh.write(np.asarray(v, np.uint32).tobytes())
