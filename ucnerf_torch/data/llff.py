"""LLFF-style pose handling and image pyramids (numpy only): a copy of
``ucnerf_tpu.data.llff``.

- ``average_poses`` / ``center_poses``: recenter all c2w poses by the
  inverse of their average pose, then apply the blender2opencv flip
  diag(1, -1, -1, 1).
- ``llff_to_opencv``: the LLFF axis shuffle, ``concat([poses[..., 1:2],
  -poses[..., :1], poses[..., 2:4]], -1)``.
- ``prepare_scene_poses``: scale bounds and translations by 1 / (bounds.min()
  * 0.75), centre, and build the intrinsics at ``img_wh``.
- ``gen_poses``: COLMAP sparse model -> ``poses_bounds.npy``.
- ``minify``: ``images_{N}/`` and ``images_{WxH}/`` pyramids, PIL's
  LANCZOS resize (``data/resize.py::pil_lanczos_u8``) and PIL's PNG and
  JPEG writers (``utils/png.py``, ``utils/jpeg.py``) without PIL.
"""

from __future__ import annotations

import os

import numpy as np

from ucnerf_torch.data.colmap import qvec2rotmat, read_model
from ucnerf_torch.data.image_io import read_frame
from ucnerf_torch.data.resize import pil_lanczos_u8
from ucnerf_torch.utils.jpeg import write_jpeg
from ucnerf_torch.utils.png import write_png

BLENDER2OPENCV = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64)


def _normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses):
    """poses [N, 3, 4] c2w -> average pose [3, 4]."""
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], axis=1)


def center_poses(poses):
    """Recenter poses [N, 3, 4]; returns (centered [N, 3, 4], avg_inv [3,4])."""
    pose_avg = np.eye(4)
    pose_avg[:3] = average_poses(poses)
    last = np.broadcast_to(np.array([0, 0, 0, 1.0]), (len(poses), 1, 4))
    homo = np.concatenate([poses, last], axis=1)
    centered = np.linalg.inv(pose_avg) @ homo
    centered = centered @ BLENDER2OPENCV
    return centered[:, :3], (np.linalg.inv(pose_avg) @ BLENDER2OPENCV)[:3]


def load_poses_bounds(path):
    """poses_bounds.npy -> (poses [N,3,5] raw, bounds [N,2])."""
    pb = np.load(path)
    return pb[:, :15].reshape(-1, 3, 5), pb[:, -2:]


def llff_to_opencv(poses_raw):
    """LLFF [down, right, back] columns -> the reference's axis order
    (``data/scared.py:239-240``).  poses_raw [N,3,5] -> [N,3,4] + hwf [3]."""
    hwf = poses_raw[0, :, 4].copy()
    poses = np.concatenate([poses_raw[..., 1:2], -poses_raw[..., 0:1],
                            poses_raw[..., 2:4]], axis=-1)
    return poses, hwf


def prepare_scene_poses(poses_bounds_path, img_wh):
    """Full reference pipeline: raw LLFF file -> centered scaled poses.

    Returns dict with c2ws [N,4,4], w2cs [N,4,4], intrinsic [3,3],
    bounds [N,2] (scaled), scale_factor, near_far [2].
    """
    poses_raw, bounds = load_poses_bounds(poses_bounds_path)
    poses, hwf = llff_to_opencv(poses_raw)
    H0, W0, focal = hwf
    scale_factor = 1.0 / (bounds.min() * 0.75)
    bounds = bounds * scale_factor
    poses = poses.copy()
    poses[..., 3] *= scale_factor
    poses, _ = center_poses(poses)

    fx = focal * img_wh[0] / W0
    fy = focal * img_wh[1] / H0
    intrinsic = np.array([[fx, 0, img_wh[0] / 2],
                          [0, fy, img_wh[1] / 2], [0, 0, 1]], np.float32)

    n = len(poses)
    c2ws = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
    c2ws[:, :3] = poses.astype(np.float32)
    w2cs = np.linalg.inv(c2ws).astype(np.float32)
    near_far = np.array([bounds.min() * 0.9, bounds.max() * 1.1], np.float32)
    return dict(c2ws=c2ws, w2cs=w2cs, intrinsic=intrinsic,
                bounds=bounds.astype(np.float32),
                scale_factor=float(scale_factor), near_far=near_far)


def gen_poses(scene_dir, out_path=None):
    """COLMAP sparse model -> poses_bounds.npy (reference
    ``preprocess/colmap/pose_utils.py:11-104`` consumed behavior: c2w in
    [down, right, back] LLFF layout + per-image [near, far] percentiles of
    visible point depths)."""
    cams, images, points = read_model(os.path.join(scene_dir, "sparse", "0"))
    cam = next(iter(cams.values()))
    h, w = cam.height, cam.width
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        focal = cam.params[0]
    else:
        focal = cam.params[0]

    names = sorted(images.keys(), key=lambda i: images[i].name)
    w2cs, c2ws = [], []
    for i in names:
        im = images[i]
        R = qvec2rotmat(im.qvec)
        t = im.tvec.reshape(3, 1)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3:] = t
        w2cs.append(w2c)
        c2ws.append(np.linalg.inv(w2c))
    c2ws = np.stack(c2ws)

    # visibility depth bounds
    zs = [[] for _ in names]
    idx_of = {img_id: k for k, img_id in enumerate(names)}
    for pt in points.values():
        for img_id in pt.image_ids:
            if img_id in idx_of:
                k = idx_of[img_id]
                z = (w2cs[k][:3, :3] @ pt.xyz + w2cs[k][:3, 3])[2]
                zs[k].append(z)
    rows = []
    for k in range(len(names)):
        # c2w columns [r, d, b] -> LLFF [d, r, -b]... the standard LLFF
        # save layout: [-y, x, z] of the COLMAP c2w, plus hwf column.
        m = c2ws[k][:3]
        m_llff = np.concatenate(
            [m[:, 1:2], m[:, 0:1], -m[:, 2:3], m[:, 3:4],
             np.array([[h], [w], [focal]], np.float64)], axis=1)
        z = np.array(zs[k]) if zs[k] else np.array([1.0, 10.0])
        # the reference's exact bound percentiles (pose_utils.py:84:
        # np.percentile(zs, .5), np.percentile(zs, 99.5))
        near, far = np.percentile(z, 0.5), np.percentile(z, 99.5)
        rows.append(np.concatenate([m_llff.ravel(), [near, far]]))
    arr = np.stack(rows)
    if out_path is None:
        out_path = os.path.join(scene_dir, "poses_bounds.npy")
    np.save(out_path, arr)
    return arr


def get_nearest_pose_ids(tar_pose, ref_poses, num_select):
    """Nearest views by camera-center distance (reference
    ``data/scared.py:69-106``, method='dist')."""
    dists = np.linalg.norm(tar_pose[:3, 3] - ref_poses[:, :3, 3], axis=-1)
    return np.argsort(dists)[:num_select]


_WRITERS = {".png": write_png, ".jpg": write_jpeg, ".jpeg": write_jpeg}


def minify(scene_dir, factors=(), resolutions=()):
    """Write downsampled image pyramids ``images_{N}/`` / ``images_{WxH}/``
    (the JAX package's ``minify``: each frame of ``images/`` resized as
    PIL's ``resize(size, LANCZOS)`` and saved in the format its extension
    names, PNG or JPEG at PIL's defaults).  Frames are read as 8-bit RGB
    (``data/image_io.py::read_frame``) and written as such; a frame
    already written is kept.  Returns the output directories."""
    import glob

    img_dir = os.path.join(scene_dir, "images")
    paths = sorted(glob.glob(os.path.join(img_dir, "*")))
    if not paths:
        return []
    for p in paths:
        if os.path.splitext(p)[1].lower() not in _WRITERS:
            raise ValueError(f"{p}: minify writes PNG and JPEG frames only")
    h0, w0 = read_frame(paths[0]).shape[:2]
    targets = ([(f"images_{f}", (round(w0 / f), round(h0 / f)))
                for f in factors]
               + [(f"images_{w}x{h}", (w, h)) for (w, h) in resolutions])
    out_dirs = []
    for name, (w, h) in targets:
        out = os.path.join(scene_dir, name)
        os.makedirs(out, exist_ok=True)
        for p in paths:
            dst = os.path.join(out, os.path.basename(p))
            if os.path.exists(dst):
                continue
            _WRITERS[os.path.splitext(p)[1].lower()](
                dst, pil_lanczos_u8(read_frame(p), (w, h)))
        out_dirs.append(out)
    return out_dirs
