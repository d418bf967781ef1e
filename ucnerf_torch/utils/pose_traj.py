"""Novel-view camera trajectories: a copy of ``ucnerf_tpu/utils/pose_traj.py``
(the port imports nothing of the JAX package).

- Euler-angle interpolation through the scene cameras
  (``gen_render_path_euler``),
- spherical poses (``create_spheric_poses``),
- an LLFF spiral (``render_path_spiral``),
- slerp rotations with linear or B-spline translations
  (``interp_poses_slerp``, ``interp_poses_bspline``).

Host-side numpy and scipy; ``ucnerf_torch/render_path.py`` renders them.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import splev, splprep
from scipy.spatial.transform import Rotation, Slerp


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def gen_render_path_euler(c2ws, n_views: int = 30):
    """Piecewise-linear Euler-angle + translation interpolation through the
    given cameras, closing the loop (reference ``utils/utils.py:1004-1037``)."""
    n = len(c2ws)
    per_seg = max(n_views // 3, 1)
    w = np.linspace(1.0, 0.0, per_seg, endpoint=False).reshape(-1, 1)

    eulers, centers = [], []
    for i in range(n):
        e = Rotation.from_matrix(c2ws[i, :3, :3]).as_euler(
            "xyz", degrees=True).reshape(1, 3)
        if i and (np.abs(e - eulers[0]) > 180).any():
            e = e + 360.0 * (np.abs(e - eulers[0]) > 180)
        eulers.append(e)
        centers.append(c2ws[i, :3, 3].reshape(1, 3))

    es, ts = [], []
    for i in range(1, n):
        es.append(w * eulers[i - 1] + (1 - w) * eulers[i])
        ts.append(w * centers[i - 1] + (1 - w) * centers[i])
    es.append(w * eulers[-1] + (1 - w) * eulers[0])
    ts.append(w * centers[-1] + (1 - w) * centers[0])
    es = np.concatenate(es)
    ts = np.concatenate(ts)

    out = []
    for e, t in zip(es, ts):
        m = np.eye(4)
        m[:3, :3] = Rotation.from_euler("xyz", e, degrees=True).as_matrix()
        m[:3, 3] = t
        out.append(m)
    return np.stack(out)


def interp_poses_slerp(c2ws, key_idx, n_views: int = 30):
    """Slerp rotations + linear translations through keyframe indices
    (reference ``interp_poses``, ``utils/common.py:511-524``)."""
    key_idx = np.asarray(key_idx)
    rots = Rotation.from_matrix(c2ws[key_idx, :3, :3])
    slerp = Slerp(np.arange(len(key_idx)), rots)
    t = np.linspace(0, len(key_idx) - 1, n_views)
    Rs = slerp(t).as_matrix()
    centers = np.stack([
        np.interp(t, np.arange(len(key_idx)), c2ws[key_idx, :3, 3][:, k])
        for k in range(3)], axis=-1)
    out = np.tile(np.eye(4), (n_views, 1, 1))
    out[:, :3, :3] = Rs
    out[:, :3, 3] = centers
    return out


def interp_poses_bspline(c2ws, key_idx, n_views: int = 30, degree: int = 3,
                         smoothness: float = 0.0):
    """B-spline translation path + slerp rotations
    (reference ``interp_poses_bspline``/``scipy_bspline``,
    ``utils/common.py:526-534,566-592``)."""
    key_idx = np.asarray(key_idx)
    pts = c2ws[key_idx, :3, 3]
    k = min(degree, len(key_idx) - 1)
    tck, _ = splprep(pts.T, s=smoothness, k=k)
    u = np.linspace(0, 1, n_views)
    centers = np.stack(splev(u, tck), axis=-1)
    rots = Rotation.from_matrix(c2ws[key_idx, :3, :3])
    slerp = Slerp(np.linspace(0, 1, len(key_idx)), rots)
    Rs = slerp(u).as_matrix()
    out = np.tile(np.eye(4), (n_views, 1, 1))
    out[:, :3, :3] = Rs
    out[:, :3, 3] = centers
    return out


def render_path_spiral(c2ws, bounds, n_views: int = 60, n_rots: int = 2,
                       zrate: float = 0.5, rads_scale: float = 0.5):
    """LLFF-style spiral around the average pose (reference
    ``render_path_spiral``/``generate_spiral_nerf``,
    ``utils/common.py:381-392,594-618``)."""
    center = c2ws[:, :3, 3].mean(0)
    z_avg = _normalize(c2ws[:, :3, 2].sum(0))
    up = c2ws[:, :3, 1].sum(0)
    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    rads = np.percentile(np.abs(c2ws[:, :3, 3] - center), 90, axis=0)
    rads = np.append(rads * rads_scale, 1.0)

    c2w = _viewmatrix(z_avg, up, center)
    out = []
    for theta in np.linspace(0, 2 * np.pi * n_rots, n_views + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        m = np.eye(4)
        m[:3] = _viewmatrix(z, up, c)
        out.append(m)
    return np.stack(out)


def spheric_pose(theta, phi, radius):
    """Single spheric inward-facing pose (reference ``create_spheric_poses``,
    ``utils/common.py:333-369``)."""
    trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, -0.9 * radius],
                        [0, 0, 1, radius], [0, 0, 0, 1.0]])
    rot_phi = np.array([[1, 0, 0, 0],
                        [0, np.cos(phi), -np.sin(phi), 0],
                        [0, np.sin(phi), np.cos(phi), 0], [0, 0, 0, 1.0]])
    rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta), 0],
                          [0, 1, 0, 0],
                          [np.sin(theta), 0, np.cos(theta), 0],
                          [0, 0, 0, 1.0]])
    c2w = rot_theta @ rot_phi @ trans_t
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1.0]])
    return flip @ c2w


def create_spheric_poses(radius, n_poses: int = 10, phi_deg: float = -30.0):
    phi = phi_deg * np.pi / 180.0
    return np.stack([spheric_pose(th, phi, radius)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]])
