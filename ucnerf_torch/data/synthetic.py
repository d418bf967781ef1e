"""Procedural multi-view scene for tests and benchmarks (no external data).

A smoothly-textured tilted plane viewed from a cluster of nearby cameras:
geometrically consistent across views (homography-exact), with analytic GT
depth, so the full pipeline — MVS cost volumes, ray building, rendering,
losses — runs end-to-end and a tiny-scene overfit drives image MSE toward
zero.  Produces the exact SceneDataset sample contract at any resolution.
"""

from __future__ import annotations

import numpy as np

from ucnerf_torch.data.base import SceneDataset, normalize_image


def _texture(x, y):
    """Smooth deterministic RGB texture over the plane, values in (0, 1)."""
    r = 0.5 + 0.25 * np.sin(2.1 * x + 0.3) + 0.2 * np.cos(1.3 * y)
    g = 0.5 + 0.25 * np.sin(1.7 * x + 1.1 * y) + 0.15 * np.cos(2.9 * y + 0.5)
    b = 0.5 + 0.3 * np.cos(1.1 * x - 0.7 * y) + 0.1 * np.sin(3.1 * y)
    return np.clip(np.stack([r, g, b], axis=-1), 0.05, 0.95)


class SyntheticDataset(SceneDataset):

    def __init__(self, datadir="", split="train", n_views=5, img_wh=(64, 32),
                 n_images=12, plane_z=1.5, plane_tilt=0.15, focal=60.0,
                 n_sparse=256, n_scans=1, **kw):
        self._n_images = n_images
        self._plane_z = plane_z
        self._plane_tilt = plane_tilt
        self._focal = focal
        self._n_sparse = n_sparse
        self._n_scans = n_scans
        super().__init__(datadir, split, n_views, img_wh, **kw)

    def _discover_scans(self):
        # n_scans > 1 gives decorrelated procedural scenes (different
        # plane geometry, texture phase, and sparse draws per scan) so
        # multi-scene training — the reference's normal regime, metas
        # spanning scans (``data/scared.py:255-273``) — runs with no
        # external data.  synth0 is bit-identical to the single-scan
        # scene regardless of n_scans.
        return [f"synth{i}" for i in range(self._n_scans)]

    def _load_scene(self, scan):
        # scan index from the "synthN" name; subclasses with custom scan
        # names (tests) get the base (si=0) scene
        tail = scan[5:] if scan.startswith("synth") else ""
        si = int(tail) if tail.isdigit() else 0
        W, H = self.img_wh
        rng = np.random.default_rng(42 + si)
        K = np.array([[self._focal, 0, W / 2],
                      [0, self._focal, H / 2], [0, 0, 1]], np.float32)

        # plane: z = z0 + a*x + b*y  (world frame; cameras near origin, +z fwd)
        a = self._plane_tilt * (1.0 + 0.35 * si)
        b = -0.6 * self._plane_tilt * (1.0 - 0.25 * si)
        z0 = self._plane_z + 0.3 * si
        tex_dx, tex_dy = 2.17 * si, -1.31 * si

        c2ws = []
        for i in range(self._n_images):
            t = np.array([0.12 * np.sin(2 * np.pi * i / self._n_images),
                          0.08 * np.cos(2 * np.pi * i / self._n_images),
                          0.04 * np.sin(4 * np.pi * i / self._n_images)])
            # small look-at-ish rotation toward the plane center
            yaw = -0.15 * t[0]
            pitch = 0.15 * t[1]
            Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                           [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
            Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)],
                           [0, np.sin(pitch), np.cos(pitch)]])
            m = np.eye(4)
            m[:3, :3] = Ry @ Rx
            m[:3, 3] = t
            c2ws.append(m.astype(np.float32))
        c2ws = np.stack(c2ws)
        w2cs = np.linalg.inv(c2ws).astype(np.float32)

        us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                             np.arange(H, dtype=np.float64))
        d_cam = np.stack([(us - K[0, 2]) / K[0, 0],
                          (vs - K[1, 2]) / K[1, 1],
                          np.ones_like(us)], axis=-1)

        images, depths, dpts, sparse = [], [], [], []
        for i in range(self._n_images):
            R = c2ws[i, :3, :3].astype(np.float64)
            o = c2ws[i, :3, 3].astype(np.float64)
            d_w = d_cam @ R.T
            # plane z = z0 + a x + b y  ->  o_z + t dz = z0 + a(o_x+t dx)+...
            denom = d_w[..., 2] - a * d_w[..., 0] - b * d_w[..., 1]
            t = (z0 + a * o[0] + b * o[1] - o[2]) / denom
            p = o + t[..., None] * d_w
            img = _texture(p[..., 0] * 6.0 + tex_dx, p[..., 1] * 6.0 + tex_dy)
            images.append(normalize_image(img.astype(np.float32)))
            depth = t.astype(np.float32)  # camera z-depth (d_cam z == 1)
            depths.append(depth)
            dpts.append(depth.copy())

            ys = rng.integers(0, H, self._n_sparse)
            xs = rng.integers(0, W, self._n_sparse)
            depth_img = np.zeros((H, W), np.float32)
            weight_img = np.zeros((H, W), np.float32)
            depth_img[ys, xs] = depth[ys, xs]
            weight_img[ys, xs] = 2.0 * np.exp(
                -rng.uniform(0.0, 1.0, self._n_sparse) ** 2)
            sparse.append(dict(
                depth_img=depth_img, weight_img=weight_img,
                coords=np.stack([ys, xs], axis=-1).astype(np.int32),
                depths=depth[ys, xs],
                weights=weight_img[ys, xs]))

        zs = np.stack(depths)
        near_far = np.array([zs.min() * 0.8, zs.max() * 1.2], np.float32)
        return dict(images=np.stack(images), depths=np.stack(depths),
                    dpt=np.stack(dpts), sparse=sparse, c2ws=c2ws, w2cs=w2cs,
                    intrinsic=K, near_far=near_far, bounds=None)
