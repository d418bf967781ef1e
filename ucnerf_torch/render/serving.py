"""Novel-view serving for a fixed source set.

A serving process holds one scene's sample on the device and answers
pose -> frame requests.  The target-independent FeatureNet forward of the
fixed source views runs once; per request only the warp / variance /
CostRegNet remainder of the cascade reruns (the cost volume lives in the
target view's frame), then the tile loop renders the frame.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ucnerf_torch.config import Config
from ucnerf_torch.data.base import build_affine_mats
from ucnerf_torch.train.loop import make_eval_render

_POSE_KEYS = ("c2ws", "w2cs", "affine_mat", "affine_mat_inv")


def to_device_batch(sample, device):
    """numpy sample -> dict of tensors on ``device`` (nested dicts kept)."""
    return {k: (to_device_batch(v, device) if isinstance(v, dict)
                else torch.as_tensor(np.asarray(v), device=device))
            for k, v in sample.items()}


class ServingRenderer:
    """Pose -> (rgb, depth, confidence) renderer over a fixed source set.

    ``nerf`` is the MLP callable (the kernel wrapper on the card), ``mvs``
    the cascade; ``sample`` one dataset sample, whose view-0 pose is
    replaced per request; ``intrinsic`` the target camera.  With a
    ``mesh`` each frame's pixel tiles split over all its ranks
    (``train/loop.py::make_eval_render`` on the mesh, the cached
    features in place of the cascade's FeatureNet), and every rank gets
    the whole frame; each rank must render the same poses in the same
    order."""

    def __init__(self, cfg: Config, nerf, mvs, sample,
                 img_hw: Tuple[int, int], intrinsic, device, mesh=None):
        self.cfg = cfg
        self.sample = sample
        self.intrinsic = np.asarray(intrinsic, np.float32)
        self.img_hw = tuple(img_hw)
        self.device = torch.device(device)
        self.base = to_device_batch(sample, self.device)
        with torch.no_grad():
            self.src_feats = mvs.features(self.base["images"][1:])

        def mvs_cached(imgs_src, aff, aff_inv, near, far, pad):
            del imgs_src  # features precomputed for the fixed source set
            return mvs.from_features(self.src_feats, aff, aff_inv, near, far,
                                     pad)

        self.mesh = mesh
        self._render_view = make_eval_render(cfg, nerf, mvs, self.img_hw,
                                             mvs_apply=mvs_cached, mesh=mesh)

    def frame_batch(self, c2w):
        """Device batch for a target pose: only the view-0 pose rows and the
        per-stage projection matrices change."""
        c2w = np.asarray(c2w, np.float32)
        w2c = np.linalg.inv(c2w).astype(np.float32)
        aff, aff_inv = build_affine_mats(self.intrinsic, w2c)
        s = dict(self.base)
        for key, row in zip(_POSE_KEYS, (c2w, w2c, aff, aff_inv)):
            arr = np.asarray(self.sample[key]).copy()
            arr[0] = row
            s[key] = torch.as_tensor(arr, device=self.device)
        return s

    def render(self, c2w):
        """Enqueue one frame; returns device tensors (rgb [H,W,3],
        depth [H,W], confidence)."""
        return self._render_view(self.frame_batch(c2w))

    def render_np(self, c2w):
        """Synchronous convenience: fetch to numpy."""
        return tuple(t.cpu().numpy() for t in self.render(c2w))
