"""Resizes with torch ``F.interpolate`` semantics (align_corners=False), at
the JAX package's channel-last layouts."""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(x, out_hw):
    """Bilinear resize of ``x [H, W, C]`` to ``out_hw=(H', W')``."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=tuple(out_hw),
                      mode="bilinear", align_corners=False)
    return y[0].permute(1, 2, 0)


def resize_trilinear(x, out_dhw):
    """Trilinear resize of ``x [D, H, W, C]`` to ``out_dhw=(D', H', W')``."""
    y = F.interpolate(x.permute(3, 0, 1, 2)[None], size=tuple(out_dhw),
                      mode="trilinear", align_corners=False)
    return y[0].permute(1, 2, 3, 0)


def upsample2x_nearest(x):
    """Nearest x2 upsample of ``x [..., H, W, C]`` (repeat-2 along H, W)."""
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
