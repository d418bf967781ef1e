"""Resizes with torch ``F.interpolate`` semantics (align_corners=False), at
the JAX package's channel-last layouts."""

from __future__ import annotations

import functools

import numpy as np
import torch
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


@functools.lru_cache(maxsize=64)
def _cubic_weight_matrix(in_size: int, out_size: int, a: float = -0.75):
    """Dense [out, in] resampling matrix for Keys cubic convolution, as the
    JAX package builds it: source positions and weights in float64,
    accumulated into a float32 matrix.

    a=-0.75 is the kernel of torch's ``interpolate(mode='bicubic',
    align_corners=False)`` and cv2's ``INTER_CUBIC``: half-pixel source
    rule, edge-replicated taps, no antialias."""
    scale = in_size / out_size
    src = scale * (np.arange(out_size, dtype=np.float64) + 0.5) - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    W = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    for k in range(-1, 3):
        x = np.abs(t - k)
        w = np.where(
            x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
            np.where(x < 2, a * (x ** 3 - 5 * x ** 2 + 8 * x - 4), 0.0))
        np.add.at(W, (rows, np.clip(i0 + k, 0, in_size - 1)), w)
    W.flags.writeable = False
    return W


def _resize_axis_cubic(x, axis: int, out_size: int):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    W = torch.as_tensor(_cubic_weight_matrix(in_size, out_size).copy(),
                        dtype=x.dtype, device=x.device)
    return torch.movedim(torch.movedim(x, axis, -1) @ W.T, -1, axis)


def resize_bicubic(x, out_hw, h_axis: int = -3, w_axis: int = -2):
    """Bicubic (a=-0.75) resize, one matrix product per axis, as
    ``ucnerf_tpu.ops.interpolate.resize_bicubic``.  The default axes fit
    ``[..., H, W, C]``; pass ``h_axis=-2, w_axis=-1`` for ``[..., H, W]``
    maps."""
    nd = x.ndim
    x = _resize_axis_cubic(x, h_axis % nd, out_hw[0])
    return _resize_axis_cubic(x, w_axis % nd, out_hw[1])
