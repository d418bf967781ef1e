"""Plane-sweep homography warp (the MVS cost-volume hot loop).

For every target pixel (x, y) and depth hypothesis d,

    [u, v, w]^T = R @ [x, y, 1]^T + T / d          (R|T = src_proj @ ref_proj_inv)
    src_px      = (u/w, v/w)

then nearest sampling with border padding at align_corners=True
normalization, and an in-bounds mask that is strict ``(-1, 1)`` in
normalized coordinates.  Nearest rounds half to even (``torch.round``), as
the JAX package does.  One flat row gather per source view.
"""

from __future__ import annotations

import torch


def homo_warp(src_feat, proj_mat, depth_values, pad: int = 0):
    """Warp one source feature map into the target frustum's plane sweep.

    src_feat [H, W, C]; proj_mat [3, 4] rows [R | T]; depth_values
    [D, H_pad, W_pad] (already padded if pad > 0).
    Returns (warped [D, H_pad, W_pad, C], mask [D, H_pad, W_pad]).
    """
    H, W, C = src_feat.shape
    _, H_pad, W_pad = depth_values.shape
    R = proj_mat[:, :3]
    T = proj_mat[:, 3]
    dev, dt = src_feat.device, src_feat.dtype

    ys = torch.arange(H_pad, dtype=dt, device=dev) - pad
    xs = torch.arange(W_pad, dtype=dt, device=dev) - pad
    base = (R[:, 0][:, None, None] * xs[None, None, :]
            + R[:, 1][:, None, None] * ys[None, :, None]
            + R[:, 2][:, None, None])                       # [3, H_pad, W_pad]
    src = base[:, None] + T[:, None, None, None] / depth_values[None]
    u = src[0] / src[2]
    v = src[1] / src[2]

    gx = u / ((W - 1) / 2.0) - 1.0
    gy = v / ((H - 1) / 2.0) - 1.0
    in_mask = (gx > -1.0) & (gx < 1.0) & (gy > -1.0) & (gy < 1.0)

    ix = torch.clamp(torch.round((gx + 1.0) * 0.5 * (W - 1)), 0, W - 1)
    iy = torch.clamp(torch.round((gy + 1.0) * 0.5 * (H - 1)), 0, H - 1)
    idx = iy.long() * W + ix.long()
    warped = src_feat.reshape(H * W, C)[idx]
    return warped, in_mask.to(dt)
