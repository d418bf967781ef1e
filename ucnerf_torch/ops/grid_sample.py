"""Grid sampling with ``F.grid_sample``'s semantics, as flat gathers.

Channel-last like the JAX package's ``ops/grid_sample.py``: images
``[H, W, C]``, volumes ``[D, H, W, C]``, grids ``[..., 2]`` / ``[..., 3]``
holding (x, y) / (x, y, z) in [-1, 1].  Written as index gathers rather
than calls of ``F.grid_sample``: the backward of a gather is an
``index_put`` accumulation, which has a deterministic version on the card,
where ``F.grid_sample``'s CUDA backward has none (``--deterministic``).
"""

from __future__ import annotations

import torch


def _unnormalize(coord, size: int, align_corners: bool):
    """[-1, 1] -> pixel index space."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _gather(flat, idx, valid=None):
    """Rows ``idx`` [...] of ``flat`` [n, C] -> [..., C], zero where
    ``valid`` is False."""
    out = flat[idx]
    if valid is not None:
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out


def grid_sample_2d(img, grid, mode: str = "bilinear",
                   padding_mode: str = "border", align_corners: bool = False):
    """Sample ``img [H, W, C]`` at ``grid [..., 2]`` -> ``[..., C]``;
    ``mode`` bilinear or nearest (half to even), ``padding_mode`` border or
    zeros."""
    H, W = img.shape[:2]
    flat = img.reshape(H * W, -1)
    x = _unnormalize(grid[..., 0], W, align_corners)
    y = _unnormalize(grid[..., 1], H, align_corners)
    border = padding_mode == "border"

    def at(yi, xi):
        valid = None if border else ((xi >= 0) & (xi <= W - 1)
                                     & (yi >= 0) & (yi <= H - 1))
        yi = torch.clamp(yi, 0, H - 1)
        xi = torch.clamp(xi, 0, W - 1)
        return _gather(flat, yi * W + xi, valid)

    if mode == "nearest":
        # torch.round rounds half to even, as F.grid_sample's nearbyint
        return at(torch.round(y).long(), torch.round(x).long())
    if mode != "bilinear":
        raise ValueError(f"unsupported mode {mode}")
    if border:
        x = torch.clamp(x, 0.0, W - 1.0)
        y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    top = at(y0i, x0i) * (1 - wx) + at(y0i, x0i + 1) * wx
    bot = at(y0i + 1, x0i) * (1 - wx) + at(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def grid_sample_3d(vol, grid, mode: str = "bilinear",
                   padding_mode: str = "border", align_corners: bool = False):
    """Sample ``vol [D, H, W, C]`` at ``grid [..., 3]`` (x indexes W, y H,
    z D) -> ``[..., C]``; trilinear only, border or zeros padding."""
    if mode != "bilinear":
        raise ValueError(f"unsupported mode {mode}")
    D, H, W = vol.shape[:3]
    flat = vol.reshape(D * H * W, -1)
    x = _unnormalize(grid[..., 0], W, align_corners)
    y = _unnormalize(grid[..., 1], H, align_corners)
    z = _unnormalize(grid[..., 2], D, align_corners)
    border = padding_mode == "border"
    if border:
        x = torch.clamp(x, 0.0, W - 1.0)
        y = torch.clamp(y, 0.0, H - 1.0)
        z = torch.clamp(z, 0.0, D - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    z0 = torch.floor(z)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    wz = (z - z0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    z0i = z0.long()

    def at(zi, yi, xi):
        valid = None if border else (
            (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            & (zi >= 0) & (zi <= D - 1))
        zi = torch.clamp(zi, 0, D - 1)
        yi = torch.clamp(yi, 0, H - 1)
        xi = torch.clamp(xi, 0, W - 1)
        return _gather(flat, (zi * H + yi) * W + xi, valid)

    def lerp_x(zi, yi):
        return at(zi, yi, x0i) * (1 - wx) + at(zi, yi, x0i + 1) * wx

    c0 = lerp_x(z0i, y0i) * (1 - wy) + lerp_x(z0i, y0i + 1) * wy
    c1 = lerp_x(z0i + 1, y0i) * (1 - wy) + lerp_x(z0i + 1, y0i + 1) * wy
    return c0 * (1 - wz) + c1 * wz
