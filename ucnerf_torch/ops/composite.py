"""Alpha compositing (volume integration).

Opacity is distance-free, ``alpha = 1 - exp(-sigma)``: ``depth2dist``'s
distances are computed but not used by the opacity, as in the reference.
Transmittance ``T = cumprod([1, 1-alpha+1e-10])[:-1]``.
"""

from __future__ import annotations

import torch


def depth2dist(z_vals, cos_angle):
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    tail = torch.full_like(dists[..., :1], 1e10)
    return torch.cat([dists, tail], dim=-1) * cos_angle[..., None]


def raw2alpha(sigma):
    """sigma [N_rays, N_samples] -> (alpha, weights)."""
    alpha = 1.0 - torch.exp(-sigma)
    ones = torch.ones_like(alpha[..., :1])
    t = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1),
                      dim=-1)[..., :-1]
    return alpha, alpha * t


def raw2outputs(raw, z_vals, white_bkgd: bool = False):
    """raw [N_rays, N_samples, 4] -> (rgb_map, depth_map, acc_map, weights)."""
    rgb = raw[..., :3]
    _, weights = raw2alpha(raw[..., 3])
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, depth_map, acc_map, weights
