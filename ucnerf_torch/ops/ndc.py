"""World points -> reference-view pixel coordinates and per-stage NDC."""

from __future__ import annotations

import torch


def project_to_pixel(points, w2c, intrinsic, inv_scale, clamp_z: bool = True):
    """World points [..., P, 3] -> (x/(W-1), y/(H-1), z_cam) [..., P, 3].

    ``w2c`` [..., 4, 4] (None if the points are already in the camera
    frame), ``intrinsic`` [..., 3, 3], ``inv_scale`` [2] = (W-1, H-1); the
    cameras' leading dims broadcast against the points'.  |z_cam| < 1e-4
    is clamped to +1e-4.
    """
    if w2c is not None:
        points = (points @ w2c[..., :3, :3].transpose(-1, -2)
                  + w2c[..., None, :3, 3])
    if clamp_z:
        z = points[..., 2:]
        z = torch.where(torch.abs(z) < 1e-4, torch.full_like(z, 1e-4), z)
        points = torch.cat([points[..., :2], z], dim=-1)
    pix = points @ intrinsic.transpose(-1, -2)
    xy = pix[..., :2] / pix[..., 2:] / inv_scale
    return torch.cat([xy, pix[..., 2:]], dim=-1)


def world_to_ref_ndc(points, w2c, intrinsic, inv_scale, stage_near_far):
    """Per-stage NDC of world points [N, S, 3] in the reference view:
    {'stage1', 'stage2', 'stage3', 'ndc'} of [N, S, 3], xy from
    ``project_to_pixel`` and z normalized by each ray's stage range
    ('near_k' / 'far_k' [N, 1]) or by the scene's ('near' / 'far').  The
    rays' builders write this in closed form (``ops.rays``); this is the
    general projection, for points off the reference view's rays."""
    pix = project_to_pixel(points, w2c, intrinsic, inv_scale)
    xy, z = pix[..., :2], pix[..., 2:]
    out = {}
    for k in (1, 2, 3):
        near = stage_near_far[f"near_{k}"][..., None]
        far = stage_near_far[f"far_{k}"][..., None]
        out[f"stage{k}"] = torch.cat([xy, (z - near) / (far - near)], dim=-1)
    near, far = stage_near_far["near"], stage_near_far["far"]
    out["ndc"] = torch.cat([xy, (z - near) / (far - near)], dim=-1)
    return out
