"""Eval ray generation (raster order, per chunk of flat pixel indices).

Ray directions: ``dirs = [(x - cx)/fx, (y - cy)/fy, 1] @ c2w[:3,:3]^T``,
origin ``c2w[:3,3]``.  Pixel coordinates are stored (y, x).  Per ray, the
depth candidates come from the 3 cascade stages' per-pixel [near_k, far_k]
planes (``ops.sampling.stage_depth_candidates``).

The NDC reference view is the view the rays are cast from, so a point at
parameter t on the ray through pixel (x, y) projects back to (x, y) and its
camera z equals t: the per-stage NDC is written in closed form.
"""

from __future__ import annotations

import torch

from ucnerf_torch.ops.sampling import stage_depth_candidates


def ray_dirs_from_pixels(xs, ys, intrinsic, c2w):
    """Pixel coords -> world-space ray directions and origin."""
    dirs = torch.stack([(xs - intrinsic[0, 2]) / intrinsic[0, 0],
                        (ys - intrinsic[1, 2]) / intrinsic[1, 1],
                        torch.ones_like(xs)], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def _stage_near_far(stage_planes, ys, xs, near_ref, far_ref):
    """Per-ray [near_k, far_k] from each stage's first/last depth plane
    (pixel coords integer-divided by the stage scale 4/2/1)."""
    out = {"near": near_ref, "far": far_ref}
    for k, scale in ((1, 4), (2, 2), (3, 1)):
        near_p, far_p = stage_planes[k]
        yy = torch.div(ys, scale, rounding_mode="floor")
        xx = torch.div(xs, scale, rounding_mode="floor")
        out[f"near_{k}"] = near_p[yy, xx][:, None]
        out[f"far_{k}"] = far_p[yy, xx][:, None]
    return out


def build_test_rays(pixel_idx, *, H: int, W: int, intrinsic, c2w,
                    near_ref, far_ref, stage_planes, n_samples: int,
                    jitter_u=None):
    """Raster-order eval rays for one chunk of flat pixel indices.

    ``jitter_u`` [N, 3*(n_samples//3)] uniform draws stratify the depth
    candidates; None gives deterministic midpoints."""
    ys = torch.div(pixel_idx, W, rounding_mode="floor")
    xs = pixel_idx % W
    ysf = ys.to(torch.float32)
    xsf = xs.to(torch.float32)
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=pixel_idx.device)
    rays_o, rays_d = ray_dirs_from_pixels(xsf, ysf, intrinsic, c2w)
    nf = _stage_near_far(stage_planes, ys, xs, near_ref, far_ref)
    depth = stage_depth_candidates(nf, n_samples, jitter_u)
    points = rays_o[:, None, :] + depth[..., None] * rays_d[:, None, :]

    S = depth.shape[-1]
    xy = (torch.stack([xsf, ysf], dim=-1) / inv_scale)[:, None, :].expand(
        depth.shape[0], S, 2)
    ndc = {}
    for k in (1, 2, 3):
        zk = ((depth - nf[f"near_{k}"])
              / (nf[f"far_{k}"] - nf[f"near_{k}"]))[..., None]
        ndc[f"stage{k}"] = torch.cat([xy, zk], dim=-1)
    z = ((depth - near_ref) / (far_ref - near_ref))[..., None]
    ndc["ndc"] = torch.cat([xy, z], dim=-1)
    return dict(rays_o=rays_o, rays_d=rays_d,
                pixel_coords=torch.stack([ys, xs], dim=-1),
                depth_candidates=depth, points_world=points, ndc=ndc,
                stage_near_far=nf)
