"""Ray generation: the train step's 3-population ray mix and the eval rays.

Per train step, in this order:
  (a) ``patch_num//2`` patches of ``patch_size**2`` pixels, patch centres
      drawn without replacement in proportion to the MVS confidence,
  (b) as many drawn on (1 - confidence),
  (c) ``n_uniform`` uniformly random pixels,
  (d) the sparse-depth pixels, a fixed buffer with a validity mask.

Ray directions: ``dirs = [(x - cx)/fx, (y - cy)/fy, 1] @ c2w[:3,:3]^T``,
origin ``c2w[:3,3]``.  Pixel coordinates are stored (y, x).  Per ray, the
depth candidates come from the 3 cascade stages' per-pixel [near_k, far_k]
planes (``ops.sampling.stage_depth_candidates``).

The NDC reference view is the view the rays are cast from, so a point at
parameter t on the ray through pixel (x, y) projects back to (x, y) and its
camera z equals t: the per-stage NDC is written in closed form.

Every random draw comes in as a tensor (``TrainDraws``), so a test can feed
the JAX package's draws; ``draw_train_randomness`` makes them from one
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ucnerf_torch.ops.sampling import stage_depth_candidates


class TrainDraws(NamedTuple):
    """The random draws of one train-ray batch."""
    gumbel: torch.Tensor    # [2, H*W] Gumbel noise, one row per patch half
    shifts: torch.Tensor    # [2, 2, patch_num//2] int in [0, patch_size)
    xs: torch.Tensor        # [n_uniform] int in [0, W)
    ys: torch.Tensor        # [n_uniform] int in [0, H)
    jitter: torch.Tensor    # [N_rays, 3*(n_samples//3)] uniform [0, 1)


def draw_train_randomness(generator: torch.Generator, *, H: int, W: int,
                          patch_size: int, patch_num: int, n_uniform: int,
                          n_rays: int, n_samples: int) -> TrainDraws:
    """All draws of one train-ray batch from ``generator``, on its device.
    ``n_rays`` counts every ray of the batch, sparse-depth slots included."""
    dev = generator.device
    half = patch_num // 2
    u = torch.rand((2, H * W), generator=generator, device=dev)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return TrainDraws(
        gumbel=-torch.log(-torch.log(u)),
        shifts=torch.randint(0, patch_size, (2, 2, half), generator=generator,
                             device=dev),
        xs=torch.randint(0, W, (n_uniform,), generator=generator, device=dev),
        ys=torch.randint(0, H, (n_uniform,), generator=generator, device=dev),
        jitter=torch.rand((n_rays, 3 * (n_samples // 3)), generator=generator,
                          device=dev))


def gumbel_topk_sample(gumbel, weights, k: int):
    """k indices without replacement in proportion to ``weights`` (Gumbel
    top-k, the distribution of ``torch.multinomial(weights, k)``).  Zero
    weights are never picked unless fewer than k entries are positive."""
    logw = torch.where(weights > 0, torch.log(torch.clamp(weights, min=1e-30)),
                       torch.full_like(weights, -float("inf")))
    return torch.topk(logw + gumbel, k).indices


def ray_dirs_from_pixels(xs, ys, intrinsic, c2w):
    """Pixel coords -> world-space ray directions and origin."""
    dirs = torch.stack([(xs - intrinsic[0, 2]) / intrinsic[0, 0],
                        (ys - intrinsic[1, 2]) / intrinsic[1, 1],
                        torch.ones_like(xs)], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def _patch_pixels(gumbel, shifts, confidence, patch_size: int,
                  num_patches: int):
    """Confidence-guided patch pixel coords: a pixel drawn per patch, its
    patch cell (clamped to H//ps - 2), a shift inside the cell
    (``shifts`` [2, num_patches]), then a ps x ps block, row-major.
    Returns (ys, xs) each [num_patches * patch_size**2]."""
    H, W = confidence.shape
    ps = patch_size
    sel = gumbel_topk_sample(gumbel, confidence.reshape(-1), num_patches)
    xs_c = sel % W
    ys_c = torch.div(sel, W, rounding_mode="floor")
    pi = torch.clamp(torch.div(ys_c, ps, rounding_mode="floor"), 0,
                     H // ps - 2)
    pj = torch.clamp(torch.div(xs_c, ps, rounding_mode="floor"), 0,
                     W // ps - 2)
    row0 = pi * ps + shifts[0]
    col0 = pj * ps + shifts[1]
    rr = torch.arange(ps, device=confidence.device)
    ys = (row0[:, None, None] + rr[None, :, None]).expand(num_patches, ps, ps)
    xs = (col0[:, None, None] + rr[None, None, :]).expand(num_patches, ps, ps)
    return ys.reshape(-1), xs.reshape(-1)


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


def _assemble(ys, xs, *, H: int, W: int, intrinsic, c2w, near_ref, far_ref,
              stage_planes, n_samples: int, jitter_u=None):
    """Rays through the pixels (ys, xs) [N] (int64): origins, directions,
    depth candidates (jittered with ``jitter_u`` when given), world points
    and the closed-form per-stage NDC."""
    ysf = ys.to(torch.float32)
    xsf = xs.to(torch.float32)
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=ys.device)
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


def build_train_rays(draws: TrainDraws, *, image_tgt, confidence,
                     sparse_coords, sparse_mask, intrinsic, c2w, near_ref,
                     far_ref, stage_planes, patch_size: int, patch_num: int,
                     n_samples: int, jitter: bool = True):
    """The full train-ray batch.

    image_tgt [H, W, 3] un-normalized target image (the ray colours);
    confidence [H, W] MVS photometric confidence; sparse_coords
    [n_depth_rays, 2] int (y, x), padded; sparse_mask [n_depth_rays] float
    slot validity; stage_planes {k: (near_plane, far_plane)}.

    Rays are ordered [conf patches | (1-conf) patches | uniform |
    sparse-depth]; ``depth_ray_mask`` is 1 for the fixed rays and the
    sparse mask for the rest."""
    H, W = confidence.shape
    half = patch_num // 2
    ys_p1, xs_p1 = _patch_pixels(draws.gumbel[0], draws.shifts[0],
                                 confidence, patch_size, half)
    ys_p2, xs_p2 = _patch_pixels(draws.gumbel[1], draws.shifts[1],
                                 1.0 - confidence, patch_size, half)
    sparse_coords = sparse_coords.long()
    ys = torch.cat([ys_p1, ys_p2, draws.ys.long(), sparse_coords[:, 0]])
    xs = torch.cat([xs_p1, xs_p2, draws.xs.long(), sparse_coords[:, 1]])

    out = _assemble(ys, xs, H=H, W=W, intrinsic=intrinsic, c2w=c2w,
                    near_ref=near_ref, far_ref=far_ref,
                    stage_planes=stage_planes, n_samples=n_samples,
                    jitter_u=draws.jitter if jitter else None)
    out["colors"] = image_tgt[ys, xs]
    n_fixed = ys.shape[0] - sparse_mask.shape[0]
    out["depth_ray_mask"] = torch.cat([
        torch.ones((n_fixed,), dtype=torch.float32, device=ys.device),
        sparse_mask.to(torch.float32)])
    return out


def build_test_rays(pixel_idx, *, H: int, W: int, intrinsic, c2w,
                    near_ref, far_ref, stage_planes, n_samples: int,
                    jitter_u=None):
    """Raster-order eval rays for one chunk of flat pixel indices.

    ``jitter_u`` [N, 3*(n_samples//3)] uniform draws stratify the depth
    candidates; None gives deterministic midpoints."""
    ys = torch.div(pixel_idx, W, rounding_mode="floor")
    xs = pixel_idx % W
    return _assemble(ys, xs, H=H, W=W, intrinsic=intrinsic, c2w=c2w,
                     near_ref=near_ref, far_ref=far_ref,
                     stage_planes=stage_planes, n_samples=n_samples,
                     jitter_u=jitter_u)
