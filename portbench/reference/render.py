"""Frozen copy of the port's rays, featurization and compositing.

Copied from ``ucnerf_torch`` (``ops/sampling.py``, ``ops/ndc.py``,
``ops/rays.py``, ``render/fast_feats.py``, ``ops/composite.py`` and the
renderer's ``render_rays``), without the options the benchmark's cells do
not turn on (colour volumes, the literal featurization, white
background).  ``draws`` are the benchmark's own: any object with the
fields ``gumbel [2, H*W]``, ``shifts [2, 2, patch_num//2]``, ``xs``,
``ys [n_uniform]`` and ``jitter [N_rays, 3*(S//3)]``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# ---- depth candidates

def sample_points_uniform(near, far, num_samples: int):
    """near/far [..., 1] -> [..., num_samples] linearly spaced depths."""
    t = torch.linspace(0.0, 1.0, num_samples, dtype=near.dtype,
                       device=near.device)
    return near * (1.0 - t) + far * t


def stratified_jitter(depth_sorted, u):
    """Jitter sorted depths within their midpoint intervals; ``u`` holds
    uniform [0, 1) draws of ``depth_sorted``'s shape."""
    mids = 0.5 * (depth_sorted[..., 1:] + depth_sorted[..., :-1])
    upper = torch.cat([mids, depth_sorted[..., -1:]], dim=-1)
    lower = torch.cat([depth_sorted[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def stage_depth_candidates(stage_near_far, n_samples: int, jitter_u=None):
    """stage_near_far: dict with 'near_k'/'far_k' [N_rays, 1], k in 1..3.
    Returns [N_rays, 3 * (n_samples // 3)] sorted depths, jittered with
    ``jitter_u`` when it is given."""
    avg = n_samples // 3
    per_stage = [sample_points_uniform(stage_near_far[f"near_{k}"],
                                       stage_near_far[f"far_{k}"], avg)
                 for k in (1, 2, 3)]
    depth = torch.sort(torch.cat(per_stage, dim=-1), dim=-1).values
    if jitter_u is not None:
        depth = stratified_jitter(depth, jitter_u)
    return depth


# ---- projection

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


# ---- rays

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


def train_pixels(draws, confidence, sparse_coords, patch_size: int,
                 patch_num: int):
    """(ys, xs) of the train-ray batch: [conf patches | (1-conf) patches |
    uniform | sparse-depth]."""
    half = patch_num // 2
    ys_p1, xs_p1 = _patch_pixels(draws.gumbel[0], draws.shifts[0],
                                 confidence, patch_size, half)
    ys_p2, xs_p2 = _patch_pixels(draws.gumbel[1], draws.shifts[1],
                                 1.0 - confidence, patch_size, half)
    sparse_coords = sparse_coords.long()
    return (torch.cat([ys_p1, ys_p2, draws.ys.long(), sparse_coords[:, 0]]),
            torch.cat([xs_p1, xs_p2, draws.xs.long(), sparse_coords[:, 1]]))


def _cell_best(scores, H: int, W: int, ps: int):
    """Per patch cell (the clamped cell of ``_patch_pixels``) the best
    score of a pixel that maps to it; cells numbered row-major over
    (H//ps - 1) x (W//ps - 1)."""
    ncol = W // ps - 1
    pix = torch.arange(H * W, device=scores.device)
    pi = torch.clamp(torch.div(pix // W, ps, rounding_mode="floor"), 0,
                     H // ps - 2)
    pj = torch.clamp(torch.div(pix % W, ps, rounding_mode="floor"), 0,
                     W // ps - 2)
    best = torch.full(((H // ps - 1) * ncol,), -float("inf"),
                      device=scores.device)
    return best.scatter_reduce(0, pi * ncol + pj, scores, "amax"), ncol


def draw_gap(draws, confidence, sparse_coords, pixels, patch_size: int,
             patch_num: int) -> float:
    """How far the pixels (ys, xs) of a train batch lie from a draw out of
    ``confidence``: each patch's cell is scored by the best Gumbel score
    (log weight + ``draws.gumbel``) of a pixel in it, and the gap is the
    largest shortfall of a drawn cell below the score that the last of the
    top ``patch_num // 2`` reaches.  A sound draw from a confidence a
    rounding away reads that rounding in log-confidence; a draw that
    ignores the confidence reads several units.  Patches not laid out as
    ``_patch_pixels`` lays them, and uniform or sparse-depth rays not at
    the drawn pixels, read infinite."""
    H, W = confidence.shape
    ps, half = patch_size, patch_num // 2
    ys, xs = (p.long() for p in pixels)
    rr = torch.arange(ps, device=ys.device)
    gap = 0.0
    for part, weights in enumerate((confidence, 1.0 - confidence)):
        w = weights.reshape(-1)
        logw = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-30)),
                           torch.full_like(w, -float("inf")))
        scores = logw + draws.gumbel[part]
        kth = torch.topk(scores, half).values[-1]
        best, ncol = _cell_best(scores, H, W, ps)
        sl = slice(part * half * ps * ps, (part + 1) * half * ps * ps)
        by = ys[sl].reshape(half, ps, ps)
        bx = xs[sl].reshape(half, ps, ps)
        row0, col0 = by[:, 0, 0], bx[:, 0, 0]
        di, dj = row0 - draws.shifts[part][0], col0 - draws.shifts[part][1]
        pi = torch.div(di, ps, rounding_mode="floor")
        pj = torch.div(dj, ps, rounding_mode="floor")
        laid_out = (
            (by == row0[:, None, None] + rr[None, :, None]).all()
            & (bx == col0[:, None, None] + rr[None, None, :]).all()
            & (di % ps == 0).all() & (dj % ps == 0).all()
            & (pi >= 0).all() & (pi <= H // ps - 2).all()
            & (pj >= 0).all() & (pj <= W // ps - 2).all())
        if not bool(laid_out):
            return math.inf
        short = kth - best[pi * ncol + pj]
        gap = max(gap, float(torch.clamp(short, min=0.0).max()))
    n_patch = patch_num * ps * ps
    n_uni = draws.ys.shape[0]
    rest_y = torch.cat([draws.ys.long(), sparse_coords[:, 0].long()])
    rest_x = torch.cat([draws.xs.long(), sparse_coords[:, 1].long()])
    if (ys.shape[0] != n_patch + n_uni + sparse_coords.shape[0]
            or not bool((ys[n_patch:] == rest_y).all())
            or not bool((xs[n_patch:] == rest_x).all())):
        return math.inf
    return gap


def build_train_rays(draws, *, image_tgt, confidence,
                     sparse_coords, sparse_mask, intrinsic, c2w, near_ref,
                     far_ref, stage_planes, patch_size: int, patch_num: int,
                     n_samples: int, jitter: bool = True, pixels=None):
    """The full train-ray batch through ``pixels`` (ys, xs), or through
    the pixels ``train_pixels`` draws when it is None.

    image_tgt [H, W, 3] un-normalized target image (the ray colours);
    confidence [H, W] MVS photometric confidence; sparse_coords
    [n_depth_rays, 2] int (y, x), padded; sparse_mask [n_depth_rays] float
    slot validity; stage_planes {k: (near_plane, far_plane)}.
    ``depth_ray_mask`` is 1 for the fixed rays and the sparse mask for
    the rest."""
    H, W = confidence.shape
    ys, xs = pixels if pixels is not None else train_pixels(
        draws, confidence, sparse_coords, patch_size, patch_num)
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


# ---- featurization

def _corner_ids_weights(x01, y01, h: int, w: int):
    """align_corners=False border-clamped bilinear corners.
    x01/y01 [N] in [0, 1] -> (idx [N, 4] flat h*w ids, wgt [N, 4])."""
    ix = torch.clamp(x01 * w - 0.5, 0.0, w - 1.0)
    iy = torch.clamp(y01 * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = ix - x0
    wy = iy - y0
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    idx = torch.stack([y0i * w + x0i, y0i * w + x1i,
                       y1i * w + x0i, y1i * w + x1i], dim=-1)
    wgt = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy),
                       (1 - wx) * wy, wx * wy], dim=-1)
    return idx, wgt


def sample_volume_per_ray(vol_cols, z01, idx, wgt):
    """vol_cols [h*w, D, C]; z01 [N, S]; idx/wgt [N, 4] -> [N, S, C]."""
    D, C = vol_cols.shape[1:]
    zc = torch.clamp(z01 * D - 0.5, 0.0, D - 1.0)
    z0 = torch.floor(zc)
    wz = (zc - z0)[..., None]                       # [N, S, 1]
    z0i = z0.long()
    z1i = torch.clamp(z0i + 1, max=D - 1)
    cols = 0.0
    for c in range(4):
        cols = cols + wgt[:, c, None, None] * vol_cols[idx[:, c]]  # [N, D, C]
    a = torch.gather(cols, 1, z0i[..., None].expand(-1, -1, C))
    b = torch.gather(cols, 1, z1i[..., None].expand(-1, -1, C))
    return a * (1 - wz) + b * wz


def index_point_feature_fast(stage_volumes: Dict, confidence, rays):
    """stage_volumes {k: [D_k, h_k, w_k, C]}; confidence [H, W]; rays with
    'pixel_coords' [N, 2] (y, x) and per-stage NDC.
    Returns (ray_feats [N, S, 3C], conf [N, S])."""
    ys = rays["pixel_coords"][:, 0].to(torch.float32)
    xs = rays["pixel_coords"][:, 1].to(torch.float32)
    H, W = confidence.shape
    x01 = xs / (W - 1)
    y01 = ys / (H - 1)

    feats = []
    for k in (1, 2, 3):
        vol = stage_volumes[k]
        D, h, w, C = vol.shape
        idx, wgt = _corner_ids_weights(x01, y01, h, w)
        vol_cols = vol.permute(1, 2, 0, 3).reshape(h * w, D, C)
        z01 = rays["ndc"][f"stage{k}"][..., 2]
        feats.append(sample_volume_per_ray(vol_cols, z01, idx, wgt))
    ray_feats = torch.cat(feats, dim=-1)

    idx, wgt = _corner_ids_weights(x01, y01, H, W)
    conf_ray = torch.sum(confidence.reshape(-1)[idx] * wgt, dim=-1)
    conf = conf_ray[:, None].expand(-1, ray_feats.shape[1])
    return ray_feats, conf


def _sample_views(points, src_w2cs, src_intrinsics, views, img_hw):
    """Project points [P, 3] into every view of ``views`` [V, H, W, c]
    (cameras [V, 4, 4], [V, 3, 3]) and sample it bilinearly
    (align_corners=True, border).  Returns (data [V, P, c], strict
    in-bounds mask [V, P])."""
    H, W = img_hw
    V1, c = views.shape[0], views.shape[-1]
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=points.device)
    pix = project_to_pixel(points[None], src_w2cs, src_intrinsics,
                           inv_scale)                        # [V, P, 3]
    g = pix[..., :2] * 2.0 - 1.0
    ix = torch.clamp((g[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1.0)
    iy = torch.clamp((g[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1.0)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = (ix - x0)[..., None]
    wy = (iy - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    row0 = (torch.arange(V1, device=points.device)[:, None] * H + y0i) * W
    row1 = row0 + (y1i - y0i) * W
    flat = views.reshape(V1 * H * W, c)
    top = flat[row0 + x0i] * (1 - wx) + flat[row0 + x1i] * wx
    bot = flat[row1 + x0i] * (1 - wx) + flat[row1 + x1i] * wx
    data = top * (1 - wy) + bot * wy                           # [V, P, c]
    mask = ((g[..., 0] > -1.0) & (g[..., 0] < 1.0)
            & (g[..., 1] > -1.0) & (g[..., 1] < 1.0))
    return data, mask


def build_color_volume_fast(points, src_w2cs, src_intrinsics, views, img_hw):
    """Project points [N, S, 3] into every source view and sample the views
    [V-1, H, W, 3 + C_f] (unnormalized images with stage-3 features
    appended) bilinearly (align_corners=True, border), all views at once.
    Returns [N, S, (V-1)*4 + (V-1)*C_f]: the colours + strict in-bounds
    mask block, then the features block."""
    N, S = points.shape[:2]
    V1, c = views.shape[0], views.shape[-1]
    data, mask = _sample_views(points.reshape(N * S, 3), src_w2cs,
                               src_intrinsics, views, img_hw)
    colors = torch.cat([data[..., :3], mask[..., None].to(data.dtype)], -1)
    colors = colors.permute(1, 0, 2).reshape(N, S, V1 * 4)
    feats = data[..., 3:].permute(1, 0, 2).reshape(N, S, V1 * (c - 3))
    return torch.cat([colors, feats], dim=-1)


def gen_pts_feats_fast(rays, stage_volumes, confidence, views, src_w2cs,
                       src_intrinsics, img_hw):
    """The [N, S, feat_dim] conditioning tensor:
    [cost features 24 | colours+mask | image features | confidence]."""
    ray_feats, conf = index_point_feature_fast(stage_volumes, confidence,
                                               rays)
    color_feats = build_color_volume_fast(rays["points_world"], src_w2cs,
                                          src_intrinsics, views, img_hw)
    return torch.cat([ray_feats, color_feats, conf[..., None]], dim=-1)


# ---- compositing

def raw2alpha(sigma):
    """sigma [N_rays, N_samples] -> (alpha, weights)."""
    alpha = 1.0 - torch.exp(-sigma)
    ones = torch.ones_like(alpha[..., :1])
    t = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1),
                      dim=-1)[..., :-1]
    return alpha, alpha * t


def raw2outputs(raw, z_vals):
    """raw [N_rays, N_samples, 4] -> (rgb_map, depth_map, acc_map, weights)."""
    rgb = raw[..., :3]
    _, weights = raw2alpha(raw[..., 3])
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    return rgb_map, depth_map, acc_map, weights


def gen_dir_feature(w2c_ref, rays_dir_unit):
    """Rotate unit ray directions into the reference-camera frame."""
    return rays_dir_unit @ w2c_ref[:3, :3].T


def make_feat_ctx(mvs_out, confidence, imgs_src, src_w2cs, src_intrinsics):
    """The stage cost volumes and the source views with their stage-3
    features appended ([V-1, H, W, 3 + 8])."""
    H, W = imgs_src.shape[1:3]
    return dict(
        stage_volumes={k: mvs_out[f"stage{k}"]["volume_feature"]
                       for k in (1, 2, 3)},
        views=torch.cat([imgs_src, mvs_out["img_feats"]], dim=-1),
        confidence=confidence, src_w2cs=src_w2cs,
        src_intrinsics=src_intrinsics, img_hw=(H, W))


def render_rays(nerf_apply, rays, ctx, w2c_ref):
    """One batch of rays -> (rgb [N, 3], depth [N])."""
    cos_angle = torch.linalg.norm(rays["rays_d"], dim=-1)
    dirs = gen_dir_feature(w2c_ref, rays["rays_d"] / cos_angle[..., None])
    input_feat = gen_pts_feats_fast(
        rays, ctx["stage_volumes"], ctx["confidence"], ctx["views"],
        ctx["src_w2cs"], ctx["src_intrinsics"], ctx["img_hw"])
    raw = nerf_apply(rays["ndc"]["ndc"], dirs, input_feat)
    rgb_map, depth_map, _, _ = raw2outputs(raw, rays["depth_candidates"])
    return rgb_map, depth_map
