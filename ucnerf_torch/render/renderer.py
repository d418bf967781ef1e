"""Volume rendering: point featurization + MLP query + compositing, and the
full-image render as a loop over fixed-size ray tiles.

Two featurizations give the MLP's [N, S, 24 + 12(V-1) + 1] input: the
per-ray one of ``render.fast_feats`` (the default) and, for
``fast_featurization`` false, the literal reference formulation below,
which samples every point on its own: a trilinear lookup of each stage's
cost volume at the point's NDC and a bilinear lookup of each source view
at its reprojection.  The two agree up to the round-off of the
reprojection.
"""

from __future__ import annotations

import torch

from ucnerf_torch.ops.composite import depth2dist, raw2outputs
from ucnerf_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d
from ucnerf_torch.ops.ndc import project_to_pixel
from ucnerf_torch.render.fast_feats import (build_color_volumes,
                                            gen_pts_feats_fast)


def gen_dir_feature(w2c_ref, rays_dir_unit):
    """Rotate unit ray directions into the reference-camera frame."""
    return rays_dir_unit @ w2c_ref[:3, :3].T


def index_point_feature(stage_volumes, confidence, ndc):
    """Trilinear lookup of the 3 cost volumes {k: [D, h, w, 8]} at each
    stage's NDC [N, S, 3] (border, align_corners False), and the
    confidence [H, W] bilinearly at the stage-3 xy.
    Returns (ray_feats [N, S, 24], conf [N, S])."""
    feats = [grid_sample_3d(stage_volumes[k], ndc[f"stage{k}"] * 2.0 - 1.0)
             for k in (1, 2, 3)]
    conf = grid_sample_2d(confidence[..., None],
                          ndc["stage3"][..., :2] * 2.0 - 1.0)[..., 0]
    return torch.cat(feats, dim=-1), conf


def build_color_volume(points, src_w2cs, src_intrinsics, views):
    """Reproject points [N, S, 3] into each source view and sample the
    view [H, W, 3 + C_f] (the unnormalized image with its stage-3 features
    appended) bilinearly (border, align_corners True), plus a strict
    in-bounds mask.  Returns [N, S, (V-1)*4 + (V-1)*C_f]: the colours +
    mask block, then the features block."""
    H, W = views.shape[1:3]
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=points.device)
    colors, feats = [], []
    for w2c, K, view in zip(src_w2cs, src_intrinsics, views):
        grid = project_to_pixel(points, w2c, K, inv_scale)[..., :2] * 2 - 1
        data = grid_sample_2d(view, grid, align_corners=True)
        mask = ((grid[..., 0] > -1.0) & (grid[..., 0] < 1.0)
                & (grid[..., 1] > -1.0) & (grid[..., 1] < 1.0))
        colors.append(torch.cat([data[..., :3], mask[..., None].to(
            data.dtype)], dim=-1))
        feats.append(data[..., 3:])
    return torch.cat(colors + feats, dim=-1)


def gen_pts_feats(rays, feat_ctx):
    """The literal featurization of ``rays`` over a ``make_feat_ctx``:
    [cost features 24 | colours+mask | image features | confidence]."""
    ray_feats, conf = index_point_feature(feat_ctx["stage_volumes"],
                                          feat_ctx["confidence"],
                                          rays["ndc"])
    color_feats = build_color_volume(rays["points_world"],
                                     feat_ctx["src_w2cs"],
                                     feat_ctx["src_intrinsics"],
                                     feat_ctx["views"])
    return torch.cat([ray_feats, color_feats, conf[..., None]], dim=-1)


def make_feat_ctx(mvs_out, confidence, imgs_src, src_w2cs, src_intrinsics,
                  color_volume=None):
    """Per-frame featurization context, built once and reused across ray
    tiles: the stage cost volumes and the source views with their stage-3
    features appended ([V-1, H, W, 3 + 8]).

    ``color_volume``: optional (c2w_tgt, K_tgt, near, far, n_depths), the
    ``--use_color_volume`` option: every source view sampled once at
    ``n_depths`` planes of every target pixel (``build_color_volumes``),
    so that the fast featurization reads one column per (ray, view)."""
    H, W = imgs_src.shape[1:3]
    ctx = dict(
        stage_volumes={k: mvs_out[f"stage{k}"]["volume_feature"]
                       for k in (1, 2, 3)},
        views=torch.cat([imgs_src, mvs_out["img_feats"]], dim=-1),
        confidence=confidence, src_w2cs=src_w2cs,
        src_intrinsics=src_intrinsics, img_hw=(H, W),
        color_volumes=None, near=None, far=None)
    if color_volume is not None:
        c2w_tgt, k_tgt, near, far, n_depths = color_volume
        ctx["color_volumes"] = build_color_volumes(
            ctx["views"], src_w2cs, src_intrinsics, c2w_tgt, k_tgt, near,
            far, n_depths)
        ctx["near"], ctx["far"] = near, far
    return ctx


def render_rays(nerf_apply, rays, feat_ctx, w2c_ref,
                white_bkgd: bool = False, fast: bool = True):
    """Render one batch of rays -> (rgb [N, 3], depth [N]).

    ``nerf_apply(pts, dirs, feats)`` -> raw [N, S, 4]; ``feat_ctx`` from
    ``make_feat_ctx`` (source-view poses only: the target view is not a
    colour source).  ``fast`` picks the per-ray featurization (with the
    context's colour volumes when it has them), else the literal one."""
    cos_angle = torch.linalg.norm(rays["rays_d"], dim=-1)
    dirs = gen_dir_feature(w2c_ref, rays["rays_d"] / cos_angle[..., None])
    ctx = feat_ctx
    if fast:
        input_feat = gen_pts_feats_fast(
            rays, ctx["stage_volumes"], ctx["confidence"], ctx["views"],
            ctx["src_w2cs"], ctx["src_intrinsics"], ctx["img_hw"],
            color_volumes=ctx["color_volumes"], near=ctx["near"],
            far=ctx["far"])
    else:
        input_feat = gen_pts_feats(rays, ctx)
    raw = nerf_apply(rays["ndc"]["ndc"], dirs, input_feat)
    # dists are computed for parity; the opacity ignores them
    _ = depth2dist(rays["depth_candidates"], cos_angle)
    rgb_map, depth_map, _, _ = raw2outputs(raw, rays["depth_candidates"],
                                           white_bkgd)
    return rgb_map, depth_map


def render_image_chunked(build_chunk_rays, render_chunk, H: int, W: int,
                         chunk: int, device):
    """Full-image render as a loop over ``chunk``-ray pixel tiles.

    ``build_chunk_rays(pixel_idx)`` -> rays; ``render_chunk(rays)`` ->
    (rgb, depth).  The pixel count is padded up to a tile multiple by
    wrapping (``% n``) and cropped after."""
    n = H * W
    n_tiles = (n + chunk - 1) // chunk
    idx = torch.arange(n_tiles * chunk, device=device) % n
    rgbs, depths = [], []
    for pix in idx.reshape(-1, chunk):
        rgb, depth = render_chunk(build_chunk_rays(pix))
        rgbs.append(rgb)
        depths.append(depth)
    rgb = torch.cat(rgbs)[:n].reshape(H, W, 3)
    depth = torch.cat(depths)[:n].reshape(H, W)
    return rgb, depth
