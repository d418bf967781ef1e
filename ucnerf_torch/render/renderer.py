"""Volume rendering: point featurization + MLP query + compositing, and the
full-image render as a loop over fixed-size ray tiles."""

from __future__ import annotations

import torch

from ucnerf_torch.ops.composite import depth2dist, raw2outputs
from ucnerf_torch.render.fast_feats import gen_pts_feats_fast


def gen_dir_feature(w2c_ref, rays_dir_unit):
    """Rotate unit ray directions into the reference-camera frame."""
    return rays_dir_unit @ w2c_ref[:3, :3].T


def make_feat_ctx(mvs_out, confidence, imgs_src, src_w2cs, src_intrinsics):
    """Per-frame featurization context, built once and reused across ray
    tiles: the stage cost volumes and the source views with their stage-3
    features appended ([V-1, H, W, 3 + 8])."""
    H, W = imgs_src.shape[1:3]
    return dict(
        stage_volumes={k: mvs_out[f"stage{k}"]["volume_feature"]
                       for k in (1, 2, 3)},
        views=torch.cat([imgs_src, mvs_out["img_feats"]], dim=-1),
        confidence=confidence, src_w2cs=src_w2cs,
        src_intrinsics=src_intrinsics, img_hw=(H, W))


def render_rays(nerf_apply, rays, feat_ctx, w2c_ref,
                white_bkgd: bool = False):
    """Render one batch of rays -> (rgb [N, 3], depth [N]).

    ``nerf_apply(pts, dirs, feats)`` -> raw [N, S, 4]; ``feat_ctx`` from
    ``make_feat_ctx`` (source-view poses only: the target view is not a
    colour source)."""
    cos_angle = torch.linalg.norm(rays["rays_d"], dim=-1)
    dirs = gen_dir_feature(w2c_ref, rays["rays_d"] / cos_angle[..., None])
    ctx = feat_ctx
    input_feat = gen_pts_feats_fast(rays, ctx["stage_volumes"],
                                    ctx["confidence"], ctx["views"],
                                    ctx["src_w2cs"], ctx["src_intrinsics"],
                                    ctx["img_hw"])
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
