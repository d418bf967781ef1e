"""Point featurization, per ray.

The NDC used for the cost-volume lookups is computed in the target view's
frame, so all samples of a ray share their xy and only z varies.  Per
ray: 4 bilinear-corner gathers of whole depth columns ``[D, C]`` and a
lerp along D per sample; the photometric confidence is one bilinear value
per ray.  Per point and source view: project, then bilinear-sample the
source image and its stage-3 features at the 4 border-clamped corners,
plus a strict in-bounds mask, in the reference's colours-block then
features-block channel layout.
"""

from __future__ import annotations

from typing import Dict

import torch

from ucnerf_torch.ops.ndc import project_to_pixel


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


def build_color_volume_fast(points, src_w2cs, src_intrinsics, views, img_hw):
    """Project points [N, S, 3] into every source view and sample the views
    [V-1, H, W, 3 + C_f] (unnormalized images with stage-3 features
    appended) bilinearly (align_corners=True, border), all views at once.
    Returns [N, S, (V-1)*4 + (V-1)*C_f]: the colours + strict in-bounds
    mask block, then the features block."""
    H, W = img_hw
    N, S = points.shape[:2]
    V1, c = views.shape[0], views.shape[-1]
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=points.device)
    pix = project_to_pixel(points.reshape(1, N * S, 3), src_w2cs,
                           src_intrinsics, inv_scale)        # [V-1, N*S, 3]
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
    data = top * (1 - wy) + bot * wy                           # [V-1, N*S, c]
    mask = ((g[..., 0] > -1.0) & (g[..., 0] < 1.0)
            & (g[..., 1] > -1.0) & (g[..., 1] < 1.0))
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
