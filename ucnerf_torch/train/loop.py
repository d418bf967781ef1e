"""The eval render of the train loop: one cascade forward per view, then a
loop over ray tiles.  The train step joins these functions later.

``nerf`` is a callable ``(pts [N,S,3], dirs [N,3], feats [N,S,F]) -> raw
[N,S,4]``: the fused kernel's wrapper (``kernels.fused_mlp.FusedNeRFMLP``)
on the card, or the plain ``models.nerf.UCNeRFMLP``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ucnerf_torch.config import Config
from ucnerf_torch.data.base import IMAGENET_MEAN, IMAGENET_STD
from ucnerf_torch.ops.rays import build_test_rays
from ucnerf_torch.render.renderer import (make_feat_ctx, render_image_chunked,
                                          render_rays)


def unnormalize(images):
    """Undo ImageNet normalization; images [..., 3] channel-last."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return images * std + mean


def _stage_planes(mvs_out, pad: int):
    """Per-stage (near, far) depth planes for ray building; the padded
    stage-3 planes are cropped so pixel coordinates line up."""
    planes = {}
    for k in (1, 2, 3):
        dv = mvs_out[f"stage{k}"]["depth_values"]
        near_p, far_p = dv[0], dv[-1]
        if k == 3 and pad > 0:
            near_p = near_p[pad:-pad, pad:-pad]
            far_p = far_p[pad:-pad, pad:-pad]
        planes[k] = (near_p, far_p)
    return planes


def prepare_view_ctx(cfg: Config, mvs, batch, mvs_apply=None) -> Dict:
    """Per-view render context: cascade forward + featurization inputs.
    ``mvs_apply(imgs_src, affine_mat, affine_mat_inv, near, far, pad)``
    overrides the cascade forward (serving reuses cached features)."""
    if cfg.use_color_volume:
        raise NotImplementedError("--use_color_volume is not ported yet")
    imgs_norm = batch["images"]
    imgs = unnormalize(imgs_norm)
    near, far = batch["near_fars"][0, 0], batch["near_fars"][0, 1]
    run = mvs if mvs_apply is None else mvs_apply
    mvs_out = run(imgs_norm[1:], batch["affine_mat"],
                  batch["affine_mat_inv"], near, far, cfg.pad)
    confidence = mvs_out["stage3"]["photometric_confidence"]
    feat_ctx = make_feat_ctx(mvs_out, confidence, imgs[1:],
                             batch["w2cs"][1:], batch["intrinsics"][1:])
    return dict(mvs_out=mvs_out, confidence=confidence,
                w2cs=batch["w2cs"], intrinsics=batch["intrinsics"],
                c2w_tgt=batch["c2ws"][0], near=near, far=far,
                feat_ctx=feat_ctx)


def view_chunk_fns(cfg: Config, nerf, H: int, W: int, ctx: Dict):
    """(build_chunk, render_chunk) closures over a ``prepare_view_ctx``."""
    planes = _stage_planes(ctx["mvs_out"], cfg.pad)
    gen = ctx.get("jitter_generator")      # set iff cfg.eval_jitter
    n_cand = 3 * (cfg.N_samples // 3)

    def build_chunk(pix):
        u = (None if gen is None else
             torch.rand((pix.shape[0], n_cand), generator=gen,
                        device=pix.device))
        return build_test_rays(
            pix, H=H, W=W, intrinsic=ctx["intrinsics"][0],
            c2w=ctx["c2w_tgt"], near_ref=ctx["near"], far_ref=ctx["far"],
            stage_planes=planes, n_samples=cfg.N_samples, jitter_u=u)

    def render_chunk(rays):
        return render_rays(nerf, rays, ctx["feat_ctx"], ctx["w2cs"][0],
                           white_bkgd=cfg.white_bkgd)

    return build_chunk, render_chunk


def make_eval_render(cfg: Config, nerf, mvs, img_hw: Tuple[int, int],
                     mvs_apply=None):
    """Full-image eval render: ``render_view(batch)`` -> (rgb [H,W,3]
    clipped to [0,1], depth [H,W], confidence [H,W])."""
    H, W = img_hw

    @torch.no_grad()
    def render_view(batch):
        ctx = prepare_view_ctx(cfg, mvs, batch, mvs_apply=mvs_apply)
        if cfg.eval_jitter:
            gen = torch.Generator(device=batch["images"].device)
            gen.manual_seed(0)
            ctx["jitter_generator"] = gen
        build_chunk, render_chunk = view_chunk_fns(cfg, nerf, H, W, ctx)
        rgb, depth = render_image_chunked(build_chunk, render_chunk, H, W,
                                          cfg.chunk, batch["images"].device)
        return torch.clamp(rgb, 0.0, 1.0), depth, ctx["confidence"]

    return render_view
