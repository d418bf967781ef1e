"""The train step and the eval render.

Train step: cascade forward -> train-ray build -> render -> 5-term loss ->
autograd -> Adam with the configured LR schedule.  The MLP of the train
step is the plain ``models.nerf.UCNeRFMLP``: the fused kernel has no
backward.  ``--finetune`` freezes the cascade: its forward runs under
``torch.no_grad()`` and its parameters stay out of the optimizer.

Eval render: one cascade forward per view, then a loop over ray tiles.
``nerf`` there is a callable ``(pts [N,S,3], dirs [N,3], feats [N,S,F]) ->
raw [N,S,4]``: the fused kernel's wrapper (``kernels.fused_mlp.
FusedNeRFMLP``) on the card, or the plain ``UCNeRFMLP``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ucnerf_torch.config import Config
from ucnerf_torch.data.base import IMAGENET_MEAN, IMAGENET_STD
from ucnerf_torch.ops.rays import TrainDraws, build_test_rays, build_train_rays
from ucnerf_torch.render.renderer import (make_feat_ctx, render_image_chunked,
                                          render_rays)
from ucnerf_torch.train.losses import cas_mvsnet_loss, total_loss


def objective(cfg: Config) -> str:
    """The run's training objective: ``mvs_only`` | ``full`` | ``finetune``."""
    if cfg.mvs_only:
        return "mvs_only"
    return "full" if cfg.finetune is None else "finetune"


@dataclasses.dataclass
class TrainState:
    nerf: torch.nn.Module
    mvs: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    objective: str = "full"
    appearance: Optional[torch.nn.Parameter] = None   # --encode_a


def cosine_epoch_schedule(lrate: float, num_epochs: int,
                          steps_per_epoch: int, eta_min: float = 1e-7):
    """torch CosineAnnealingLR(T_max=num_epochs) stepped once per epoch."""
    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, num_epochs)
        return eta_min + (lrate - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * epoch / num_epochs))
    return schedule


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable:
    """--lr_scheduler: the LR as a function of the count of updates made.
    - cosine: CosineAnnealingLR(T_max=num_epochs), per epoch.
    - steplr: lr * gamma^(milestones passed), milestones = --decay_step
      in global steps, gamma = --decay_gamma.
    - poly:   lr * (1 - epoch/num_epochs)^0.9."""
    if cfg.lr_scheduler == "cosine":
        return cosine_epoch_schedule(cfg.lrate, cfg.num_epochs,
                                     steps_per_epoch)
    if cfg.lr_scheduler == "steplr":
        def steplr(step: int) -> float:
            n = sum(step >= m for m in cfg.decay_step)
            return cfg.lrate * cfg.decay_gamma ** n
        return steplr
    if cfg.lr_scheduler == "poly":
        total = cfg.num_epochs

        def poly(step: int) -> float:
            epoch = min(step // steps_per_epoch, total)
            return cfg.lrate * (1.0 - epoch / total) ** 0.9
        return poly
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")


def make_optimizer(cfg: Config, nerf, mvs,
                   appearance=None) -> torch.optim.Optimizer:
    """Adam, betas (0.9, 0.999), eps 1e-8, over the NeRF MLP, the cascade
    (unless ``--finetune`` freezes it) and ``--encode_a``'s appearance
    table (which no render reads: its gradient is zero, so Adam leaves it
    as it is).  The train step sets the LR from the schedule before each
    update."""
    params = list(nerf.parameters())
    if cfg.finetune is None:
        params += list(mvs.parameters())
    if appearance is not None:
        params.append(appearance)
    return torch.optim.Adam(params, lr=cfg.lrate, betas=(0.9, 0.999),
                            eps=1e-8)


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


def run_mvs(cfg: Config, mvs, batch):
    """The cascade forward of a batch (``mvs`` the module or a stand-in
    with its signature)."""
    imgs_norm = batch["images"]
    near, far = batch["near_fars"][0, 0], batch["near_fars"][0, 1]
    return mvs(imgs_norm[1:], batch["affine_mat"], batch["affine_mat_inv"],
               near, far, cfg.pad)


def scene_inputs(cfg: Config, mvs, batch, draws: TrainDraws,
                 train: bool = True):
    """Cascade forward + train-ray build for one scene sample.  Under
    ``--finetune`` the cascade runs without autograd."""
    imgs = unnormalize(batch["images"])
    near, far = batch["near_fars"][0, 0], batch["near_fars"][0, 1]
    frozen = torch.no_grad() if cfg.finetune is not None \
        else contextlib.nullcontext()
    with frozen:
        mvs_out = run_mvs(cfg, mvs, batch)
    confidence = mvs_out["stage3"]["photometric_confidence"]
    rays = build_train_rays(
        draws, image_tgt=imgs[0], confidence=confidence.detach(),
        sparse_coords=batch["sparse_coords"],
        sparse_mask=batch["sparse_mask"],
        intrinsic=batch["intrinsics"][0], c2w=batch["c2ws"][0],
        near_ref=near, far_ref=far,
        stage_planes=_stage_planes(mvs_out, cfg.pad),
        patch_size=cfg.patch_size, patch_num=cfg.patch_num,
        n_samples=cfg.N_samples, jitter=train and cfg.perturb > 0)
    return imgs, mvs_out, confidence, rays


def forward_scene(cfg: Config, nerf, mvs, batch, draws: TrainDraws,
                  train: bool = True):
    """Cascade forward + ray build + render for one scene sample."""
    imgs, mvs_out, confidence, rays = scene_inputs(cfg, mvs, batch, draws,
                                                   train)
    feat_ctx = make_feat_ctx(mvs_out, confidence, imgs[1:],
                             batch["w2cs"][1:], batch["intrinsics"][1:])
    rgb, depth = render_rays(nerf, rays, feat_ctx, batch["w2cs"][0],
                             white_bkgd=cfg.white_bkgd,
                             fast=cfg.fast_featurization)
    return rgb, depth, rays, mvs_out


def scene_loss_terms(cfg: Config, batch, rgb, depth, rays, mvs_out):
    """The 5-term objective from the render outputs."""
    coords = rays["pixel_coords"]            # [(patch|unif|depth), 2]
    patch_pts = cfg.n_patch_rays
    n_fixed = cfg.batch_size
    dpt_patches = batch["dpt"][coords[:patch_pts, 0],
                               coords[:patch_pts, 1]].reshape(
        cfg.patch_num, cfg.patch_size, cfg.patch_size)
    dcoords = coords[n_fixed:]
    target_depths = batch["sparse_depths"][dcoords[:, 0], dcoords[:, 1]]
    target_weights = batch["sparse_weights"][dcoords[:, 0], dcoords[:, 1]]
    return total_loss(
        cfg, rgb=rgb, target_rgb=rays["colors"], depth_pred=depth,
        mvs_out=mvs_out, sparse_depth_ms=batch["sparse_depth_ms"],
        weight_ms=batch["weight_ms"], target_depths=target_depths,
        target_weights=target_weights,
        depth_ray_mask=rays["depth_ray_mask"], dpt_patches=dpt_patches,
        n_rays_fixed=n_fixed)


def mvs_only_scene_loss(cfg: Config, mvs, batch):
    """``--mvs_only``: ``cas_mvsnet_loss`` alone, no rays and no render;
    pretrains the cascade from scratch.  ``depth_abs`` is the mean |depth
    error| at the supervised pixels, a diagnostic."""
    mvs_out = run_mvs(cfg, mvs, batch)
    loss = cas_mvsnet_loss(mvs_out, batch["sparse_depth_ms"],
                           batch["weight_ms"])
    est = mvs_out["stage3"]["depth"]
    gt = batch["sparse_depth_ms"]["stage3"]
    mask = (gt > 0).to(est.dtype)
    abs_err = (torch.sum(torch.abs(est - gt) * mask)
               / torch.clamp(torch.sum(mask), min=1.0))
    return loss, {"loss": loss, "mvs": loss, "depth_abs": abs_err}


def scene_loss(cfg: Config, nerf, mvs, batch, draws: TrainDraws):
    """Single-scene loss: forward + the 5-term objective, or the MVS-only
    objective under ``--mvs_only``."""
    if cfg.mvs_only:
        return mvs_only_scene_loss(cfg, mvs, batch)
    rgb, depth, rays, mvs_out = forward_scene(cfg, nerf, mvs, batch, draws,
                                              train=True)
    return scene_loss_terms(cfg, batch, rgb, depth, rays, mvs_out)


def make_train_step(cfg: Config, schedule: Callable):
    """``train_step(state, batch, draws)`` -> metrics (detached tensors):
    forward, backward, LR = ``schedule(state.step)`` (the count of updates
    already made), one Adam update.  A trained parameter that got no
    gradient gets a zero one, so its moments decay as in an update of the
    whole tree.  ``--debug_nans`` runs forward and backward in autograd's
    anomaly mode and raises FloatingPointError, before the update, when
    the loss or a gradient is not finite."""
    anomaly = (torch.autograd.detect_anomaly if cfg.debug_nans
               else contextlib.nullcontext)

    def train_step(state: TrainState, batch, draws: TrainDraws) -> Dict:
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        with anomaly():
            loss, metrics = scene_loss(cfg, state.nerf, state.mvs, batch,
                                       draws)
            if cfg.debug_nans and not torch.isfinite(loss):
                raise FloatingPointError(
                    f"--debug_nans: step {state.step} loss is "
                    f"{float(loss.detach())}")
            loss.backward()
        if cfg.debug_nans:
            bad = [n for m in (state.nerf, state.mvs)
                   for n, p in m.named_parameters()
                   if p.grad is not None and not torch.isfinite(p.grad).all()]
            if bad:
                raise FloatingPointError(
                    f"--debug_nans: step {state.step} gradients not finite "
                    f"in {len(bad)} tensors: {', '.join(bad[:5])}")
        lr = schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def prepare_view_ctx(cfg: Config, mvs, batch, mvs_apply=None) -> Dict:
    """Per-view render context: cascade forward + featurization inputs,
    with ``--use_color_volume``'s volumes of ``--color_volume_depths``
    planes (the eval render only: the train step never builds them).
    ``mvs_apply(imgs_src, affine_mat, affine_mat_inv, near, far, pad)``
    overrides the cascade forward (serving reuses cached features)."""
    imgs = unnormalize(batch["images"])
    near, far = batch["near_fars"][0, 0], batch["near_fars"][0, 1]
    mvs_out = run_mvs(cfg, mvs if mvs_apply is None else mvs_apply, batch)
    confidence = mvs_out["stage3"]["photometric_confidence"]
    cv = ((batch["c2ws"][0], batch["intrinsics"][0], near, far,
           cfg.color_volume_depths) if cfg.use_color_volume else None)
    feat_ctx = make_feat_ctx(mvs_out, confidence, imgs[1:],
                             batch["w2cs"][1:], batch["intrinsics"][1:],
                             color_volume=cv)
    return dict(mvs_out=mvs_out, confidence=confidence,
                w2cs=batch["w2cs"], intrinsics=batch["intrinsics"],
                c2w_tgt=batch["c2ws"][0], near=near, far=far,
                feat_ctx=feat_ctx)


def view_chunk_fns(cfg: Config, nerf, H: int, W: int, ctx: Dict):
    """(build_chunk, render_chunk) closures over a ``prepare_view_ctx``;
    ``ctx['jitter_draws'](pix, n)``, when set, gives a tile's [N, n]
    uniform draws for ``--eval_jitter``."""
    planes = _stage_planes(ctx["mvs_out"], cfg.pad)
    draws = ctx.get("jitter_draws")      # set iff cfg.eval_jitter
    n_cand = 3 * (cfg.N_samples // 3)

    def build_chunk(pix):
        u = None if draws is None else draws(pix, n_cand)
        return build_test_rays(
            pix, H=H, W=W, intrinsic=ctx["intrinsics"][0],
            c2w=ctx["c2w_tgt"], near_ref=ctx["near"], far_ref=ctx["far"],
            stage_planes=planes, n_samples=cfg.N_samples, jitter_u=u)

    def render_chunk(rays):
        return render_rays(nerf, rays, ctx["feat_ctx"], ctx["w2cs"][0],
                           white_bkgd=cfg.white_bkgd,
                           fast=cfg.fast_featurization)

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
            ctx["jitter_draws"] = lambda pix, n: torch.rand(
                (pix.shape[0], n), generator=gen, device=pix.device)
        build_chunk, render_chunk = view_chunk_fns(cfg, nerf, H, W, ctx)
        rgb, depth = render_image_chunked(build_chunk, render_chunk, H, W,
                                          cfg.chunk, batch["images"].device)
        return torch.clamp(rgb, 0.0, 1.0), depth, ctx["confidence"]

    return render_view
