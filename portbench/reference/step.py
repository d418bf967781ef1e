"""The plain reference's train steps and served frame.

Plain PyTorch over the frozen copies in this folder.  It takes the
benchmark's inputs (scene samples, weights, ray draws, poses) and works
out again everything the program derives from them: the batch of each
step, the cached source features of a served scene, the rays, the
features, the loss, the gradients and Adam's update.

``precision`` selects what the reference computes in (``build_models``,
``flags``):

- ``{}``: float32 throughout, TF32 off everywhere;
- ``stated_precision(cfg)``: what the configuration states for the
  program: the MLP rounded to its ``nerf_dtype`` where the program's plain
  MLP rounds (``"mlp_dtype"``), the cascade's convolutions at cuDNN's TF32
  (``"cudnn_tf32"``, PyTorch's default, which the port's entry points
  keep), matmuls in float32.  This is the yardstick ``correct`` is
  decided by;
- ``{"mvs": torch.bfloat16}``: the cascade's convolution blocks in bf16;
- ``{"mlp": round_fp8 | round_tf32}``: both operands of every MLP matmul,
  forward and backward, rounded (``model.RoundedLinear``).

The lower precisions are the benchmark's control: the reference put in
the program's place and computed one step below what the configuration
states (``portbench/calibrate.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

from portbench.reference import losses, model, render


def stated_precision(cfg) -> Dict:
    """The precision the configuration states for the program (see the
    module's docstring)."""
    return {"mlp_dtype": {"bfloat16": torch.bfloat16,
                          "float32": None}[cfg.nerf_dtype],
            "cudnn_tf32": True}


@contextlib.contextmanager
def flags(precision: Dict):
    """TF32 off for matmuls, and for cuDNN's convolutions unless
    ``precision["cudnn_tf32"]``, inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = bool(precision.get("cudnn_tf32"))
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def build_models(cfg, weights: Dict, device, precision=None):
    """(nerf, mvs) of the configuration, loaded with ``weights``
    ({'nerf': state dict, 'mvs': state dict})."""
    precision = precision or {}
    nerf = model.UCNeRFMLP(depth=cfg.netdepth, width=cfg.netwidth,
                           multires=cfg.multires,
                           multires_views=cfg.multires_views,
                           view_num=cfg.view_num, skips=tuple(cfg.skips),
                           operand_round=precision.get("mlp"),
                           dtype=precision.get("mlp_dtype"))
    mvs = model.CascadeMVSNet(ndepths=tuple(cfg.ndepths),
                              depth_intervals_ratio=tuple(
                                  cfg.depth_intervals_ratio),
                              dtype=precision.get("mvs"))
    if weights is not None:
        nerf.load_state_dict(weights["nerf"])
        mvs.load_state_dict(weights["mvs"])
    return nerf.to(device), mvs.to(device)


def unnormalize(images):
    mean = torch.tensor([0.485, 0.456, 0.406], device=images.device)
    std = torch.tensor([0.229, 0.224, 0.225], device=images.device)
    return images * std + mean


def stage_planes(mvs_out, pad: int):
    planes = {}
    for k in (1, 2, 3):
        dv = mvs_out[f"stage{k}"]["depth_values"]
        near_p, far_p = dv[0], dv[-1]
        if k == 3 and pad > 0:
            near_p = near_p[pad:-pad, pad:-pad]
            far_p = far_p[pad:-pad, pad:-pad]
        planes[k] = (near_p, far_p)
    return planes


def scene_loss(cfg, nerf, mvs, batch, draws, pixels=None):
    """The 5-term loss of one scene sample, its terms, the pixels (ys, xs)
    of its rays and the cascade's confidence: through ``pixels`` when
    given (the program's), else the ones the reference draws from its own
    confidence.  The terms are
    floats.  With ``pixels``, ``terms['patch_gap']`` is the share of the
    patch rays at which the reference's own draw differs, and
    ``terms['draw_gap']`` how far ``pixels`` lie from a draw out of the
    reference's confidence (``render.draw_gap``)."""
    imgs = unnormalize(batch["images"])
    near, far = batch["near_fars"][0, 0], batch["near_fars"][0, 1]
    mvs_out = mvs(batch["images"][1:], batch["affine_mat"],
                  batch["affine_mat_inv"], near, far, cfg.pad)
    confidence = mvs_out["stage3"]["photometric_confidence"]
    own = render.train_pixels(draws, confidence.detach(),
                              batch["sparse_coords"], cfg.patch_size,
                              cfg.patch_num)
    n_patch = cfg.patch_num * cfg.patch_size ** 2
    patch_gap = gap = None
    if pixels is None:
        pixels = own
    else:
        same = ((own[0] == pixels[0]) & (own[1] == pixels[1]))[:n_patch]
        patch_gap = 1.0 - float(same.float().mean())
        gap = render.draw_gap(draws, confidence.detach(),
                              batch["sparse_coords"], pixels,
                              cfg.patch_size, cfg.patch_num)
    rays = render.build_train_rays(
        draws, image_tgt=imgs[0], confidence=confidence.detach(),
        sparse_coords=batch["sparse_coords"],
        sparse_mask=batch["sparse_mask"],
        intrinsic=batch["intrinsics"][0], c2w=batch["c2ws"][0],
        near_ref=near, far_ref=far, stage_planes=stage_planes(mvs_out,
                                                              cfg.pad),
        patch_size=cfg.patch_size, patch_num=cfg.patch_num,
        n_samples=cfg.N_samples, jitter=cfg.perturb > 0, pixels=pixels)
    ctx = render.make_feat_ctx(mvs_out, confidence, imgs[1:],
                               batch["w2cs"][1:], batch["intrinsics"][1:])
    rgb, depth = render.render_rays(nerf, rays, ctx, batch["w2cs"][0])
    coords = rays["pixel_coords"]
    dpt_patches = batch["dpt"][coords[:n_patch, 0],
                               coords[:n_patch, 1]].reshape(
        cfg.patch_num, cfg.patch_size, cfg.patch_size)
    dcoords = coords[cfg.batch_size:]
    loss, terms = losses.total_loss(
        cfg, rgb=rgb, target_rgb=rays["colors"], depth_pred=depth,
        mvs_out=mvs_out, sparse_depth_ms=batch["sparse_depth_ms"],
        weight_ms=batch["weight_ms"],
        target_depths=batch["sparse_depths"][dcoords[:, 0], dcoords[:, 1]],
        target_weights=batch["sparse_weights"][dcoords[:, 0],
                                               dcoords[:, 1]],
        depth_ray_mask=rays["depth_ray_mask"], dpt_patches=dpt_patches,
        n_rays_fixed=cfg.batch_size)
    terms = {k: float(v.detach()) for k, v in terms.items()}
    terms["patch_gap"], terms["draw_gap"] = patch_gap, gap
    return loss, terms, pixels, confidence.detach()


def cosine_lr(cfg, step: int, steps_per_epoch: int,
              eta_min: float = 1e-7) -> float:
    """CosineAnnealingLR(T_max=num_epochs) stepped once an epoch."""
    epoch = min(step // steps_per_epoch, cfg.num_epochs)
    return eta_min + (cfg.lrate - eta_min) * 0.5 * (
        1.0 + math.cos(math.pi * epoch / cfg.num_epochs))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def train_steps(cfg, nerf, mvs, batches: List, draws: List,
                lrs: List[float], pixels=None, betas=(0.9, 0.999),
                eps: float = 1e-8) -> Dict:
    """Steps of the full objective with Adam, one per batch, each through
    ``pixels[i]`` when given: the loss and the loss terms of each, every
    leaf's gradient norm at the first step, every leaf's change over all
    the steps, the pixels each step used, the cascade's confidence at the
    first step (``confidence1``), and the largest ``patch_gap`` and
    ``draw_gap`` (with the first step's as ``patch1_gap`` and
    ``draw1_gap``).  Leaves are named ``nerf.<name>`` and
    ``mvs.<name>``."""
    params = {f"{g}.{n}": p for g, m in (("nerf", nerf), ("mvs", mvs))
              for n, p in m.named_parameters()}
    start = {k: p.detach().clone() for k, p in params.items()}
    m1 = {k: torch.zeros_like(p) for k, p in params.items()}
    m2 = {k: torch.zeros_like(p) for k, p in params.items()}
    out = {"loss": [], "terms": [], "pixels": []}
    for t, (batch, dr, lr) in enumerate(zip(batches, draws, lrs), start=1):
        for p in params.values():
            p.grad = None
        loss, terms, used, confidence = scene_loss(
            cfg, nerf, mvs, batch, dr,
            None if pixels is None else pixels[t - 1])
        loss.backward()
        out["loss"].append(float(loss.detach()))
        out["terms"].append(terms)
        out["pixels"].append(used)
        if t == 1:
            out["confidence1"] = confidence
        for key in ("patch_gap", "draw_gap"):
            if terms[key] is not None:
                out[key] = max(out.get(key, 0.0), terms[key])
                if t == 1:
                    out[key.replace("_", "1_", 1)] = terms[key]
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if t == 1:
            out["grad_norm"] = leaf_norms(grads)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m1[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                m2[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                step = lr / (1 - betas[0] ** t)
                denom = (m2[k].sqrt() / math.sqrt(1 - betas[1] ** t)).add_(
                    eps)
                p.addcdiv_(m1[k], denom, value=-step)
    out["change"] = {k: p.detach() - start[k] for k, p in params.items()}
    out["change_norm"] = leaf_norms(out["change"])
    return out


@torch.no_grad()
def render_frame(cfg, nerf, mvs, batch, chunk: int):
    """One served frame of ``batch`` (view 0 the target pose): the whole
    cascade from the source images, then every pixel's ray in blocks of
    ``chunk``.  Returns (rgb [H, W, 3] in [0, 1], depth [H, W],
    confidence [H, W])."""
    imgs = unnormalize(batch["images"])
    near, far = batch["near_fars"][0, 0], batch["near_fars"][0, 1]
    mvs_out = mvs(batch["images"][1:], batch["affine_mat"],
                  batch["affine_mat_inv"], near, far, cfg.pad)
    confidence = mvs_out["stage3"]["photometric_confidence"]
    ctx = render.make_feat_ctx(mvs_out, confidence, imgs[1:],
                               batch["w2cs"][1:], batch["intrinsics"][1:])
    planes = stage_planes(mvs_out, cfg.pad)
    H, W = confidence.shape
    rgbs, depths = [], []
    for start in range(0, H * W, chunk):
        pix = torch.arange(start, min(start + chunk, H * W),
                           device=confidence.device)
        rays = render.build_test_rays(
            pix, H=H, W=W, intrinsic=batch["intrinsics"][0],
            c2w=batch["c2ws"][0], near_ref=near, far_ref=far,
            stage_planes=planes, n_samples=cfg.N_samples)
        rgb, depth = render.render_rays(nerf, rays, ctx, batch["w2cs"][0])
        rgbs.append(rgb)
        depths.append(depth)
    rgb = torch.cat(rgbs).reshape(H, W, 3)
    return (torch.clamp(rgb, 0.0, 1.0), torch.cat(depths).reshape(H, W),
            confidence)
