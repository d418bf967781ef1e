"""The 5-term UC-NeRF training loss.

    total = 0.05*nerf_depth + 0.05*mvs + 0.05*smooth + 0.008*scaleinv
            + 5*img_mse

- img2mse on all rays.
- NeRF depth: weighted MSE at the sparse-depth rays, divided by the count
  of valid slots (the sparse-ray buffer is padded).
- cas_mvsnet_loss: per-stage smooth-L1 of the MVS depth against the
  splatted sparse depth where it is > 0, times the point weights, stage
  weights [0.5, 1.0, 2.0], each stage divided by its count of supervised
  pixels.
- edge-preserving smoothness: 4-direction bilateral-weighted depth TV on
  the confidence-drawn patch half against the DPT prior.
- gradient scale-invariant loss: closed-form scale/shift alignment, then a
  gradient difference, on the other patch half.
"""

from __future__ import annotations

from typing import Dict

import torch


def img2mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mse2psnr(mse):
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def smooth_l1(x, y):
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def cas_mvsnet_loss(mvs_out: Dict, sparse_depth_ms: Dict, weight_ms: Dict,
                    stage_weights=(0.5, 1.0, 2.0)):
    total = 0.0
    for k in (1, 2, 3):
        est = mvs_out[f"stage{k}"]["depth"]
        gt = sparse_depth_ms[f"stage{k}"]
        w = weight_ms[f"stage{k}"]
        mask = (gt > 0).to(est.dtype)
        per_px = smooth_l1(est, gt) * w * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
        total = total + stage_weights[k - 1] * torch.sum(per_px) / denom
    return total


def edge_preserving_smoothness(depth_patches, dpt_patches,
                               gamma: float = 0.1):
    """depth_patches [P, ps, ps], dpt_patches [P, ps, ps, 1]."""
    def bilateral(x):
        return torch.exp(-torch.abs(x).sum(-1) / gamma)

    w = dpt_patches
    d = depth_patches
    w1 = bilateral(w[:, :, :-1] - w[:, :, 1:])
    w2 = bilateral(w[:, :-1, :] - w[:, 1:, :])
    w3 = bilateral(w[:, :-1, :-1] - w[:, 1:, 1:])
    w4 = bilateral(w[:, 1:, :-1] - w[:, :-1, 1:])
    l1 = torch.mean(torch.abs(w1 * (d[:, :, :-1] - d[:, :, 1:])))
    l2 = torch.mean(torch.abs(w2 * (d[:, :-1, :] - d[:, 1:, :])))
    l3 = torch.mean(torch.abs(w3 * (d[:, :-1, :-1] - d[:, 1:, 1:])))
    l4 = torch.mean(torch.abs(w4 * (d[:, 1:, :-1] - d[:, :-1, 1:])))
    return (l1 + l2 + l3 + l4) / 4.0


def _compute_scale_and_shift(pred, target, mask):
    """Closed-form least-squares (s, t) minimizing ||s*pred + t - target||²
    over ``mask``; [P, ps, ps] inputs, s = t = 0 where the system is
    singular."""
    a00 = torch.sum(mask * pred * pred, dim=(1, 2))
    a01 = torch.sum(mask * pred, dim=(1, 2))
    a11 = torch.sum(mask, dim=(1, 2))
    b0 = torch.sum(mask * pred * target, dim=(1, 2))
    b1 = torch.sum(mask * target, dim=(1, 2))
    det = a00 * a11 - a01 * a01
    singular = det == 0
    safe = torch.where(singular, torch.ones_like(det), det)
    zero = torch.zeros_like(det)
    s = torch.where(singular, zero, (a11 * b0 - a01 * b1) / safe)
    t = torch.where(singular, zero, (-a01 * b0 + a00 * b1) / safe)
    return s, t


def gradient_scaleinv_loss(pred_patches, target_patches, mask=None):
    """Scale/shift-aligned gradient-difference loss, [P, ps, ps] inputs."""
    if mask is None:
        mask = torch.ones_like(pred_patches)
    s, t = _compute_scale_and_shift(pred_patches, target_patches, mask)
    pred_ssi = s[:, None, None] * pred_patches + t[:, None, None]
    diff = pred_ssi - target_patches
    gx = torch.abs(diff[:, :, 1:] - diff[:, :, :-1])
    gy = torch.abs(diff[:, 1:, :] - diff[:, :-1, :])
    per_img = torch.sum(gx, dim=(1, 2)) + torch.sum(gy, dim=(1, 2))
    return torch.sum(per_img) / pred_patches.shape[0]


def total_loss(cfg, *, rgb, target_rgb, depth_pred, mvs_out, sparse_depth_ms,
               weight_ms, target_depths, target_weights, depth_ray_mask,
               dpt_patches, n_rays_fixed: int):
    """The 5-term total and its terms.

    depth_pred [N_total], rays laid out [patches | uniform | sparse-depth];
    ``dpt_patches`` [patch_num, ps, ps] the DPT prior at the patch pixels.
    """
    patch_pts = cfg.patch_num * cfg.patch_size * cfg.patch_size
    half = cfg.patch_num // 2

    loss_img = img2mse(rgb, target_rgb)

    dmask = depth_ray_mask[n_rays_fixed:]
    d = depth_pred[n_rays_fixed:]
    num = torch.sum(((d - target_depths) ** 2) * target_weights * dmask)
    loss_nerf_depth = num / torch.clamp(torch.sum(dmask), min=1.0)

    loss_mvs = cas_mvsnet_loss(mvs_out, sparse_depth_ms, weight_ms)

    patch_depth = depth_pred[:patch_pts].reshape(-1, cfg.patch_size,
                                                 cfg.patch_size)
    loss_smooth = edge_preserving_smoothness(patch_depth[:half],
                                             dpt_patches[:half][..., None])
    loss_scaleinv = gradient_scaleinv_loss(patch_depth[half:],
                                           dpt_patches[half:])

    loss = (cfg.w_nerf_depth * loss_nerf_depth + cfg.w_mvs * loss_mvs
            + cfg.w_smooth * loss_smooth + cfg.w_scaleinv * loss_scaleinv
            + cfg.w_img * loss_img)
    return loss, {
        "loss": loss, "img_mse": loss_img, "psnr": mse2psnr(loss_img),
        "nerf_depth": loss_nerf_depth, "mvs": loss_mvs,
        "smooth": loss_smooth, "scaleinv": loss_scaleinv,
    }
