"""Evaluation metrics of the reference harness, in torch (a copy of
``ucnerf_tpu.eval.metrics``'s semantics).

- PSNR: -10*log10 of each image's mean-square error, then averaged over
  images (reference ``utils/evaluation.py:82-83``).
- SSIM: scikit-image ``structural_similarity(data_range=1, channel_axis=2)``
  (reference ``utils/evaluation.py:94``): 7x7 uniform windows through 2-D
  cumulative sums, K1=0.01, K2=0.03, covariance scaled by N/(N-1), the
  valid-region crop, the mean over channels.  Runs on the inputs' device.
- depth: median-ratio scaling, then abs_rel / sq_rel / rmse / rmse_log /
  delta<1.25^k, clamped to [1e-4, 100] (reference
  ``utils/evaluation.py:29-74``), in numpy.
- LPIPS lives in ``ucnerf_torch.eval.lpips``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device=None) -> torch.Tensor:
    """float32 tensor on ``device`` (a tensor's own device by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def psnr(gt, pred, dim=None):
    gt = _tensor(gt)
    pred = _tensor(pred, gt.device)
    sq = (gt - pred) ** 2
    mse = sq.mean() if dim is None else sq.mean(dim=dim)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _uniform_valid(x, win: int):
    """Valid-region uniform filter via 2-D cumulative sums; x [..., H, W]."""
    pad = torch.nn.functional.pad(x, (1, 0, 1, 0))
    cs = torch.cumsum(torch.cumsum(pad, dim=-2), dim=-1)
    s = (cs[..., win:, win:] - cs[..., :-win, win:] - cs[..., win:, :-win]
         + cs[..., :-win, :-win])
    return s / (win * win)


def ssim(gt, pred, data_range: float = 1.0, win_size: int = 7,
         channel_axis: int = 2):
    """skimage-compatible SSIM of one image pair ([H, W, C] by default)."""
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size * win_size
    cov_norm = NP / (NP - 1)

    x = torch.movedim(_tensor(gt), channel_axis, 0)
    y = torch.movedim(_tensor(pred, x.device), channel_axis, 0)
    ux = _uniform_valid(x, win_size)
    uy = _uniform_valid(y, win_size)
    uxx = _uniform_valid(x * x, win_size)
    uyy = _uniform_valid(y * y, win_size)
    uxy = _uniform_valid(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    a1 = 2 * ux * uy + C1
    a2 = 2 * vxy + C2
    b1 = ux * ux + uy * uy + C1
    b2 = vx + vy + C2
    return torch.mean(((a1 * a2) / (b1 * b2)).mean(dim=(-2, -1)))


def depth_metrics(gt, pred):
    """abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 on flat valid arrays
    (reference ``compute_errors``, ``utils/evaluation.py:8-26``)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return np.array([abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3])


DEPTH_METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def depth_evaluation(gt_depths, pred_depths, masks=None, min_depth=1e-4,
                     max_depth=100.0):
    """Median-ratio-scaled depth metrics over a stack of frames
    (reference ``depth_evaluation``, ``utils/evaluation.py:29-74``)."""
    gts, preds = [], []
    for i in range(gt_depths.shape[0]):
        gt = gt_depths[i]
        mask = (gt > min_depth) & (gt < max_depth)
        if masks is not None:
            mask &= masks[i] > 0.5
        if mask.sum() == 0:
            continue
        gts.append(gt[mask])
        preds.append(pred_depths[i][mask])
    ratio = np.median(np.concatenate(gts)) / np.median(np.concatenate(preds))
    errs = []
    for gt, pred in zip(gts, preds):
        pred = np.clip(pred * ratio, min_depth, max_depth)
        errs.append(depth_metrics(gt, pred))
    return np.stack(errs).mean(axis=0)


def rgb_evaluation(gts, preds, lpips_fn=None):
    """Stacks [N, H, W, 3] in [0, 1] (numpy or tensors) -> (psnr, ssim,
    lpips | nan) (reference ``rgb_evaluation``,
    ``utils/evaluation.py:76-101``).  Runs on the device of ``gts``."""
    gts = _tensor(gts)
    preds = _tensor(preds, gts.device)
    mse = ((gts - preds) ** 2).mean(dim=(1, 2, 3))
    psnr_val = float((-10 * torch.log10(torch.clamp(mse, min=1e-12))).mean())
    ssim_val = float(np.mean([float(ssim(g, p)) for g, p in zip(gts, preds)]))
    if lpips_fn is not None:
        lpips_val = float(np.mean([lpips_fn(g, p) for g, p in
                                   zip(gts, preds)]))
    else:
        lpips_val = float("nan")
    return psnr_val, ssim_val, lpips_val
