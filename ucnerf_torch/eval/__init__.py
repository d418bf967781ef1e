"""Evaluation: PSNR, SSIM, the depth metrics and LPIPS."""

from ucnerf_torch.eval.metrics import (depth_evaluation, depth_metrics, psnr,
                                       rgb_evaluation, ssim)
