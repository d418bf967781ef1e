"""ucnerf_torch's evaluation metrics and LPIPS against the JAX package's on
the same numpy inputs: PSNR, SSIM (abs 1e-5), the depth metrics and
``rgb_evaluation`` (rel 1e-6), LPIPS with seeded random weights of
AlexNet's shapes (rtol 1e-4)."""

import numpy as np
import pytest
import torch

import jax

from ucnerf_tpu.eval import lpips as j_lpips
from ucnerf_tpu.eval import metrics as j_metrics

from ucnerf_torch.eval import lpips as t_lpips
from ucnerf_torch.eval import metrics as t_metrics

torch.set_num_threads(1)

# the JAX references compiled whole, as the JAX package's validator runs
# LPIPS (``load_lpips``): op-by-op dispatch compiles every op on its own
J_SSIM = jax.jit(j_metrics.ssim)
J_LPIPS = jax.jit(j_lpips.lpips_distance)


def _pairs(rng, n, h, w):
    gts = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    preds = np.clip(gts + 0.08 * rng.standard_normal(gts.shape), 0,
                    1).astype(np.float32)
    return gts, preds


def _lpips_weights(rng):
    """Random weights in the npz layout (conv kernels (kh, kw, Cin, Cout),
    non-negative heads)."""
    w, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(t_lpips._ALEX_CFG):
        w[f"conv{i}_w"] = rng.normal(0, 0.1, (k, k, cin, cout)).astype(
            np.float32)
        w[f"conv{i}_b"] = rng.normal(0, 0.1, (cout,)).astype(np.float32)
        w[f"lin{i}_w"] = np.abs(rng.normal(0, 0.05, (cout,))).astype(
            np.float32)
        cin = cout
    return w


def test_psnr_matches_jax(rng):
    gts, preds = _pairs(rng, 3, 16, 24)
    j_psnr = jax.jit(j_metrics.psnr, static_argnames="axis")
    np.testing.assert_allclose(float(t_metrics.psnr(gts, preds)),
                               float(j_psnr(gts, preds)), rtol=1e-6)
    np.testing.assert_allclose(
        t_metrics.psnr(gts, preds, dim=(1, 2, 3)).numpy(),
        np.asarray(j_psnr(gts, preds, axis=(1, 2, 3))), rtol=1e-6)


@pytest.mark.parametrize("hw", [(24, 20), (32, 64)])
def test_ssim_matches_jax(rng, hw):
    gts, preds = _pairs(rng, 2, *hw)
    for g, p in zip(gts, preds):
        np.testing.assert_allclose(float(t_metrics.ssim(g, p)),
                                   float(J_SSIM(g, p)), atol=1e-5)
    assert float(t_metrics.ssim(gts[0], gts[0])) == pytest.approx(1.0,
                                                                  abs=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_depth_evaluation_matches_jax(rng, masked):
    gt = rng.uniform(0.5, 3.0, size=(4, 24, 32))
    gt[gt < 0.8] = 0.0
    pred = np.abs(gt * 1.3 + rng.normal(scale=0.05, size=gt.shape)) + 1e-3
    masks = ((rng.uniform(size=gt.shape) > 0.3).astype(np.float32)
             if masked else None)
    np.testing.assert_allclose(
        t_metrics.depth_evaluation(gt, pred.copy(), masks),
        j_metrics.depth_evaluation(gt, pred.copy(), masks), rtol=1e-6)


def test_rgb_evaluation_matches_jax(rng, monkeypatch):
    """Without LPIPS weights both read nan; with the same random weights
    each package's LPIPS goes through its own ``rgb_evaluation``."""
    monkeypatch.setattr(j_metrics, "ssim", J_SSIM)
    gts, preds = _pairs(rng, 2, 32, 40)
    t = t_metrics.rgb_evaluation(gts, preds)
    j = j_metrics.rgb_evaluation(gts, preds)
    np.testing.assert_allclose(t[:2], j[:2], rtol=1e-6, atol=1e-7)
    assert np.isnan(t[2]) and np.isnan(j[2])

    gts, preds = _pairs(rng, 1, 64, 64)
    w = _lpips_weights(np.random.default_rng(3))
    tw = t_lpips.lpips_weights(w)
    t = t_metrics.rgb_evaluation(
        torch.from_numpy(gts), torch.from_numpy(preds),
        lpips_fn=lambda a, b: float(t_lpips.lpips_distance(tw, a, b)))
    j = j_metrics.rgb_evaluation(
        gts, preds,
        lpips_fn=lambda a, b: float(J_LPIPS(w, a, b)))
    np.testing.assert_allclose(t[:2], j[:2], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-4)


def test_lpips_matches_jax(rng, tmp_path):
    """lpips_distance at 64x64 with seeded random weights of AlexNet's
    shapes, and ``load_lpips`` of the npz those weights make."""
    w = _lpips_weights(np.random.default_rng(1))
    img0 = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(0, 0.1, img0.shape), 0, 1).astype(
        np.float32)
    want = float(J_LPIPS(w, img0, img1))
    got = float(t_lpips.lpips_distance(t_lpips.lpips_weights(w), img0, img1))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    npz = str(tmp_path / "lpips_alex.npz")
    np.savez(npz, **w)
    fn = t_lpips.load_lpips(npz)
    np.testing.assert_allclose(fn(img0, img1), want, rtol=1e-4)
    assert abs(fn(img0, img0)) < 1e-6


def test_load_lpips_without_weights_returns_none(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("UCNERF_LPIPS_WEIGHTS", raising=False)
    assert t_lpips.load_lpips() is None
    monkeypatch.setenv("UCNERF_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert t_lpips.load_lpips() is None
