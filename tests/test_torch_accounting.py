"""ucnerf_torch's FLOP, byte and gather-row accounting
(``ucnerf_torch/utils/accounting.py``) against the JAX package's copy
(``ucnerf_tpu/utils/accounting.py``): the same math over three
configurations, apart from the warp's pack factor, and the same
``perf_accounting`` fields at equal peaks and floors."""

import numpy as np
import torch

import ucnerf_tpu.models.mvs as j_mvs
from ucnerf_tpu.config import Config as JConfig
from ucnerf_tpu.utils import accounting as j_acc

from ucnerf_torch.config import Config
from ucnerf_torch.utils import accounting as t_acc

torch.set_num_threads(1)

# (flags, H, W): the SCARED operating point (bench.py's train point), the
# cut point of scripts/quality_seeds.py, and the tests' small shape with a
# padded stage 3
CONFIGS = {
    "scared": (dict(dataset_name="synthetic", view_num=7, batch_size=2000,
                    patch_size=6, patch_num=50, n_depth_rays=1024,
                    N_samples=90), 256, 320),
    "cut": (dict(dataset_name="synthetic", view_num=7, batch_size=500,
                 patch_size=6, patch_num=12, n_depth_rays=256,
                 N_samples=90), 64, 96),
    "small_padded": (dict(dataset_name="synthetic", view_num=4,
                          batch_size=80, patch_size=4, patch_num=4,
                          n_depth_rays=32, N_samples=9, ndepths=(8, 8, 8),
                          pad=4), 32, 64),
}
SCALARS = ("featurenet_flops", "featurenet_bytes")
CFG_FNS = ("mvs_forward_flops", "train_step_flops", "eval_frame_flops",
           "mvs_forward_bytes", "train_step_bytes", "train_bw_seconds",
           "eval_bw_seconds")


def _unpacked(monkeypatch):
    """The JAX copy's warp rows without its TPU row packing: the port
    gathers one row of C channels per (view, plane, pixel)."""
    monkeypatch.setattr(j_mvs, "warp_pack_factor", lambda C, ws: 1)


def test_accounting_functions_equal_the_jax_copy(monkeypatch):
    for name in CONFIGS:
        with monkeypatch.context() as mp:
            _functions_equal(name, mp)


def _functions_equal(name, monkeypatch):
    flags, H, W = CONFIGS[name]
    cfg, jcfg = Config(**flags), JConfig(**flags)
    # the peaks differ on purpose (the card's, not a TPU's): the
    # bandwidth seconds are compared at equal peaks
    monkeypatch.setattr(j_acc, "PEAK_HBM_GBPS", t_acc.PEAK_HBM_GBPS)
    for fn in SCALARS:
        assert getattr(t_acc, fn)(H, W) == getattr(j_acc, fn)(H, W), fn
    dims = t_acc._stage_dims(cfg, H, W)
    assert dims == j_acc._stage_dims(jcfg, H, W)
    for D, hs, ws, C in dims:
        assert t_acc.costreg_flops(D, hs, ws, C) == j_acc.costreg_flops(
            D, hs, ws, C)
        assert t_acc.costreg_bytes(D, hs, ws, C) == j_acc.costreg_bytes(
            D, hs, ws, C)
        assert (t_acc.softmax_regression_bytes(D, hs, ws)
                == j_acc.softmax_regression_bytes(D, hs, ws))
        assert (t_acc.variance_bytes(cfg, D, hs, ws, C)
                == j_acc.variance_bytes(jcfg, D, hs, ws, C))
    for fn in CFG_FNS:
        assert getattr(t_acc, fn)(cfg, H, W) == getattr(j_acc, fn)(
            jcfg, H, W), fn
    for n in (1, 1000, H * W):
        assert t_acc.nerf_mlp_flops(cfg, n) == j_acc.nerf_mlp_flops(jcfg, n)
        assert t_acc.feat_rows(cfg, n) == j_acc.feat_rows(jcfg, n)
    # the warp: the JAX copy's rows times its pack factor (4 at an
    # 8-channel stage whose width is a multiple of 4, else 1)
    packed = j_acc.warp_rows(jcfg, H, W)
    _unpacked(monkeypatch)
    assert t_acc.warp_rows(cfg, H, W) == j_acc.warp_rows(jcfg, H, W)
    assert t_acc.warp_rows(cfg, H, W) >= packed
    if name == "scared":
        s3 = 6 * 8 * 256 * 320
        assert t_acc.warp_rows(cfg, H, W) - packed == s3 - s3 / 4


def test_perf_accounting_equals_the_jax_copy(monkeypatch):
    """At the same peaks and floors (and without the pack factor) every
    field of ``perf_accounting`` is the JAX copy's; with the card's own
    constants the MFUs are the counted FLOPs over 989 TFLOP/s."""
    for name in ("scared", "small_padded"):
        with monkeypatch.context() as mp:
            _perf_equal(name, mp)


def _perf_equal(name, monkeypatch):
    flags, H, W = CONFIGS[name]
    cfg, jcfg = Config(**flags), JConfig(**flags)
    times = (0.1935, 0.3175, 0.05, 0.04)
    own = t_acc.perf_accounting(cfg, H, W, *times)
    fl = t_acc.train_step_flops(cfg, H, W)
    assert own["peak_tflops"] == 989.0 and own["peak_hbm_gbps"] == 3350.0
    assert own["train_mfu"] == round(fl / times[0] / 989e12, 4)
    _unpacked(monkeypatch)
    for k in ("PEAK_TFLOPS", "PEAK_HBM_GBPS", "GATHER_NS_PER_ROW",
              "SCATTER_NS_PER_ROW"):
        monkeypatch.setattr(j_acc, k, getattr(t_acc, k))
    want = j_acc.perf_accounting(jcfg, H, W, *times)
    assert sorted(own) == sorted(want)
    for k, v in want.items():
        assert own[k] == v, k
    for mod in (t_acc, j_acc):   # and at the JAX copy's own floors
        monkeypatch.setattr(mod, "GATHER_NS_PER_ROW", 2.9)
        monkeypatch.setattr(mod, "SCATTER_NS_PER_ROW", 8.7)
    assert (t_acc.perf_accounting(cfg, H, W, *times)
            == j_acc.perf_accounting(jcfg, H, W, *times))


def test_k1_tile_flops_and_bounds():
    """K1's 92,160-point tile (1024 rays x 90 samples, V=7) is 27.16
    GFLOP: 0.0275 ms at the bf16 peak, 0.4053 ms at the f32 one."""
    cfg = Config(**CONFIGS["scared"][0])
    fl = t_acc.nerf_mlp_flops(cfg, 1024 * 90)
    assert round(fl / 1e9, 2) == 27.16
    assert round(fl / (t_acc.PEAK_TFLOPS * 1e12) * 1e3, 4) == 0.0275
    assert round(fl / (t_acc.PEAK_TFLOPS_F32 * 1e12) * 1e3, 4) == 0.4053
    nbytes = t_acc.nerf_mlp_bytes(cfg, 1024, 90, 300_000)
    assert nbytes == 4.0 * (92160 * (3 + 97 + 4) + 1024 * 3) + 300_000
    assert np.isfinite(nbytes / (t_acc.PEAK_HBM_GBPS * 1e9))


def test_k1_f32_bound_is_the_least_route(monkeypatch):
    """K1's f32 bound at the phase-k1 tile is the least of the FMA route
    (0.4053 ms at 67 TFLOP/s) and the 3xTF32 route (3 x 27.16 GFLOP at
    494.7 TFLOP/s: 0.1647 ms), so the tensor-core route's; at a TF32 rate
    under 3 x 67 TFLOP/s it would be the FMA route's."""
    cfg = Config(**CONFIGS["scared"][0])
    fl = t_acc.nerf_mlp_flops(cfg, 1024 * 90)
    fma = fl / (t_acc.PEAK_TFLOPS_F32 * 1e12)
    tf32 = 3 * fl / (t_acc.PEAK_TFLOPS_TF32 * 1e12)
    assert round(fma * 1e3, 4) == 0.4053 and round(tf32 * 1e3, 4) == 0.1647
    assert t_acc.f32_matmul_seconds(fl) == tf32
    monkeypatch.setattr(t_acc, "PEAK_TFLOPS_TF32", 150.0)
    assert t_acc.f32_matmul_seconds(fl) == fma
