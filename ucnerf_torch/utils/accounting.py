"""Analytic FLOP, byte and gather-row accounting for MFU and floor
shares on one NVIDIA H100 (a copy of the JAX package's
``utils/accounting.py`` with the same functions and the same FLOP and
byte math; only the row count of the warp and the card's constants
differ).

- **MFU** = achieved model FLOP/s over the card's peak matmul rate.  FLOPs
  are counted analytically over the matmul/conv work ONLY (cascade convs +
  NeRF MLP matmuls, 2*K*Cin*Cout*N each; backward = 2x forward for the
  dgrad+wgrad pair, so a train step is 3x its forward) -- the standard
  "model FLOPs" MFU convention; elementwise/softmax/normalization work is
  deliberately excluded.  ``PEAK_TFLOPS`` is the H100 SXM's dense bf16
  tensor-core rate (989 TFLOP/s); the cascade runs f32 by default, whose
  ceiling is lower (``PEAK_TFLOPS_F32``, 67 TFLOP/s outside the tensor
  cores), so reported MFU is a conservative lower bound on utilization
  of the achievable rate.
- **floor_bound_frac** = the fraction of the measured wall time accounted
  for by gather/scatter rows priced at the card's measured issue floors
  (the marginal cost of one more row when many are in flight: a gather
  ``table[idx]`` and an ``index_add_`` of rows of the warp's size, timed
  at two row counts, ``chip_smoke.py`` phase ``accounting``).  A step with
  floor_bound_frac f cannot be sped up more than (1-f)x by reformulating
  the non-gather phases.

Row counts per phase:
- plane-sweep warp (``models/mvs.py::_variance_cost_volume`` over
  ``ops/warp.py::homo_warp``): one gather row of C channels per (source
  view, depth plane, output pixel); the backward is the same count of
  scatter-add rows into the source map.  The port gathers whole rows and
  has no ``warp_pack_factor`` (the JAX package packs 4 pixels of its
  8-channel stage into one 128-lane row on the TPU): its count is the JAX
  package's times that factor.
- featurization (``render/fast_feats.py``): one row per (sample point,
  source view) covering the 11 channels (3 rgb + 8 img_feat);
  cost-volume column gathers are one row per (ray, stage) -- negligible
  next to the per-point rows but counted.
"""

from __future__ import annotations

import os
from typing import Dict

# the card's marginal ns per row, measured by chip_smoke.py phase
# ``accounting`` on an "NVIDIA H100 80GB HBM3, 700.00 W": 16-channel f32
# rows, 4M and 8M random indices into a 128x160 source map; the gather
# ``table[idx]`` reads 0.60 ns at 8, 16 and 32 channels alike (PyTorch's
# index kernel), ``index_add_`` 0.06 / 0.12 / 0.24 ns
GATHER_NS_PER_ROW = 0.60
SCATTER_NS_PER_ROW = 0.12

# H100 SXM (80GB HBM3, 700 W) dense bf16 tensor-core rate; override for
# other cards via UCNERF_PEAK_TFLOPS
PEAK_TFLOPS = float(os.environ.get("UCNERF_PEAK_TFLOPS", 989.0))
# H100 SXM FP32 rate outside the tensor cores, and its dense TF32
# tensor-core rate (NVIDIA's H100 SXM datasheet)
PEAK_TFLOPS_F32 = 67.0
PEAK_TFLOPS_TF32 = 494.7

# H100 SXM HBM3 bandwidth; override via UCNERF_PEAK_HBM_GBPS
PEAK_HBM_GBPS = float(os.environ.get("UCNERF_PEAK_HBM_GBPS", 3350.0))


def _conv2d(cin: int, cout: int, k: int, n_px: int, kw: int = None) -> float:
    return 2.0 * k * (kw if kw is not None else k) * cin * cout * n_px


def _conv3d(cin: int, cout: int, k: int, n_vox: int) -> float:
    return 2.0 * k ** 3 * cin * cout * n_vox


def _dense(cin: int, cout: int, n: int) -> float:
    return 2.0 * cin * cout * n


def featurenet_flops(H: int, W: int, bc: int = 8) -> float:
    """FPN forward for ONE view (``models/mvs.py::FeatureNet``)."""
    full, half, quart = H * W, (H // 2) * (W // 2), (H // 4) * (W // 4)
    f = 0.0
    f += _conv2d(3, bc, 3, full) + _conv2d(bc, bc, 3, full)
    f += _conv2d(bc, 2 * bc, 5, half) + 2 * _conv2d(2 * bc, 2 * bc, 3, half)
    f += (_conv2d(2 * bc, 4 * bc, 5, quart)
          + 2 * _conv2d(4 * bc, 4 * bc, 3, quart))
    f += _conv2d(4 * bc, 4 * bc, 1, quart)          # out1
    f += _conv2d(2 * bc, 4 * bc, 1, half)           # inner1
    f += _conv2d(4 * bc, 2 * bc, 3, half)           # out2
    f += _conv2d(bc, 4 * bc, 1, full)               # inner2
    f += _conv2d(4 * bc, bc, 3, full)               # out3
    return f


def costreg_flops(D: int, H: int, W: int, cin: int, bc: int = 8) -> float:
    """3D U-Net forward for one stage volume [D, H, W, cin]
    (``models/mvs.py::CostRegNet``; depth-folding changes the lowering,
    not the mathematical FLOPs)."""
    n = D * H * W
    n2, n4, n8 = n // 8, n // 64, n // 512
    f = _conv3d(cin, bc, 3, n)
    f += _conv3d(bc, 2 * bc, 3, n2) + _conv3d(2 * bc, 2 * bc, 3, n2)
    f += _conv3d(2 * bc, 4 * bc, 3, n4) + _conv3d(4 * bc, 4 * bc, 3, n4)
    f += _conv3d(4 * bc, 8 * bc, 3, n8) + _conv3d(8 * bc, 8 * bc, 3, n8)
    f += _conv3d(8 * bc, 4 * bc, 3, n4)             # deconvs: priced at
    f += _conv3d(4 * bc, 2 * bc, 3, n2)             # output voxel count
    f += _conv3d(2 * bc, bc, 3, n)
    f += _conv3d(bc, 1, 3, n)                       # prob head
    return f


def _stage_dims(cfg, H: int, W: int):
    """(D, H_s, W_s, C_feat) per cascade stage (scales 4/2/1, channels
    32/16/8, ``models/mvs.py``)."""
    chans = (32, 16, 8)
    out = []
    for si, D in enumerate(cfg.ndepths):
        scale = 2 ** (len(cfg.ndepths) - 1 - si)
        hs, ws = H // scale, W // scale
        if si == len(cfg.ndepths) - 1 and cfg.pad:
            hs, ws = hs + 2 * cfg.pad, ws + 2 * cfg.pad
        out.append((D, hs, ws, chans[si]))
    return out


def mvs_forward_flops(cfg, H: int, W: int) -> float:
    """Cascade forward: (V-1) FPN views + 3 CostRegNets."""
    f = (cfg.view_num - 1) * featurenet_flops(H, W)
    for (D, hs, ws, C) in _stage_dims(cfg, H, W):
        f += costreg_flops(D, hs, ws, C)
    return f


def nerf_mlp_flops(cfg, n_pts: int) -> float:
    """UC-NeRF MLP forward for n_pts sample points
    (``models/nerf.py``; dims from the reference ``network/models.py:87-91``)."""
    Wd = 128
    v1 = cfg.view_num - 1
    pts_ch = 3 + 3 * 2 * cfg.multires            # 63
    dir_ch = 3 + 3 * 2 * cfg.multires_views      # 27
    f = _dense(24 + 4 * v1, Wd, n_pts)           # pts_bias_depth_fine
    f += _dense(8 * v1, Wd, n_pts)               # pts_bias_confidence
    f += _dense(pts_ch, Wd, n_pts)               # trunk layer 0
    for i in range(1, cfg.netdepth):
        cin = Wd + (pts_ch if (i - 1) in cfg.skips else 0)
        f += _dense(cin, Wd, n_pts)
    f += _dense(Wd, 3, n_pts) + _dense(Wd, 1, n_pts)   # base heads
    f += _dense(Wd, Wd, n_pts)                   # feature_linear
    h1 = Wd + dir_ch
    f += 2 * (_dense(h1, Wd // 2, n_pts))        # views / view_confi
    f += _dense(Wd // 2, 3, n_pts) + _dense(Wd // 2, 1, n_pts)
    return f


def f32_matmul_seconds(flops: float) -> float:
    """The least time the card takes for ``flops`` of matmul at f32
    accuracy: the least of the FMA route (at PEAK_TFLOPS_F32) and the
    3xTF32 route, three TF32 products per product on the tensor cores (at
    PEAK_TFLOPS_TF32), which K1's f32 kernel takes."""
    return min(flops / (PEAK_TFLOPS_F32 * 1e12),
               3.0 * flops / (PEAK_TFLOPS_TF32 * 1e12))


def nerf_mlp_bytes(cfg, n_rays: int, n_samples: int,
                   weight_bytes: int) -> float:
    """Bytes one MLP call must move: pts [P, 3], dirs [n_rays, 3] and
    feats [P, feat_dim] read, raw [P, 4] written (f32), the packed weights
    read once."""
    P = n_rays * n_samples
    return (4.0 * (P * 3 + n_rays * 3 + P * cfg.feat_dim + P * 4)
            + weight_bytes)


def train_step_flops(cfg, H: int, W: int) -> float:
    """One train step's matmul/conv FLOPs: forward + backward (2x)."""
    fwd = (mvs_forward_flops(cfg, H, W)
           + nerf_mlp_flops(cfg, cfg.n_train_rays * cfg.N_samples))
    return 3.0 * fwd


def eval_frame_flops(cfg, H: int, W: int) -> float:
    """Full-frame eval render: cascade forward + MLP over H*W rays."""
    return (mvs_forward_flops(cfg, H, W)
            + nerf_mlp_flops(cfg, H * W * cfg.N_samples))


def warp_rows(cfg, H: int, W: int) -> float:
    """Plane-sweep warp gather rows for one cascade forward: one row of C
    channels per (source view, plane, pixel); no pack factor."""
    return float(sum((cfg.view_num - 1) * D * hs * ws
                     for (D, hs, ws, C) in _stage_dims(cfg, H, W)))


def feat_rows(cfg, n_rays: int) -> float:
    """Featurization gather rows: one row per (point, view) + one
    cost-volume column row per (ray, stage)."""
    return (n_rays * cfg.N_samples * (cfg.view_num - 1)
            + n_rays * len(cfg.ndepths))


# ------------------------------------------------------------ HBM traffic
# Analytic byte counts for the NON-gather, NON-matmul-bound work: volume
# elementwise (variance accumulation, softmax/regression, depth-range
# resampling) and conv ACTIVATION traffic (the cascade's small-channel
# convs are bandwidth-, not FLOP-, limited: e.g. a folded 3x3 conv at
# C=8..64 moves far more activation bytes per FLOP than the tensor
# cores' ridge point).  Each conv layer is priced at one read of its input + one write
# of its output (+BN/relu fused); the variance path at one read per
# warped view + accumulator traffic.  This is a LOWER bound on traffic
# (no re-reads, perfect fusion), so ``bw_ms`` is the bandwidth floor of
# those phases the way ``floor_ms`` is the issue floor of the gathers.


def _conv_bytes(n_px: int, cin: int, cout: int) -> float:
    return 4.0 * n_px * (cin + cout)


def featurenet_bytes(H: int, W: int, bc: int = 8) -> float:
    """FPN activation traffic for ONE view (mirrors featurenet_flops)."""
    full, half, quart = H * W, (H // 2) * (W // 2), (H // 4) * (W // 4)
    t = _conv_bytes(full, 3, bc) + _conv_bytes(full, bc, bc)
    t += _conv_bytes(half, bc, 2 * bc) + 2 * _conv_bytes(half, 2 * bc,
                                                         2 * bc)
    t += (_conv_bytes(quart, 2 * bc, 4 * bc)
          + 2 * _conv_bytes(quart, 4 * bc, 4 * bc))
    t += _conv_bytes(quart, 4 * bc, 4 * bc)          # out1 1x1
    t += _conv_bytes(half, 2 * bc, 4 * bc)           # inner1
    t += _conv_bytes(half, 4 * bc, 2 * bc)           # out2
    t += _conv_bytes(full, bc, 4 * bc)               # inner2
    t += _conv_bytes(full, 4 * bc, bc)               # out3
    t += 4.0 * (half * 4 * bc + full * 4 * bc)       # upsample-add reads
    return t


def costreg_bytes(D: int, H: int, W: int, cin: int, bc: int = 8) -> float:
    """3D U-Net activation traffic for one stage volume (mirrors
    costreg_flops; depth-folding changes the lowering, not the bytes)."""
    n = D * H * W
    n2, n4, n8 = n // 8, n // 64, n // 512
    t = _conv_bytes(n, cin, bc)
    t += _conv_bytes(n2, bc, 2 * bc) + _conv_bytes(n2, 2 * bc, 2 * bc)
    t += _conv_bytes(n4, 2 * bc, 4 * bc) + _conv_bytes(n4, 4 * bc, 4 * bc)
    t += _conv_bytes(n8, 4 * bc, 8 * bc) + _conv_bytes(n8, 8 * bc, 8 * bc)
    t += _conv_bytes(n4, 8 * bc, 4 * bc)             # deconvs at output vox
    t += _conv_bytes(n2, 4 * bc, 2 * bc)
    t += _conv_bytes(n, 2 * bc, bc)
    t += _conv_bytes(n, bc, 1)                       # prob head
    t += 4.0 * 2 * (n4 * 4 * bc + n2 * 2 * bc + n * bc)  # skip-adds
    return t


def variance_bytes(cfg, D: int, hs: int, ws: int, C: int) -> float:
    """Plane-sweep variance accumulation for one stage: read each view's
    warped volume once + mean/sq-mean accumulator traffic + the in-bounds
    count plane."""
    vol = D * hs * ws
    V1 = cfg.view_num - 1
    reads = V1 * vol * C * 4.0                # warped feature volumes
    acc = 4.0 * vol * C * 4.0                 # mean+sq accumulate+finalize
    mask = V1 * vol * 4.0                     # in-bounds counts
    return reads + acc + mask


def softmax_regression_bytes(D: int, hs: int, ws: int) -> float:
    """Prob-volume softmax (max, exp-sum, normalize) + expectation depth +
    4-bin confidence: ~6 passes over the [D, hs, ws] volume."""
    return 6.0 * D * hs * ws * 4.0


def mvs_forward_bytes(cfg, H: int, W: int) -> float:
    """Cascade forward HBM traffic EXCLUDING the warp gathers (priced by
    the issue floor, not bandwidth)."""
    t = (cfg.view_num - 1) * featurenet_bytes(H, W)
    for (D, hs, ws, C) in _stage_dims(cfg, H, W):
        t += variance_bytes(cfg, D, hs, ws, C)
        t += costreg_bytes(D, hs, ws, C)
        t += softmax_regression_bytes(D, hs, ws)
        t += 3.0 * D * hs * ws * 4.0          # depth-range resampling
    return t


def train_step_bytes(cfg, H: int, W: int) -> float:
    """Train-step traffic of the bandwidth-priced phases: forward +
    backward (the backward re-reads activations and writes cotangents —
    priced 2x forward, the same convention as train_step_flops)."""
    return 3.0 * mvs_forward_bytes(cfg, H, W)


def train_bw_seconds(cfg, H: int, W: int) -> float:
    return train_step_bytes(cfg, H, W) / (PEAK_HBM_GBPS * 1e9)


def eval_bw_seconds(cfg, H: int, W: int) -> float:
    return mvs_forward_bytes(cfg, H, W) / (PEAK_HBM_GBPS * 1e9)


def train_floor_seconds(cfg, H: int, W: int) -> float:
    """Issue-floor seconds of the train step's gather/scatter phases:
    warp + featurization rows forward (gathers) and backward
    (scatter-adds into the source maps)."""
    rows = warp_rows(cfg, H, W) + feat_rows(cfg, cfg.n_train_rays)
    return rows * (GATHER_NS_PER_ROW + SCATTER_NS_PER_ROW) * 1e-9


def eval_floor_seconds(cfg, H: int, W: int) -> float:
    """Issue-floor seconds of the eval frame (forward only)."""
    rows = warp_rows(cfg, H, W) + feat_rows(cfg, H * W)
    return rows * GATHER_NS_PER_ROW * 1e-9


def perf_accounting(cfg, H: int, W: int, train_step_s: float,
                    eval_frame_s: float,
                    warp_fwd_bwd_s: float = None,
                    feat_fwd_s: float = None) -> Dict:
    """The fields backing MFU / floor / bandwidth claims.

    The three denominators cover disjoint op families, so their sum is the
    explained wall time and ``residual_ms`` the unexplained remainder
    (a step is explained when the residual is small or the remainder is
    certified with a measured per-phase map):
    - ``floor_ms``: gather/scatter rows at the card's measured issue floors;
    - ``matmul_ms``: counted conv/matmul FLOPs at the peak bf16 rate;
    - ``bw_ms``: volume-elementwise + conv-activation bytes at peak HBM
      bandwidth (conv layers appear in BOTH matmul and bw terms — the true
      per-op bound is the max, so summing the two denominators slightly
      OVERSTATES explained time for the few layers that are genuinely
      matmul-bound; at these channel widths nearly all cascade convs are
      bandwidth-bound, making the overlap a second-order effect).
    Since independent op families overlap in the schedule, a small or even
    negative residual means "fully attributed", not "0 ms of slack".

    ``warp_fwd_bwd_s`` / ``feat_fwd_s``: optionally, MEASURED seconds of
    the isolated warp+variance fwd+bwd phase (train) and the featurization
    gather phase (render) -- reported as achieved ns/row against the
    gather / scatter floors (overlap efficiency; 1.0 = at the floor).
    With a floor of 0 (not measured) its efficiency reads 0.
    """
    t_fl = train_step_flops(cfg, H, W)
    e_fl = eval_frame_flops(cfg, H, W)
    t_floor = train_floor_seconds(cfg, H, W)
    e_floor = eval_floor_seconds(cfg, H, W)
    t_bw = train_bw_seconds(cfg, H, W)
    e_bw = eval_bw_seconds(cfg, H, W)
    t_mm = t_fl / (PEAK_TFLOPS * 1e12)
    e_mm = e_fl / (PEAK_TFLOPS * 1e12)
    out = {
        "train_tflops_per_step": round(t_fl / 1e12, 4),
        "train_achieved_tflops": round(t_fl / train_step_s / 1e12, 2),
        "train_mfu": round(t_fl / train_step_s / (PEAK_TFLOPS * 1e12), 4),
        "train_floor_ms": round(t_floor * 1e3, 1),
        "train_floor_bound_frac": round(t_floor / train_step_s, 3),
        "train_matmul_ms": round(t_mm * 1e3, 1),
        "train_bw_ms": round(t_bw * 1e3, 1),
        "train_bw_bound_frac": round(t_bw / train_step_s, 3),
        "train_residual_ms": round(
            (train_step_s - t_floor - t_mm - t_bw) * 1e3, 1),
        "render_tflops_per_frame": round(e_fl / 1e12, 4),
        "render_achieved_tflops": round(e_fl / eval_frame_s / 1e12, 2),
        "render_mfu": round(e_fl / eval_frame_s / (PEAK_TFLOPS * 1e12), 4),
        "render_floor_ms": round(e_floor * 1e3, 1),
        "render_floor_bound_frac": round(e_floor / eval_frame_s, 3),
        "render_matmul_ms": round(e_mm * 1e3, 1),
        "render_bw_ms": round(e_bw * 1e3, 1),
        "render_bw_bound_frac": round(e_bw / eval_frame_s, 3),
        "render_residual_ms": round(
            (eval_frame_s - e_floor - e_mm - e_bw) * 1e3, 1),
        "peak_tflops": PEAK_TFLOPS,
        "peak_hbm_gbps": PEAK_HBM_GBPS,
        "floor_ns_per_row": [GATHER_NS_PER_ROW, SCATTER_NS_PER_ROW],
    }
    achieved = {}
    if warp_fwd_bwd_s is not None:
        rows = warp_rows(cfg, H, W)
        ns = warp_fwd_bwd_s * 1e9 / rows
        achieved["warp_fwd_bwd"] = round(ns, 2)
        achieved["warp_overlap_eff"] = round(
            (GATHER_NS_PER_ROW + SCATTER_NS_PER_ROW) / ns, 3)
        # residual against the MEASURED warp phase (not its floor): the
        # train step's other gather family (featurization rows fwd+bwd)
        # stays floor-priced — it is a small term
        t_feat_floor = (feat_rows(cfg, cfg.n_train_rays)
                        * (GATHER_NS_PER_ROW + SCATTER_NS_PER_ROW) * 1e-9)
        out["train_residual_vs_measured_ms"] = round(
            (train_step_s - warp_fwd_bwd_s - t_feat_floor - t_mm - t_bw)
            * 1e3, 1)
    if feat_fwd_s is not None:
        rows = feat_rows(cfg, H * W)
        ns = feat_fwd_s * 1e9 / rows
        achieved["featurization_fwd"] = round(ns, 2)
        achieved["featurization_overlap_eff"] = round(
            GATHER_NS_PER_ROW / ns, 3)
        # frame residual vs the MEASURED featurization phase; the cascade
        # forward's warp gathers stay floor-priced (forward only)
        e_warp_floor = warp_rows(cfg, H, W) * GATHER_NS_PER_ROW * 1e-9
        out["render_residual_vs_measured_ms"] = round(
            (eval_frame_s - feat_fwd_s - e_warp_floor - e_mm - e_bw) * 1e3,
            1)
    if achieved:
        out["achieved_ns_per_row"] = achieved
    return out
