"""The benchmark's frozen arithmetic: the work a step or a frame needs,
counted from shapes, and the card's peaks.

Copied from the port's ``utils/accounting.py`` (its FLOP and byte math:
convolutions and matmuls only, ``2 * K * Cin * Cout * N`` each, a train
step three times its forward), with two deliberate changes:

- ``serve_frame_flops`` counts what a served frame computes: the three
  CostRegNets and the MLP over every sample.  The source views' FeatureNet
  runs once when the server starts, so it is left out (the port's
  ``eval_frame_flops`` counts it).
- ``k1_bound_seconds`` counts the MLP's work once, at the peak of the
  configuration's MLP precision (bf16 989, TF32 494.7 TFLOP/s), against
  its bytes at 3.35 TB/s.  The port's ``f32_matmul_seconds`` counts the
  three products of one route to f32 accuracy (3xTF32), so a better route
  would read above 100% of it.

Peaks: one NVIDIA H100 SXM (80GB HBM3) at its 700 W limit, dense rates
from NVIDIA's data sheet.  They are constants: no environment variable
moves the yardstick.
"""

from __future__ import annotations

PEAK_BF16 = 989.0e12           # FLOP/s, dense bf16 tensor cores
PEAK_TF32 = 494.7e12           # FLOP/s, dense TF32 tensor cores
PEAK_HBM = 3.35e12             # bytes/s
MLP_PEAK = {"bfloat16": PEAK_BF16, "float32": PEAK_TF32}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


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
    """UC-NeRF MLP forward for n_pts sample points (``models/nerf.py``;
    dims from the reference ``network/models.py:87-91``)."""
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


def nerf_mlp_bytes(cfg, n_rays: int, n_samples: int,
                   weight_bytes: int) -> float:
    """Bytes one MLP call must move: pts [P, 3], dirs [n_rays, 3] and
    feats [P, feat_dim] read, raw [P, 4] written (f32), the packed weights
    read once."""
    P = n_rays * n_samples
    feat_dim = 24 + 12 * (cfg.view_num - 1) + 1
    return (4.0 * (P * 3 + n_rays * 3 + P * feat_dim + P * 4)
            + weight_bytes)


def train_step_flops(cfg, H: int, W: int) -> float:
    """One train step's matmul/conv FLOPs: forward + backward (2x)."""
    fwd = (mvs_forward_flops(cfg, H, W)
           + nerf_mlp_flops(cfg, cfg.n_train_rays * cfg.N_samples))
    return 3.0 * fwd


def serve_frame_flops(cfg, H: int, W: int) -> float:
    """One served frame: the cascade after the cached FeatureNet (three
    CostRegNets) and the MLP over H*W rays of ``N_samples`` points."""
    return (sum(costreg_flops(D, hs, ws, C)
                for (D, hs, ws, C) in _stage_dims(cfg, H, W))
            + nerf_mlp_flops(cfg, H * W * cfg.N_samples))


def mlp_weight_count(cfg) -> int:
    """Weights and biases of the MLP (``models/nerf.py``)."""
    Wd = 128
    v1 = cfg.view_num - 1
    pts_ch = 3 + 3 * 2 * cfg.multires
    dir_ch = 3 + 3 * 2 * cfg.multires_views
    layers = [(24 + 4 * v1, Wd), (8 * v1, Wd), (pts_ch, Wd)]
    layers += [(Wd + (pts_ch if (i - 1) in cfg.skips else 0), Wd)
               for i in range(1, cfg.netdepth)]
    layers += [(Wd, 3), (Wd, 1), (Wd, Wd), (Wd + dir_ch, Wd // 2),
               (Wd + dir_ch, Wd // 2), (Wd // 2, 3), (Wd // 2, 1)]
    return sum(i * o + o for i, o in layers)


def k1_bound_seconds(cfg, n_rays: int, n_samples: int) -> float:
    """The least time the card takes for one MLP call over ``n_rays`` rays
    of ``n_samples`` points: the larger of its FLOPs at the MLP
    precision's peak and its bytes (inputs read once, the output written
    once, the weights in the MLP precision) at the HBM rate."""
    flops = nerf_mlp_flops(cfg, n_rays * n_samples)
    nbytes = nerf_mlp_bytes(cfg, n_rays, n_samples,
                            mlp_weight_count(cfg)
                            * DTYPE_BYTES[cfg.nerf_dtype])
    return max(flops / MLP_PEAK[cfg.nerf_dtype], nbytes / PEAK_HBM)
