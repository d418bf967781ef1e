"""Kernel K1: the fused NeRF MLP forward, hand-written in CUDA for Hopper.

Replaces ``ucnerf_tpu/pallas/mlp_kernel.py::fused_nerf_mlp``.  The kernel
(``csrc/fused_mlp.cu``) is bound by its arithmetic (about 720 FLOP per
input byte at V=7): bf16 runs on the tensor cores with f32 accumulation,
f32 on FMA for parity.  Its weights do not fit a block's shared memory, so
they stream through it one layer at a time and stay in L2 across blocks;
a tile's activations never leave shared memory.  See the source's header.

On a CPU tensor the wrapper runs the plain version (``models.nerf``); on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from ucnerf_torch.kernels import build
from ucnerf_torch.models.nerf import UCNeRFMLP

# weight order of the JAX package's pack_mlp_weights (and of the kernel)
LAYER_NAMES = ["pts_bias_depth_fine", "pts_bias_confidence",
               "pts_linears_0", "pts_linears_1", "pts_linears_2",
               "pts_linears_3", "pts_linears_4", "pts_linears_5",
               "confi_rgb_linear", "alpha_linear_1", "feature_linear",
               "views_linears_0", "rgb_linear", "view_confi_linears_0",
               "alpha_linear"]
PE_PTS, PE_PTS_PAD = 63, 64


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def layer_blocks(mlp: UCNeRFMLP) -> List[Tuple[str, torch.Tensor,
                                               torch.Tensor]]:
    """(name, kernel [in, out], bias [out]) per layer in ``LAYER_NAMES``
    order, unpadded, float32."""
    nerf = mlp.nerf
    out = []
    for name in LAYER_NAMES:
        if name.startswith("pts_linears_"):
            layer = nerf.pts_linears[int(name.rsplit("_", 1)[1])]
        elif name in ("views_linears_0", "view_confi_linears_0"):
            layer = getattr(nerf, name[:-2])[0]
        else:
            layer = getattr(nerf, name)
        out.append((name, layer.weight.detach().float().T,
                    layer.bias.detach().float()))
    return out


def _pad_block(name: str, w: torch.Tensor, b: torch.Tensor):
    """Zero-pad a [K, N] block to multiples of 16.  pts_linears_5's input
    is [pe(pts) 63 | h 128], which the kernel holds as [pe 63 | 0 | h 128]:
    its zero row goes in at row 63, not at the end."""
    K, N = w.shape
    Kp, Np = _round16(K), _round16(N)
    wp = w.new_zeros((Kp, Np))
    if name == "pts_linears_5":
        wp[:PE_PTS, :N] = w[:PE_PTS]
        wp[PE_PTS_PAD:PE_PTS_PAD + K - PE_PTS, :N] = w[PE_PTS:]
    else:
        wp[:K, :N] = w
    bp = b.new_zeros(Np)
    bp[:N] = b
    return wp, bp


class PackedMLP(NamedTuple):
    weights: torch.Tensor      # flat, bf16 or f32
    biases: torch.Tensor       # flat f32
    table: ctypes.Array        # (K, N, w_off, b_off) per layer
    use_bf16: bool
    view_num: int
    plain: UCNeRFMLP           # the plain version, for CPU tensors


def pack_mlp_weights(mlp: UCNeRFMLP) -> PackedMLP:
    """Pad and pack a ``UCNeRFMLP``'s 15 layers for the kernel, in its
    compute dtype (``mlp.nerf.dtype``: bf16, or None for f32)."""
    nerf = mlp.nerf
    if (nerf.width, nerf.depth, nerf.skips, mlp.multires,
            mlp.multires_views) != (128, 6, (4,), 10, 4):
        raise ValueError("the fused MLP kernel takes width 128, depth 6, "
                         "skips (4,), multires 10/4")
    v1 = nerf.view_num - 1
    if _round16(24 + 4 * v1) > 128 or _round16(8 * v1) > 128:
        raise ValueError(f"the fused MLP kernel takes view_num <= 17, got "
                         f"{nerf.view_num}")
    use_bf16 = nerf.dtype == torch.bfloat16
    ws, bs, table = [], [], []
    w_off = b_off = 0
    for name, w, b in layer_blocks(mlp):
        wp, bp = _pad_block(name, w, b)
        table += [wp.shape[0], wp.shape[1], w_off, b_off]
        w_off += wp.numel()
        b_off += bp.numel()
        ws.append(wp.reshape(-1))
        bs.append(bp)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    return PackedMLP(torch.cat(ws).to(dtype).contiguous(),
                     torch.cat(bs).contiguous(),
                     (ctypes.c_int * len(table))(*table), use_bf16,
                     nerf.view_num, mlp)


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    lib = build.load("fused_mlp")
    fn = lib.ucnerf_fused_mlp_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_nerf_mlp(pts, dirs, feats, packed: PackedMLP):
    """pts [N, S, 3], dirs [N, 3], feats [N, S, F] float32 -> raw [N, S, 4].

    CPU tensors: the plain version.  CUDA tensors: the kernel, counted in
    ``fused_nerf_mlp.launches``."""
    devices = {t.device for t in (pts, dirs, feats, packed.weights)}
    if len(devices) != 1:
        raise ValueError(f"fused_nerf_mlp: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return packed.plain(pts, dirs, feats)
    if dev.type != "cuda":
        raise ValueError(f"fused_nerf_mlp: unsupported device {dev}")
    N, S = pts.shape[:2]
    F = feats.shape[-1]
    v1 = packed.view_num - 1
    if (pts.shape != (N, S, 3) or dirs.shape != (N, 3)
            or feats.shape != (N, S, 24 + 12 * v1 + 1)):
        raise ValueError(f"fused_nerf_mlp: shapes pts {tuple(pts.shape)}, "
                         f"dirs {tuple(dirs.shape)}, feats "
                         f"{tuple(feats.shape)} at view_num "
                         f"{packed.view_num}")
    for t in (pts, dirs, feats):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_nerf_mlp takes contiguous float32 inputs")
    if N * S >= 2 ** 31 // max(F, 4):
        raise ValueError("fused_nerf_mlp: too many points for int32 offsets")
    out = torch.empty((N, S, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_lib()(
            pts.data_ptr(), dirs.data_ptr(), feats.data_ptr(),
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            out.data_ptr(), N * S, S, F, v1,
            ctypes.cast(packed.table, ctypes.c_void_p), int(packed.use_bf16),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_nerf_mlp: kernel launch failed with CUDA "
                           f"error {err}")
    fused_nerf_mlp.launches += 1
    return out


fused_nerf_mlp.launches = 0


class FusedNeRFMLP:
    """The MLP callable of the render path: packs a ``UCNeRFMLP`` once and
    calls ``fused_nerf_mlp`` per ray tile."""

    def __init__(self, mlp: UCNeRFMLP):
        self.packed = pack_mlp_weights(mlp)

    def __call__(self, pts, dirs, feats):
        return fused_nerf_mlp(pts, dirs, feats, self.packed)
