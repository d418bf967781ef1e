"""Kernel K1: the fused NeRF MLP forward, hand-written in CUDA for Hopper.

Replaces ``ucnerf_tpu/pallas/mlp_kernel.py::fused_nerf_mlp``.  The kernel
(``csrc/fused_mlp.cu``) is bound by its arithmetic (about 720 FLOP per
input byte at V=7).  bf16, the main path: mma.sync on the tensor cores
with f32 accumulation, each warp's 16 points held in registers for the
whole chain, 128 points per block sharing each pass over the weights,
which stream from L2 through a two-stage ring in shared memory (bulk
copies completed on mbarriers).
The packing here merges layers that share an input into 12 blocks and
stores each in mma.sync B-fragment order.  f32, for parity: FMA, weights
streamed one layer at a time.  See the source's header.

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
PE_PTS = 63
# the bf16 kernel's weight blocks, in its ring order: each is a list of
# (layer, first input row); the parts of a block sit side by side in its
# columns.  Three blocks merge layers that share an input, or (the last one,
# block-diagonal) that the kernel can multiply as one.
BF16_STEPS = [
    [("pts_bias_depth_fine", 0)],
    *([(f"pts_linears_{i}", 0)] for i in range(6)),
    [("confi_rgb_linear", 0), ("alpha_linear_1", 0)],
    [("pts_bias_confidence", 0)],
    [("feature_linear", 0)],
    [("views_linears_0", 0), ("view_confi_linears_0", 0)],
    [("rgb_linear", 0), ("alpha_linear", 64)],
]


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


def kernel_rows(name: str, w: torch.Tensor) -> torch.Tensor:
    """A layer's [K, N] kernel as the kernels index its input rows.
    pts_linears_5's input is [pe(pts) 63 | h 128], which the kernels hold
    as [pe 63 | 0 | h 128]: a zero row goes in at row 63."""
    if name != "pts_linears_5":
        return w
    return torch.cat([w[:PE_PTS], w.new_zeros((1, w.shape[1])), w[PE_PTS:]])


def merge_block(parts):
    """[(kernel [k, n], bias [n], first row)] -> one [K, N] block and its
    [N] bias, zero-padded to multiples of 16, parts side by side."""
    K = max(r + w.shape[0] for w, _, r in parts)
    N = sum(w.shape[1] for w, _, _ in parts)
    wp = parts[0][0].new_zeros((_round16(K), _round16(N)))
    bp = parts[0][1].new_zeros(_round16(N))
    col = 0
    for w, b, r in parts:
        wp[r:r + w.shape[0], col:col + w.shape[1]] = w
        bp[col:col + w.shape[1]] = b
        col += w.shape[1]
    return wp, bp


def shuffle_b_fragments(w: torch.Tensor) -> torch.Tensor:
    """A [K, N] block (multiples of 16) -> flat, in mma.sync m16n8k16
    B-fragment order: for each k-tile kt and pair of n-tiles np, 32 lanes x
    8 values, lane = 4 g + t holding (k, n) = (16 kt + 8 kh + 2 t + kl,
    16 np + 8 i + g) at 4 i + 2 kh + kl.  One 16-byte load gives a lane
    its B registers of both n-tiles."""
    K, N = w.shape
    return (w.reshape(K // 16, 2, 4, 2, N // 16, 2, 8)
            .permute(0, 4, 6, 2, 5, 1, 3).reshape(-1))


def unshuffle_b_fragments(flat: torch.Tensor, K: int, N: int):
    """The inverse of ``shuffle_b_fragments``: flat -> [K, N]."""
    return (flat.reshape(K // 16, N // 16, 8, 4, 2, 2, 2)
            .permute(0, 5, 3, 6, 1, 4, 2).reshape(K, N))


class PackedMLP(NamedTuple):
    weights: torch.Tensor      # flat, bf16 or f32
    biases: torch.Tensor       # flat f32
    table: ctypes.Array        # (K, N, w_off, b_off) per weight block
    use_bf16: bool
    view_num: int
    plain: UCNeRFMLP           # the plain version, for CPU tensors


def pack_mlp_weights(mlp: UCNeRFMLP) -> PackedMLP:
    """Pad and pack a ``UCNeRFMLP``'s 15 layers for the kernel, in its
    compute dtype (``mlp.nerf.dtype``: bf16, or None for f32).  f32: one
    row-major block per layer in ``LAYER_NAMES`` order.  bf16: the blocks
    of ``BF16_STEPS`` in B-fragment order (``shuffle_b_fragments``)."""
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
    layers = {name: (kernel_rows(name, w), b)
              for name, w, b in layer_blocks(mlp)}
    steps = (BF16_STEPS if use_bf16
             else [[(name, 0)] for name in LAYER_NAMES])
    ws, bs, table = [], [], []
    w_off = b_off = 0
    for parts in steps:
        wp, bp = merge_block([(*layers[name], r) for name, r in parts])
        table += [wp.shape[0], wp.shape[1], w_off, b_off]
        w_off += wp.numel()
        b_off += bp.numel()
        ws.append(shuffle_b_fragments(wp) if use_bf16 else wp.reshape(-1))
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


def kernel_attrs(use_bf16: bool, view_num: int) -> dict:
    """What one mode's launch uses on the current card at this view count:
    registers and local (stack or spill) bytes a thread, dynamic shared
    memory a block, blocks resident per SM, points per block."""
    fn = build.load("fused_mlp").ucnerf_fused_mlp_attrs
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(int(use_bf16), view_num - 1, out)
    if err != 0:
        raise RuntimeError(f"fused_nerf_mlp: CUDA error {err} reading the "
                           f"kernel's attributes")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "points_per_block"), out))


def fused_nerf_mlp(pts, dirs, feats, packed: PackedMLP):
    """pts [N, S, 3], dirs [N, 3], feats [N, S, F] float32 -> raw [N, S, 4].

    CPU tensors: the plain version.  CUDA tensors: the kernel, counted in
    ``fused_nerf_mlp.launches``.  Forward only: with grad enabled and an
    input or a weight of ``packed.plain`` that requires grad it raises, on
    either device, since its output would carry no gradient."""
    devices = {t.device for t in (pts, dirs, feats, packed.weights)}
    if len(devices) != 1:
        raise ValueError(f"fused_nerf_mlp: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if torch.is_grad_enabled() and (
            any(t.requires_grad for t in (pts, dirs, feats))
            or any(p.requires_grad for p in packed.plain.parameters())):
        raise RuntimeError(
            "fused_nerf_mlp has no backward: call it under torch.no_grad(), "
            "or run the plain models.nerf.UCNeRFMLP where gradients are "
            "needed (the train step does)")
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
    if feats.data_ptr() % 16:   # the kernel copies feats rows 16 bytes at once
        feats = feats.clone()
    if packed.weights.data_ptr() % 16 or packed.biases.data_ptr() % 16:
        raise ValueError("fused_nerf_mlp: packed weights and biases must be "
                         "16-byte aligned (the kernel copies them in bulk)")
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
    calls ``fused_nerf_mlp`` per ray tile.  The packed copy does not follow
    later updates of the module's weights: build a new one after training
    steps."""

    def __init__(self, mlp: UCNeRFMLP):
        self.packed = pack_mlp_weights(mlp)

    def __call__(self, pts, dirs, feats):
        return fused_nerf_mlp(pts, dirs, feats, self.packed)
