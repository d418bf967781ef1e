"""K1's float32 mode on the CPU, without a card or JAX: the packing's
m16n8k8 tf32 B-fragment order with the rows of each group of 8 permuted,
its split of each weight into tf32 big and small (3xTF32), and an
emulation of the kernel's dataflow held to the plain f32 ``UCNeRFMLP``.
The emulation reads each weight where the kernel's lanes read it
(``csrc/fused_mlp.cu::f32::mma_ktile``), so the packing, the kernel's
addressing and its A-fragment order are checked together; the card
itself holds the kernel to the plain MLP (``test_torch_kernels.py``)."""

import numpy as np
import torch
import torch.nn.functional as F

from ucnerf_torch.config import Config
from ucnerf_torch.kernels.fused_mlp import (WEIGHT_STEPS, kernel_rows,
                                            layer_blocks, merge_block,
                                            pack_mlp_weights,
                                            shuffle_tf32_fragments,
                                            split_tf32,
                                            unshuffle_tf32_fragments)
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.ops.pe import positional_encoding

torch.set_num_threads(1)

# input column of each logical k of a k-tile: the A fragment's k = t and
# t + 4 are the accumulator lane's columns 2 t and 2 t + 1
PHYS = [0, 2, 4, 6, 1, 3, 5, 7]


def _fragments(flat, off, K, N):
    """The [K, N] block's big and small parts as the kernel's lanes read
    them, rows in logical order: k-tile kt starts at float off + kt (N / 8)
    128; lane 4 g + t takes (b0 big, b1 big, b0 small, b1 small) of n-tile
    nt from float4 nt 32 + lane; PTX's m16n8k8 tf32 B fragment puts b0 at
    (k, n) = (t, g) and b1 at (t + 4, g)."""
    kt, nt, lane, part, kl = np.meshgrid(
        np.arange(K // 8), np.arange(N // 8), np.arange(32), np.arange(2),
        np.arange(2), indexing="ij")
    g, t = lane // 4, lane % 4
    addr = off + kt * (N // 8) * 128 + (nt * 32 + lane) * 4 + part * 2 + kl
    out = torch.full((2, K, N), float("nan"))
    out[part, 8 * kt + t + 4 * kl, 8 * nt + g] = flat[torch.from_numpy(addr)]
    return out.unbind(0)


def _rows_permuted(w):
    K = w.shape[0]
    return w[(8 * np.arange(K // 8)[:, None] + PHYS).reshape(-1)]


def _tf32_read(x):
    """What the tensor core reads of an f32 register: its top 11
    significant bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mlps(view_num):
    cfg = Config(view_num=view_num)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return create_models(cfg.replace(nerf_dtype="float32"), "cpu",
                         params)[0], cfg


def _assert_equal(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tf32_fragment_order_round_trips():
    """Each packed f32 block, read where the kernel's lanes read it, is the
    big and small parts of its zero-padded [K, N] block with each group of
    8 rows permuted; ``unshuffle_tf32_fragments`` gives both back bit for
    bit; an arange block pins the order itself."""
    K, N = 24, 16
    w = torch.arange(K * N, dtype=torch.float32).reshape(K, N) * 1.001
    flat = shuffle_tf32_fragments(w)
    big, small = split_tf32(w)
    assert small.any()
    for got, want in zip(_fragments(flat, 0, K, N), (big, small)):
        _assert_equal(got, _rows_permuted(want))
    for got, want in zip(unshuffle_tf32_fragments(flat, K, N), (big, small)):
        _assert_equal(got, want)
    for view_num in (7, 4):
        mlp, _ = _mlps(view_num)
        pk = pack_mlp_weights(mlp)
        assert not pk.use_bf16 and pk.weights.dtype == torch.float32
        layers = {name: (kernel_rows(name, w), b)
                  for name, w, b in layer_blocks(mlp)}
        table = np.asarray(list(pk.table)).reshape(len(WEIGHT_STEPS), 4)
        for parts, (K, N, wo, bo) in zip(WEIGHT_STEPS, table):
            want, bias = merge_block([(*layers[name], r)
                                      for name, r in parts], 8)
            assert (K, N) == want.shape and wo % 16 == 0 and bo % 2 == 0
            big, small = split_tf32(want)
            for got, part in zip(_fragments(pk.weights, wo, K, N),
                                 (big, small)):
                _assert_equal(got, _rows_permuted(part))
            got = unshuffle_tf32_fragments(pk.weights[wo:wo + 2 * K * N],
                                           K, N)
            _assert_equal(got[0] + got[1], want)
            _assert_equal(pk.biases[bo:bo + N], bias)
        assert table[-1, 2] + 2 * table[-1, 0] * table[-1, 1] \
            == pk.weights.numel()


def test_tf32_split_is_exact():
    """big keeps 11 significant bits (the low 13 mantissa bits clear), big
    + small is each value exactly in f32, and what the tensor core reads
    of the two parts is within 2^-21 of the value: on the packed weights
    (split on the host) and on seeded activations over 12 decades (split
    by the same bit rounding in the kernel)."""
    mlp, _ = _mlps(7)
    pk = pack_mlp_weights(mlp)
    table = np.asarray(list(pk.table)).reshape(len(WEIGHT_STEPS), 4)
    rng = np.random.default_rng(0)
    acts = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(
        -6, 6, 4096)).astype(np.float32))
    cases = [(*unshuffle_tf32_fragments(pk.weights[wo:wo + 2 * K * N], K,
                                        N), None)
             for K, N, wo, _ in table]
    cases.append((*split_tf32(acts), acts))
    for big, small, x in cases:
        x = big + small if x is None else x
        assert not (big.view(torch.int32) & 0x1FFF).any()
        assert torch.equal(big + small, x)
        assert (small.abs() <= x.abs() * 2.0 ** -11).all()
        read = big.double() + _tf32_read(small).double()
        assert ((read - x.double()).abs()
                <= x.abs().double() * 2.0 ** -21).all()
    # the packed weights' small parts are the f32 remainders of the
    # layers' own weights
    by_name = {name: w for name, w, _ in layer_blocks(mlp)}
    w = by_name["pts_linears_1"]
    big, small = unshuffle_tf32_fragments(
        pk.weights[table[2, 2]:table[2, 2] + 2 * 128 * 128], 128, 128)
    _assert_equal(big + small, w)


def _emulate(pk, pts, dirs, feats):
    """The f32 kernel's dataflow on whole tensors: each block's weights
    read as the lanes read them (split into big and small on the host),
    A's columns in the fragments' permuted order and split by the same bit
    rounding, and per k-tile
    the three products a_small b_big, a_big b_small, a_big b_big summed,
    then added to an accumulator that starts at the bias."""
    table = np.asarray(list(pk.table)).reshape(len(WEIGHT_STEPS), 4)
    blocks = [(_fragments(pk.weights, wo, K, N), pk.biases[bo:bo + N])
              for K, N, wo, bo in table]
    n, s = pts.shape[:2]
    P = n * s
    x, f = pts.reshape(P, 3), feats.reshape(P, -1)
    d = dirs[:, None].expand(n, s, 3).reshape(P, 3)
    v1 = pk.view_num - 1
    cdb, cfb = 24 + 4 * v1, 8 * v1

    def dense(i, a):
        (wb, ws), bias = blocks[i]
        a = F.pad(a, (0, wb.shape[0] - a.shape[1]))
        acc = bias.expand(P, -1).clone()
        for kt in range(wb.shape[0] // 8):
            ab, as_ = split_tf32(a[:, [8 * kt + c for c in PHYS]])
            bb, bs = wb[8 * kt:8 * kt + 8], ws[8 * kt:8 * kt + 8]
            acc = acc + (_tf32_read(as_) @ bb + ab @ _tf32_read(bs)
                         + ab @ bb)
        return acc

    pe_pts = positional_encoding(x, 10)
    pe_dirs = positional_encoding(d, 4)
    db = dense(0, f[:, :cdb])
    h = torch.relu(dense(1, pe_pts) * db)
    for i in range(2, 6):
        h = torch.relu(dense(i, h) * db)
    h = torch.relu(dense(6, torch.cat([F.pad(pe_pts, (0, 1)), h], 1)) * db)
    base = dense(7, h)
    h = h * dense(8, f[:, cdb:cdb + cfb])
    h = torch.relu(dense(10, torch.cat([dense(9, h), pe_dirs], 1)))
    adapt = dense(11, h)
    u = 1.0 - f[:, -1:]
    rgb = torch.sigmoid(base[:, :3] * (1 - u) + adapt[:, :3] * u)
    alpha = torch.relu(adapt[:, 3:4] * (1 - u) + base[:, 3:4] * u)
    return torch.cat([rgb, alpha], 1).reshape(n, s, 4)


def test_emulated_dataflow_matches_plain_f32():
    """The emulation agrees with the plain f32 MLP at V=7 and V=4 on seeded
    inputs: within 1e-5 of each output, and of 1e-5 relative where an
    alpha exceeds 1.  Alpha is unbounded (up to 13.6 here), and there the
    plain f32 MLP is itself 6.3e-6 (V=7) and 2.3e-5 (V=4) off the float64
    MLP on these inputs, so an absolute 1e-5 would measure its rounding."""
    for view_num in (7, 4):
        mlp, cfg = _mlps(view_num)
        rng = np.random.default_rng(view_num)
        pts = rng.uniform(0, 1, (24, 11, 3))
        dirs = rng.standard_normal((24, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        feats = rng.standard_normal((24, 11, cfg.feat_dim))
        feats[..., -1] = rng.uniform(0, 1, (24, 11))
        x = [torch.as_tensor(a, dtype=torch.float32)
             for a in (pts, dirs, feats)]
        with torch.no_grad():
            want = mlp(*x)
            got = _emulate(pack_mlp_weights(mlp), *x)
        assert got.shape == want.shape
        err = (got - want).abs() / want.abs().clamp(min=1.0)
        assert err.max().item() <= 1e-5, (view_num, err.max().item())
