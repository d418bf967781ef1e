"""ucnerf_torch's NeRF MLP (the plain version of kernel K1) and the kernel's
weight packing, against the JAX package (the kernel itself is held against
the plain version in test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.config import Config as JConfig
from ucnerf_tpu.models.factory import create_models as j_create_models
from ucnerf_tpu.pallas.mlp_kernel import _LAYER_NAMES, pack_mlp_weights
from ucnerf_tpu.utils.checkpoint_io import export_nerf_state_dict

from ucnerf_torch.config import Config
from ucnerf_torch.kernels.fused_mlp import (LAYER_NAMES, WEIGHT_STEPS,
                                            FusedNeRFMLP, fused_nerf_mlp,
                                            layer_blocks,
                                            pack_mlp_weights as t_pack,
                                            render_mlp,
                                            shuffle_b_fragments as t_shuffle,
                                            unshuffle_b_fragments,
                                            unshuffle_tf32_fragments)
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.utils.checkpoint_io import (jax_params_from_state_dict,
                                              nerf_state_dict_from_jax)

torch.set_num_threads(1)
# compile time, not run time, dominates these references on the CPU
JIT_QUICK = {"xla_backend_optimization_level": 0}

V, S = 5, 7


def _inputs(n, feat_dim, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, S, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    feats = rng.standard_normal((n, S, feat_dim)).astype(np.float32)
    feats[..., -1] = rng.uniform(0, 1, (n, S))
    return pts, dirs, feats


@pytest.fixture(scope="module")
def case():
    """The port's seeded MLP weights carried into the JAX params tree and
    the JAX MLP's outputs (f32 and bf16), computed once."""
    cfg = JConfig(view_num=V, N_samples=S)
    j_bf16, _ = j_create_models(cfg)
    j_f32, _ = j_create_models(cfg.replace(nerf_dtype="float32"))
    params = jax.tree.map(jnp.asarray, jax_params_from_state_dict({
        "nerf": init_params(Config(view_num=V, N_samples=S),
                            torch.Generator().manual_seed(0), "cpu")["nerf"]}
    )["nerf"])
    x33 = _inputs(33, cfg.feat_dim, 3)   # 33 * 7 points: not a tile multiple
    x16 = _inputs(16, cfg.feat_dim, 4)
    f32, bf16 = (jax.jit(m.apply, compiler_options=JIT_QUICK)
                 for m in (j_f32, j_bf16))
    out = dict(
        f32=np.asarray(f32({"params": params}, *x33)),
        truth16=np.asarray(f32({"params": params}, *x16)),
        flax_bf16=np.asarray(bf16({"params": params}, *x16)))
    packed = [np.asarray(a) for a in pack_mlp_weights(params, jnp.float32)]
    return dict(params=jax.tree.map(np.asarray, params), x33=x33, x16=x16,
                packed=packed, **out)


def _port_mlp(case, dtype="float32"):
    sd = nerf_state_dict_from_jax(case["params"])
    cfg = Config(view_num=V, N_samples=S, nerf_dtype=dtype)
    nerf, _ = create_models(cfg, "cpu")
    nerf.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    return nerf


def _t(xs):
    return [torch.from_numpy(a) for a in xs]


def test_state_dict_from_jax_matches_export(case):
    """The port's converter loads strictly and equals the JAX package's
    export to reference naming, key for key."""
    ours = nerf_state_dict_from_jax(case["params"])
    ref = export_nerf_state_dict(case["params"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    nerf = _port_mlp(case)
    assert sorted(nerf.state_dict()) == sorted(ref)


def test_packing_follows_pallas_order(case):
    """Layer order, kernels and biases equal ``pack_mlp_weights``.  Both
    packs hold the ``WEIGHT_STEPS`` blocks where the table says: bf16 in
    mma.sync m16n8k16 B-fragment order, f32 split into tf32 big and small
    in m16n8k8 B-fragment order.  Each unpacks to its zero-padded [K, N]
    block (f32: big + small), whose parts give back their layers bit for
    bit, column for column (bf16: the layers rounded to bf16)."""
    nerf = _port_mlp(case)
    assert LAYER_NAMES == _LAYER_NAMES
    blocks = layer_blocks(nerf)
    n = len(_LAYER_NAMES)
    for i, (name, w, b) in enumerate(blocks):
        assert name == _LAYER_NAMES[i]
        np.testing.assert_array_equal(w.numpy(), case["packed"][i], name)
        np.testing.assert_array_equal(b.numpy(), case["packed"][n + i], name)
    by_name = {name: (w, b) for name, w, b in blocks}
    assert sorted(nm for parts in WEIGHT_STEPS for nm, _ in parts) \
        == sorted(_LAYER_NAMES)
    for dtype, mult in (("float32", 8), ("bfloat16", 16)):
        pk = t_pack(_port_mlp(case, dtype))
        bf16 = dtype == "bfloat16"
        assert pk.use_bf16 == bf16 and pk.weights.dtype == getattr(torch,
                                                                   dtype)
        table = np.asarray(list(pk.table)).reshape(len(WEIGHT_STEPS), 4)
        for parts, (K, N, wo, bo) in zip(WEIGHT_STEPS, table):
            assert K % mult == 0 and N % mult == 0 and wo % 8 == 0
            if bf16:
                size = K * N
                blk = unshuffle_b_fragments(pk.weights[wo:wo + size], K,
                                            N).float().numpy()
            else:
                size = 2 * K * N
                big, small = unshuffle_tf32_fragments(
                    pk.weights[wo:wo + size], K, N)
                blk = (big + small).numpy()
            bias = pk.biases[bo:bo + N].numpy()
            left = np.ones((K, N), bool)
            col = 0
            for name, row0 in parts:
                w, b = by_name[name]
                w = (w.to(torch.bfloat16).float() if bf16 else w).numpy()
                if name == "pts_linears_5":   # [pe 63 | zero row | h 128]
                    w = np.concatenate([w[:63], np.zeros((1, w.shape[1])),
                                        w[63:]])
                k, m = w.shape
                np.testing.assert_array_equal(
                    blk[row0:row0 + k, col:col + m], w, name)
                np.testing.assert_array_equal(bias[col:col + m], b.numpy())
                left[row0:row0 + k, col:col + m] = False
                col += m
            assert not blk[left].any() and not bias[col:].any()
        assert table[-1, 2] + size == pk.weights.numel()


def test_b_fragment_order():
    """The bf16 pack's order is the PTX ISA's m16n8k16 B fragment: lane
    4 g + t holds (k, n) = (2 t + kl + 8 kh, g) of k-tile kt and n-tile
    2 np + i, as its 16-byte word ((kt * N/16 + np) * 32 + lane), value
    4 i + 2 kh + kl."""
    K, N = 48, 32
    w = torch.arange(K * N, dtype=torch.float32).reshape(K, N)
    flat = t_shuffle(w).numpy()
    kt, np_, lane, e = np.meshgrid(np.arange(K // 16), np.arange(N // 16),
                                   np.arange(32), np.arange(8),
                                   indexing="ij")
    g, t = lane // 4, lane % 4
    i, kh, kl = e // 4, (e // 2) % 2, e % 2
    k = 16 * kt + 8 * kh + 2 * t + kl
    n = 16 * np_ + 8 * i + g
    pos = ((kt * (N // 16) + np_) * 32 + lane) * 8 + e
    np.testing.assert_array_equal(flat[pos], w.numpy()[k, n])
    torch.testing.assert_close(
        unshuffle_b_fragments(torch.from_numpy(flat), K, N), w,
        rtol=0, atol=0)


def test_plain_mlp_matches_jax_f32(case):
    nerf = _port_mlp(case)
    with torch.no_grad():
        out = nerf(*_t(case["x33"])).numpy()
    assert out.shape == case["f32"].shape
    np.testing.assert_allclose(out, case["f32"], rtol=1e-4, atol=1e-5)


def test_plain_mlp_bf16_bounds(case):
    """bf16 plain MLP vs f32 truth, under the bounds the JAX package holds
    its bf16 Pallas kernel to."""
    nerf = _port_mlp(case, "bfloat16")
    with torch.no_grad():
        out = nerf(*_t(case["x16"])).numpy()
    err = np.abs(out - case["truth16"])
    err_flax = np.abs(case["flax_bf16"] - case["truth16"])
    assert err.mean() <= 2 * err_flax.mean() + 5e-3, (err.mean(),
                                                      err_flax.mean())
    assert np.quantile(err, 0.99) <= 0.25


def test_wrapper_on_cpu_runs_plain_version(case):
    nerf = _port_mlp(case)
    before = fused_nerf_mlp.launches
    with torch.no_grad():
        got = FusedNeRFMLP(nerf)(*_t(case["x33"]))
        want = nerf(*_t(case["x33"]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_nerf_mlp.launches == before


def test_render_mlp_plain_only_on_the_cpu(case, capsys):
    """An MLP shape the kernel does not take renders with the plain MLP on
    the CPU, after one stderr line, and raises on any other device: off
    the CPU a render runs on the kernel or not at all."""
    nerf, _ = create_models(Config(view_num=V, N_samples=S, netwidth=64),
                            "cpu")
    assert render_mlp(nerf) is nerf
    assert capsys.readouterr().err.count("plain UCNeRFMLP") == 1
    with pytest.raises(NotImplementedError, match="kernel only.*width 128"):
        render_mlp(nerf.to("meta"))
    assert isinstance(render_mlp(_port_mlp(case).to("meta")), FusedNeRFMLP)
    assert capsys.readouterr().err == ""


def test_init_params_laws():
    """Fresh weights follow the JAX init laws: kaiming-normal / zero bias,
    except the two torch-default layers; conv weights U(±1/sqrt(fan_in))."""
    cfg = Config(view_num=V)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    nerf = p["nerf"]
    w = nerf["nerf.pts_linears.1.weight"]
    assert abs(w.std().item() - np.sqrt(2 / 128)) < 0.01
    assert not nerf["nerf.pts_linears.1.bias"].any()
    for name in ("pts_bias_confidence", "alpha_linear_1"):
        b = nerf[f"nerf.{name}.bias"]
        assert b.any() and b.abs().max() <= 1 / np.sqrt(
            nerf[f"nerf.{name}.weight"].shape[1])
    conv = p["mvs"]["cost_regularization.0.conv0.conv.weight"]
    assert conv.abs().max() <= 1 / np.sqrt(32 * 27)
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(v, again["mvs"][k]) for k, v in p["mvs"].items())
