"""The bf16 dense layer of ucnerf_torch's plain MLP at the JAX train
step's rounding (``tests/bf16_rounding.py``: forward ``"flax"``,
backward ``"xla"``) against ``jax.vjp`` of flax's ``nn.Dense(dtype=
bfloat16)`` and the whole JAX MLP, compiled without XLA's excess
precision (``EXACT_BF16``) so that every bf16 operation rounds where the
program says.

Bit for bit: the output, the input's cotangent and the bias product's
cotangents.  Two cotangents are held to a stated tolerance:

- the weight's: both accumulate ``g.T @ x`` in float32 and round once,
  in different orders (XLA's dot against torch's), so a few elements
  land on the other side of a bf16 rounding: at most 1% of them, each
  within one bf16 step (2**-7 of its magnitude);
- the bias's: XLA sums it in bf16 (the transpose of flax's bias add is a
  ``reduce_sum`` whose accumulator is bf16, split by XLA's tree reduction
  into windows of 32 rows), the port in float32 with one rounding, as
  ``RoundedDense`` says; so each is held to the float64 sum of the
  (bit-equal) product cotangents: the port's within one bf16 rounding
  (2**-8), XLA's within the error of its bf16 additions, which this
  test measures at 8.5e-3 and 1.6e-2 of the largest sum and bounds at
  3e-2."""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from bf16_rounding import RoundedDense, rounding
from test_torch_train import (EXACT_BF16, JIT_QUICK, SCENE_REFS,  # noqa: F401
                              _jcfg, _port, case)

torch.set_num_threads(1)

EXACT = {**JIT_QUICK, **EXACT_BF16}
BF16 = torch.bfloat16


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _bias_sums_in_bounds(port, jax_sum, terms):
    """``port`` and ``jax_sum`` [C] against the float64 sum of ``terms``
    [rows, C] (module docstring)."""
    exact = terms.astype(np.float64).sum(0)
    scale = np.abs(exact).max()
    assert np.all(np.abs(port - exact) <= 2.0 ** -8 * np.abs(exact)
                  + 1e-6 * scale)
    assert np.abs(jax_sum - exact).max() <= 3e-2 * scale


def _weights_within_one_step(port, want):
    diff = port != want
    assert diff.mean() <= 0.01, diff.mean()
    assert np.all(np.abs(port - want)[diff]
                  <= 2.0 ** -7 * np.abs(want)[diff]), "more than a bf16 step"


@pytest.mark.parametrize("fan_in", [63, 128])
def test_dense_times_depth_bias_matches_flax_vjp(fan_in):
    """``RoundedDense`` (forward ``"flax"``) then ``* depth_bias`` on
    bf16 tensors, with a bf16 output cotangent, against ``jax.vjp`` of
    ``nn.Dense(128, dtype=bfloat16)(x) * depth_bias``: the trunk's first
    layer (63 inputs) and a middle one (128), 1008 rows."""
    rng = np.random.default_rng(fan_in)
    n = 1008
    x = rng.normal(size=(n, fan_in)).astype(np.float32)
    w = (rng.normal(size=(128, fan_in)) * np.sqrt(2 / fan_in)).astype(
        np.float32)
    b = (0.1 * rng.normal(size=128)).astype(np.float32)
    db = _bf16(rng.normal(size=(n, 128)))
    g = _bf16(rng.normal(size=(n, 128)))
    dense = nn.Dense(128, dtype=jnp.bfloat16)

    def vjp(x, k, bias, d, ct):
        y, pull = jax.vjp(lambda *a: dense.apply(
            {"params": {"kernel": a[1], "bias": a[2]}}, a[0]) * a[3],
            x, k, bias, d)
        return (y, *pull(ct))
    args = (x, w.T, b, jnp.asarray(db, jnp.bfloat16),
            jnp.asarray(g, jnp.bfloat16))
    y, gx, gk, gb, gd = (np.asarray(a, np.float32) for a in jax.jit(
        vjp).lower(*args).compile(EXACT)(*args))

    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    dt = torch.from_numpy(db).to(BF16).requires_grad_()
    out = RoundedDense.apply(xt, wt, bt, BF16, "flax") * dt
    assert out.dtype == BF16
    out.backward(torch.from_numpy(g).to(BF16))
    np.testing.assert_array_equal(out.detach().float().numpy(), y)
    assert xt.grad.dtype == torch.float32
    np.testing.assert_array_equal(xt.grad.numpy(), gx)
    np.testing.assert_array_equal(dt.grad.float().numpy(), gd)
    _weights_within_one_step(wt.grad.numpy(), gk.T)
    np.testing.assert_array_equal(wt.grad.numpy(), _bf16(wt.grad.numpy()))
    _bias_sums_in_bounds(bt.grad.numpy(), gb, _bf16(g * db))


def test_mlp_at_the_jax_rounding_matches_flax(case):
    """The whole plain MLP at forward ``"flax"``, backward ``"xla"``
    against the JAX package's bf16 MLP on the seeded inputs of
    ``scripts/jax_option_gaps.py --bf16_step`` (its line (f)): the
    output to float32 round-off, every weight gradient within one bf16
    step at no more than 1% of its elements, every bias gradient within
    4e-2 of its largest (XLA's bf16 sums, module docstring; measured at
    most 3.0e-2, ``pts_bias_depth_fine``'s, whose cotangent also sums the
    six trunk layers' in bf16), and the features' gradient to 1e-4 of its
    largest."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from jax_option_gaps import mlp_inputs
    from ucnerf_tpu.models.factory import create_models as j_create_models
    from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax

    cfg = case["cfg"].replace(**SCENE_REFS["bf16"][0])
    jnerf, _ = j_create_models(_jcfg(cfg))
    pn = jax.tree.map(jnp.asarray, case["jparams"]["nerf"])
    pts, dirs, feats, ct = mlp_inputs(cfg.view_num)

    def loss(p, f):
        out = jnerf.apply({"params": p}, pts, dirs, f)
        return jnp.sum(out * ct), out
    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, out_j), (gp, gf) = jax.tree.map(
        np.asarray, fn.lower(pn, feats).compile(EXACT)(pn, feats))
    want = state_dict_from_jax({"nerf": gp, "mvs": case["jparams"][
        "mvs"]})["nerf"]

    nerf, _ = _port(cfg, case["params"])
    f = torch.from_numpy(feats).requires_grad_()
    with rounding(nerf, "flax", "xla"):
        out = nerf(torch.from_numpy(pts), torch.from_numpy(dirs), f)
        (out * torch.from_numpy(ct)).sum().backward()
    assert np.abs(out.detach().numpy() - out_j).max() <= 1e-6
    assert np.abs(f.grad.numpy() - gf).max() <= 1e-4 * np.abs(gf).max()
    for name, p in nerf.named_parameters():
        if name.endswith("weight"):
            _weights_within_one_step(p.grad.numpy(), want[name])
        else:
            scale = max(np.abs(want[name]).max(), 1e-10)
            assert np.abs(p.grad.numpy() - want[name]).max() <= 4e-2 * scale
