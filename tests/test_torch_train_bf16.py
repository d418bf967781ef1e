"""The train step at ``--nerf_dtype bfloat16`` (the default) against the
JAX package's, at the small shape and seeded weights of
``tests/test_torch_train.py``, JAX compiled without XLA's excess
precision (``EXACT_BF16``) so that its bf16 operations round where the
program says: the step's loss terms and its 154 gradients, and the
``--mvs_only`` loss.

The port's plain MLP rounds where the fused kernel rounds (once, after an
f32 bias add), in the train step as in every render; flax's
``nn.Dense(dtype=bfloat16)`` in the JAX train step rounds the product,
the bias and their sum.  The gradients' envelope is twice the JAX
package's own gap between two roundings of its step, measured by
``scripts/jax_option_gaps.py --bf16_step`` on the JAX package (as the
bounds of ``chip_smoke.py`` phase ``options`` are): the step compiled at
XLA's optimization level 0 and at its default, the bf16 roundings in
place and the float32 round-off of the cascade and the featurization
moved, as the port's differs.  The port's step takes the JAX step's
ReLU choices (as the view-split case of ``tests/test_torch_parallel.py``
does), so this holds the step's continuous part only: the JAX gap keeps
its own flipped choices (48 samples, ``--bf16_step``'s line (h)), and
the port's step with its own choices (188 flipped against JAX's) reads
a median rel of 4.05e-2, outside the envelope, with flax's rounding too
(line (g)); that gap is an open fault of the port (``ROADMAP.md`` §3).
Two tests, so that pytest-xdist's ``--dist loadfile`` queues this file
after the suite's long JAX files."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_parallel_refs

from ucnerf_tpu.models.factory import create_models as j_create_models
from ucnerf_tpu.train.loop import to_device_batch as j_device_batch

from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import loop as t_loop
from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax

from test_torch_train import (EXACT_BF16, JIT_QUICK, SCENE_REFS,  # noqa: F401
                              _draws, _grads, _jcfg, _port, _rel_envelope,
                              case, jax_scene_refs)
from torch_parallel_worker import relu_choices

torch.set_num_threads(1)

# scripts/jax_option_gaps.py --bf16_step (the JAX package on a CPU, its
# line (e)): the 154 gradients of the bf16 step at SCENE_REFS["bf16"]
# compiled at optimization level 0 and at the default: per-tensor rel
# (max abs diff over the larger max abs), median and worst
BF16_STEP_GAP = dict(median=7.162067e-3, worst=4.113924e-2)


@pytest.fixture(scope="module")
def refs(case):
    """The JAX bf16 step's loss, terms and gradients (and the --mvs_only
    loss), and the ReLU choices of the bf16 step, each compiled once."""
    cfg = case["cfg"].replace(**SCENE_REFS["bf16"][0])
    jcfg = _jcfg(cfg)
    jnerf, jmvs = j_create_models(jcfg)
    p = jax.tree.map(jnp.asarray, case["jparams"])
    batch = j_device_batch(case["sample"])
    key = jax.random.PRNGKey(SCENE_REFS["bf16"][1])

    def relu():
        fn = jax.jit(jax_parallel_refs.relu_choices(jcfg, jnerf, jmvs))
        return [np.asarray(m) for m in fn.lower(p, batch, key).compile(
            {**JIT_QUICK, **EXACT_BF16})(p, batch, key)]

    with ThreadPoolExecutor(2) as pool:
        masks = pool.submit(relu)
        scene = jax_scene_refs(("bf16", "mvs_only"))
        return dict(scene=scene, relu=masks.result())


def test_bf16_and_mvs_only_losses_match_jax(case, refs):
    """At --nerf_dtype bfloat16 the loss terms agree to 2e-2 (the two
    MLPs round at different points, above, and the two cascades' float32
    round-off moves the rounded values).  --mvs_only: the loss
    and its depth diagnostic agree to 6e-3, and a train step leaves the
    MLP as it was (zero gradients, zero Adam moments)."""
    batch = to_device_batch(case["sample"], "cpu")
    for name, rtol in (("bf16", 2e-2), ("mvs_only", 6e-3)):
        flags, seed, grad = SCENE_REFS[name]
        cfg = case["cfg"].replace(**flags)
        terms_j = refs["scene"][name][0][1] if grad \
            else refs["scene"][name][1]
        nerf, mvs = _port(cfg, case["params"])
        with torch.no_grad():
            _, terms = t_loop.scene_loss(cfg, nerf, mvs, batch,
                                         _draws(cfg, jax.random.PRNGKey(
                                             seed)))
        assert sorted(terms) == sorted(terms_j)
        for name in terms_j:
            np.testing.assert_allclose(float(terms[name]),
                                       float(terms_j[name]), rtol=rtol,
                                       err_msg=f"{flags} {name}")

    before = {n: p.detach().clone() for n, p in nerf.named_parameters()}
    state = t_loop.TrainState(nerf, mvs, t_loop.make_optimizer(cfg, nerf,
                                                               mvs))
    t_loop.make_train_step(cfg, t_loop.make_lr_schedule(cfg, 10))(
        state, batch, None)
    assert state.step == 1
    for n, p in nerf.named_parameters():
        torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0)


def test_bf16_scene_loss_and_gradients_match_jax(case, refs):
    """The bf16 step's loss terms (rtol 2e-2) and its 154 gradients
    against ``jax.value_and_grad`` of the JAX package's bf16
    ``scene_loss`` at JAX's draws and ReLU choices: per-tensor rel median
    and worst within twice the JAX package's own gap between its step
    compiled at two optimization levels (that gap has its own flipped
    ReLU choices; the port's own choices miss it, module docstring)."""
    flags, seed, _ = SCENE_REFS["bf16"]
    cfg = case["cfg"].replace(**flags)
    (_, terms_j), grads_j = refs["scene"]["bf16"]
    nerf, mvs = _port(cfg, case["params"])
    with relu_choices(refs["relu"]):
        loss, terms = t_loop.scene_loss(cfg, nerf, mvs,
                                        to_device_batch(case["sample"],
                                                        "cpu"),
                                        _draws(cfg, jax.random.PRNGKey(seed)))
        loss.backward()
    for name in terms_j:
        np.testing.assert_allclose(float(terms[name].detach()),
                                   float(terms_j[name]), rtol=2e-2,
                                   err_msg=name)
    want = state_dict_from_jax(grads_j)
    want = {**want["nerf"], **want["mvs"]}
    got = _grads(nerf, mvs)
    assert sorted(got) == sorted(want) and len(want) == 154
    rels = _rel_envelope(got, want)
    worst = max(rels, key=rels.get)
    med = float(np.median(list(rels.values())))
    assert med <= 2 * BF16_STEP_GAP["median"], f"median rel {med:.2e}"
    assert rels[worst] <= 2 * BF16_STEP_GAP["worst"], (worst, rels[worst])
