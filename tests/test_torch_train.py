"""The training slice as a whole: ucnerf_torch's LR schedules, train step
and ``python -m ucnerf_torch.train`` against the JAX package's (Adam and
the CLI's ``--save_params`` round trip in
``tests/test_torch_train_optax.py``), at the
small shape of ``tests/test_train_e2e.py`` with cascade depths 8/8/8, and
the case and JAX references that ``tests/test_torch_train_grads.py`` and
``tests/test_torch_train_bf16.py`` hold the step's gradients to.

The weights are the port's ``init_params`` from a seed, carried into the
JAX tree by ``jax_params_from_state_dict``; the ray draws are the ones
JAX makes from one key (``test_torch_train_rays.jax_train_draws``)."""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.config import Config as JConfig
from ucnerf_tpu.models.factory import create_models as j_create_models
from ucnerf_tpu.train import loop as j_loop
from ucnerf_tpu.utils import checkpoint_io as j_ckpt

from ucnerf_torch.config import Config, parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.models.factory import (create_appearance, create_models,
                                         init_params)
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import __main__ as train_cli
from ucnerf_torch.train import loop as t_loop
from ucnerf_torch.utils import checkpoint_io
from ucnerf_torch.utils.checkpoint_io import (jax_params_from_state_dict,
                                              state_dict_from_jax)

from test_torch_train_rays import jax_train_draws

torch.set_num_threads(1)

ARGS = ["--dataset_name", "synthetic", "--view_num", "4", "--N_samples",
        "9", "--batch_size", "80", "--patch_size", "4", "--patch_num", "4",
        "--n_depth_rays", "32", "--chunk", "256", "--num_epochs", "4",
        "--lrate", "5e-4", "--ndepths", "8", "8", "8", "--nerf_dtype",
        "float32"]
H, W = 32, 64
# compile time, not run time, dominates the JAX references on the CPU
JIT_QUICK = {"xla_backend_optimization_level": 0}
# XLA on the CPU keeps a bf16 operation's output at f32 by default
# ("excess precision"); without it the output rounds to bf16 where the
# program says, as on the TPU
EXACT_BF16 = {"xla_allow_excess_precision": False}
# the JAX scene losses the port is held to (tests/test_torch_train_grads.py
# and tests/test_torch_train_bf16.py): (config flags, PRNG key, with
# gradients); the bf16 one compiled with EXACT_BF16
SCENE_REFS = {"fast": ({}, 21, True),
              "literal": ({"fast_featurization": False}, 21, True),
              "bf16": ({"nerf_dtype": "bfloat16"}, 5, True),
              "mvs_only": ({"mvs_only": True}, 5, False)}


def _jcfg(cfg: Config) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _case() -> dict:
    cfg = parse_config(ARGS)
    sample = build_dataset(cfg, "train")[0]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return dict(cfg=cfg, sample=sample, params=params,
                jparams=jax_params_from_state_dict(params))


@pytest.fixture(scope="module")
def case():
    return _case()


@functools.lru_cache(maxsize=None)
def jax_scene_refs(names) -> dict:
    """The JAX package's ``scene_loss`` on the case's sample and weights
    for each of ``names`` of SCENE_REFS: {name: ((loss, terms), gradient
    tree)} with gradients, else (loss, terms).  Compiling dominates, so
    each is compiled on a thread of its own while the next one is traced,
    and each test file asks only for the ones it reads (the suite's
    workers run files apart, and would compile them all twice)."""
    c = _case()
    batch = j_loop.to_device_batch(c["sample"])
    p = jax.tree.map(jnp.asarray, c["jparams"])

    def ref(flags, seed, grad):
        jcfg = _jcfg(c["cfg"].replace(**flags))
        jnerf, jmvs = j_create_models(jcfg)

        def loss(p):
            return j_loop.scene_loss(jcfg, jnerf, jmvs, p, batch,
                                     jax.random.PRNGKey(seed))
        return jax.value_and_grad(loss, has_aux=True) if grad else loss

    def options(flags):
        return ({**JIT_QUICK, **EXACT_BF16}
                if flags.get("nerf_dtype") == "bfloat16" else JIT_QUICK)

    with ThreadPoolExecutor(len(names)) as pool:
        compiled = {name: pool.submit(jax.jit(ref(
            *SCENE_REFS[name])).lower(p).compile,
            options(SCENE_REFS[name][0])) for name in names}
        return {name: jax.tree.map(np.asarray, f.result()(p))
                for name, f in compiled.items()}


def _port(cfg, params):
    return create_models(cfg, "cpu", params)


def _draws(cfg, key):
    return jax_train_draws(key, H=H, W=W, patch_size=cfg.patch_size,
                           patch_num=cfg.patch_num,
                           n_uniform=cfg.n_uniform_rays,
                           n_rays=cfg.n_built_rays, n_samples=cfg.N_samples)


def _grads(nerf, mvs):
    out = {n: p.grad for n, p in nerf.named_parameters()}
    out.update({n: p.grad for n, p in mvs.named_parameters()})
    return out


@pytest.mark.parametrize("sched", ["cosine", "steplr", "poly"])
def test_lr_schedules_match_jax(sched):
    cfg = Config(lr_scheduler=sched, lrate=3e-4, num_epochs=3,
                 decay_step=(4, 9, 13), decay_gamma=0.5)
    spe = 5
    j = j_loop.make_lr_schedule(_jcfg(cfg), spe)
    t = t_loop.make_lr_schedule(cfg, spe)
    for step in range(0, 3 * spe + 3):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))),
                                   rtol=1e-5, atol=1e-12,
                                   err_msg=f"{sched} step {step}")


def _rel_envelope(got: dict, want: dict):
    """Per tensor: max abs diff over the larger max abs."""
    rels = {}
    for name, w in want.items():
        g = got[name].numpy()
        scale = max(np.abs(w).max(), np.abs(g).max(), 1e-10)
        rels[name] = float(np.abs(g - w).max() / scale)
    return rels


def test_finetune_step_freezes_cascade(case):
    """A --finetune train step runs the cascade without autograd: its
    parameters get no .grad and do not move, the MLP's do."""
    cfg = case["cfg"].replace(finetune="synth0")
    nerf, mvs = _port(cfg, case["params"])
    mvs_before = {n: p.detach().clone() for n, p in mvs.named_parameters()}
    nerf_before = {n: p.detach().clone() for n, p in nerf.named_parameters()}
    state = t_loop.TrainState(nerf, mvs, t_loop.make_optimizer(cfg, nerf,
                                                               mvs))
    step = t_loop.make_train_step(cfg, t_loop.make_lr_schedule(cfg, 10))
    metrics = step(state, to_device_batch(case["sample"], "cpu"),
                   _draws(cfg, jax.random.PRNGKey(3)))
    assert np.isfinite(float(metrics["loss"]))
    for n, p in mvs.named_parameters():
        assert p.grad is None, n
        torch.testing.assert_close(p.detach(), mvs_before[n], rtol=0, atol=0)
    moved = [not torch.equal(p.detach(), nerf_before[n])
             for n, p in nerf.named_parameters()]
    assert all(moved)


def test_encode_a_table_trains_and_is_harmless(case, tmp_path):
    """--encode_a (the JAX package's ``test_encode_a_table_trains_and_is_
    harmless``): ``init_params`` draws the appearance table [N_vocab, N_a]
    N(0, 1) after both nets, whose weights stay as without the flag; Adam
    holds it with a zero gradient, so three steps leave it bit for bit as
    drawn and give the losses of the same steps without it; --finetune
    keeps it in the trained set and freezes the cascade only.  The table
    round-trips through a checkpoint (weights and Adam's zero moments) and
    through the JAX params tree and its npz, which the JAX package reads."""
    cfg = case["cfg"].replace(encode_a=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    table0 = params["appearance"].clone()
    assert table0.shape == (cfg.N_vocab, cfg.N_a)
    assert abs(float(table0.std()) - 1.0) < 0.05
    for name in ("nerf", "mvs"):
        for k, v in case["params"][name].items():
            assert torch.equal(params[name][k], v), k
    batch = to_device_batch(case["sample"], "cpu")
    losses, states = {}, {}
    for flag in (True, False):
        c = case["cfg"].replace(encode_a=flag)
        nerf, mvs = _port(c, params)
        table = create_appearance(c, "cpu", params)
        assert (table is None) != flag
        state = t_loop.TrainState(nerf, mvs, t_loop.make_optimizer(
            c, nerf, mvs, table), appearance=table)
        step = t_loop.make_train_step(c, t_loop.make_lr_schedule(c, 10))
        losses[flag] = [float(step(state, batch, _draws(
            c, jax.random.PRNGKey(i)))["loss"]) for i in range(3)]
        states[flag] = state
    assert losses[True] == losses[False]
    state = states[True]
    assert torch.equal(state.appearance.detach(), table0)
    assert not torch.equal(state.nerf.nerf.rgb_linear.weight,
                           case["params"]["nerf"]["nerf.rgb_linear.weight"])

    # checkpoint: the table and its (zero) Adam moments come back
    path = checkpoint_io.save_checkpoint(str(tmp_path), state, state.step)
    saved = checkpoint_io.load_params_npz(path + "/params.npz")
    np.testing.assert_array_equal(saved["appearance"], table0.numpy())
    nerf, mvs = _port(cfg, params)
    other = create_appearance(cfg, "cpu", {"appearance": torch.zeros(
        table0.shape)})
    back = t_loop.TrainState(nerf, mvs, t_loop.make_optimizer(
        cfg, nerf, mvs, other), objective=state.objective, appearance=other)
    checkpoint_io.load_checkpoint(path, back)
    assert torch.equal(back.appearance.detach(), table0)
    moments = back.optimizer.state[back.appearance]
    assert not moments["exp_avg"].any() and not moments["exp_avg_sq"].any()

    # the JAX params tree ('appearance' beside 'nerf' and 'mvs', as the
    # JAX package's init_params puts it), its npz in both packages, and
    # back
    tree = checkpoint_io.params_tree(state.nerf, state.mvs, state.appearance)
    assert sorted(tree) == ["appearance", "mvs", "nerf"]
    sd = state_dict_from_jax(tree)
    np.testing.assert_array_equal(sd["appearance"], table0.numpy())
    jax.tree.map(np.testing.assert_array_equal,
                 jax_params_from_state_dict(sd), tree)
    npz = checkpoint_io.save_params_npz(tree, str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(j_ckpt.load_params_npz(npz)["appearance"],
                                  table0.numpy())
    loaded = checkpoint_io.load_params(cfg.replace(ckpt=npz), "cpu")
    np.testing.assert_array_equal(
        create_appearance(cfg, "cpu", loaded).detach().numpy(),
        table0.numpy())

    # --finetune: the cascade frozen, the MLP and the table trained
    cf = cfg.replace(finetune="synth0")
    nerf, mvs = _port(cf, params)
    table = create_appearance(cf, "cpu", params)
    opt = t_loop.make_optimizer(cf, nerf, mvs, table)
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    assert id(table) in trained
    assert not any(id(p) in trained for p in mvs.parameters())
    assert all(id(p) in trained for p in nerf.parameters())


@pytest.mark.parametrize("where", ["loss", "gradient"])
def test_debug_nans_raises_before_the_update(case, where):
    """--debug_nans: a NaN weight (in the forward, so the loss) or a
    gradient hook that writes a NaN raises FloatingPointError naming it,
    and the step makes no update."""
    cfg = case["cfg"].replace(debug_nans=True)
    nerf, mvs = _port(cfg, case["params"])
    layer = nerf.nerf.rgb_linear
    if where == "loss":
        with torch.no_grad():
            layer.weight[0, 0] = float("nan")
    else:
        layer.bias.register_hook(lambda g: torch.full_like(g, float("nan")))
    before = {n: p.detach().clone() for n, p in nerf.named_parameters()}
    state = t_loop.TrainState(nerf, mvs, t_loop.make_optimizer(cfg, nerf,
                                                               mvs))
    step = t_loop.make_train_step(cfg, t_loop.make_lr_schedule(cfg, 10))
    match = "loss" if where == "loss" else "nerf.rgb_linear.bias"
    with pytest.raises(FloatingPointError, match=match):
        step(state, to_device_batch(case["sample"], "cpu"),
             _draws(cfg, jax.random.PRNGKey(3)))
    assert state.step == 0
    for n, p in nerf.named_parameters():
        torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0,
                                   equal_nan=True)


def test_trainer_needs_the_card_or_cpu():
    """Without a card and without --device cpu the trainer raises instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cpu"):
        train_cli.main([*ARGS, "--stop_after_steps", "1"])
