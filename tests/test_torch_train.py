"""The training slice as a whole: ucnerf_torch's LR schedules, Adam, train
step and ``python -m ucnerf_torch.train`` against the JAX package's, at the
small shape of ``tests/test_train_e2e.py`` with cascade depths 8/8/8.

The weights are the port's ``init_params`` from a seed, carried into the
JAX tree by ``jax_params_from_state_dict``; the ray draws are the ones
JAX makes from one key (``test_torch_train_rays.jax_train_draws``)."""

import dataclasses
import functools
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.config import Config as JConfig
from ucnerf_tpu.models.factory import (create_models as j_create_models,
                                       init_params as j_init_params)
from ucnerf_tpu.train import loop as j_loop
from ucnerf_tpu.utils import checkpoint_io as j_ckpt

from ucnerf_torch import serve
from ucnerf_torch.config import Config, parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.models.factory import (create_appearance, create_models,
                                         init_params)
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import __main__ as train_cli
from ucnerf_torch.train import loop as t_loop
from ucnerf_torch.utils import checkpoint_io
from ucnerf_torch.utils.checkpoint_io import (jax_params_from_state_dict,
                                              load_params_npz,
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
# the JAX scene losses this file and tests/test_torch_losses.py hold the
# port to: (config flags, PRNG key, with gradients)
SCENE_REFS = {"fast": ({}, 21, True),
              "literal": ({"fast_featurization": False}, 21, True),
              "bf16": ({"nerf_dtype": "bfloat16"}, 5, False),
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

    with ThreadPoolExecutor(len(names)) as pool:
        compiled = {name: pool.submit(jax.jit(ref(
            *SCENE_REFS[name])).lower(p).compile, JIT_QUICK)
            for name in names}
        return {name: jax.tree.map(np.asarray, f.result()(p))
                for name, f in compiled.items()}


def _port(cfg, params):
    return create_models(cfg, "cpu", params)


def _draws(cfg, key):
    return jax_train_draws(key, H=H, W=W, patch_size=cfg.patch_size,
                           patch_num=cfg.patch_num,
                           n_uniform=cfg.n_uniform_rays,
                           n_rays=cfg.n_train_rays, n_samples=cfg.N_samples)


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


def _random_grads(tree, rng):
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("finetune", [False, True])
def test_adam_matches_optax(case, finetune):
    """Fed identical gradient trees, three Adam updates of the port equal
    ``make_optimizer``'s ``tx.update``, the LR of each taken from the
    schedule at the count of updates already made; so do the first and
    second moments.  Under --finetune the cascade stays as it was and its
    parameters get no gradient."""
    cfg = case["cfg"].replace(num_epochs=3, finetune="synth0" if finetune
                              else None)
    spe = 1                      # the cosine LR moves every update
    tx = j_loop.make_optimizer(_jcfg(cfg), spe)
    jp = jax.tree.map(jnp.asarray, case["jparams"])
    # one compile, not one per shape
    opt_state = jax.jit(tx.init, compiler_options=JIT_QUICK)(jp)
    nerf, mvs = _port(cfg, case["params"])
    opt = t_loop.make_optimizer(cfg, nerf, mvs)
    sched = t_loop.make_lr_schedule(cfg, spe)
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    rng = np.random.default_rng(1)

    @functools.partial(jax.jit, compiler_options=JIT_QUICK)
    def j_step(g, opt_state, jp):
        updates, opt_state = tx.update(g, opt_state, jp)
        return jax.tree.map(lambda a, u: a + u, jp, updates), opt_state

    for step in range(3):
        g = _random_grads(case["jparams"], rng)
        jp, opt_state = j_step(g, opt_state, jp)
        sd_g = state_dict_from_jax(g)
        for name, module in (("nerf", nerf), ("mvs", mvs)):
            for n, p in module.named_parameters():
                if id(p) in trained:
                    p.grad = torch.from_numpy(sd_g[name][n])
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()

    got = jax_params_from_state_dict({"nerf": nerf.state_dict(),
                                      "mvs": mvs.state_dict()})
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=1e-5, atol=1e-6), got, jp)
    if finetune:
        for n, p in mvs.named_parameters():
            assert p.grad is None, n
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                     got["mvs"], case["jparams"]["mvs"])
    else:
        adam = opt_state[0]
        for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            mom = jax_params_from_state_dict({
                name: {n: opt.state[p][key]
                       for n, p in module.named_parameters()}
                for name, module in (("nerf", nerf), ("mvs", mvs))})
            # torch's Adam updates the first moment by lerp, optax by
            # b1*m + (1-b1)*g: equal up to f32 round-off, whose absolute
            # size follows the tensor's scale
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                a, np.asarray(b), rtol=1e-5,
                atol=1e-6 * np.abs(np.asarray(b)).max()), mom, moment)


def _rel_envelope(got: dict, want: dict):
    """Per tensor: max abs diff over the larger max abs."""
    rels = {}
    for name, w in want.items():
        g = got[name].numpy()
        scale = max(np.abs(w).max(), np.abs(g).max(), 1e-10)
        rels[name] = float(np.abs(g - w).max() / scale)
    return rels


def _check_scene_loss_and_gradients(case, name: str):
    """The port's ``scene_loss`` and gradients at SCENE_REFS[name] against
    ``jax_scene_refs(("fast", "literal"))[name]``, with JAX's draws."""
    flags, seed, _ = SCENE_REFS[name]
    cfg = case["cfg"].replace(**flags)
    (_, terms_j), grads_j = jax_scene_refs(("fast", "literal"))[name]
    nerf, mvs = _port(cfg, case["params"])
    loss, terms = t_loop.scene_loss(cfg, nerf, mvs,
                                    to_device_batch(case["sample"], "cpu"),
                                    _draws(cfg, jax.random.PRNGKey(seed)))
    loss.backward()
    for name in terms_j:
        np.testing.assert_allclose(float(terms[name].detach()),
                                   float(terms_j[name]), rtol=6e-3,
                                   err_msg=name)
    want = state_dict_from_jax(grads_j)
    want = {**want["nerf"], **want["mvs"]}
    got = _grads(nerf, mvs)
    assert sorted(got) == sorted(want) and len(want) == 154
    assert all(g is not None for g in got.values())
    rels = _rel_envelope(got, want)
    worst = max(rels, key=rels.get)
    med = float(np.median(list(rels.values())))
    assert med < 5e-3, f"median gradient rel {med:.2e}"
    assert rels[worst] < 3e-2, f"gradient mismatch {worst}: {rels[worst]:.2e}"


def test_scene_loss_and_gradients_match_jax(case):
    """``scene_loss`` with pinned draws against ``jax.value_and_grad`` of
    the JAX package's, over all 154 gradient tensors mapped through the
    weight bridge.  The envelope of ``tests/test_loss_parity.py``: terms
    rtol 6e-3; per-tensor rel (max abs diff / max abs) median < 5e-3 and
    worst < 3e-2.  float32 MLP: at bf16 its rounding rounds the cotangents
    too (``tests/test_torch_losses.py`` checks the bf16 loss values)."""
    _check_scene_loss_and_gradients(case, "fast")


def test_literal_scene_loss_and_gradients_match_jax(case):
    """``fast_featurization`` false: the train step's loss and its 154
    gradients through the literal featurization (per-point trilinear and
    bilinear lookups, ``render/renderer.py::gen_pts_feats``) against
    ``jax.value_and_grad`` of the JAX package's literal path, in the same
    envelope."""
    _check_scene_loss_and_gradients(case, "literal")


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


def test_cli_trains_saves_and_serves(case, tmp_path, capsys):
    """``python -m ucnerf_torch.train --device cpu --stop_after_steps 2
    --save_params p.npz`` prints its step, checkpoint and summary lines
    and, stopped as a killed run would be, checkpoints and does not
    validate; p.npz holds the JAX package's params layout (as does the
    checkpoint's params.npz), round-trips through the weight bridge, and
    ``ucnerf_torch.serve --ckpt p.npz`` renders from it."""
    p = str(tmp_path / "p.npz")
    summary = train_cli.main([*ARGS, "--device", "cpu", "--stop_after_steps",
                              "2", "--save_params", p, "--basedir",
                              str(tmp_path)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    steps = [ln for ln in lines if "step" in ln]
    assert [ln["step"] for ln in steps] == [1, 2]
    for ln in steps:
        assert np.isfinite([ln[k] for k in ("loss", "img_mse", "mvs", "smooth",
                                            "scaleinv", "nerf_depth", "lr",
                                            "ms")]).all()
        assert ln["lr"] == pytest.approx(5e-4)
    assert not any("val_step" in ln for ln in lines)
    ckpt = str(tmp_path / "scared" / "ckpts" / "step_00000002")
    assert [ln["checkpoint"] for ln in lines if "checkpoint" in ln] == [ckpt]
    assert lines[-1] == summary and summary["steps"] == 2
    assert summary["stopped"] and summary["val"] is None
    assert summary["ckpt"] == ckpt

    tree = load_params_npz(p)
    jax.tree.map(np.testing.assert_array_equal,
                 load_params_npz(ckpt + "/params.npz"), tree)
    sd = state_dict_from_jax(tree)
    back = jax_params_from_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    create_models(case["cfg"], "cpu", sd)          # strict load
    assert not np.array_equal(sd["nerf"]["nerf.rgb_linear.weight"],
                              case["params"]["nerf"]["nerf.rgb_linear.weight"]
                              .numpy())
    # the JAX package reads it as its own params tree
    shapes = jax.eval_shape(lambda k: j_init_params(_jcfg(case["cfg"]), k,
                                                    (H, W)),
                            jax.random.PRNGKey(0))
    j_tree = j_ckpt.load_params_npz(p)
    assert (jax.tree.structure(j_tree) == jax.tree.structure(shapes))
    jax.tree.map(lambda a, s: np.testing.assert_equal(a.shape, s.shape),
                 j_tree, shapes)

    c2w = np.asarray(case["sample"]["c2ws"][0]).tolist()
    reqs = tmp_path / "reqs.jsonl"
    out = str(tmp_path / "f.npz")
    reqs.write_text(json.dumps({"c2w": c2w, "out": out}) + "\n")
    assert serve.main(["--requests", str(reqs), "--device", "cpu", "--ckpt",
                       p, *ARGS]) == 1
    frame = np.load(out)
    assert frame["rgb"].shape == (H, W, 3)
    assert np.isfinite(frame["rgb"]).all()
    assert np.isfinite(frame["depth"]).all()


def test_trainer_needs_the_card_or_cpu():
    """Without a card and without --device cpu the trainer raises instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cpu"):
        train_cli.main([*ARGS, "--stop_after_steps", "1"])
