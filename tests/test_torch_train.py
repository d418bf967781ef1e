"""The training slice as a whole: ucnerf_torch's LR schedules, Adam, train
step and ``python -m ucnerf_torch.train`` against the JAX package's, at the
small shape of ``tests/test_train_e2e.py`` with cascade depths 8/8/8.

The weights are the port's ``init_params`` from a seed, carried into the
JAX tree by ``jax_params_from_state_dict``; the ray draws are the ones
JAX makes from one key (``test_torch_train_rays.jax_train_draws``)."""

import dataclasses
import json

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
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import __main__ as train_cli
from ucnerf_torch.train import loop as t_loop
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


def _jcfg(cfg: Config) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def case():
    cfg = parse_config(ARGS)
    sample = build_dataset(cfg, "train")[0]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return dict(cfg=cfg, sample=sample, params=params,
                jparams=jax_params_from_state_dict(params))


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
    opt_state = tx.init(jp)
    nerf, mvs = _port(cfg, case["params"])
    opt = t_loop.make_optimizer(cfg, nerf, mvs)
    sched = t_loop.make_lr_schedule(cfg, spe)
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    rng = np.random.default_rng(1)

    @jax.jit
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


def test_scene_loss_and_gradients_match_jax(case):
    """``scene_loss`` with pinned draws against ``jax.value_and_grad`` of
    the JAX package's, over all 154 gradient tensors mapped through the
    weight bridge.  The envelope of ``tests/test_loss_parity.py``: terms
    rtol 6e-3; per-tensor rel (max abs diff / max abs) median < 5e-3 and
    worst < 3e-2.  float32 MLP: at bf16 its rounding rounds the cotangents
    too (``tests/test_torch_losses.py`` checks the bf16 loss values)."""
    cfg = case["cfg"]
    jcfg = _jcfg(cfg)
    jnerf, jmvs = j_create_models(jcfg)
    key = jax.random.PRNGKey(21)
    batch_j = j_loop.to_device_batch(case["sample"])
    (loss_j, terms_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: j_loop.scene_loss(jcfg, jnerf, jmvs, p, batch_j, key),
        has_aux=True))(jax.tree.map(jnp.asarray, case["jparams"]))

    nerf, mvs = _port(cfg, case["params"])
    loss, terms = t_loop.scene_loss(cfg, nerf, mvs,
                                    to_device_batch(case["sample"], "cpu"),
                                    _draws(cfg, key))
    loss.backward()
    for name in terms_j:
        np.testing.assert_allclose(float(terms[name].detach()),
                                   float(terms_j[name]), rtol=6e-3,
                                   err_msg=name)
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads_j))
    want = {**want["nerf"], **want["mvs"]}
    got = _grads(nerf, mvs)
    assert sorted(got) == sorted(want) and len(want) == 154
    assert all(g is not None for g in got.values())
    rels = _rel_envelope(got, want)
    worst = max(rels, key=rels.get)
    med = float(np.median(list(rels.values())))
    assert med < 5e-3, f"median gradient rel {med:.2e}"
    assert rels[worst] < 3e-2, f"gradient mismatch {worst}: {rels[worst]:.2e}"


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
