"""Adam against optax, and ``python -m ucnerf_torch.train --save_params``
read back by both packages and served, at the small shape and seeded
weights of ``tests/test_torch_train.py``.  Three tests, so that
pytest-xdist's ``--dist loadfile`` queues this file after the suite's
long JAX files."""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.models.factory import init_params as j_init_params
from ucnerf_tpu.train import loop as j_loop
from ucnerf_tpu.utils import checkpoint_io as j_ckpt

from ucnerf_torch import serve
from ucnerf_torch.models.factory import create_models
from ucnerf_torch.train import __main__ as train_cli
from ucnerf_torch.train import loop as t_loop
from ucnerf_torch.utils.checkpoint_io import (jax_params_from_state_dict,
                                              load_params_npz,
                                              state_dict_from_jax)

from test_torch_train import (ARGS, JIT_QUICK, H, W, _jcfg,  # noqa: F401
                              _port, case)

torch.set_num_threads(1)


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
