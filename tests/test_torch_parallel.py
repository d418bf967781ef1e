"""Multi-rank ucnerf_torch (``ucnerf_torch/parallel``) against the JAX
package's ``ucnerf_tpu/parallel`` on the conftest's 8-device CPU mesh, at
the small shape of ``tests/test_torch_train.py``: ray-DP here, and the
helpers of ``tests/test_torch_parallel_*.py`` (scene-DP and the grid,
the view-sharded cascade, the sharded eval render, kill-and-resume).

The port's ranks run on the CPU over gloo, spawned by
``ucnerf_torch.parallel.launch.run_ranks`` with a time limit of their own
and running ``tests/torch_parallel_worker.py``.  The weights are the
port's seeded ones, carried into the JAX tree by
``jax_params_from_state_dict``; the ray draws are JAX's
(``test_torch_train_rays.jax_train_draws``).  Each result is held twice:

- against the JAX package's parallel function (``_ray_dp_loss_fn``,
  ``_scene_dp_loss_fn``, ``_grid_loss_fn``, ``make_view_sharded_cascade``,
  ``make_parallel_eval_render``) at the port's parity envelope of the
  single-device tests (loss terms rtol 6e-3; gradients per tensor max
  abs diff over max abs, median < 5e-3, worst < 3e-2; frames rgb atol
  2e-3, depth rtol 5e-3, confidence mean 2e-3; cascade outputs 1e-4 of
  their max where JAX's view-sharded test holds its own);
- against the port's serial step or frame at the JAX package's own
  tolerances for its parallel modes (``tests/test_parallel*.py``): loss
  rtol 1e-5 for ray-DP, 1e-4 for the view split, scene-DP and the grid;
  gradients per tensor within 1e-1 of their max
  (``test_scene_dp_8dev_grads_match_vmap_serial``); the sharded frame bit
  for bit (each rank renders the same tiles).

Each file holds at most three tests, one rank set or two, and the JAX
programs its tests read: pytest-xdist's ``--dist loadfile`` queues files
by descending test count, so these run after the JAX package's long
``tests/test_parallel_resume.py`` has started.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

import jax_parallel_refs

from ucnerf_torch.models.factory import create_models
from ucnerf_torch.parallel import launch
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import loop as t_loop
from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax

from test_torch_train import ARGS, _case, _draws
from torch_parallel_worker import relu_choices

torch.set_num_threads(1)

TIMEOUT = 60          # s for each set of spawned ranks
RAY_CASES = {         # name: (flags, JAX key, JAX's ReLU choices)
    "plain": ({}, 21, False),
    # 85 + 32 rays, odd, and the 3 source views split too, at the key of
    # JAX's view test; at this key a few of the MLP's pre-activations lie
    # within round-off of 0 and their ReLUs flip between the packages
    # (tests/view_split_key_gaps.py), so the port takes JAX's choices
    "padded_views": ({"batch_size": 85, "shard_mvs_views": True}, 5, True),
}


def _argv(cfg, **flags):
    """The CLI flags of ``ARGS`` with ``cfg``'s ray count and ``flags``."""
    out = [*ARGS, "--batch_size", str(cfg.batch_size)]
    for k, v in flags.items():
        out += [f"--{k}"] + ([] if v is True else
                             [str(x) for x in np.atleast_1d(v)])
    return out


def _np_params(params):
    return {k: {n: t.numpy() for n, t in sd.items()}
            for k, sd in params.items()}


def _spawn(shape, axes, jobs):
    return launch.run_ranks("torch_parallel_worker:run_jobs", (jobs,),
                            shape, axes, "cpu", timeout=TIMEOUT)[0]


def spawn_both(first, second):
    """Two rank sets (each ``(shape, axes, jobs)``) at once: their
    results."""
    with ThreadPoolExecutor(2) as pool:
        a, b = (pool.submit(_spawn, *x) for x in (first, second))
        return a.result(), b.result()


def _draw_arrays(draws):
    return tuple(t.numpy() for t in draws)


def parallel_case() -> dict:
    """``test_torch_train``'s case (config, sample, seeded weights in both
    trees) with the weights as numpy for the ranks."""
    c = _case()
    return dict(c, np_params=_np_params(c["params"]))


def jax_spec(case, **spec) -> dict:
    return dict(cfg=dataclasses.asdict(case["cfg"]), params=case["jparams"],
                **spec)


def run_both(port_fn, todo: dict):
    """(``port_fn()``, {name: JAX result}): the port's ranks run on a
    thread while this one traces the JAX references of ``todo`` ({name:
    (kind, spec)}, ``tests/jax_parallel_refs.py``) one after the other,
    each compiled on a thread of its own as soon as it is traced."""
    with ThreadPoolExecutor(1 + len(todo)) as pool:
        port = pool.submit(port_fn)
        futures = {k: pool.submit(jax_parallel_refs.run,
                                  *jax_parallel_refs.lowered(*v))
                   for k, v in todo.items()}
        return port.result(), {k: f.result() for k, f in futures.items()}


def _port_serial(case, cfg, samples, draws, relu=None):
    """The port's serial loss (the mean over ``samples``) and gradients;
    ``relu``: the ReLU choices of the one sample's step
    (``relu_choices``)."""
    nerf, mvs = create_models(cfg, "cpu", case["params"])
    losses = []
    for sample, d in zip(samples, draws):
        with relu_choices(relu):
            loss, _ = t_loop.scene_loss(cfg, nerf, mvs,
                                        to_device_batch(sample, "cpu"), d)
            (loss / len(samples)).backward()
        losses.append(float(loss.detach()))
    grads = {f"{name}/{n}": p.grad.numpy()
             for name, m in (("nerf", nerf), ("mvs", mvs))
             for n, p in m.named_parameters()}
    return float(np.mean(losses)), grads


def _rels(got: dict, want: dict) -> dict:
    out = {}
    for k, w in want.items():
        g = got[k]
        scale = max(np.abs(w).max(), np.abs(g).max(), 1e-10)
        out[k] = float(np.abs(g - w).max() / scale)
    return out


def check_step(port_res, jax_res, serial, loss_rtol):
    """Port vs JAX at the parity envelope, port vs serial at JAX's own
    tolerances."""
    (_, terms_j), grads_j = jax_res
    terms = port_res["metrics"]
    for k in terms_j:
        np.testing.assert_allclose(terms[k], float(terms_j[k]), rtol=6e-3,
                                   err_msg=k)
    sd = state_dict_from_jax(grads_j)
    want = {f"{name}/{n}": v for name in ("nerf", "mvs")
            for n, v in sd[name].items()}
    got = port_res["grads"]
    assert sorted(got) == sorted(want) and len(want) == 154
    rels = _rels(got, want)
    worst = max(rels, key=rels.get)
    assert float(np.median(list(rels.values()))) < 5e-3
    assert rels[worst] < 3e-2, (worst, rels[worst])
    loss_s, grads_s = serial
    np.testing.assert_allclose(terms["loss"], loss_s, rtol=loss_rtol)
    rels_s = _rels(got, grads_s)
    worst = max(rels_s, key=rels_s.get)
    assert rels_s[worst] <= 1e-1, (worst, rels_s[worst])


@pytest.fixture(scope="module")
def case():
    return parallel_case()


@pytest.fixture(scope="module")
def rays(case):
    """Each ray case's config and draws, JAX's ReLU choices where the case
    asks for them (its serial step's), the port's 2-rank step taking them
    and JAX's ``_ray_dp_loss_fn`` on a 2-device mesh."""
    cases, pending = {}, {}
    with ThreadPoolExecutor(1) as pool:
        for name, (flags, seed, same_relu) in RAY_CASES.items():
            cfg = case["cfg"].replace(**flags)
            cases[name] = (cfg, _draws(cfg, jax.random.PRNGKey(seed)))
            if same_relu:
                pending[name] = pool.submit(
                    jax_parallel_refs.run, *jax_parallel_refs.lowered(
                        "relu", dict(jax_spec(case, sample=case["sample"],
                                              seed=seed),
                                     cfg=dataclasses.asdict(cfg))))
        relu = {}

        def port():
            relu.update({k: f.result() for k, f in pending.items()})
            jobs = [dict(kind="loss", argv=_argv(cfg, parallel_mode="rays",
                                                 **RAY_CASES[name][0]),
                         params=case["np_params"], samples=[case["sample"]],
                         draws=[_draw_arrays(draws)], relu=relu.get(name))
                    for name, (cfg, draws) in cases.items()]
            return dict(zip(cases, _spawn((2,), ("data",), jobs)))

        todo = {name: ("rays", dict(
            jax_spec(case, sample=case["sample"], seed=RAY_CASES[name][1]),
            cfg=dataclasses.asdict(cfg))) for name, (cfg, _) in cases.items()}
        got, refs = run_both(port, todo)
    return dict(cases=cases, port=got, jax=refs, relu=relu)


@pytest.mark.parametrize("name", list(RAY_CASES))
def test_ray_dp_matches_jax_and_serial(case, rays, name):
    """Ray-DP on 2 ranks: the 112 rays split in halves; then 117 rays
    (the head repeated to 118) with ``--shard_mvs_views`` (the cascade's
    3 source views split too, padded with a zero view), against
    ``_ray_dp_loss_fn`` on a 2-device mesh and the port's serial step
    (loss rtol 1e-5; 1e-4 with the view split, whose sums change
    order).  The view-split case's port runs take the ReLU choices of
    JAX's serial step at its key."""
    cfg, draws = rays["cases"][name]
    serial = _port_serial(case, cfg, [case["sample"]], [draws],
                          rays["relu"].get(name))
    check_step(rays["port"][name], rays["jax"][name], serial,
               1e-4 if cfg.shard_mvs_views else 1e-5)
