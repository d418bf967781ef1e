"""The renderer's options in an eval render, against the JAX package's at
32x64, V=4: ``--use_color_volume`` and ``--eval_jitter``'s tile with
JAX's draws injected.  (The grid samplers are in
``tests/test_torch_options.py``.)  Two tests, so that pytest-xdist's
``--dist loadfile`` queues this file after the suite's long JAX files."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.config import parse_config as j_parse_config
from ucnerf_tpu.models.factory import create_models as j_create_models
from ucnerf_tpu.train import loop as j_loop

from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.kernels.fused_mlp import FusedNeRFMLP
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import loop as t_loop
from ucnerf_torch.utils.checkpoint_io import jax_params_from_state_dict

from test_torch_serving import ARGS

torch.set_num_threads(1)

# compile time, not run time, dominates these references on the CPU
JIT_QUICK = {"xla_backend_optimization_level": 0}
H, W = 32, 64


@pytest.fixture(scope="module")
def scene():
    cfg = parse_config(ARGS)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return dict(cfg=cfg, params=params,
                jparams=jax.tree.map(jnp.asarray,
                                     jax_params_from_state_dict(params)),
                sample=build_dataset(cfg, "val")[0])


def test_color_volume_eval_render_matches_jax(scene):
    """``--use_color_volume --color_volume_depths 16``: the port's eval
    render against the JAX package's ``make_eval_render`` on the same
    weights and sample, to the tolerances of
    ``tests/test_torch_serving.py``'s frames (rgb abs 2e-3, depth rel
    5e-3, confidence mean abs 2e-3)."""
    cfg = scene["cfg"].replace(use_color_volume=True, color_volume_depths=16)
    jcfg = j_parse_config(ARGS).replace(use_color_volume=True,
                                        color_volume_depths=16,
                                        eval_unroll=1)
    jnerf, jmvs = j_create_models(jcfg)
    render_j = j_loop.make_eval_render(jcfg, jnerf, jmvs, (H, W))
    want = [np.asarray(a) for a in jax.jit(
        render_j, compiler_options=JIT_QUICK)(
        scene["jparams"], j_loop.to_device_batch(scene["sample"]))]

    nerf, mvs = create_models(cfg, "cpu", scene["params"])
    batch = to_device_batch(scene["sample"], "cpu")
    got = [t.numpy() for t in t_loop.make_eval_render(
        cfg, FusedNeRFMLP(nerf), mvs, (H, W))(batch)]
    with torch.no_grad():
        vols = t_loop.prepare_view_ctx(cfg, mvs, batch)["feat_ctx"][
            "color_volumes"]
    assert vols.shape == (cfg.view_num - 1, H * W, 16, 3 + 8 + 1)
    np.testing.assert_allclose(got[0], want[0], atol=2e-3, rtol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=5e-3, atol=0)
    assert np.abs(got[2] - want[2]).mean() < 2e-3


def test_eval_jitter_tile_matches_jax(scene):
    """``--eval_jitter``: the eval tile's rays, built by each package's
    ``view_chunk_fns`` with JAX's draws, ``jax.random.uniform`` under
    ``fold_in(PRNGKey(0), pix[0])``, injected into the port's
    ``jitter_draws``; and the port's own draws stratify within the same
    intervals."""
    cfg = scene["cfg"].replace(eval_jitter=True)
    jcfg = j_parse_config(ARGS).replace(eval_jitter=True)
    rng = np.random.default_rng(4)
    sample = scene["sample"]
    mvs_out = {}
    for k, (d, s) in zip((1, 2, 3), ((8, 4), (8, 2), (8, 1))):
        lo = rng.uniform(0.8, 1.4, (1, H // s, W // s))
        mvs_out[f"stage{k}"] = {"depth_values": (
            lo + np.linspace(0.0, 1.0, d)[:, None, None]).astype(np.float32)}
    ctx = dict(mvs_out=mvs_out, w2cs=sample["w2cs"],
               intrinsics=sample["intrinsics"], c2w_tgt=sample["c2ws"][0],
               near=sample["near_fars"][0, 0], far=sample["near_fars"][0, 1],
               eval_key=jax.random.PRNGKey(0), packed=None, nerf_params=None)
    pix = np.arange(2 * cfg.chunk, 3 * cfg.chunk, dtype=np.int32)
    build_j, _ = j_loop.view_chunk_fns(jcfg, None, H, W,
                                       jax.tree.map(jnp.asarray, ctx))
    want = jax.jit(build_j, compiler_options=JIT_QUICK)(jnp.asarray(pix))
    n_cand = 3 * (cfg.N_samples // 3)
    uniform = jax.jit(lambda p0, shape: jax.random.uniform(jax.random.fold_in(
        jax.random.PRNGKey(0), p0), shape), static_argnums=1)

    def jax_draws(p, n):
        return torch.from_numpy(np.array(uniform(int(p[0]),
                                                 (p.shape[0], n))))
    tctx = {k: (jax.tree.map(lambda a: torch.from_numpy(np.array(a)), v)
                if k in ("mvs_out", "w2cs", "intrinsics", "c2w_tgt", "near",
                         "far") else v) for k, v in ctx.items()}
    tctx["jitter_draws"] = jax_draws
    build_t, _ = t_loop.view_chunk_fns(cfg, None, H, W, tctx)
    got = build_t(torch.from_numpy(pix).long())
    assert got["depth_candidates"].shape == (cfg.chunk, n_cand)
    for key in ("depth_candidates", "points_world"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key, val in want["ndc"].items():
        np.testing.assert_allclose(got["ndc"][key].numpy(), np.asarray(val),
                                   rtol=1e-5, atol=1e-5, err_msg=key)

    # the port's own draws: jittered, inside the midpoint intervals
    tctx["jitter_draws"] = None
    plain = t_loop.view_chunk_fns(cfg, None, H, W, tctx)[0](
        torch.from_numpy(pix).long())["depth_candidates"]
    gen = torch.Generator().manual_seed(0)
    tctx["jitter_draws"] = lambda p, n: torch.rand((p.shape[0], n),
                                                   generator=gen)
    jit = t_loop.view_chunk_fns(cfg, None, H, W, tctx)[0](
        torch.from_numpy(pix).long())["depth_candidates"]
    mids = 0.5 * (plain[:, 1:] + plain[:, :-1])
    assert not torch.equal(jit, plain)
    assert (jit[:, 1:] >= mids).all() and (jit[:, :-1] <= mids).all()
