"""The renderer's options in ucnerf_torch against the JAX package's, at
32x64, V=4: the grid samplers of the literal featurization, an eval render
with ``--use_color_volume``, and ``--eval_jitter``'s tile with JAX's draws
injected.  (The literal featurization's tensors are in
``tests/test_torch_ops.py``, its train step in ``tests/test_torch_train.py``,
the bf16 cascade in ``tests/test_torch_mvs.py``.)"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.config import parse_config as j_parse_config
from ucnerf_tpu.models.factory import create_models as j_create_models
from ucnerf_tpu.ops import grid_sample as j_gs
from ucnerf_tpu.train import loop as j_loop

from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.kernels.fused_mlp import FusedNeRFMLP
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.ops import grid_sample as t_gs
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import loop as t_loop
from ucnerf_torch.utils.checkpoint_io import jax_params_from_state_dict

from test_torch_serving import ARGS

torch.set_num_threads(1)

# compile time, not run time, dominates these references on the CPU
JIT_QUICK = {"xla_backend_optimization_level": 0}
H, W = 32, 64
GS_CASES = [(dims, mode, pad, ac) for dims, mode, pad, ac in itertools.product(
    (2, 3), ("bilinear", "nearest"), ("border", "zeros"), (False, True))
    if not (dims == 3 and mode == "nearest")]


@pytest.fixture(scope="module")
def grids():
    """A [6, 5, 4] image and a [3, 6, 5, 4] volume, and grids reaching
    past [-1, 1] on every axis, with points at exact half-pixel positions
    (the nearest mode's ties) for both corner conventions; every JAX
    sample compiled as one function."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((6, 5, 4)).astype(np.float32)
    vol = rng.standard_normal((3, 6, 5, 4)).astype(np.float32)
    g2 = rng.uniform(-1.3, 1.3, (40, 2)).astype(np.float32)
    g3 = rng.uniform(-1.3, 1.3, (40, 3)).astype(np.float32)
    # x = 1.5 px: (2*1.5 + 1) / 5 - 1 without, 1.5 / 2 - 1 with corners
    ties = np.array([[-0.2, -0.5], [-0.25, -0.25], [0.2, 0.5]], np.float32)
    g2 = np.concatenate([g2, ties])

    def refs(img, vol, g2, g3):
        return {c: (j_gs.grid_sample_2d(img, g2, c[1], c[2], c[3])
                    if c[0] == 2 else
                    j_gs.grid_sample_3d(vol, g3, c[1], c[2], c[3]))
                for c in GS_CASES}
    j = jax.jit(refs, compiler_options=JIT_QUICK)(img, vol, g2, g3)
    return dict(img=img, vol=vol, g2=g2, g3=g3,
                j={c: np.asarray(v) for c, v in j.items()})


@pytest.mark.parametrize("dims,mode,padding,align_corners", GS_CASES)
def test_grid_sample_matches_jax(grids, dims, mode, padding, align_corners):
    """``ops.grid_sample`` against the JAX package's samplers: every mode,
    padding and corner convention each has (3D: trilinear only)."""
    t = lambda a: torch.from_numpy(np.array(a))
    if dims == 2:
        got = t_gs.grid_sample_2d(t(grids["img"]), t(grids["g2"]), mode,
                                  padding, align_corners)
    else:
        got = t_gs.grid_sample_3d(t(grids["vol"]), t(grids["g3"]), mode,
                                  padding, align_corners)
    want = grids["j"][(dims, mode, padding, align_corners)]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_grid_sample_3d_refuses_nearest():
    vol = torch.zeros((2, 2, 2, 1))
    with pytest.raises(ValueError, match="nearest"):
        t_gs.grid_sample_3d(vol, torch.zeros((1, 3)), mode="nearest")
    with pytest.raises(ValueError, match="nearest"):
        j_gs.grid_sample_3d(jnp.asarray(vol.numpy()), jnp.zeros((1, 3)),
                            mode="nearest")


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
