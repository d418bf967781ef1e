"""Measure, with the JAX package on the CPU, the two gaps that bound
``chip_smoke.py`` phase ``options`` on the card:

- (a) the JAX package's bfloat16 cascade (``--mvs_dtype bfloat16``)
  against its float32 cascade: the stage-3 depth's mean relative error
  and the confidence's max abs difference, compiled without XLA's excess
  precision (``EXACT_BF16``);
- (c) the JAX package's ``--use_color_volume --color_volume_depths 64``
  frame against its exact frame of the same pose: the mean abs error of
  rgb and of depth (``tests/test_color_volume.py`` bounds them at 32x64).

Both at the serving point of ``chip_smoke.py`` (the synthetic scene at
320x256, V=7, 90 samples, cascade 48/32/8), on val sample 0 and its
target pose, with the port's weights drawn from ``--seed`` (123456, as
``python -m ucnerf_torch.serve`` draws them) and carried into the JAX
tree by ``jax_params_from_state_dict``.  Prints one JSON line.

    JAX_PLATFORMS=cpu python scripts/jax_option_gaps.py

With ``--bf16_step`` it measures instead, at the small shape, seeded
weights and PRNG key of ``tests/test_torch_train_bf16.py``, the gap that
bounds that test, between two roundings of one JAX computation:

- (e) the bf16 train step's 154 gradients at ``SCENE_REFS["bf16"]``,
  compiled without excess precision at optimization level 0 and at XLA's
  default: the per-tensor rel (max abs diff over the larger max abs),
  median and worst;

and beside it:

- (d) the bf16 MLP of the JAX train step on ``mlp_inputs()`` and an
  output cotangent, compiled with XLA's excess precision and without:
  the output's max abs difference, the parameter gradients' median and
  worst rel, the features' gradient's rel;
- (f) the port's plain MLP on the same inputs against the exact JAX one;
- (g) the port's bf16 step against the exact JAX one at optimization
  level 0, with its own ReLU choices and with the JAX step's
  (``tests/torch_parallel_worker.py::relu_choices``);
- (h) the ReLU choices that differ, per ReLU of the MLP (the six trunk
  layers, the two view heads, the blended alpha): the JAX step at level
  0 against the default, and the port's step against the JAX step at
  level 0;

(f), (g) and (h) for each of four arms of the MLP's rounding
(``tests/bf16_rounding.py``): the forward rounding of a
dense layer, ``kernel`` (the fused kernel's: one rounding after the f32
bias add) or ``flax`` (``nn.Dense(dtype=bfloat16)``'s: the product, the
bias and their sum), times the backward, ``autograd`` (through f32
operations on bf16 values) or ``xla`` (bf16 cotangents rounded where
XLA's transpose rounds them).

    JAX_PLATFORMS=cpu python scripts/jax_option_gaps.py --bf16_step

With ``--bf16_stages`` it splits (g)'s gap by stage, at the same shape,
weights and key, the MLP at bf16 and everything before it in float32:

- (j) each stage's forward output: per cascade stage the volume features,
  depth, confidence and depth planes, the stage-3 image features, the
  samples' depths ``z_vals``, the MLP's inputs ``pts``, ``dirs`` and
  features ``[P, 97]``; as the rel of (g) three ways: the port against
  the JAX step at XLA's default compile and at level 0, and the JAX step
  at level 0 against the default;
- (k) the port's step fed the JAX step's (level 0) ``pts``, ``dirs``,
  features and ``z_vals`` in value (the port's own graph carries the
  gradients), with its own ReLU choices, at each of the four rounding
  arms of (f)-(h): the 154 gradients' median and worst rel against the
  JAX step at level 0 and the ReLU choices that differ from that step's
  (and, beside them, the JAX step's own at level 0 against the
  default).

    JAX_PLATFORMS=cpu python scripts/jax_option_gaps.py --bf16_stages

With ``--bf16_view_split`` it measures, at the same small shape and bf16
MLP, the ray-DP view split of ``tests/test_torch_parallel.py``'s
``padded_views`` case (2 devices or ranks, 85 + 32 rays, the cascade's
views split too, its key, each package's own ReLU choices) against the
serial step of the same package, as ``chip_smoke.py`` phase ``mesh``
holds the port's on the card (worst gradient rel ``MESH_GRAD_RTOL``):

- (i) the JAX package's view split against its serial step, both
  compiled without excess precision, and the port's (2 gloo ranks on the
  CPU) against its serial step at each rounding arm: per-tensor rel
  median, worst and the worst's tensor, and the loss's rel.

    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python scripts/jax_option_gaps.py --bf16_view_split
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.config import parse_config as j_parse_config
from ucnerf_tpu.data import build_dataset as j_build_dataset
from ucnerf_tpu.models.factory import create_models as j_create_models
from ucnerf_tpu.render.serving import ServingRenderer as JServingRenderer
from ucnerf_tpu.train.loop import to_device_batch

from ucnerf_torch.config import parse_config
from ucnerf_torch.models.factory import init_params
from ucnerf_torch.utils.checkpoint_io import jax_params_from_state_dict

SERVE_ARGS = ["--dataset_name", "synthetic", "--img_wh", "320", "256",
              "--view_num", "7"]
# XLA on the CPU keeps a bf16 convolution's output at f32 by default
# ("excess precision"); without it, the output rounds to bf16 as the
# program says and as the TPU and the card's cuDNN round it
EXACT_BF16 = {"xla_allow_excess_precision": False}


def cascade_gap(cfg, params, batch) -> dict:
    """Stage-3 depth mean rel error and confidence max abs of the bf16
    cascade against the f32 one."""
    outs = {}
    for dt in ("float32", "bfloat16"):
        _, mvs = j_create_models(cfg.replace(mvs_dtype=dt))
        near, far = batch["near_fars"][0, 0], batch["near_fars"][0, 1]
        out = jax.jit(lambda p, b: mvs.apply(
            {"params": p}, b["images"][1:], b["affine_mat"],
            b["affine_mat_inv"], near, far, pad=cfg.pad),
            compiler_options=EXACT_BF16)(params["mvs"], batch)
        outs[dt] = {k: np.asarray(out["stage3"][k], np.float64)
                    for k in ("depth", "photometric_confidence")}
    d32, d16 = outs["float32"]["depth"], outs["bfloat16"]["depth"]
    c32 = outs["float32"]["photometric_confidence"]
    c16 = outs["bfloat16"]["photometric_confidence"]
    return dict(depth_mean_rel=float(np.mean(np.abs(d16 - d32)
                                             / np.abs(d32))),
                confidence_max_abs=float(np.abs(c16 - c32).max()),
                confidence_mean_abs=float(np.abs(c16 - c32).mean()))


def color_volume_gap(cfg, params, sample, img_hw, intrinsic) -> dict:
    """Mean abs rgb and depth error of the 64-plane colour-volume frame
    against the exact frame, one pose, the JAX ServingRenderer."""
    c2w = np.asarray(sample["c2ws"][0], np.float32)
    frames = {}
    for name, c in (("exact", cfg), ("volume", cfg.replace(
            use_color_volume=True, color_volume_depths=64))):
        nerf, mvs = j_create_models(c)
        r = JServingRenderer(c, nerf, mvs, params, sample, img_hw, intrinsic)
        frames[name] = r.render_np(c2w)
    (rgb_e, depth_e, _), (rgb_v, depth_v, _) = frames["exact"], \
        frames["volume"]
    return dict(rgb_mean_abs=float(np.abs(rgb_e - rgb_v).mean()),
                depth_mean_abs=float(np.abs(depth_e - depth_v).mean()))


def _rels(a: dict, b: dict) -> list:
    return [float(np.abs(a[k] - b[k]).max()
                  / max(np.abs(a[k]).max(), np.abs(b[k]).max(), 1e-10))
            for k in b]


def mlp_inputs(view_num: int, n: int = 64, s: int = 9):
    """Seeded MLP inputs and an output cotangent: pts [n, s, 3] in [0, 1],
    dirs [n, 3], feats [n, s, 24 + 12 (view_num - 1) + 1] with the
    confidence in [0, 1], cotangent [n, s, 4]."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, s, 24 + 12 * (view_num - 1) + 1))
    feats[..., -1] = rng.uniform(0, 1, (n, s))
    return tuple(a.astype(np.float32) for a in (
        rng.uniform(0, 1, (n, s, 3)), rng.normal(size=(n, 3)), feats,
        rng.normal(size=(n, s, 4))))


ARMS = [(f, b) for f in ("kernel", "flax") for b in ("autograd", "xla")]


def bf16_step_gaps() -> dict:
    """(d)-(h) of the module's docstring."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    import torch
    import jax_parallel_refs
    from test_torch_train import (JIT_QUICK, SCENE_REFS, _case, _draws,
                                  _jcfg, _port)
    from torch_parallel_worker import relu_choices
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.train import loop as t_loop
    from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax
    from ucnerf_tpu.train import loop as j_loop
    torch.set_num_threads(1)
    c = _case()
    cfg = c["cfg"].replace(**SCENE_REFS["bf16"][0])
    jcfg = _jcfg(cfg)
    jnerf, jmvs = j_create_models(jcfg)
    p = jax.tree.map(jnp.asarray, c["jparams"])
    exact = {**JIT_QUICK, **EXACT_BF16}

    def flat(grads):
        sd = state_dict_from_jax({"nerf": grads["nerf"], "mvs": grads.get(
            "mvs", c["jparams"]["mvs"])})
        return {f"{k}/{n}": np.asarray(v) for k in ("nerf", "mvs")
                if k in grads for n, v in sd[k].items()}

    def port_grads(*modules):
        return {f"{k}/{n}": q.grad.numpy() for k, m in modules
                for n, q in m.named_parameters()}

    # (d) and (f): the MLP alone
    pts, dirs, feats, ct = mlp_inputs(cfg.view_num)

    def mlp_loss(pn, f):
        out = jnerf.apply({"params": pn}, pts, dirs, f)
        return jnp.sum(out * ct), out
    mlp = jax.jit(jax.value_and_grad(mlp_loss, argnums=(0, 1), has_aux=True))
    runs = {}
    for name, opts in (("exact", exact), ("excess", JIT_QUICK)):
        (_, out), (g, gf) = mlp.lower(p["nerf"], feats).compile(opts)(
            p["nerf"], feats)
        runs[name] = (np.asarray(out), flat({"nerf": g}), np.asarray(gf))
    (o1, g1, f1), (o2, g2, f2) = runs["exact"], runs["excess"]
    rels = _rels(g2, g1)
    out = dict(mlp_excess_vs_exact=dict(
        out=float(np.abs(o1 - o2).max()), median=float(np.median(rels)),
        worst=max(rels), feats=_rels({"f": f2}, {"f": f1})[0]))
    from bf16_rounding import rounding
    for arm in ARMS:
        nerf, _ = _port(cfg, c["params"])
        with rounding(nerf, *arm):
            o = nerf(torch.from_numpy(pts), torch.from_numpy(dirs),
                     torch.from_numpy(feats))
            (o * torch.from_numpy(ct)).sum().backward()
        rels = _rels(port_grads(("nerf", nerf)), g1)
        out["port_mlp_vs_exact_" + "_".join(arm)] = dict(
            out=float(np.abs(o.detach().numpy() - o1).max()),
            median=float(np.median(rels)), worst=max(rels))

    # (e) and (g): the step
    batch = j_loop.to_device_batch(c["sample"])
    key = jax.random.PRNGKey(SCENE_REFS["bf16"][1])
    step = jax.jit(jax.grad(lambda pm: j_loop.scene_loss(
        jcfg, jnerf, jmvs, pm, batch, key)[0]))
    grads = {name: flat(jax.tree.map(np.asarray, step.lower(p).compile(
        opts)(p))) for name, opts in (("level0", exact),
                                      ("default", EXACT_BF16))}
    rels = _rels(grads["default"], grads["level0"])
    out["step_level0_vs_default"] = dict(
        median=float(np.median(rels)), worst=max(rels), tensors=len(rels))
    choose = jax.jit(jax_parallel_refs.relu_choices(jcfg, jnerf, jmvs)
                     ).lower(p, batch, key)
    masks, masks_default = ([np.asarray(m) for m in choose.compile(opts)(
        p, batch, key)] for opts in (exact, EXACT_BF16))

    def flips(a, b):
        return [int((x != y).sum()) for x, y in zip(a, b)]
    out["relu_flips"] = dict(level0_vs_default=flips(masks, masks_default),
                             samples=[int(m.size) for m in masks])
    for arm in ARMS:
        tag = "_".join(arm)
        for same in (False, True):
            nerf, mvs = _port(cfg, c["params"])
            own = []
            with rounding(nerf, *arm), relu_choices(
                    masks if same else None, record=own):
                loss, _ = t_loop.scene_loss(cfg, nerf, mvs, to_device_batch(
                    c["sample"], "cpu"), _draws(cfg, key))
                loss.backward()
            rels = _rels(port_grads(("nerf", nerf), ("mvs", mvs)),
                         grads["level0"])
            out[f"port_step_{tag}" + ("_jax_relu" if same else "")] = dict(
                median=float(np.median(rels)), worst=max(rels))
            if not same:
                out["relu_flips"]["port_" + tag] = flips(own, masks)
    return out


STAGE_KEYS = ("volume_feature", "depth", "photometric_confidence",
              "depth_values")


def _stage_arrays(mvs_out, rays, dirs, feats) -> dict:
    out = {f"stage{s}/{k}": mvs_out[f"stage{s}"][k] for s in (1, 2, 3)
           for k in STAGE_KEYS}
    out.update(img_feats=mvs_out["img_feats"], z_vals=rays[
        "depth_candidates"], pts=rays["ndc"]["ndc"], dirs=dirs, feats=feats)
    return out


def bf16_stage_gaps() -> dict:
    """(j) and (k) of the module's docstring."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    import contextlib
    from unittest import mock
    import jax_parallel_refs
    from test_torch_train import SCENE_REFS, JIT_QUICK, _case, _draws, _jcfg, \
        _port
    from torch_parallel_worker import relu_choices
    from ucnerf_torch.render import renderer as t_renderer
    from ucnerf_torch.render.serving import to_device_batch as t_batch
    from ucnerf_torch.train import loop as t_loop
    from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax
    from ucnerf_tpu.render import renderer as j_renderer
    from ucnerf_tpu.render.fast_feats import gen_pts_feats_fast
    from ucnerf_tpu.train import loop as j_loop
    torch.set_num_threads(1)
    c = _case()
    cfg = c["cfg"].replace(**SCENE_REFS["bf16"][0])
    jcfg = _jcfg(cfg)
    jnerf, jmvs = j_create_models(jcfg)
    p = jax.tree.map(jnp.asarray, c["jparams"])
    batch = j_loop.to_device_batch(c["sample"])
    key = jax.random.PRNGKey(SCENE_REFS["bf16"][1])
    level0, default = {**JIT_QUICK, **EXACT_BF16}, EXACT_BF16

    def j_stages(q):
        imgs, mvs_out, conf, rays = j_loop.scene_inputs(jcfg, jmvs, q, batch,
                                                        key)
        cos = jnp.linalg.norm(rays["rays_d"], axis=-1)
        dirs = j_renderer.gen_dir_feature(batch["w2cs"][0],
                                          rays["rays_d"] / cos[..., None])
        ctx = j_renderer.make_feat_ctx(mvs_out, conf, imgs[1:],
                                       batch["w2cs"][1:],
                                       batch["intrinsics"][1:])
        feats = gen_pts_feats_fast(rays, ctx["stage_volumes"],
                                   ctx["confidence"], ctx["quad_views"],
                                   ctx["src_w2cs"], ctx["src_intrinsics"],
                                   ctx["img_hw"])
        return _stage_arrays(mvs_out, rays, dirs, feats)
    lowered = jax.jit(j_stages).lower(p)
    jax_st = {name: {k: np.asarray(v, np.float64) for k, v in
                     lowered.compile(opts)(p).items()}
              for name, opts in (("level0", level0), ("default", default))}

    tb = t_batch(c["sample"], "cpu")
    draws = _draws(cfg, key)
    nerf, mvs = _port(cfg, c["params"])
    with torch.no_grad():
        imgs, mvs_out, conf, rays = t_loop.scene_inputs(cfg, mvs, tb, draws)
        cos = torch.linalg.norm(rays["rays_d"], dim=-1)
        dirs = t_renderer.gen_dir_feature(tb["w2cs"][0],
                                          rays["rays_d"] / cos[..., None])
        ctx = t_renderer.make_feat_ctx(mvs_out, conf, imgs[1:],
                                       tb["w2cs"][1:], tb["intrinsics"][1:])
        feats = t_renderer.gen_pts_feats_fast(
            rays, ctx["stage_volumes"], ctx["confidence"], ctx["views"],
            ctx["src_w2cs"], ctx["src_intrinsics"], ctx["img_hw"])
    port_st = {k: v.double().numpy() for k, v in _stage_arrays(
        mvs_out, rays, dirs, feats).items()}

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(a).max(),
                                                np.abs(b).max(), 1e-30))
    out = {"stages": {k: dict(
        port_vs_default=rel(port_st[k], jax_st["default"][k]),
        port_vs_level0=rel(port_st[k], jax_st["level0"][k]),
        level0_vs_default=rel(jax_st["level0"][k], jax_st["default"][k]),
        shape=list(port_st[k].shape)) for k in jax_st["level0"]}}

    # (k): the JAX step's MLP inputs in value, the port's graph for the
    # gradients, the port's own ReLU choices
    grads = jax.jit(jax.grad(lambda q: j_loop.scene_loss(
        jcfg, jnerf, jmvs, q, batch, key)[0])).lower(p).compile(level0)(p)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    want = {f"{k}/{n}": np.asarray(v) for k in ("nerf", "mvs")
            for n, v in sd[k].items()}
    masks = [np.asarray(m) for m in jax.jit(jax_parallel_refs.relu_choices(
        jcfg, jnerf, jmvs)).lower(p, batch, key).compile(level0)(
            p, batch, key)]
    fed = {k: torch.from_numpy(jax_st["level0"][k].astype(np.float32))
           for k in ("pts", "dirs", "feats", "z_vals")}

    def value_of(t, name):
        return t + (fed[name] - t).detach()
    build, dirf, featf = (t_loop.build_train_rays,
                          t_renderer.gen_dir_feature,
                          t_renderer.gen_pts_feats_fast)

    def build_fed(*a, **kw):
        r = build(*a, **kw)
        r["ndc"] = dict(r["ndc"], ndc=value_of(r["ndc"]["ndc"], "pts"))
        r["depth_candidates"] = value_of(r["depth_candidates"], "z_vals")
        return r
    from bf16_rounding import rounding
    for arm in ARMS:
        nerf, mvs = _port(cfg, c["params"])
        own = []
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(t_loop, "build_train_rays",
                                                  build_fed))
            stack.enter_context(mock.patch.object(
                t_renderer, "gen_dir_feature",
                lambda *a: value_of(dirf(*a), "dirs")))
            stack.enter_context(mock.patch.object(
                t_renderer, "gen_pts_feats_fast",
                lambda *a, **kw: value_of(featf(*a, **kw), "feats")))
            stack.enter_context(rounding(nerf, *arm))
            stack.enter_context(relu_choices(None, record=own))
            loss, _ = t_loop.scene_loss(cfg, nerf, mvs, t_batch(
                c["sample"], "cpu"), draws)
            loss.backward()
        got = {f"{k}/{n}": q.grad.numpy() for k, m in (("nerf", nerf),
                                                       ("mvs", mvs))
               for n, q in m.named_parameters()}
        rels = _rels(got, want)
        out["port_step_fed_jax_mlp_inputs_" + "_".join(arm)] = dict(
            median=float(np.median(rels)), worst=max(rels),
            tensors=len(rels),
            relu_flips=[int((x != y).sum()) for x, y in zip(own, masks)])
    out["relu_flips_level0_vs_default"] = [
        int((x != y).sum()) for x, y in zip(masks, [
            np.asarray(m) for m in jax.jit(jax_parallel_refs.relu_choices(
                jcfg, jnerf, jmvs)).lower(p, batch, key).compile(default)(
                    p, batch, key)])]
    return out


def bf16_view_split_gaps() -> dict:
    """(i) of the module's docstring."""
    import dataclasses
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    import jax_parallel_refs
    from test_torch_parallel import (RAY_CASES, _argv, _draw_arrays, _rels,
                                     _spawn, parallel_case)
    from test_torch_train import JIT_QUICK, _draws, _jcfg, _port
    from bf16_rounding import rounding
    from ucnerf_torch.render.serving import to_device_batch as t_device_batch
    from ucnerf_torch.train import loop as t_loop
    from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax
    from ucnerf_tpu.train import loop as j_loop
    torch.set_num_threads(1)
    case = parallel_case()
    flags, seed, _ = RAY_CASES["padded_views"]
    cfg = case["cfg"].replace(nerf_dtype="bfloat16", **flags)
    exact = {**JIT_QUICK, **EXACT_BF16}

    def gap(split, serial):
        rels = _rels(split, serial)
        return dict(median=float(np.median(list(rels.values()))),
                    worst=max(rels.values()),
                    worst_tensor=max(rels, key=rels.get))

    def flat(grads):
        sd = state_dict_from_jax(grads)
        return {f"{k}/{n}": np.asarray(v) for k in ("nerf", "mvs")
                for n, v in sd[k].items()}
    spec = dict(cfg=dataclasses.asdict(cfg), params=case["jparams"],
                sample=case["sample"], seed=seed)
    split_fn, args = jax_parallel_refs.lowered("rays", spec)
    (_, terms_split), g_split = jax.tree.map(
        np.asarray, split_fn.compile(exact)(*args))
    jcfg = _jcfg(cfg)
    jnerf, jmvs = j_create_models(jcfg)
    batch = to_device_batch(case["sample"])
    key = jax.random.PRNGKey(seed)
    p = jax.tree.map(jnp.asarray, case["jparams"])
    serial = jax.jit(jax.value_and_grad(lambda q: j_loop.scene_loss(
        jcfg, jnerf, jmvs, q, batch, key), has_aux=True))
    (_, terms_serial), g_serial = jax.tree.map(
        np.asarray, serial.lower(p).compile(exact)(p))
    out = dict(jax_package=dict(
        gap(flat(g_split), flat(g_serial)),
        loss_rel=abs(float(terms_split["loss"])
                     / float(terms_serial["loss"]) - 1)))
    draws = _draws(cfg, key)
    argv = _argv(cfg, parallel_mode="rays", nerf_dtype="bfloat16",
                 **flags)
    jobs = [dict(kind="loss", argv=argv, params=case["np_params"],
                 samples=[case["sample"]], draws=[_draw_arrays(draws)],
                 rounding=arm) for arm in ARMS]
    ranks = _spawn((2,), ("data",), jobs)
    for arm, res in zip(ARMS, ranks):
        nerf, mvs = _port(cfg, case["params"])
        with rounding(nerf, *arm):
            loss, _ = t_loop.scene_loss(cfg, nerf, mvs, t_device_batch(
                case["sample"], "cpu"), draws)
            loss.backward()
        g_s = {f"{name}/{n}": q.grad.numpy()
               for name, m in (("nerf", nerf), ("mvs", mvs))
               for n, q in m.named_parameters()}
        out["port_" + "_".join(arm)] = dict(
            gap(res["grads"], g_s), loss_rel=abs(float(
                res["metrics"]["loss"]) / float(loss.detach()) - 1))
    return out


def main():
    t0 = time.perf_counter()
    if "--bf16_view_split" in sys.argv[1:]:
        print(json.dumps(dict(bf16_view_split_gaps(), jax=jax.__version__,
                              seconds=time.perf_counter() - t0)))
        return
    if "--bf16_stages" in sys.argv[1:]:
        print(json.dumps(dict(bf16_stage_gaps(), jax=jax.__version__,
                              seconds=time.perf_counter() - t0)))
        return
    if "--bf16_step" in sys.argv[1:]:
        print(json.dumps(dict(bf16_step_gaps(), jax=jax.__version__,
                              seconds=time.perf_counter() - t0)))
        return
    cfg = j_parse_config(SERVE_ARGS)
    params = jax.tree.map(jnp.asarray, jax_params_from_state_dict(
        init_params(parse_config(SERVE_ARGS),
                    torch.Generator().manual_seed(cfg.seed), "cpu")))
    ds = j_build_dataset(cfg, "val")
    sample = ds[0]
    W, H = ds.img_wh
    res = dict(img_wh=[W, H], view_num=cfg.view_num, seed=cfg.seed,
               cascade_bf16_vs_f32=cascade_gap(cfg, params,
                                               to_device_batch(sample)),
               color_volume_64_vs_exact=color_volume_gap(
                   cfg, params, sample, (H, W),
                   ds.scene[ds.metas[0][0]]["intrinsic"]),
               jax=jax.__version__, device=str(jax.devices()[0]),
               seconds=time.perf_counter() - t0)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
