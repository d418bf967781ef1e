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
- (f) the port's plain MLP (the fused kernel's rounding) on the same
  inputs against the exact JAX one;
- (g) the port's bf16 step against the exact JAX one at optimization
  level 0, with its own ReLU choices and with the JAX step's
  (``tests/torch_parallel_worker.py::relu_choices``);
- (h) the ReLU choices that differ, per ReLU of the MLP (the six trunk
  layers, the two view heads, the blended alpha): the JAX step at level
  0 against the default, and the port's step against the JAX step at
  level 0;
- (f), (g) and (h) again with the port's plain MLP rounding as flax's
  ``nn.Dense(dtype=bfloat16)`` does (the product, the bias and their sum
  to bf16; ``_flax_rounding``, this script only).

    JAX_PLATFORMS=cpu python scripts/jax_option_gaps.py --bf16_step
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def _flax_rounding():
    """The port's plain MLP (``ucnerf_torch/models/nerf.py``) rounding each
    dense layer as flax's ``nn.Dense(dtype=bfloat16)`` does."""
    import torch.nn.functional as F
    from ucnerf_torch.models.nerf import BaseAdaptRenderer

    def dense(self, x, layer):
        r = self._round
        return r(r(F.linear(x, r(layer.weight))) + r(layer.bias))
    saved = BaseAdaptRenderer._dense
    BaseAdaptRenderer._dense = dense
    try:
        yield
    finally:
        BaseAdaptRenderer._dense = saved


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
    for tag, rounding in (("", contextlib.nullcontext), ("_flax",
                                                        _flax_rounding)):
        nerf, _ = _port(cfg, c["params"])
        with rounding():
            o = nerf(torch.from_numpy(pts), torch.from_numpy(dirs),
                     torch.from_numpy(feats))
        (o * torch.from_numpy(ct)).sum().backward()
        rels = _rels(port_grads(("nerf", nerf)), g1)
        out["port_mlp_vs_exact" + tag] = dict(
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
    for tag, rounding in (("", contextlib.nullcontext), ("_flax",
                                                        _flax_rounding)):
        for same in (False, True):
            nerf, mvs = _port(cfg, c["params"])
            own = []
            with rounding(), relu_choices(masks if same else None,
                                          record=own):
                loss, _ = t_loop.scene_loss(cfg, nerf, mvs, to_device_batch(
                    c["sample"], "cpu"), _draws(cfg, key))
                loss.backward()
            rels = _rels(port_grads(("nerf", nerf), ("mvs", mvs)),
                         grads["level0"])
            out["port_step" + tag + ("_jax_relu" if same else "")] = dict(
                median=float(np.median(rels)), worst=max(rels))
            if not same:
                out["relu_flips"]["port" + tag] = flips(own, masks)
    return out


def main():
    t0 = time.perf_counter()
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
