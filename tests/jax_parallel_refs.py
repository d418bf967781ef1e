"""The JAX references of ``tests/test_torch_parallel.py``: one of the JAX
package's parallel functions, traced, compiled at optimization level 0
and run on the conftest's 8-device CPU mesh, from numpy inputs (the
port's seeded weights in the JAX tree, its samples, JAX's keys).  pytest
does not collect it.

``lowered(kind, spec)`` -> (the traced program, its arguments), and
``run(lowered, args)`` compiles and runs it to numpy, for ``kind``:
``rays`` (``_ray_dp_loss_fn`` on a 2-device mesh) and ``scenes``
(``_scene_dp_loss_fn`` on the batch sharded over 2 devices), each its
loss, metrics and gradients; ``cascade`` (``make_view_sharded_cascade``
on ``n`` devices) and ``render`` (``make_parallel_eval_render`` on the
mesh ``spec["mesh"]``); ``relu`` (``relu_choices``).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ucnerf_tpu.config import Config
from ucnerf_tpu.models.factory import create_models
from ucnerf_tpu.parallel import sharding
from ucnerf_tpu.parallel.mesh import make_mesh
from ucnerf_tpu.parallel.mvs_views import make_view_sharded_cascade
from ucnerf_tpu.render.fast_feats import gen_pts_feats_fast
from ucnerf_tpu.render.renderer import gen_dir_feature, make_feat_ctx
from ucnerf_tpu.train.loop import scene_inputs, to_device_batch

JIT_QUICK = {"xla_backend_optimization_level": 0}


def run(lowered, args):
    """Compile (without Python's lock for most of it) and run."""
    return jax.tree.map(np.asarray, lowered.compile(JIT_QUICK)(*args))


def _lower(fn, *args):
    return fn.lower(*args), args


def _scene_sharded(samples, mesh):
    stacked = jax.tree.map(jnp.asarray, sharding.stack_batches(samples))
    return jax.tree.map(lambda x: jax.device_put(x, NamedSharding(
        mesh, P("data", *([None] * (x.ndim - 1))))), stacked)


def relu_choices(cfg, nerf, mvs):
    """``fn(params, batch, key)`` -> the sign pattern of each ReLU of the
    JAX package's MLP in its serial train step (the fast featurization,
    ``render_rays``' inputs rebuilt from its own functions), in the
    port's call order: the trunk layers' ``dense * depth_bias``, the two
    view heads, the blended alpha; each [N_rays, S, width]."""
    def fn(p, batch, key):
        imgs, mvs_out, conf, rays = scene_inputs(cfg, mvs, p, batch, key)
        ctx = make_feat_ctx(mvs_out, conf, imgs[1:], batch["w2cs"][1:],
                            batch["intrinsics"][1:])
        feats = gen_pts_feats_fast(rays, ctx["stage_volumes"],
                                   ctx["confidence"], ctx["quad_views"],
                                   ctx["src_w2cs"], ctx["src_intrinsics"],
                                   ctx["img_hw"])
        d = rays["rays_d"]
        dirs = gen_dir_feature(batch["w2cs"][0],
                               d / jnp.linalg.norm(d, axis=-1)[..., None])
        _, state = nerf.apply({"params": p["nerf"]}, rays["ndc"]["ndc"],
                              dirs, feats, capture_intermediates=True,
                              mutable=["intermediates"])
        out = state["intermediates"]["nerf"]

        def dense(name):
            return out[name]["__call__"][0]
        u = 1.0 - feats[..., -1:]
        trunk = [dense(f"pts_linears_{i}") * dense("pts_bias_depth_fine")
                 for i in range(cfg.netdepth)]
        alpha = dense("alpha_linear") * (1.0 - u) + dense("alpha_linear_1") * u
        return [z > 0 for z in (*trunk, dense("views_linears_0"),
                                dense("view_confi_linears_0"), alpha)]
    return fn


def lowered(kind: str, spec: dict):
    cfg = Config(**spec["cfg"])
    nerf, mvs = create_models(cfg)
    p = jax.tree.map(jnp.asarray, spec["params"])
    if kind in ("rays", "scenes"):
        mesh = make_mesh((2,), ("data",))
        if kind == "rays":
            loss = sharding._ray_dp_loss_fn(cfg, nerf, mvs, mesh, "data")
            args = (to_device_batch(spec["sample"]),
                    jax.random.PRNGKey(spec["seed"]))
        else:
            loss = sharding._scene_dp_loss_fn(cfg, nerf, mvs)
            args = (_scene_sharded(spec["samples"], mesh),
                    jax.random.split(jax.random.PRNGKey(spec["seed"]), 2))
        return _lower(jax.jit(jax.value_and_grad(loss, has_aux=True)), p,
                      *args)
    batch = to_device_batch(spec["sample"])
    if kind == "relu":
        return _lower(jax.jit(relu_choices(cfg, nerf, mvs)), p, batch,
                      jax.random.PRNGKey(spec["seed"]))
    if kind == "cascade":
        fn = make_view_sharded_cascade(
            mvs, make_mesh((spec["n"],), ("data",)))
        near, far = batch["near_fars"][0, 0], batch["near_fars"][0, 1]
        return _lower(jax.jit(lambda pm, *a: fn(pm, *a, cfg.pad)),
                      p["mvs"], batch["images"][1:], batch["affine_mat"],
                      batch["affine_mat_inv"], near, far)
    shape, axes = spec["mesh"]
    H, W = spec["sample"]["images"].shape[1:3]
    render = sharding.make_parallel_eval_render(
        cfg.replace(eval_unroll=1), nerf, mvs, (H, W),
        make_mesh(shape, axes), axis=axes if len(axes) > 1 else axes[0])
    return _lower(render, p, batch)
