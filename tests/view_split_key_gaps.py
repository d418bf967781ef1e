"""Per-key gradient gaps of the padded view-split ray-DP case of
``tests/test_torch_parallel.py`` (117 rays, ``--shard_mvs_views``, 2
ranks), beside the single-device gap of the same draws.  pytest does not
collect it.

Run from the repository root (CPU only; a few minutes):

    python tests/view_split_key_gaps.py 1 2 3 4 5 6 7 8 9 10 11 12 --warp

For each JAX key it prints one JSON line with the median, over the 154
gradient tensors, of max |a - b| over the larger max |.| (the statistic
that the test holds under 5e-3 against JAX), for:

- ``port2_jax2``: the port's 2-rank view split against JAX's
  ``_ray_dp_loss_fn`` with the view split on a 2-device mesh;
- ``port1_jax1``: the port's serial ``scene_loss`` against JAX's, the
  single-device parity gap of the same draws;
- ``jax2_jax1`` and ``port2_port1``: each package's view split against
  its own serial step;
- ``port1_jax1_same_relu`` and ``port2_jax2_same_relu``: the first two
  with the port's plain MLP taking the ReLU choices of JAX's serial step
  (``torch_parallel_worker.relu_choices``), as the test's view-split
  case does.

and the discrete choices of the serial step that differ between the two
packages at that key, each counted over the step's 117 rays:

- ``patch_rays``: rays whose pixel differs (the confidence-guided patch
  pick and the uniform draw);
- ``z_floor``: samples whose depth-lerp cell (``floor`` in
  ``fast_feats.sample_volume_per_ray``) differs, per cascade stage;
- ``view_floor`` / ``view_mask``: (sample, source view) pairs whose
  bilinear corner or in-bounds mask differs (``_sample_views``);
- ``sort``: rays whose depth candidates sort in another order;
- ``relu_samples`` / ``relu_rays``: samples and rays with a ReLU whose
  sign differs, per ReLU of the MLP (six trunk layers, the two view
  heads, the blended alpha), and over all of them.

With ``--warp`` it also prints, once (the cascade does not depend on the
key), the plane-sweep cells whose nearest source pixel
(``ops/warp.py::homo_warp``'s ``round``) differs, per stage (the JAX
cascade run op by op, so that the warp's indices can be read).
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import dataclasses  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax_parallel_refs  # noqa: E402
import test_torch_parallel as tp  # noqa: E402
from test_torch_train import _case, _draws, _jcfg  # noqa: E402
from torch_parallel_worker import relu_choices  # noqa: E402
from ucnerf_tpu.models import mvs as j_mvs  # noqa: E402
from ucnerf_tpu.models.factory import create_models as j_create_models  # noqa: E402,E501
from ucnerf_tpu.ops import ndc as j_ndc  # noqa: E402
from ucnerf_tpu.train import loop as j_loop  # noqa: E402
from ucnerf_torch.models import mvs as t_mvs  # noqa: E402
from ucnerf_torch.models.factory import create_models  # noqa: E402
from ucnerf_torch.ops import ndc as t_ndc  # noqa: E402
from ucnerf_torch.render.serving import to_device_batch  # noqa: E402
from ucnerf_torch.train import loop as t_loop  # noqa: E402
from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax  # noqa: E402,E501


def _flat(grads_j) -> dict:
    sd = state_dict_from_jax(grads_j)
    return {f"{name}/{n}": v for name in ("nerf", "mvs")
            for n, v in sd[name].items()}


def _median(got: dict, want: dict) -> float:
    return float(np.median(list(tp._rels(got, want).values())))


def _cells(rays, img_hw, views):
    """Per-stage depth-lerp cells, and per source view the bilinear
    corner and in-bounds mask, of each sample of ``rays`` (numpy, one
    package's), with the package's own ``project_to_pixel``."""
    out = {}
    for k, D in zip((1, 2, 3), views["ndepths"]):
        z01 = np.asarray(rays["ndc"][f"stage{k}"])[..., 2]
        out[f"z{k}"] = np.floor(np.clip(z01 * np.float32(D) - np.float32(0.5),
                                        0, D - 1))
    H, W = img_hw
    inv = np.asarray([W - 1, H - 1], np.float32)
    pix = np.asarray(views["project"](np.asarray(rays["points_world"]), inv))
    g = pix[..., :2] * np.float32(2) - np.float32(1)
    ix = np.clip((g[..., 0] + 1) * np.float32(0.5) * (W - 1), 0, W - 1)
    iy = np.clip((g[..., 1] + 1) * np.float32(0.5) * (H - 1), 0, H - 1)
    out["corner"] = np.floor(iy) * W + np.floor(ix)
    out["mask"] = ((g[..., 0] > -1) & (g[..., 0] < 1)
                   & (g[..., 1] > -1) & (g[..., 1] < 1))
    nf = rays["stage_near_far"]
    cands = np.concatenate([np.asarray(nf[f"near_{k}"]) + (
        np.asarray(nf[f"far_{k}"]) - np.asarray(nf[f"near_{k}"]))
        * np.linspace(0, 1, views["per_stage"], dtype=np.float32)
        for k in (1, 2, 3)], axis=-1)
    out["order"] = np.argsort(cands, axis=-1, kind="stable")
    return out


def choice_counts(c, cfg, key, draws, jfwd, jrelu) -> dict:
    """The discrete choices of the serial step that differ between the
    packages at ``key`` (see the module's docstring)."""
    batch = j_loop.to_device_batch(c["sample"])
    p = jax.tree.map(jnp.asarray, c["jparams"])
    rays_j = jax.tree.map(np.asarray, jfwd(p, batch, key)[2])
    nerf, mvs = create_models(cfg, "cpu", c["params"])
    record = []
    with torch.no_grad(), relu_choices(record=record):
        rays_t = t_loop.forward_scene(cfg, nerf, mvs,
                                      to_device_batch(c["sample"], "cpu"),
                                      draws)[2]
    rays_t = jax.tree.map(lambda t: t.numpy(), rays_t)
    b = c["sample"]
    H, W = b["images"].shape[1:3]
    w2cs, ks = b["w2cs"][1:], b["intrinsics"][1:]
    common = dict(ndepths=cfg.ndepths, per_stage=cfg.N_samples // 3)
    cj = _cells(rays_j, (H, W), dict(common, project=lambda x, inv: jax.vmap(
        lambda w, k: j_ndc.project_to_pixel(x, w, k, inv))(w2cs, ks)))
    ct = _cells(rays_t, (H, W), dict(common, project=lambda x, inv: torch.stack(
        [t_ndc.project_to_pixel(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(k), torch.from_numpy(inv))
         for w, k in zip(w2cs, ks)])))
    out = dict(patch_rays=int((rays_j["pixel_coords"]
                               != rays_t["pixel_coords"]).any(-1).sum()))
    out["z_floor"] = [int((cj[f"z{k}"] != ct[f"z{k}"]).sum())
                      for k in (1, 2, 3)]
    out["view_floor"] = int((cj["corner"] != ct["corner"]).sum())
    out["view_mask"] = int((cj["mask"] != ct["mask"]).sum())
    out["sort"] = int((cj["order"] != ct["order"]).any(-1).sum())
    masks = jrelu(p, batch, key)
    flips = [np.asarray(m) != r for m, r in zip(masks, record)]
    per_sample = [f.any(-1) for f in flips]
    out["relu_samples"] = [int(f.sum()) for f in per_sample]
    out["relu_rays"] = [int(f.any(-1).sum()) for f in per_sample]
    any_flip = np.any(per_sample, axis=0)
    out["relu_samples_all"] = int(any_flip.sum())
    out["relu_rays_all"] = int(any_flip.any(-1).sum())
    return out, [np.asarray(m) for m in masks]


def warp_counts(c, cfg) -> list:
    """Plane-sweep cells per stage whose nearest source pixel differs
    between the two cascades (the JAX one run op by op)."""
    seen = {"jax": [], "port": []}

    def recorder(name, warp, as_map):
        def wrapped(src_feat, proj_mat, depth_values, pad=0, *a, **kw):
            H, W = src_feat.shape[:2]
            ids = as_map(np.arange(H * W, dtype=np.float32).reshape(H, W, 1))
            seen[name].append(np.asarray(warp(ids, proj_mat, depth_values,
                                              pad)[0])[..., 0])
            return warp(src_feat, proj_mat, depth_values, pad, *a, **kw)
        return wrapped

    batch = j_loop.to_device_batch(c["sample"])
    jcfg = _jcfg(cfg.replace(shard_mvs_views=False))
    _, jm = j_create_models(jcfg)
    near, far = batch["near_fars"][0, 0], batch["near_fars"][0, 1]
    warp_j, warp_t = j_mvs.homo_warp, t_mvs.homo_warp
    j_mvs.homo_warp = recorder("jax", warp_j, jnp.asarray)
    t_mvs.homo_warp = recorder("port", warp_t, torch.from_numpy)
    try:
        with jax.disable_jit():
            jm.apply({"params": jax.tree.map(jnp.asarray,
                                             c["jparams"]["mvs"])},
                     batch["images"][1:], batch["affine_mat"],
                     batch["affine_mat_inv"], near, far, pad=jcfg.pad)
        _, mvs = create_models(cfg, "cpu", c["params"])
        with torch.no_grad():
            t_loop.run_mvs(cfg, mvs, to_device_batch(c["sample"], "cpu"))
    finally:
        j_mvs.homo_warp, t_mvs.homo_warp = warp_j, warp_t
    per_view = [int((a != b).sum()) for a, b in zip(seen["jax"],
                                                    seen["port"])]
    n = len(per_view) // 3
    return [sum(per_view[i * n:(i + 1) * n]) for i in range(3)]


def main(keys, warp=False):
    torch.set_num_threads(1)
    c = _case()
    cfg = c["cfg"].replace(**tp.RAY_CASES["padded_views"][0])
    p = jax.tree.map(jnp.asarray, c["jparams"])
    batch = j_loop.to_device_batch(c["sample"])
    split, args = jax_parallel_refs.lowered("rays", dict(
        cfg=dataclasses.asdict(cfg), params=c["jparams"],
        sample=c["sample"], seed=keys[0]))
    split = split.compile(jax_parallel_refs.JIT_QUICK)
    jcfg = _jcfg(cfg.replace(shard_mvs_views=False))
    jnerf, jmvs = j_create_models(jcfg)
    serial = jax.jit(jax.value_and_grad(
        lambda pm, b, k: j_loop.scene_loss(jcfg, jnerf, jmvs, pm, b, k),
        has_aux=True)).lower(p, batch, jax.random.PRNGKey(0)).compile(
            jax_parallel_refs.JIT_QUICK)
    jfwd = jax.jit(lambda pm, b, k: j_loop.forward_scene(
        jcfg, jnerf, jmvs, pm, b, k)).lower(
            p, batch, jax.random.PRNGKey(0)).compile(
                jax_parallel_refs.JIT_QUICK)
    jrelu = jax.jit(jax_parallel_refs.relu_choices(jcfg, jnerf, jmvs)).lower(
        p, batch, jax.random.PRNGKey(0)).compile(jax_parallel_refs.JIT_QUICK)
    draws = {k: _draws(cfg, jax.random.PRNGKey(k)) for k in keys}
    counts, masks = {}, {}
    for k in keys:
        counts[k], masks[k] = choice_counts(c, cfg.replace(
            shard_mvs_views=False), jax.random.PRNGKey(k), draws[k], jfwd,
            jrelu)
    argv = tp._argv(cfg, parallel_mode="rays", **tp.RAY_CASES[
        "padded_views"][0])
    jobs = [dict(kind="loss", argv=argv, params=tp._np_params(c["params"]),
                 samples=[c["sample"]], draws=[tp._draw_arrays(draws[k])],
                 relu=relu) for k in keys for relu in (None, masks[k])]
    got = tp._spawn((2,), ("data",), jobs)
    for i, k in enumerate(keys):
        key = jax.random.PRNGKey(k)
        jax2 = _flat(jax.tree.map(np.asarray, split(args[0], args[1], key))[1])
        jax1 = _flat(jax.tree.map(np.asarray, serial(p, batch, key))[1])
        _, port1 = tp._port_serial(c, cfg, [c["sample"]], [draws[k]])
        _, port1_r = tp._port_serial(c, cfg, [c["sample"]], [draws[k]],
                                     masks[k])
        got2, got2_r = got[2 * i]["grads"], got[2 * i + 1]["grads"]
        print(json.dumps(dict(
            key=k, port2_jax2=_median(got2, jax2),
            port1_jax1=_median(port1, jax1), jax2_jax1=_median(jax2, jax1),
            port2_port1=_median(got2, port1),
            port1_jax1_same_relu=_median(port1_r, jax1),
            port2_jax2_same_relu=_median(got2_r, jax2),
            **counts[k])), flush=True)
    if warp:
        print(json.dumps(dict(warp_round=warp_counts(c, cfg))), flush=True)


if __name__ == "__main__":
    argv = sys.argv[1:]
    main([int(a) for a in argv if a != "--warp"] or [5, 11],
         warp="--warp" in argv)
