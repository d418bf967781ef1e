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

Needs jax and flax (this runs where the JAX package runs, not on the
card's machine).  A few minutes and a few GB on 8 CPU cores.
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


def main():
    t0 = time.perf_counter()
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
