"""The serving slice as a whole: ucnerf_torch's ServingRenderer against the
JAX package's on the synthetic scene with the same weights, and
``python -m ucnerf_torch.serve``'s batch mode on the CPU."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.config import parse_config as j_parse_config
from ucnerf_tpu.data import build_dataset as j_build_dataset
from ucnerf_tpu.models.factory import create_models as j_create_models
from ucnerf_tpu.render.serving import ServingRenderer as JServingRenderer

from ucnerf_torch import serve
from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.kernels.fused_mlp import FusedNeRFMLP
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.render.serving import ServingRenderer
from ucnerf_torch.utils.checkpoint_io import (jax_params_from_state_dict,
                                              state_dict_from_jax)
from ucnerf_torch.utils.png import read_png

torch.set_num_threads(1)

JIT_QUICK = {"xla_backend_optimization_level": 0}

ARGS = ["--dataset_name", "synthetic", "--view_num", "4", "--ndepths", "8",
        "8", "8", "--N_samples", "12", "--chunk", "256", "--nerf_dtype",
        "float32"]


def _poses(sample):
    """The sample's own target pose and a nudged novel one."""
    c2w = np.asarray(sample["c2ws"][0], np.float32)
    novel = c2w.copy()
    novel[:3, 3] += np.array([0.02, -0.01, 0.0], np.float32)
    return [c2w, novel]


@pytest.fixture(scope="module")
def case():
    """The port's seeded weights carried into the JAX params tree, and the
    JAX ServingRenderer's frames from them, computed once (its tile loop
    not unrolled, which the frames do not depend on: the compile is the
    cost here)."""
    cfg = j_parse_config(ARGS).replace(eval_unroll=1)
    ds = j_build_dataset(cfg, "val")
    W, H = ds.img_wh
    nerf, mvs = j_create_models(cfg)
    params = jax_params_from_state_dict(init_params(
        parse_config(ARGS), torch.Generator().manual_seed(0), "cpu"))
    sample = ds[0]
    r = JServingRenderer(cfg, nerf, mvs, jax.tree.map(jnp.asarray, params),
                         sample, (H, W), ds.scene[ds.metas[0][0]]["intrinsic"])
    # its render_np, compiled for compile time rather than run time
    render = jax.jit(r._render_view, compiler_options=JIT_QUICK)
    frames = [tuple(np.asarray(a) for a in render(r.params,
                                                  r.frame_batch(c2w)))
              for c2w in _poses(sample)]
    return dict(params=params, sample=sample, frames=frames)


def test_serving_matches_jax(case):
    cfg = parse_config(ARGS)
    ds = build_dataset(cfg, "val")
    sample = ds[0]
    for k in ("images", "c2ws", "w2cs", "intrinsics", "affine_mat",
              "near_fars"):
        np.testing.assert_array_equal(sample[k], case["sample"][k], k)
    W, H = ds.img_wh
    nerf, mvs = create_models(cfg, "cpu", state_dict_from_jax(case["params"]))
    r = ServingRenderer(cfg, FusedNeRFMLP(nerf), mvs, sample, (H, W),
                        ds.scene[ds.metas[0][0]]["intrinsic"], "cpu")
    for c2w, (rgb_j, depth_j, conf_j) in zip(_poses(sample), case["frames"]):
        rgb, depth, conf = r.render_np(c2w)
        assert rgb.shape == (H, W, 3) and depth.shape == (H, W)
        np.testing.assert_allclose(rgb, rgb_j, atol=2e-3, rtol=0)
        np.testing.assert_allclose(depth, depth_j, rtol=5e-3, atol=0)
        assert np.abs(conf - conf_j).mean() < 2e-3


def test_config_fields_match_jax():
    """One flag set drives both packages: same fields, same defaults."""
    import dataclasses
    from ucnerf_tpu.config import Config as JConfig
    from ucnerf_torch.config import Config
    assert ([(f.name, f.default) for f in dataclasses.fields(Config)]
            == [(f.name, f.default) for f in dataclasses.fields(JConfig)])
    assert parse_config(ARGS) == Config(**dataclasses.asdict(
        j_parse_config(ARGS)))


def test_batch_mode_cli(case, tmp_path, capsys):
    """With the JAX params exported to npz (--ckpt), two requests render
    to their npz files and equal the JAX frame; a malformed line is
    reported and skipped; a png request renders the same frame as 8-bit
    RGB."""
    from ucnerf_tpu.utils.checkpoint_io import save_params_npz
    ckpt = save_params_npz(case["params"], str(tmp_path / "params.npz"))
    cfg = parse_config(ARGS)
    c2w = np.asarray(build_dataset(cfg, "val")[0]["c2ws"][0]).tolist()
    outs = [str(tmp_path / f"f{i}.npz") for i in range(2)]
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(
        [json.dumps({"c2w": c2w, "out": o}) for o in outs]
        + ['{"c2w": [[1, 2], [3, 4]], "out": "bad.npz"}',
           json.dumps({"c2w": c2w, "out": str(tmp_path / "f.png")})]) + "\n")
    n = serve.main(["--requests", str(reqs), "--device", "cpu", "--ckpt",
                    ckpt, *ARGS])
    assert n == 3
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    errors = [ln["error"] for ln in lines if "error" in ln]
    assert len(errors) == 1 and "4x4" in errors[0]
    assert lines[-1]["frames"] == 3
    frames = [np.load(o) for o in outs]
    for f in frames:
        assert f["rgb"].shape == (32, 64, 3) and f["depth"].shape == (32, 64)
        assert np.isfinite(f["rgb"]).all() and np.isfinite(f["depth"]).all()
    np.testing.assert_array_equal(frames[0]["rgb"], frames[1]["rgb"])
    np.testing.assert_allclose(frames[0]["rgb"], case["frames"][0][0],
                               atol=2e-3, rtol=0)
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "f.png")),
        (np.clip(frames[0]["rgb"], 0, 1) * 255).astype(np.uint8))
