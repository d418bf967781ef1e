"""The sharded eval render of ucnerf_torch on 2 ranks and on a 2x2 grid,
against its single-device frame and the JAX package's
``make_parallel_eval_render`` on a 2-device mesh."""

import dataclasses

import numpy as np
import pytest
import torch

from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.kernels.fused_mlp import render_mlp
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train.loop import make_eval_render
from ucnerf_torch.utils.checkpoint_io import jax_params_from_state_dict

from test_torch_parallel import _np_params, run_both, spawn_both
from test_torch_serving import ARGS as FRAME_ARGS


@pytest.fixture(scope="module")
def frames():
    """On the inputs of ``tests/test_torch_serving.py``, where the port's
    frame envelope to JAX was set: the port's frame on one device, on 2
    ranks and on a 2x2 grid, and JAX's on a 2-device mesh."""
    cfg = parse_config(FRAME_ARGS)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sample = build_dataset(cfg, "val")[0]
    job = dict(kind="render", argv=FRAME_ARGS, params=_np_params(params),
               sample=sample)

    def port():
        two, four = spawn_both(((2,), ("data",), [job]),
                               ((2, 2), ("data", "rays"), [job]))
        return dict(render1d=two[0], render2d=four[0])

    got, refs = run_both(port, {"render": ("render", dict(
        cfg=dataclasses.asdict(cfg), sample=sample,
        params=jax_params_from_state_dict(params),
        mesh=((2,), ("data",))))})
    nerf, mvs = create_models(cfg, "cpu", params)
    H, W = sample["images"].shape[1:3]
    single = [t.numpy() for t in make_eval_render(
        cfg, render_mlp(nerf), mvs, (H, W))(to_device_batch(sample, "cpu"))]
    return dict(got, jax=refs["render"], single=single)


@pytest.mark.parametrize("mesh", ["render1d", "render2d"])
def test_sharded_eval_render_matches_jax_and_single_device(frames, mesh):
    """The eval render with its tiles split over 2 ranks and over a 2x2
    grid: bit for bit the port's single-device frame, and within the
    serving test's bounds of JAX's ``make_parallel_eval_render`` on a
    2-device mesh (``tests/test_parallel_grid.py`` holds JAX's 2-D render
    to its 1-D one), on that test's inputs
    (``tests/test_torch_serving.py``)."""
    got = frames[mesh]
    for g, s in zip(got, frames["single"]):
        np.testing.assert_array_equal(g, s)
    rgb_j, depth_j, conf_j = frames["jax"]
    np.testing.assert_allclose(got[0], rgb_j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got[1], depth_j, rtol=5e-3, atol=0)
    assert np.abs(got[2] - conf_j).mean() < 2e-3
