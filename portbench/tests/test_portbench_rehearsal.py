"""Each traffic mix rehearsed at a tiny size on the CPU, through the run's
own code with only the harness's look for a card skipped."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT, tiny
from portbench import run
from portbench.harness import cells

BENCH = cells.load_benchmark(ROOT)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _cell(kind):
    return next(w["name"] for w in BENCH["workloads"]
                if cells.resolve(BENCH, w["name"], ROOT)["traffic"]["kind"]
                == kind)


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_mix_runs_on_the_cpu(kind, trace):
    torch.set_num_threads(2)
    workload = _cell(kind)
    res = tiny(cells.resolve(BENCH, workload, ROOT), nerf_dtype="float32")
    out = run.run_cell(res, 2 ** 31 + 77, 0.5, trace, torch.device("cpu"))
    json.dumps(out, allow_nan=False)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    if trace:
        # no device on the CPU: the device readers read nothing
        assert out["metrics"] == {}
        assert out["device"]["window_s"] > 0
        names = {n for n, _ in out["breakdown"]["idle_gaps"]}
        spans = {"train": {"fetch", "draws", "train_step", "read_metrics"},
                 "serve": {"frame_batch", "render", "to_host"}}[kind]
        assert names <= spans | {"outside_spans"}
    else:
        expect = {m["name"] for m in BENCH["end_to_end"]
                  if workload in m.get("workloads", [workload])}
        assert set(out["metrics"]) == expect
        assert all(m["value"] > 0 for m in out["metrics"].values())


def test_same_seed_same_inputs():
    from portbench.harness import inputs
    a = inputs.make_scene(2 ** 33 + 5, (64, 32), 16, 64)
    b = inputs.make_scene(2 ** 33 + 5, (64, 32), 16, 64)
    c = inputs.make_scene(2 ** 33 + 6, (64, 32), 16, 64)
    assert all((a[k] == b[k]).all() for k in ("images", "c2ws", "dpt"))
    assert not (a["images"] == c["images"]).all()
    assert a["images"].shape == c["images"].shape
    d1 = inputs.train_draws(9, 4, H=32, W=64, patch_size=4, patch_num=4,
                            n_uniform=16, n_rays=48, n_samples=9,
                            device="cpu")
    d2 = inputs.train_draws(9, 4, H=32, W=64, patch_size=4, patch_num=4,
                            n_uniform=16, n_rays=48, n_samples=9,
                            device="cpu")
    assert all(torch.equal(getattr(d1, k), getattr(d2, k))
               for k in vars(d1))


def test_weights_follow_the_port_s_names_and_shapes():
    from portbench.harness import inputs
    from portbench.reference import step as reference
    from ucnerf_torch.config import Config
    from ucnerf_torch.models.factory import create_models
    res = cells.resolve(BENCH, _cell("train"), ROOT)
    m = cells.model_config(res["config"])
    laws = inputs.weight_laws(reference.build_models(m, None, "cpu"))
    w = inputs.make_weights(laws, 3, "cpu")
    cfg = Config(**{k: (tuple(v) if isinstance(v, list) else v)
                    for k, v in res["config"]["model"].items()})
    nerf, mvs = create_models(cfg, "cpu", w)      # strict load
    assert {k: tuple(v.shape) for k, v in nerf.state_dict().items()} == {
        k: tuple(v.shape) for k, v in w["nerf"].items()}
    assert len(w["mvs"]) == len(mvs.state_dict())
