"""The benchmark's frozen arithmetic against the port's
``utils/accounting.py`` at the cells' shapes, and the roofline readers."""

from __future__ import annotations

import pytest

from conftest import ROOT
from portbench.harness import cells
from portbench.reference import accounting as frozen

BENCH = cells.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _shapes(workload):
    res = cells.resolve(BENCH, workload, ROOT)
    m = cells.model_config(res["config"])
    W, H = m.img_wh
    return res, m, H, W


@pytest.mark.parametrize("workload", CELLS)
def test_frozen_arithmetic_agrees_with_the_port(workload):
    from ucnerf_torch.config import Config
    from ucnerf_torch.utils import accounting as port
    res, m, H, W = _shapes(workload)
    cfg = Config(**{k: (tuple(v) if isinstance(v, list) else v)
                    for k, v in res["config"]["model"].items()})
    assert frozen.mvs_forward_flops(m, H, W) == port.mvs_forward_flops(
        cfg, H, W)
    assert frozen.train_step_flops(m, H, W) == port.train_step_flops(
        cfg, H, W)
    P = H * W * m.N_samples
    assert frozen.nerf_mlp_flops(m, P) == port.nerf_mlp_flops(cfg, P)
    assert frozen.nerf_mlp_bytes(m, 1024, 90, 123) == port.nerf_mlp_bytes(
        cfg, 1024, 90, 123)
    # deliberate change 1: a served frame leaves out the cached FeatureNet
    assert frozen.serve_frame_flops(m, H, W) == pytest.approx(
        port.eval_frame_flops(cfg, H, W)
        - (m.view_num - 1) * port.featurenet_flops(H, W), rel=1e-12)
    # deliberate change 2: K1's bound counts the work once, at the MLP
    # precision's peak; the port's f32 route counts three TF32 products
    flops = port.nerf_mlp_flops(cfg, 1024 * 90)
    bound = frozen.k1_bound_seconds(m, 1024, 90)
    if m.nerf_dtype == "float32":
        assert 3 * bound == pytest.approx(port.f32_matmul_seconds(flops))
    else:
        assert bound == pytest.approx(flops / (port.PEAK_TFLOPS * 1e12))
    assert frozen.PEAK_BF16 == port.PEAK_TFLOPS * 1e12
    assert frozen.PEAK_TF32 == port.PEAK_TFLOPS_TF32 * 1e12
    assert frozen.PEAK_HBM == port.PEAK_HBM_GBPS * 1e9


def test_mlp_weight_count_is_the_mlp_s():
    from ucnerf_torch.models.nerf import UCNeRFMLP
    _, m, _, _ = _shapes(CELLS[0])
    assert frozen.mlp_weight_count(m) == sum(
        p.numel() for p in UCNeRFMLP(view_num=m.view_num).parameters())


def _frame_trace(res, m, k1_s, units=2):
    return dict(units=units, window_s=1.0, busy_s=0.5, kernel_count=10,
                families={"K1": k1_s}, kernels={}, idle_by_span={})


@pytest.mark.parametrize("workload", [c for c in CELLS
                                      if c.startswith("serve")])
def test_k1_roofline_reads_100_at_its_bound(workload):
    res, m, H, W = _shapes(workload)
    reader = next(x["reader"] for x in res["per_layer"]
                  if x["name"] == "k1_roofline.serve")
    chunk = res["traffic"]["chunk"]
    per_frame = sum(frozen.k1_bound_seconds(m, min(chunk, H * W - s),
                                            m.N_samples)
                    for s in range(0, H * W, chunk))
    ctx = dict(model=m, traffic=res["traffic"], unit="frame")
    at_bound = reader.read(_frame_trace(res, m, 2 * per_frame), ctx)
    assert at_bound == pytest.approx(100.0)
    assert reader.read(_frame_trace(res, m, 4 * per_frame), ctx) < 100.0
    assert reader.read(_frame_trace(res, m, 0.0), ctx) is None


def test_device_readers_read_nothing_without_a_device_trace():
    res, m, _, _ = _shapes(CELLS[0])
    empty = dict(units=2, window_s=1.0, busy_s=0.0, kernel_count=0,
                 families={}, kernels={}, idle_by_span={})
    for kind, unit in (("train", "step"), ("serve", "frame")):
        cell = next(c for c in CELLS if c.startswith(kind))
        r = cells.resolve(BENCH, cell, ROOT)
        ctx = dict(model=cells.model_config(r["config"]),
                   traffic=r["traffic"], unit=unit)
        for x in r["per_layer"]:
            assert x["reader"].read(empty, ctx) is None, x["name"]
