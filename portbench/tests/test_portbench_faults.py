"""A run with the timed path broken underneath comes out not correct, and
so does the control, in both of its stages and in each alone.

Each test skips only the harness's look for a card and drives the rest of
a run at a tiny size on the CPU, against the cell's own limits
(``portbench/checks``) and the reference at the configuration's stated
precision, which a sound run matches to rounding here.
"""

from __future__ import annotations

import pytest
import torch

from conftest import ROOT, tiny
from portbench import calibrate, run
from portbench.harness import cells

BENCH = cells.load_benchmark(ROOT)
TRAIN = next(w["name"] for w in BENCH["workloads"]
             if w["name"].startswith("train"))
SERVE = [w["name"] for w in BENCH["workloads"]
         if w["name"].startswith("serve")]
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(workload):
    torch.set_num_threads(2)
    res = tiny(cells.resolve(BENCH, workload, ROOT))
    return run.run_cell(res, 2 ** 32 + 9, 0.5, False, torch.device("cpu"))


def test_sound_run_is_correct():
    assert _run(TRAIN)["correct"]


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    out = _run(TRAIN)
    assert not out["correct"]
    assert out["checks"]["change_gap_median"]["value"] == pytest.approx(
        1.0, abs=0.01)


def test_half_the_batch_left_out(monkeypatch):
    from ucnerf_torch.train import losses
    whole = losses.img2mse
    monkeypatch.setattr(losses, "img2mse", lambda p, t: whole(
        p[:p.shape[0] // 2], t[:t.shape[0] // 2]))
    assert not _run(TRAIN)["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_answer_altered_where_it_is_produced(monkeypatch, workload):
    from ucnerf_torch.render import renderer
    composite = renderer.raw2outputs

    def altered(raw, z_vals, white_bkgd=False):
        rgb, depth, acc, weights = composite(raw, z_vals, white_bkgd)
        return rgb + 0.05, depth, acc, weights
    assert _run(workload)["correct"]
    monkeypatch.setattr(renderer, "raw2outputs", altered)
    assert not _run(workload)["correct"]


def _control(workload, stages):
    torch.set_num_threads(2)
    res = tiny(cells.resolve(BENCH, workload, ROOT))
    driver = res["driver"](res["config"], res["traffic"], 2 ** 32 + 3,
                           torch.device("cpu"))
    if res["traffic"]["kind"] == "serve":
        driver.window_units = run.run_window(driver, 0.5,
                                             torch.device("cpu"))[0]
    driver.check()
    return res, driver.control(
        calibrate.control_precision(res["config"], stages))


# (control, cell) pairs that the cell's limits do not hold: on the card the
# f32 MLP at TF32 alone reads inside the program's own rgb gap (PERF.md,
# Open questions); the control in both stages still fails that cell
NOT_HELD = {("control_mlp", "serve.scared-f32")}


@pytest.mark.parametrize("workload,control", [
    (w, c) for w in CELLS for c in sorted(calibrate.CONTROLS)
    if (c, w) not in NOT_HELD])
def test_control_is_not_correct(workload, control):
    """The reference one precision step below the configuration's, in the
    program's place, in both stages or in one alone, fails the cell's
    limits."""
    res, numbers = _control(workload, calibrate.CONTROLS[control])
    assert any(numbers[k] > limit for k, limit in res["limits"].items()), \
        numbers


def test_patch_draw_without_its_noise(monkeypatch):
    """The train rays' patches drawn from the confidence alone, the Gumbel
    noise left out: the reference's look at the first step's draw
    (``draw1_gap``) fails it."""
    from ucnerf_torch.ops import rays
    draw = rays.gumbel_topk_sample
    monkeypatch.setattr(rays, "gumbel_topk_sample", lambda g, w, k: draw(
        torch.zeros_like(g), w, k))
    out = _run(TRAIN)
    assert not out["correct"]
    assert out["checks"]["draw1_gap"]["value"] > out["checks"]["draw1_gap"][
        "limit"]
