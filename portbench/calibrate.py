"""Readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload train.scared-bf16 \
        --seeds 11 12 13 --program_seeds 14 15 --control --faults

For each seed, in one process: the cell's set-up from the seed, for a
serving cell a short window at the cell's load, then the numbers that
decide ``correct`` (``reference/compare.py``, against the reference at
the configuration's stated precision) of

- the program (the lower reading: the largest over a dozen seeds or
  more), and as ``program@f32`` the same outputs against the reference in
  float32 with TF32 off;
- with ``--control``, the control: the reference put in the program's
  place and computed one step below the configuration's precision, in
  both stages and in each alone (``CONTROLS``);
- with ``--faults`` (training cells), the reference in the program's
  place with half of each batch's rays left out of the image loss, the
  mean taken over the rest (``half_batch``), and the program with its
  patch draw's noise left out (``no_draw_noise``).  A state left
  unchanged reads 1 in ``change_gap_median`` by construction and needs no
  run.

``--program_seeds`` are read for the program alone.  One JSON line a
seed.  ``run.py`` never runs the control or the faults.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_precision(config, stages=("mlp", "mvs")) -> dict:
    """The configuration's precision, one step below in ``stages``: the
    MLP at fp8 under bf16, at TF32 under f32; the cascade (float32, cuDNN
    TF32 allowed) in bf16."""
    import torch
    from portbench.harness.cells import model_config
    from portbench.reference import model, step
    rc = model_config(config)
    out = step.stated_precision(rc)
    if "mlp" in stages:
        out["mlp"] = {"bfloat16": model.round_fp8,
                      "float32": model.round_tf32}[rc.nerf_dtype]
        out["mlp_dtype"] = None
    if "mvs" in stages:
        out["mvs"] = torch.bfloat16
    return out


# the controls read: both stages one step below, and each alone
CONTROLS = {"control": ("mlp", "mvs"), "control_mlp": ("mlp",),
            "control_mvs": ("mvs",)}


def half_batch_numbers(driver) -> dict:
    """The reference with half of each batch left out of the image loss,
    against the reference."""
    from portbench.reference import compare, losses
    whole = losses.img2mse
    losses.img2mse = lambda pred, target: whole(pred[:pred.shape[0] // 2],
                                                target[:target.shape[0] // 2])
    try:
        got = driver.reference_steps()
    finally:
        losses.img2mse = whole
    return compare.train_numbers(
        got, driver.reference_steps(pixels=got["pixels"]))


def program_driver(res, seed, dev, seconds):
    """The cell's driver set up from ``seed``, a serving cell's window of
    ``seconds`` run."""
    from portbench.run import run_window
    driver = res["driver"](res["config"], res["traffic"], seed, dev)
    if res["traffic"]["kind"] == "serve":
        driver.window_units = run_window(driver, seconds, dev)[0]
    return driver


def draw_without_noise(res, seed, dev) -> dict:
    """The program with its patch draw's Gumbel noise left out (the
    patches drawn from the confidence alone)."""
    import torch
    from ucnerf_torch.ops import rays
    draw = rays.gumbel_topk_sample
    rays.gumbel_topk_sample = lambda g, w, k: draw(torch.zeros_like(g), w, k)
    try:
        return program_driver(res, seed, dev, 0.0).check()
    finally:
        rays.gumbel_topk_sample = draw


def train_line(res, seed, dev, args, full: bool) -> dict:
    from portbench.reference import compare
    driver = program_driver(res, seed, dev, 0.0)
    line = {"program": driver.check()}
    line["program@f32"] = compare.train_numbers(
        driver.got, driver.reference_steps({}, driver.checked["pixels"]))
    if full and args.control:
        for name, stages in CONTROLS.items():
            line[name] = driver.control(control_precision(res["config"],
                                                          stages))
    if full and args.faults:
        line["half_batch"] = half_batch_numbers(driver)
        del driver
        line["no_draw_noise"] = draw_without_noise(res, seed, dev)
    return line


def serve_line(res, seed, dev, args, full: bool) -> dict:
    from portbench.reference import compare
    driver = program_driver(res, seed, dev, args.seconds)
    line = {"program": driver.check()}
    line["program@f32"] = compare.frame_numbers(
        driver.got, driver.reference_frames(driver.checked_poses, {}))
    if full and args.control:
        for name, stages in CONTROLS.items():
            line[name] = driver.control(control_precision(res["config"],
                                                          stages))
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program_seeds", type=int, nargs="*", default=[],
                   help="further seeds read for the program alone")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="a serving cell's window (enough for its checked "
                   "frames)")
    p.add_argument("--control", action="store_true",
                   help="read the control, and each stage's alone")
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)

    import torch
    from portbench.harness import cells
    res = cells.resolve(cells.load_benchmark(ROOT), args.workload, ROOT)
    dev = torch.device("cuda", 0)
    line_of = (train_line if res["traffic"]["kind"] == "train"
               else serve_line)
    for seed in args.seeds + args.program_seeds:
        t0 = time.perf_counter()
        line = dict(workload=args.workload, seed=seed,
                    **line_of(res, seed, dev, args, seed in args.seeds))
        torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
