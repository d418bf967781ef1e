"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload train.scared-bf16 --seed 7 \
        --seconds 30 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs``) and a traffic mix (``portbench/traffic``).  The
run makes its inputs and weights from ``--seed``, sets up the port
(``ucnerf_torch``) and warms up the cell's shapes, then measures a window
of ``--seconds``.  With ``--trace 0`` it reports the cell's end-to-end
metrics; with ``--trace 1`` it then profiles a fixed stretch of steps or
frames and reports the cell's per-layer metrics
(``portbench/metrics/<name>.py``) and a ``breakdown``.  After the window
the program's state is freed and the plain reference
(``portbench/reference``) checks what the timed path produced; each
number compared is printed beside its limit (``portbench/checks``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.  The run exits non-zero and prints no
result without enough CUDA devices, or if JAX or the JAX package was
loaded.  Build and kernel caches live in ``portbench/_cache`` and the
port's ``ucnerf_torch/_build``, inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / "_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

_IMPORTED = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (its start time in the kernel's
    process table, at 10 ms resolution); since this module's import where
    that table cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _IMPORTED


def parse_args(argv=None):
    p = argparse.ArgumentParser("portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(driver, seconds: float, device):
    """Units until ``seconds`` have passed: (units, done, failed, seconds),
    the window's time running to the end of its last unit."""
    _sync(device)
    t0 = time.perf_counter()
    units = done = failed = 0
    while True:
        d, ok = driver.unit()
        units += 1
        done += d
        failed += not ok
        now = time.perf_counter()
        if now - t0 >= seconds:
            return units, done, failed, now - t0


def run_cell(res, seed: int, seconds: float, trace: bool, device,
             age=process_age) -> dict:
    """One run of the resolved cell ``res`` (``harness.cells.resolve``) on
    ``device``: the result object, ``checks`` last."""
    import torch
    from portbench.harness import trace as tracing
    from portbench.harness.cells import model_config

    before = age()
    driver = res["driver"](res["config"], res["traffic"], seed, device)
    _sync(device)
    setup_s = age()
    print("portbench setup_s " + json.dumps(dict(
        before_driver=before, **driver.setup_phases, total=setup_s)),
        file=sys.stderr, flush=True)
    units, done, failed, window_s = run_window(driver, seconds, device)
    driver.window_units = units
    metrics, extra = {}, {}
    if trace:
        summary = tracing.trace_units(driver.unit, driver.traced_units,
                                      driver.spans)
        ctx = dict(model=model_config(res["config"]),
                   traffic=res["traffic"], unit=driver.unit_name)
        for m in res["per_layer"]:
            value = m["reader"].read(summary, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = dict(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = tracing.breakdown(summary)
    else:
        values = dict(driver.totals(done, window_s), setup_s=setup_s)
        for m in res["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    numbers = driver.check()
    limits = res["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = dict(correct=correct, attempted=units, failed=failed,
                  metrics=metrics,
                  device=dict(platform="gpu" if device.type == "cuda"
                              else device.type,
                              kind=(torch.cuda.get_device_name(device)
                                    if device.type == "cuda" else "cpu"),
                              count=res["cell"]["chips"],
                              memory_peak_bytes=peak, **extra))
    if trace:
        result["breakdown"] = breakdown
    result["notes"] = {k: v for k, v in numbers.items() if k not in limits}
    result["checks"] = checks
    return result


def finite(obj):
    """``obj`` with every float that is not finite as None, so that the
    line is strict JSON."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def card_line() -> dict:
    """The precision settings the run kept and the card's name and power
    limit."""
    import torch
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[:1]
    except (OSError, subprocess.SubprocessError):
        smi = []
    return {"precision": {
        "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32},
        "nvidia_smi": smi[0] if smi else None}


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench.harness.cells import (forbidden_loaded, load_benchmark,
                                         resolve)
    res = resolve(load_benchmark(ROOT), args.workload, ROOT)
    import torch
    chips = res["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    result = run_cell(res, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(card_line()), flush=True)
    for name, c in result["checks"].items():
        print(f"portbench check {name}: {c['value']!r} limit "
              f"{c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
