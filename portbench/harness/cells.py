"""Find a cell's files by the names in ``BENCHMARK.json``.

- ``portbench/configs/<config>.json``: the configuration (its ``file`` in
  ``BENCHMARK.json``): ``model`` holds the port's ``Config`` fields as
  run, ``scene`` the inputs' sizes.
- ``portbench/traffic/<mix>.json``: a traffic mix, the parameters of one
  general driver, ``portbench/drivers/<kind>.py`` (``harness/drivers.py``).
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(trace, cell) -> float | None``.
- ``portbench/checks/<workload>.json``: the limit of each number that
  decides the cell's ``correct``, with the readings it was set from.

A later cell, mix or metric adds files here and entries in
``BENCHMARK.json``; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# top-level module names that no process of the benchmark may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "ucnerf_tpu")


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each name compared whole: ``ucnerf_torch`` is not
    ``ucnerf_tpu``, nor ``jaxtyping`` ``jax``."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def load_benchmark(root: Path = ROOT) -> Dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: Dict, workload: str, root: Path = ROOT) -> Dict:
    """The cell ``workload``: its entry, its configuration (file loaded),
    its traffic mix (file loaded) and its driver class, its end-to-end
    metrics and its per-layer metrics with their readers."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = json.loads((Path(root) / entry["file"]).read_text())
    bench_dir = Path(root) / BENCH_DIR.name
    traffic_path = bench_dir / "traffic" / f"{cell['traffic']}.json"
    traffic = json.loads(traffic_path.read_text())
    driver = load_module(bench_dir / "drivers" / f"{traffic['kind']}.py",
                         "portbench_driver_" + traffic["kind"]).Driver

    def in_cell(metric):
        return workload in metric.get("workloads", [workload])

    end_to_end = [m for m in bench["end_to_end"] if in_cell(m)]
    per_layer = []
    for m in bench["per_layer"]:
        if in_cell(m):
            reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"]
                                 .replace(".", "_").replace("-", "_"))
            per_layer.append(dict(m, reader=reader))
    checks = json.loads((bench_dir / "checks" / f"{workload}.json")
                        .read_text())
    limits = {k: v["limit"] for k, v in checks["numbers"].items()}
    return dict(cell=cell, config_entry=entry, config=config,
                traffic=traffic, driver=driver, end_to_end=end_to_end,
                per_layer=per_layer, limits=limits)


def model_config(config: Dict) -> SimpleNamespace:
    """The configuration's sizes as attributes, with the derived counts
    the reference and the arithmetic read."""
    m = {k: (tuple(v) if isinstance(v, list) else v)
         for k, v in config["model"].items()}
    ns = SimpleNamespace(**m)
    ns.n_train_rays = ns.batch_size + ns.n_depth_rays
    ns.n_uniform_rays = ns.batch_size - ns.patch_num * ns.patch_size ** 2
    return ns
