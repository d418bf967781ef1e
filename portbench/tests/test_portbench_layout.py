"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every cell's files by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT
from portbench.harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = cells.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/configs/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert _line(c["source"]) and _line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    res = cells.resolve(BENCH, workload, ROOT)
    assert (ROOT / "portbench" / "drivers"
            / f"{res['traffic']['kind']}.py").is_file()
    assert hasattr(res["driver"], "unit")
    assert res["per_layer"] and all(hasattr(m["reader"], "read")
                                    for m in res["per_layer"])
    names = {m["name"] for m in res["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert res["limits"]
    for m in res["per_layer"]:
        assert m["moves"] in names, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for workload in m.get("workloads", CELLS):
        res = cells.resolve(BENCH, workload, ROOT)
        assert m["moves"] in {e["name"] for e in res["end_to_end"]}


def test_config_files_state_their_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
        assert cfg["assumed"]
        m = cfg["model"]
        # UC-NeRF's published widths and the train_scared preset
        assert (m["netdepth"], m["netwidth"], m["multires"],
                m["multires_views"], m["N_samples"]) == (6, 128, 10, 4, 90)
        assert (m["ndepths"], m["depth_intervals_ratio"],
                m["view_num"]) == ([48, 32, 8], [4, 2, 1], 7)
        assert (m["patch_size"], m["patch_num"], m["batch_size"],
                m["n_depth_rays"], m["lrate"]) == (6, 50, 2000, 1024, 2e-4)


def test_new_metric_needs_only_new_files(tmp_path):
    """A per-layer metric added as a file and an entry, no harness edit."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "_dev",
                                                  "__pycache__"))
    (tmp_path / "portbench" / "metrics" / "units_seen.any.py").write_text(
        "def read(trace, cell):\n    return float(trace['units'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append(dict(
        name="units_seen.any", unit="units", better="higher",
        source="device_trace", layer="device", moves="setup_s"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = cells.load_benchmark(tmp_path)
    res = cells.resolve(loaded, CELLS[0], tmp_path)
    new = [m for m in res["per_layer"] if m["name"] == "units_seen.any"]
    assert len(new) == 1
    assert new[0]["reader"].read({"units": 3}, {}) == 3.0


def test_new_traffic_kind_needs_only_new_files(tmp_path):
    """A traffic mix of a new kind added as a driver file, a data file and
    a cell entry, no harness edit; a mix of a kind that exists is one data
    file."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "_dev",
                                                  "__pycache__"))
    bench_dir = tmp_path / "portbench"
    (bench_dir / "drivers" / "idle.py").write_text(
        "class Driver:\n"
        "    def __init__(self, config, traffic, seed, device):\n"
        "        self.rate = traffic['rate']\n")
    (bench_dir / "traffic" / "idle.json").write_text('{"kind": "idle", '
                                                     '"rate": 3}')
    (bench_dir / "traffic" / "serve-c1024.json").write_text(json.dumps(
        dict(json.loads((bench_dir / "traffic" / "serve.json").read_text()),
             chunk=1024)))
    bench = json.loads(json.dumps(BENCH))
    config = BENCH["configs"][0]["name"]
    for name, mix in (("idle.x", "idle"), ("serve-c1024.x", "serve-c1024")):
        bench["workloads"].append(dict(name=name, config=config,
                                       traffic=mix, chips=1, why="a test"))
        (bench_dir / "checks" / f"{name}.json").write_text(
            '{"numbers": {}}')
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = cells.load_benchmark(tmp_path)
    idle = cells.resolve(loaded, "idle.x", tmp_path)
    assert idle["driver"](idle["config"], idle["traffic"], 1, None).rate == 3
    c1024 = cells.resolve(loaded, "serve-c1024.x", tmp_path)
    assert c1024["driver"].__name__ == "Driver"
    assert c1024["traffic"]["chunk"] == 1024
