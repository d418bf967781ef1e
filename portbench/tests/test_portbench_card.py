"""Each cell run once on the card through the benchmark's command, briefly
(``pytest -m cuda portbench/tests`` on a machine with an H100)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness import cells

CELLS = [w["name"] for w in cells.load_benchmark(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 101), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


def test_run_without_a_card_prints_no_result(monkeypatch, capsys):
    import torch
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""
