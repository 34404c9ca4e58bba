"""Each cell, briefly, on the card: a short window and a traced one, each
``correct``, every share of a peak or a roofline between 0 and 100.  Run on
the card with ``python -m pytest recbench/tests -m cuda``; skipped here."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from recbench.tests.conftest import REPO

CELLS = [c["name"] for c in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_on_the_card(cuda, cell, trace):
    out = subprocess.run([sys.executable, "-m", "recbench.run", "--workload", cell,
                          "--seed", str(2**31 + 29), "--seconds", "2", "--trace", str(trace)],
                         cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    for name, metric in line["metrics"].items():
        if metric["unit"] == "%":
            assert 0.0 <= metric["value"] <= 100.0, (name, metric)
