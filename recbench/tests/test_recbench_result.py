"""The last line's schema, and no result without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from recbench import run
from recbench.tests.conftest import REPO


@pytest.mark.parametrize("cell,trace", [("ml1m_ssm.train", False), ("ml25m_ccl.recommend", True)])
def test_the_result_line(tiny_root, cell, trace):
    result = run.run(tiny_root, cell, 2**31 + 77, 0.3, trace, device="cpu")
    line = json.loads(json.dumps(result))
    assert list(line)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(line)[-1] == "check"  # the numbers compared come last
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count"}
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    section = bench["per_layer"] if trace else bench["end_to_end"]
    units = {m["name"]: m["unit"] for m in section}
    assert line["metrics"] and all(units[k] == v["unit"] for k, v in line["metrics"].items())
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
    for entry in line["check"].values():
        assert set(entry) == {"value", "limit"}


def _no_result(cwd, env=None):
    out = subprocess.run([sys.executable, "-m", "recbench.run", "--workload", "ml1m_ssm.train",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=cwd, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    return out


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _no_result(REPO, env)
    assert "CUDA" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "recbench", tmp_path / "recbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(tmp_path)
