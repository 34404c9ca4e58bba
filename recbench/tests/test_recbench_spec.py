"""Every cell, configuration, traffic mix and metric is found by name, a
new one is added by files and entries alone, and ``BENCHMARK.json`` keeps
to the benchmark's schema."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from recbench import spec
from recbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    s = spec.load(REPO, cell)
    assert s.config["name"] == s.cell["config"]
    assert (REPO / "recbench" / "drivers" / f"{s.kind}.py").exists()
    assert s.limits["numbers"]
    assert any(m["name"] == "setup_s" for m in s.end_to_end)
    assert len(s.end_to_end) >= 2 and s.per_layer
    for m in s.per_layer:
        assert callable(spec.reader(REPO, m["name"]))
        assert m["moves"] in {e["name"] for e in s.end_to_end}


def test_the_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["recbench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("recbench/") and (REPO / c["file"]).exists()
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
        assert sorted(json.loads((REPO / c["file"]).read_text())["reduced"]) == sorted(
            c["reduced"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    perf = (REPO / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert f"| {m['layer']} |" in perf  # PERF.md's list of layers names it
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "recbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(REPO / "recbench", root / "recbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "recbench/configs/ml1m_ssm.json").read_text())
    cfg.update(name="ml1m_wide", reduced=[])
    cfg["model"]["hidden_size"] = 256
    (root / "recbench/configs/ml1m_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "recbench/traffic/train.json").read_text())
    mix["steps_per_call"] = 16
    (root / "recbench/traffic/train_k16.json").write_text(json.dumps(mix))
    (root / "recbench/limits/ml1m_wide.train_k16.json").write_text(
        (REPO / "recbench/limits/ml1m_ssm.train.json").read_text())
    (root / "recbench/metrics/steps.count.train.py").write_text(
        "def read(trace):\n    return float(trace.units)\n")
    bench["configs"].append({"name": "ml1m_wide", "source": "https://example.org/wide",
                             "file": "recbench/configs/ml1m_wide.json", "reduced": [],
                             "why": "a wider encoder"})
    bench["workloads"].append({"name": "ml1m_wide.train_k16", "config": "ml1m_wide",
                               "traffic": "train_k16", "chips": 1, "why": "16 steps a call"})
    bench["end_to_end"][0]["workloads"].append("ml1m_wide.train_k16")
    bench["per_layer"].append({"name": "steps.count.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_examples_per_s",
                               "workloads": ["ml1m_wide.train_k16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    s = spec.load(root, "ml1m_wide.train_k16")
    assert s.config["model"]["hidden_size"] == 256 and s.traffic["steps_per_call"] == 16
    assert [m["name"] for m in s.per_layer] == ["steps.count.train"]
    assert {m["name"] for m in s.end_to_end} == {"train_examples_per_s", "setup_s"}

    class T:
        units = 7

    assert spec.reader(root, "steps.count.train")(T()) == 7.0
    assert spec.driver(root, s.kind).Session.kind == "train"
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
