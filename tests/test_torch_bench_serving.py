"""The port's serving bench (``tools/bench_serving.py``) on the CPU.

Each mode runs through its CLI with ``--device cpu`` at a tiny size (4
clients, 16 requests, 2 workers) over one artifact of the deploy smoke's
one-batch fit, shared by the tests: every request answers 200, and the
record carries the keys of the JAX script it ports (read from the JAX
package's committed ``SERVING_DEVICE.json`` and ``SERVING_WORKERS.json``,
and from ``scripts/bench_serving.py``'s printed result).  Without
``--device cpu`` each mode raises where no card is present, and none
writes a root record.
"""

import json
import pathlib

import pytest
import torch

from transformer_recommenders_tpu_torch.tools import bench_serving as B

REPO = pathlib.Path(__file__).resolve().parents[1]
# scripts/bench_serving.py's result
HTTP_KEYS = {"clients", "requests_ok", "errors", "qps", "p50_ms", "p95_ms"}
TINY = ["--clients", "4", "--requests", "16", "--workers", "2"]
# scripts/bench_serving_device.py's payload
DEVICE_KEYS = {"mode", "backend", "clients", "sweep", "best", "sequential_1_client"}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return B.make_artifact(str(tmp_path_factory.mktemp("bench")), torch.device("cpu"))


def run_mode(mode: str, artifact, tmp_path, monkeypatch) -> dict:
    monkeypatch.setattr(B, "make_artifact", lambda work_dir, device: artifact)
    out = tmp_path / f"{mode}.json"
    assert B.main([mode, *TINY, "--device", "cpu", "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["device"] == {"device": "cpu", "card": None} and record["requests"] == 16
    return record


def test_http_mode_on_the_cpu(artifact, tmp_path, monkeypatch):
    record = run_mode("http", artifact, tmp_path, monkeypatch)
    assert HTTP_KEYS <= set(record)
    assert record["clients"] == 4 and record["requests_ok"] == 16 and record["errors"] == 0
    assert 0 < record["p50_ms"] <= record["p95_ms"] <= record["p99_ms"] and record["qps"] > 0
    assert record["launches"] == {}  # the plain path launches no kernel


def test_device_mode_on_the_cpu(artifact, tmp_path, monkeypatch):
    record = run_mode("device", artifact, tmp_path, monkeypatch)
    jax = json.loads((REPO / "SERVING_DEVICE.json").read_text())
    # the script's keys (the record adds a note written by hand, p99_note)
    assert DEVICE_KEYS <= set(jax) and DEVICE_KEYS <= set(record)
    assert record["backend"] == "cpu"
    assert [(p["window_ms"], p["max_batch"]) for p in record["sweep"]] == [
        (p["window_ms"], p["max_batch"]) for p in jax["sweep"]] == list(B.SWEEP)
    for point, want in zip(record["sweep"], jax["sweep"]):
        assert set(want) <= set(point)
        assert point["requests_ok"] == 16 and point["errors"] == 0
        assert set(want["batch"]) <= set(point["batch"]) and point["batch"]["mean_batch"] >= 1
        assert {"batch_wait", "encode", "search"} <= set(point["span_seconds_total"])
    assert record["best"] in record["sweep"]
    assert record["best"]["p95_ms"] == min(p["p95_ms"] for p in record["sweep"])
    seq = record["sequential_1_client"]
    assert set(jax["sequential_1_client"]) <= set(seq)
    assert seq["requests_ok"] == 96 and seq["errors"] == 0


def test_workers_mode_on_the_cpu(artifact, tmp_path, monkeypatch):
    record = run_mode("workers", artifact, tmp_path, monkeypatch)
    jax = json.loads((REPO / "SERVING_WORKERS.json").read_text())
    arms = ["workers=1", "workers=2", "workers=2_pinned"]
    top = {k for k in jax if not k.startswith("workers=")}
    assert top <= set(record) and record["n_workers"] == 2 and record["backend"] == "cpu"
    assert [k for k in record if k.startswith("workers=")] == arms
    assert record["best_config"] in arms[1:]
    assert record["speedup"] == pytest.approx(
        record[record["best_config"]]["qps"] / record["workers=1"]["qps"])
    assert set(record["left_out"]) == {"workers=2_eigen1"}
    for arm in arms:
        got, want = record[arm], jax["workers=1"]
        assert set(want) <= set(got), arm
        assert got["requests_ok"] == 16 and got["errors"] == 0, arm
        assert set(want["spans"]) <= set(got["spans"]), arm
        # every worker served and exited with its launch line
        assert got["workers_exited"] == int(arm.split("=")[1][0]) == len(got["per_worker"])
        assert sum(w["requests"] for w in got["per_worker"].values()) == 16


@pytest.mark.parametrize("mode", sorted(B.DEFAULTS))
def test_needs_a_card_unless_told_cpu(tmp_path, mode):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main([mode, "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_defaults_are_the_jax_scripts():
    # scripts/bench_serving.py, bench_serving_device.py, bench_serving_workers.py
    assert B.DEFAULTS == {"http": (16, 200), "device": (16, 480), "workers": (16, 400)}
    assert B.request_for(0, 0, ["a", "b"], ["u", "v"]) == ("/recommend_with_item_id",
                                                          {"item_id": "a"})
    assert B.request_for(1, 0, ["a", "b"], ["u", "v"]) == ("/recommend_with_user_id",
                                                          {"user_id": "v"})
    assert B.percentiles([3.0, 1.0, 2.0]) == {"p50_ms": 2.0, "p95_ms": 3.0, "p99_ms": 3.0}


@pytest.mark.parametrize("record", ["SERVING_DEVICE.json", "SERVING_WORKERS.json"])
def test_never_writes_a_root_record(tmp_path, record):
    before = (REPO / record).read_bytes()
    with pytest.raises(SystemExit, match="root of the repository"):
        B.main(["device", "--device", "cpu", "--out", str(REPO / record)])
    assert (REPO / record).read_bytes() == before
