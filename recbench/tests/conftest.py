"""Fixtures of the benchmark's CPU tests: a checkout-shaped root whose
cells are the real ones cut to a size the CPU runs in seconds (the same
code paths: the fused layer at d=128, the layer stack past 64 positions at
ml25m_ccl's widths), with limits of their own, and the ``cuda`` marker of
the tests that need the card."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]

TINY = {
    "ml25m_ccl": {
        "model": {"num_hidden_layers": 1, "eval_batch_size": 8},
        "data": {"batch_size": 16},
        "dataset": {"items": 2000, "users": 64, "events": 64 * 150, "min_events_per_user": 20,
                    "max_events_per_user": 800, "median_events_per_user": 100},
    },
    "ml1m_ssm": {
        "model": {"hidden_size": 128, "num_hidden_layers": 1, "num_attention_heads": 8,
                  "intermediate_size": 64, "max_seq_length": 8, "eval_batch_size": 8},
        "data": {"max_seq_length": 8, "batch_size": 8},
        "dataset": {"items": 60, "users": 40, "events": 40 * 30, "min_events_per_user": 20,
                    "max_events_per_user": 60, "median_events_per_user": 25},
        "item_table": {"genre_size": 8},
    },
}
# the tiny cells' limits, set as the cells' own are (recbench/limits/), from
# readings of the tiny cells on the CPU (8 seeds, the control and the
# faults on 3): above the program's highest, below the lowest reading of the
# control or a fault that fails it.  Train, K=2 (the program's highest; the
# control's lowest): ml25m_ccl loss 0.057 (0.144), moment 0.029 (0.065),
# angle 0.0027 (0.0154), change 0.0093 (unchanged: 1); ml1m_ssm loss 0.0024
# (0.0047), moment 0.0061 (0.009), angle 0.0027 (0.0106), change 0.0084
# (unchanged: 1).  The loss gaps were read over each step's own objective;
# over the larger of it and the first step's they read no higher.
TINY_LIMITS = {
    "ml25m_ccl.train": {"loss_gap": 0.25, "moment_gap": 0.15, "moment_angle": 0.008,
                        "change_gap": 0.1},
    "ml1m_ssm.train": {"loss_gap": 0.02, "moment_gap": 0.03, "moment_angle": 0.006,
                       "change_gap": 0.1},
    "ml25m_ccl.recommend": {"rank_gap": 0.005, "score_gap": 0.005},
    "ml1m_ssm.recommend": {"rank_gap": 0.005, "score_gap": 0.005},
}
TINY_TRAFFIC = {
    "train": {"pool_calls": 2, "steps_per_call": 2},
    "recommend": {"users": 24, "check_users": 16},
    "recommend_2048": {"users_per_call": 16, "users": "dataset", "check_users": 16},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs the benchmark's cells on the card); "
        "skipped where torch.cuda.is_available() is false")


def make_tiny_root(dst: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark's files with every configuration and traffic
    mix cut to the tiny sizes above; the port is linked in."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "recbench", dst / "recbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "transformer_recommenders_tpu_torch").symlink_to(
        REPO / "transformer_recommenders_tpu_torch")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        for section, values in TINY[c["name"]].items():
            cfg[section].update(values)
        path.write_text(json.dumps(cfg))
    for name, values in TINY_TRAFFIC.items():
        path = dst / "recbench" / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(values)
        path.write_text(json.dumps(mix))
    for cell, limits in TINY_LIMITS.items():
        path = dst / "recbench" / "limits" / f"{cell}.json"
        path.write_text(json.dumps({"numbers": {k: {"limit": v} for k, v in limits.items()}}))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    """Two threads a test process: the tests run in several processes, and
    the tiny cells' many small ops slow down many times over when every
    process takes every core."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run only on the card")
