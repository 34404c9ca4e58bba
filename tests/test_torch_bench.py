"""The pure parts of the port's benchmark (``transformer_recommenders_tpu_torch/
bench.py``) on the CPU, at a tiny size: its data and config against the
root ``bench.py`` and ``__graft_entry__`` (the JAX package's benchmark),
the window median and spread, the output record's keys, and the refusal
to run without a card.  The timed parts run only on the card
(``chip_smoke.py``, ``python -m transformer_recommenders_tpu_torch.bench``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import __graft_entry__
import bench as root_bench
from transformer_recommenders_tpu_torch import bench
from transformer_recommenders_tpu_torch.configs import flagship_config

ROOT_DETAILS = ("train_examples_per_s", "train_window_examples_per_s",
                "train_window_spread_pct", "torch_reference_examples_per_s", "torch_step_ms",
                "torch_step_spread_pct", "retrieval")


def test_shapes_follow_the_root_bench():
    assert (bench.B, bench.S, bench.N_ITEMS, bench.EMB_DIM) == (
        root_bench.B, root_bench.S, root_bench.N_ITEMS, root_bench.EMB_DIM)
    assert (bench.TORCH_STEPS, bench.TORCH_WARMUP) == (root_bench.TORCH_STEPS,
                                                       root_bench.TORCH_WARMUP)


def test_flagship_config_is_the_graft_entry_config():
    jcfg = __graft_entry__._flagship_config()
    tcfg = flagship_config()
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(got):  # the nested index configs
            got, want = dataclasses.asdict(got), want.model_dump()
        assert got == want, f.name
    assert flagship_config(hidden_dropout=0.0).hidden_dropout == 0.0


@pytest.mark.parametrize("seed", [0, 3])
def test_batches_and_table_are_the_root_bench_data(seed):
    """The root bench draws history, pos and neg in that order from
    ``default_rng(seed)`` and the table from ``default_rng(0)``."""
    got = bench.make_batch(seed, b=4, s=8, n_items=50)
    r = np.random.default_rng(seed)
    for k in ("history_item_idx", "pos_item_idx", "neg_item_idx"):
        want = r.integers(1, 51, size=(4, 8)).astype(np.int32)
        np.testing.assert_array_equal(got[k], want)
        assert got[k].dtype == np.int32 and got[k].min() >= 1 and got[k].max() <= 50
    table = bench.make_table(n_items=6, dim=5)
    want = np.concatenate([np.zeros((1, 5), np.float32),
                           np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)])
    np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("values", [[1.0, 2.0, 4.0], [10.0, 10.0, 10.0], [3.0, 1.0], [0.0, 0.0]])
def test_spread_is_the_root_bench_spread(values):
    assert bench.spread_pct(values) == root_bench._spread_pct(values)


def test_details_keys_and_medians():
    graphed, eager = [300.0, 100.0, 200.0], [50.0, 70.0, 60.0]
    retrieval = {"qps_batch1": 1.0}
    got = bench.details(graphed, eager, retrieval, None, "NVIDIA H100 80GB HBM3, 700.00 W",
                        "NVIDIA H100 80GB HBM3")
    assert set(ROOT_DETAILS) <= set(got)
    assert got["train_examples_per_s"] == 200.0
    assert got["train_window_spread_pct"] == 100.0
    assert got["eager_train_examples_per_s"] == 60.0
    assert got["eager_train_window_spread_pct"] == round(20 / 60 * 100, 1)
    assert got["torch_reference_examples_per_s"] is None and got["torch_step_ms"] == []
    assert got["torch_step_spread_pct"] is None and got["retrieval"] is retrieval
    assert got["device"]["nvidia_smi"].endswith("700.00 W")
    json.dumps(got)
    with_ref = bench.details(graphed, eager, retrieval, (12.34, [0.5, 0.25]), "", "")
    assert with_ref["torch_reference_examples_per_s"] == 12.3
    assert with_ref["torch_step_ms"] == [500.0, 250.0]


def test_stacked_batches_are_one_row_per_step():
    stacked = bench._stacked(3, 2, 20, "cpu")
    for k, v in stacked.items():
        assert v.shape == (3, 2, bench.S) and v.dtype == torch.int32
        np.testing.assert_array_equal(v[1].numpy(), bench.make_batch(1, 2, bench.S, 20)[k])


def test_main_refuses_without_a_card(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "details.json"
    assert bench.main(["--out", str(out)]) == 2
    assert not out.exists()
    assert capsys.readouterr().out == ""
    assert bench.DEFAULT_OUT.parts[-3:] == ("build", "bench", "bench_details.json")
