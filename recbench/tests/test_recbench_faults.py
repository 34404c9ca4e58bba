"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a cell can have, and the control (the reference with
fp8 products in the program's place) fails too.  The runs skip the look
for a card and run the tiny cells on the CPU, the program's plain
versions underneath; a sound run of each cell reads ``correct`` true."""

from __future__ import annotations

import pytest
import torch

from recbench import check, run, spec
from recbench.run import Context
from recbench.traffic import derived_seeds

SEED = 2**31 + 101
CELLS = ("ml25m_ccl.train", "ml1m_ssm.train", "ml25m_ccl.recommend", "ml1m_ssm.recommend")


def _run(root, cell):
    return run.run(root, cell, SEED, 0.2, False, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    result = _run(tiny_root, cell)
    assert result["correct"], result["check"]


def _unchanged(monkeypatch):
    from transformer_recommenders_tpu_torch.training import train_state as ts

    def make_flat_update(config):
        def update(p, g, opt_state):
            return p, opt_state, torch.sqrt(torch.sum(g * g))
        return update

    monkeypatch.setattr(ts, "make_flat_update", make_flat_update)


def _half_batch(monkeypatch):
    from transformer_recommenders_tpu_torch.training import train_state as ts

    original = ts._objective_and_logs

    def objective(config, full_logs, params, item_table, batch, seeds):
        half = batch["history_item_idx"].shape[0] // 2
        kept = {k: torch.cat([v[:half], v[:half]]) for k, v in batch.items()}
        return original(config, full_logs, params, item_table, kept, seeds)

    monkeypatch.setattr(ts, "_objective_and_logs", objective)


def _stuck(monkeypatch):
    """Every step takes the first step's rows and dropout seeds (a row
    counter that never advances)."""
    from transformer_recommenders_tpu_torch.training import train_state as ts

    original, first = ts._objective_and_logs, []

    def objective(config, full_logs, params, item_table, batch, seeds):
        if not first:
            first.append((batch, seeds))
        return original(config, full_logs, params, item_table, *first[0])

    monkeypatch.setattr(ts, "_objective_and_logs", objective)


def _altered_loss(monkeypatch):
    from transformer_recommenders_tpu_torch.training import train_state as ts

    for name in ("fused_pairwise_loss", "fused_table_infonce_loss"):
        original = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, _f=original, **k: 2.0 * _f(*a, **k))


def _half_users(monkeypatch):
    from transformer_recommenders_tpu_torch.training import evaluator

    original = evaluator.model_forward

    def forward(*args, **kwargs):
        out = original(*args, **kwargs)
        q = out["sentence_embedding"]
        half = q.shape[0] // 2
        return {**out, "sentence_embedding": torch.cat([q[:half], q[:q.shape[0] - half]])}

    monkeypatch.setattr(evaluator, "model_forward", forward)


def _altered_answer(monkeypatch):
    from transformer_recommenders_tpu_torch.training import evaluator

    original = evaluator.top_k_columns

    def top_k(scores, k):
        cols = original(scores, k).clone()
        cols[:, 0] = (cols[:, 0] + 1) % scores.shape[1]
        return cols

    monkeypatch.setattr(evaluator, "top_k_columns", top_k)


FAULTS = {"train": {"unchanged": _unchanged, "half": _half_batch, "altered": _altered_loss,
                    "stuck": _stuck},
          "recommend": {"half": _half_users, "altered": _altered_answer}}
CASES = [(c, f) for c in CELLS for f in FAULTS[c.rsplit(".", 1)[1].split("_")[0]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_underneath_reads_incorrect(tiny_root, monkeypatch, cell, fault):
    FAULTS[cell.rsplit(".", 1)[1]][fault](monkeypatch)
    result = _run(tiny_root, cell)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_incorrect(tiny_root, cell):
    s = spec.load(tiny_root, cell)
    driver = spec.driver(tiny_root, s.kind)
    ctx = Context(tiny_root, s.cell, s.config, s.traffic, SEED, derived_seeds(SEED),
                  torch.device("cpu"))
    inputs = driver.make_inputs(ctx)
    if s.kind == "train":
        numbers = driver.numbers(ctx, inputs, driver.reference_out(ctx, inputs, "fp8"))
    else:
        users = driver.sample_users(ctx, inputs, range(len(inputs.pool)))
        items, scores = driver.reference_answer(ctx, inputs, users, "fp8")
        numbers = driver.numbers(ctx, inputs, users, items, scores)
    ok, table = check.judge(numbers, s.limits["numbers"])
    assert not ok, table
