"""The traffic repeats bit for bit for a seed, deals every seed the same
lengths, and follows the stated distributions and the sampling rule."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from recbench import traffic
from recbench.tests.conftest import REPO

DATASETS = {n: json.loads((REPO / f"recbench/configs/{n}.json").read_text())["dataset"]
            for n in ("ml1m_ssm", "ml25m_ccl")}
MIX = {"zipf_exponent": 0.8, "jump_probability": 0.3, "pool_calls": 2, "steps_per_call": 4,
       "users": 300}
SMALL = {"items": 500, "users": 300, "events": 300 * 60, "min_events_per_user": 20,
         "max_events_per_user": 400, "median_events_per_user": 45}
BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_lengths_keep_the_published_counts(name):
    ds = DATASETS[name]
    lengths = traffic.user_lengths(ds, ds["users"])
    assert lengths.min() >= ds["min_events_per_user"]
    assert lengths.max() <= ds["max_events_per_user"]
    assert abs(lengths.mean() - ds["events"] / ds["users"]) < 0.005 * ds["events"] / ds["users"]
    assert abs(np.median(lengths) - ds["median_events_per_user"]) <= 2
    assert np.mean(lengths) > 1.5 * np.median(lengths)  # heavy-tailed


def test_a_seed_repeats_bit_for_bit_and_seeds_differ():
    a = traffic.train_pool(SMALL, 8, 16, MIX, BIG_SEED, "cpu")
    b = traffic.train_pool(SMALL, 8, 16, MIX, BIG_SEED, "cpu")
    c = traffic.train_pool(SMALL, 8, 16, MIX, BIG_SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["history_item_idx"], c["history_item_idx"])
    r1 = traffic.recommend_pool(SMALL, 64, 16, MIX, BIG_SEED, "cpu")
    r2 = traffic.recommend_pool(SMALL, 64, 16, MIX, BIG_SEED, "cpu")
    for x, y in zip(r1, r2):
        assert all(torch.equal(x[k], y[k]) for k in x if k != "n_real")
    seeds = traffic.derived_seeds(BIG_SEED)
    assert len(set(seeds.values())) == 4 and all(0 <= v < 2**63 for v in seeds.values())


def test_every_seed_gets_the_same_lengths():
    def lengths(seed):
        pool = traffic.recommend_pool(SMALL, 300, 16, MIX, seed, "cpu")[0]
        return sorted(((pool["history_full"] != 0).sum(dim=1) + 1).tolist())

    assert lengths(1) == lengths(2) == sorted(traffic.user_lengths(SMALL, 300).tolist())


def test_popularity_is_zipf():
    gen = torch.Generator().manual_seed(3)
    mix = dict(MIX, jump_probability=1.0)  # every event a popularity draw
    items, _ = traffic.walk(torch.full((400,), 500), 1000, mix, gen, "cpu")
    freq = torch.bincount(items, minlength=1001)[1:].double() / len(items)
    want = 1.0 / torch.arange(1, 1001, dtype=torch.float64) ** 0.8
    want /= want.sum()
    assert torch.allclose(freq[:10], want[:10], rtol=0.05)
    # the ring walk: steps of 1 to 3 between popularity draws
    items, off = traffic.walk(torch.full((50,), 100), 1000, dict(MIX, jump_probability=0.0),
                              gen, "cpu")
    steps = (items[1:100] - items[:99]) % 1000
    assert set(steps.tolist()) <= {1, 2, 3}


def test_training_rows_follow_the_sampling_rule():
    seq = 16
    pool = traffic.train_pool(SMALL, 8, seq, MIX, 7, "cpu")
    hist, pos, neg = (pool[k].reshape(-1, seq) for k in
                      ("history_item_idx", "pos_item_idx", "neg_item_idx"))
    valid = hist != 0
    # items at the front of each row, zeros behind them
    assert torch.equal(valid, torch.sort(valid.int(), dim=1, descending=True).values.bool())
    assert torch.equal(valid, pos != 0) and torch.equal(valid, neg != 0)
    for r in range(hist.shape[0]):
        n = int(valid[r].sum())
        row_neg = neg[r, :n].tolist()
        assert len(set(row_neg)) == n  # without replacement
        assert not set(row_neg) & (set(hist[r, :n].tolist()) | set(pos[r, :n].tolist()))
    assert int(hist.max()) <= SMALL["items"] and int(neg.max()) <= SMALL["items"]


def test_recommendation_batches_exclude_the_whole_history():
    calls = traffic.recommend_pool(SMALL, 64, 16, MIX, 9, "cpu")
    assert sum(c["n_real"] for c in calls) == 300
    for c in calls:
        h = c["history_full"]
        assert h.shape[1] & (h.shape[1] - 1) == 0  # a power of two
        n = (h != 0).sum(dim=1)
        w = c["history_window"]
        for u in range(c["n_real"]):
            k = int(n[u])
            tail = h[u, max(0, k - 16):k]
            assert torch.equal(w[u, :len(tail)], tail) and not w[u, len(tail):].any()
        assert not c["targets"][c["n_real"]:].any() and not c["n_targets"][c["n_real"]:].any()
