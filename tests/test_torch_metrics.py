"""The port's retrieval metrics (``ops/metrics.py``) against the JAX
package's and the torchmetrics goldens, on the CPU.

- hand-computed cases, as JAX's ``tests/test_metrics.py`` has them (rtol
  1e-6);
- random relevance lists against JAX's ``retrieval_metrics``: both compute
  the same closed forms in f32, their sums in possibly other orders, so
  within 1e-6 (abs);
- every case of ``tests/golden/metrics_torchmetrics.json`` (the
  torchmetrics functionals' values), rtol 1e-5 and atol 1e-6 as JAX's
  golden test;
- the host API and the mean over the users with targets.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.ops import metrics as JMX
from transformer_recommenders_tpu_torch.ops.metrics import (
    aggregate_metrics,
    compute_retrieval_metrics,
    retrieval_metrics,
)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "metrics_torchmetrics.json"
NAMES = ["retrieval_normalized_dcg", "retrieval_average_precision", "retrieval_auroc",
         "retrieval_precision", "retrieval_recall", "retrieval_hit_rate",
         "retrieval_reciprocal_rank"]


def run_one(rel, n_targets, top_k):
    out = retrieval_metrics(torch.tensor([rel], dtype=torch.float32),
                            torch.tensor([n_targets]), top_k)
    return {k: float(v[0]) for k, v in out.items()}


IDCG4 = sum(1 / np.log2(i + 2) for i in range(4))


@pytest.mark.parametrize("rel,n_targets,top_k,want", [
    ([1, 1, 0, 0, 0], 2, 5, dict(retrieval_precision=2 / 5, retrieval_recall=1.0,
                                 retrieval_hit_rate=1.0, retrieval_reciprocal_rank=1.0,
                                 retrieval_average_precision=1.0, retrieval_normalized_dcg=1.0,
                                 retrieval_auroc=1.0)),
    ([0, 0, 1, 0, 0], 4, 5, dict(retrieval_precision=1 / 5, retrieval_recall=1 / 4,
                                 retrieval_hit_rate=1.0, retrieval_reciprocal_rank=1 / 3,
                                 retrieval_average_precision=1 / 3,
                                 retrieval_normalized_dcg=0.5 / IDCG4, retrieval_auroc=2 / 4)),
    ([0, 0, 0, 0], 3, 4, dict.fromkeys(NAMES, 0.0)),
    ([1, 0, 0, 1], 2, 4, dict(retrieval_average_precision=(1 / 1 + 2 / 4) / 2,
                              retrieval_auroc=2 / 4)),
    ([1, 1, 1], 10, 3, dict(retrieval_normalized_dcg=1.0, retrieval_recall=3 / 10,
                            retrieval_auroc=0.0)),
], ids=["perfect", "rank3", "no_hits", "interleaved_ap", "many_targets"])
def test_hand_computed(rel, n_targets, top_k, want):
    got = run_one(rel, n_targets, top_k)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("top_k", [1, 5, 20])
def test_matches_jax(top_k):
    rng = np.random.default_rng(top_k)
    u = 300
    rel = (rng.random((u, top_k + 3)) < rng.random((u, 1))).astype(np.float32)
    n_targets = rng.integers(0, 2 * top_k + 2, size=u).astype(np.int32)
    got = retrieval_metrics(torch.from_numpy(rel), torch.from_numpy(n_targets), top_k)
    want = JMX.retrieval_metrics(jnp.asarray(rel), jnp.asarray(n_targets), top_k)
    assert set(got) == set(want)
    for name in NAMES:
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    agg, jagg = aggregate_metrics(got), JMX.aggregate_metrics(want)
    for name in NAMES:
        np.testing.assert_allclose(float(agg[name]), float(jagg[name]), rtol=0, atol=1e-6)


def test_torchmetrics_goldens():
    cases = json.loads(GOLDEN.read_text())["cases"]
    assert len(cases) >= 100
    by_k: dict[int, list[dict]] = {}
    for case in cases:
        by_k.setdefault(case["top_k"], []).append(case)
    for top_k, group in by_k.items():
        rel = torch.zeros((len(group), top_k))
        n_targets = torch.zeros(len(group), dtype=torch.int32)
        for i, case in enumerate(group):
            rel[i, : len(case["rel"])] = torch.tensor(case["rel"], dtype=torch.float32)
            n_targets[i] = case["n_targets"]
        out = retrieval_metrics(rel, n_targets, top_k)
        for name in NAMES:
            np.testing.assert_allclose(out[name].numpy(),
                                       [c["expected"][name] for c in group], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} @ top_k={top_k}")


def test_host_api_matches_reference_protocol():
    m = compute_retrieval_metrics(["a", "b"], {"b", "z"}, top_k=4)
    want = JMX.compute_retrieval_metrics(["a", "b"], {"b", "z"}, top_k=4)
    assert m.keys() == want.keys()
    for name in m:
        np.testing.assert_allclose(m[name], want[name], rtol=1e-6)
    np.testing.assert_allclose(m["retrieval_reciprocal_rank"], 1 / 2)
    assert compute_retrieval_metrics(["a"], set(), top_k=4) == {}


def test_aggregate_skips_empty_target_users():
    out = retrieval_metrics(torch.tensor([[1.0, 0.0], [0.0, 0.0], [1.0, 1.0]]),
                            torch.tensor([1, 0, 2]), 2)
    agg = aggregate_metrics(out)
    np.testing.assert_allclose(float(agg["retrieval_recall"]), 1.0)
    np.testing.assert_allclose(float(agg["retrieval_precision"]), (0.5 + 1.0) / 2)
