"""The port's ``Evaluator`` against the JAX package's on the CPU, from the
same numpy weights (``params_from_jax``), catalog and eval arrays, in f32.

Both encode the last windows (the JAX package's XLA layer stack on its CPU
backend, the port's plain layer: f32 sums in other orders, ~1e-6 apart),
score the projected catalog by cosine, mask the full histories, take the
top-k and compute the metrics.  On inputs without near ties (no two of a
user's k + 1 best scores within 1e-5, ten times the packages' score
differences, checked on the port's scores) the rankings are the same, so:

- ``recommend_batch``: item ids identical, scores within 1e-5;
- ``run``: every metric within 1e-5 (the same ranks; means of f32 values
  summed in other orders);
- with and without the input projection, over batches with a partial
  last one.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_recommenders_tpu.data.module import EvalArrays as JaxEvalArrays
from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu.training.evaluator import Evaluator as JaxEvaluator
from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.data.module import EvalArrays
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.models.recommender import (
    model_forward,
    retrieval_item_embeddings,
)
from transformer_recommenders_tpu_torch.ops.topk import mask_excluded, normalize_rows
from transformer_recommenders_tpu_torch.training.evaluator import Evaluator

SETTINGS = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=48, max_seq_length=8, compute_dtype="float32", top_k=10,
                eval_batch_size=16, hidden_dropout=0.0, attention_dropout=0.0)
N_ITEMS, N_USERS = 90, 37


def make_arrays(seed: int):
    rng = np.random.default_rng(seed)
    hists, targets, n_targets = [], [], []
    for _ in range(N_USERS):
        hists.append(rng.integers(1, N_ITEMS + 1, size=int(rng.integers(1, 20))).astype(np.int32))
        t = rng.choice(np.arange(1, N_ITEMS + 1), size=int(rng.integers(0, 6)), replace=False)
        targets.append(t.astype(np.int32))
        n_targets.append(len(t) + int(rng.integers(0, 2)))  # some ids outside the vocabulary
    window = np.zeros((N_USERS, 8), np.int32)
    for i, h in enumerate(hists):
        window[i, : len(h[-8:])] = h[-8:]
    fields = dict(user_ids=[f"u{i}" for i in range(N_USERS)], histories=hists,
                  history_window=window, target_lists=targets,
                  n_targets=np.asarray(n_targets, np.int32))
    return JaxEvalArrays(**fields), EvalArrays(**fields)


def min_gap(params, cfg, table, arrays, k) -> float:
    with torch.no_grad():
        q = model_forward(params, cfg, table, torch.from_numpy(arrays.history_window).long())
        items = retrieval_item_embeddings(params, cfg, table)
        scores = normalize_rows(q["sentence_embedding"]) @ normalize_rows(items).T
        scores = mask_excluded(scores, torch.from_numpy(arrays.history_full).long())
    top = torch.sort(scores, dim=1, descending=True).values[:, : k + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


@pytest.mark.parametrize("input_dim", [None, 48])
def test_evaluator_matches_jax(input_dim):
    jcfg = JaxTrainConfig(input_dim=input_dim, **SETTINGS)
    tcfg = TrainConfig(input_dim=input_dim, **SETTINGS)
    jparams = JT.init_transformer_params(jax.random.key(3), jcfg)
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(N_ITEMS, jcfg.resolved_input_dim)).astype(np.float32)
    table_np = np.concatenate([np.zeros((1, emb.shape[1]), np.float32), emb])
    table = torch.from_numpy(table_np)
    jarrays, arrays = make_arrays(5)
    assert min_gap(params, tcfg, table, arrays, tcfg.top_k) > 1e-5

    jev, ev = JaxEvaluator(jcfg), Evaluator(tcfg)
    want_idx, want_scores = jev.recommend_batch(jparams, jax.numpy.asarray(table_np), jarrays)
    got_idx, got_scores = ev.recommend_batch(params, table, arrays)
    assert got_idx.dtype == np.int32 and got_idx.shape == (N_USERS, tcfg.top_k)
    np.testing.assert_array_equal(got_idx, np.asarray(want_idx))
    np.testing.assert_allclose(got_scores, np.asarray(want_scores), rtol=0, atol=1e-5)
    for i, h in enumerate(arrays.histories):  # history excluded
        assert set(h.tolist()).isdisjoint(got_idx[i].tolist())

    want = jev.run(jparams, jax.numpy.asarray(table_np), jarrays, stage="val")
    got = ev.run(params, table, arrays, stage="val")
    assert got.keys() == want.keys() and len(got) == 7
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5, err_msg=name)
    assert 0.0 < got["val/retrieval_hit_rate"] <= 1.0


def test_padded_users_and_empty_split():
    cfg = TrainConfig(**SETTINGS)
    params = TT.init_transformer_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    table = torch.cat([torch.zeros(1, 32), torch.randn(N_ITEMS, 32)])
    _, arrays = make_arrays(6)
    ev = Evaluator(cfg)
    full = ev.run(params, table, arrays, stage="test")
    assert all(k.startswith("test/") for k in full)
    # users without targets do not count: dropping them changes nothing
    keep = [i for i in range(N_USERS) if arrays.n_targets[i] > 0]
    subset = dataclasses.replace(
        arrays, user_ids=[arrays.user_ids[i] for i in keep],
        histories=[arrays.histories[i] for i in keep], history_window=arrays.history_window[keep],
        target_lists=[arrays.target_lists[i] for i in keep], n_targets=arrays.n_targets[keep])
    assert len(keep) < N_USERS
    again = ev.run(params, table, subset, stage="test")
    for name in full:
        np.testing.assert_allclose(again[name], full[name], rtol=1e-6)
    assert ev.run(params, table, arrays.head(0)) == {}
    idx, scores = ev.recommend_batch(params, table, arrays.head(0))
    assert idx.shape == (0, cfg.top_k) and scores.shape == (0, cfg.top_k)
