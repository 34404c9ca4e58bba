"""The port's exact MIPS retrieval (ops/topk.py) against the JAX one:
same item indices in the same order and scores within 1e-5 (f32 sums in
another order), with 1-based exclusion lists padded by 0; and, where
items tie, the same indices as ``lax.top_k`` (lower index first)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.ops import topk as jtopk
from transformer_recommenders_tpu_torch.ops import topk as ttopk


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("prenormalized", [False, True])
def test_topk_items_matches_jax(metric, prenormalized):
    rng = np.random.default_rng(0)
    queries = rng.normal(size=(5, 32)).astype(np.float32)
    items = rng.normal(size=(300, 32)).astype(np.float32)
    if prenormalized:
        items /= np.linalg.norm(items, axis=1, keepdims=True)
    exclude = np.zeros((5, 8), np.int32)
    exclude[0, :3] = [1, 2, 300]  # 1-based; 0 pads
    exclude[3, :8] = rng.integers(1, 301, size=8)
    want_s, want_i = jtopk.topk_items(
        jnp.asarray(queries), jnp.asarray(items), 20, exclude_idx=jnp.asarray(exclude),
        metric=metric, items_prenormalized=prenormalized)
    got_s, got_i = ttopk.topk_items(
        torch.from_numpy(queries), torch.from_numpy(items), 20,
        exclude_idx=torch.from_numpy(exclude), metric=metric, items_prenormalized=prenormalized)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    for row in range(5):
        assert not set(exclude[row][exclude[row] > 0]) & set(got_i[row].tolist())


def test_mask_excluded_ignores_padding_and_keeps_item_one():
    scores = torch.arange(12, dtype=torch.float32).view(2, 6)
    masked = ttopk.mask_excluded(scores, torch.tensor([[0, 7], [1, 6]]))  # 7: past the end
    assert torch.isfinite(masked[0]).all()
    assert masked[1, 0] == -np.inf and masked[1, 5] == -np.inf
    assert torch.isfinite(masked[1, 1:5]).all()


def test_normalize_rows_matches_jax():
    x = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    x[2] = 0.0  # the clamp keeps a zero row finite
    np.testing.assert_allclose(ttopk.normalize_rows(torch.from_numpy(x)).numpy(),
                               np.asarray(jtopk.normalize_rows(x)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_topk_items_orders_ties_as_jax(metric):
    """Items with identical embeddings score equal: the port returns them
    lower index first, as ``lax.top_k`` does, across the k-th place too."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(40, 16)).astype(np.float32)
    items = base[rng.integers(0, 40, size=400)]  # every item has copies
    queries = rng.normal(size=(6, 16)).astype(np.float32)
    exclude = np.zeros((6, 4), np.int32)
    exclude[1, :3] = [5, 17, 399]
    for k in (1, 25, 100):
        want_s, want_i = jtopk.topk_items(jnp.asarray(queries), jnp.asarray(items), k,
                                          exclude_idx=jnp.asarray(exclude), metric=metric)
        got_s, got_i = ttopk.topk_items(torch.from_numpy(queries), torch.from_numpy(items), k,
                                        exclude_idx=torch.from_numpy(exclude), metric=metric)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
        # the scores may differ in the last ulp between the packages; the
        # test compares the index order where the port's own scores tie
        # as JAX's do
        assert (np.diff(got_s.numpy(), axis=1) <= 0).all()
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_top_k_columns_breaks_ties_by_column_as_lax_top_k():
    import jax

    rng = np.random.default_rng(3)
    s = rng.integers(-4, 4, size=(8, 300)).astype(np.float32) * 0.25
    s[0, :10] = -0.0
    s[1, 5:20] = np.inf
    s[2, 3:40] = -np.inf
    for k in (1, 7, 50, 300):
        want = np.asarray(jax.lax.top_k(jnp.asarray(s), k)[1])
        np.testing.assert_array_equal(ttopk.top_k_columns(torch.from_numpy(s), k).numpy(), want)
