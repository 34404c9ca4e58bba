"""The port's gather (``gather_rows``: the CUDA row copy on the card, its
plain version on CPU tensors) against the JAX one-hot Pallas kernel in
interpret mode, bf16 and f32 rows, out-of-range indices included.  The
rows are copies, so the tolerance is zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.ops.gather_matmul import gather_rows as jax_gather_rows
from transformer_recommenders_tpu_torch.models.recommender import fast_table_lookup
from transformer_recommenders_tpu_torch.ops.gather_matmul import gather_rows


@pytest.mark.parametrize(("n", "d", "r"), [(300, 128, 96), (37, 48, 50), (3707, 16, 64)])
def test_gather_matches_jax_interpret(n, d, r):
    """bf16 rows against the JAX kernel; f32 rows are exact copies (the
    JAX kernel rounds every row through bf16 whatever its out_dtype; the
    port's f32 rows serve the exact ``jnp.take`` lookup instead)."""
    rng = np.random.default_rng(n + r)
    table = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(-3, n + 3, size=r).astype(np.int32)
    idx[:3] = [-1, n, n + 100]  # out of range -> zero rows
    want_bf16 = jax_gather_rows(jnp.asarray(table), jnp.asarray(idx), interpret=True,
                                out_dtype=jnp.bfloat16)
    want_f32 = np.where(((idx >= 0) & (idx < n))[:, None], table[np.clip(idx, 0, n - 1)], 0.0)
    for idx_dtype in (torch.int32, torch.int64):
        t_idx = torch.from_numpy(idx).to(idx_dtype)
        got = gather_rows(torch.from_numpy(table), t_idx, torch.bfloat16)
        assert got.dtype == torch.bfloat16 and got.shape == (r, d)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want_bf16.astype(jnp.float32)))
        got = gather_rows(torch.from_numpy(table), t_idx, torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want_f32)
    assert not got[:3].any()


def test_fast_table_lookup_dtypes():
    """bf16 compute gets bf16-rounded rows (the TPU lookup's values) up to
    the catalog cap; f32 compute gets exact rows, like the JAX ``jnp.take``
    branch."""
    table = torch.randn(20, 8)
    idx = torch.tensor([[1, 2, 0], [19, 5, 5]])
    rows_bf16 = fast_table_lookup(table, idx, compute_dtype="bfloat16")
    rows_f32 = fast_table_lookup(table, idx, compute_dtype="float32")
    assert rows_bf16.shape == rows_f32.shape == (2, 3, 8)
    assert rows_bf16.dtype == torch.bfloat16
    torch.testing.assert_close(rows_f32, table[idx], rtol=0, atol=0)
    torch.testing.assert_close(rows_bf16, table[idx].bfloat16(), rtol=0, atol=0)



@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lookup_above_the_catalog_cap_is_jnp_take(dtype):
    """A 16,385-row catalog (one past ``ONEHOT_LOOKUP_MAX_ITEMS``): exact
    f32 rows under either compute dtype, equal bit for bit to JAX's
    ``fast_table_lookup`` (``jnp.take``), their gradient an f32 sum; at
    16,384 rows bf16 compute still gets bf16-rounded rows."""
    from transformer_recommenders_tpu.models.recommender import (
        ONEHOT_LOOKUP_MAX_ITEMS,
        fast_table_lookup as jax_fast_table_lookup,
    )
    from transformer_recommenders_tpu_torch.models import recommender as TR

    assert TR.ONEHOT_LOOKUP_MAX_ITEMS == ONEHOT_LOOKUP_MAX_ITEMS == 16384
    rng = np.random.default_rng(5)
    table = rng.normal(size=(16385, 8)).astype(np.float32)
    idx = rng.integers(0, 16385, size=(4, 50))
    idx[0, :3] = [16384, 16384, 0]
    want = np.asarray(jax_fast_table_lookup(jnp.asarray(table), jnp.asarray(idx),
                                            compute_dtype=jnp.dtype(dtype)))
    t = torch.from_numpy(table).requires_grad_()
    got = fast_table_lookup(t, torch.from_numpy(idx), compute_dtype=dtype)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    assert t.grad.dtype == torch.float32
    assert t.grad[16384, 0] == 2.0 and t.grad[0, 0] == float((idx == 0).sum())
    below = fast_table_lookup(torch.from_numpy(table[:16384]), torch.from_numpy(idx % 16384),
                              compute_dtype=dtype)
    assert below.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
