"""The port's gather backward (``gather_rows`` under autograd on CPU
tensors, i.e. ``gather_rows_backward_reference``) against ``jax.grad``
through the JAX one-hot Pallas kernel in interpret mode, with duplicate
and out-of-range indices.

Tolerances: the gradient is a sum of cotangent rows by index, in f32 in
both packages, in another order.
- bf16 rows: the cotangent is bf16, the sums are f32 and are rounded to
  bf16 once, so the two agree to one bf16 ulp of each entry
  (2**-8 relative).
- f32 rows: the port's gather stands for the JAX ``jnp.take`` branch,
  whose gradient is the exact f32 sum: 1e-6 relative, plus 1e-6 absolute
  for sums that cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.ops.gather_matmul import gather_rows as jax_gather_rows
from transformer_recommenders_tpu_torch.ops.gather_matmul import (
    gather_rows,
    gather_rows_backward_reference,
    group_rows_reference,
)


def make_case(n, d, r, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, min(n, 7), size=r).astype(np.int32)  # many duplicates
    idx[r // 2:] = rng.integers(-3, n + 3, size=r - r // 2)
    idx[:3] = [-1, n, n + 100]  # out of range: no gradient
    probe = rng.normal(size=(r, d)).astype(np.float32)
    return table, idx, probe


def port_grad(table, idx, probe, dtype):
    t = torch.from_numpy(table).to(dtype).requires_grad_()
    rows = gather_rows(t, torch.from_numpy(idx).long(), dtype)
    (rows.float() * torch.from_numpy(probe)).sum().backward()
    assert t.grad.dtype == dtype
    return t.grad.float().numpy()


@pytest.mark.parametrize(("n", "d", "r"), [(300, 128, 96), (37, 48, 50)])
def test_bf16_rows_gradient_matches_jax_kernel(n, d, r):
    table, idx, probe = make_case(n, d, r, n + r)

    def loss(t):
        rows = jax_gather_rows(t, jnp.asarray(idx), interpret=True, out_dtype=jnp.bfloat16)
        return jnp.vdot(rows.astype(jnp.float32), jnp.asarray(probe))

    want = np.asarray(jax.grad(loss)(jnp.asarray(table).astype(jnp.bfloat16)).astype(jnp.float32))
    got = port_grad(table, idx, probe, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=0)
    named = np.zeros(n, bool)
    named[idx[(idx >= 0) & (idx < n)]] = True
    assert not got[~named].any() and got[named].any(axis=1).all()


@pytest.mark.parametrize(("n", "d", "r"), [(300, 128, 96), (37, 48, 50)])
def test_f32_rows_gradient_matches_jnp_take(n, d, r):
    table, idx, probe = make_case(n, d, r, n * r)
    valid = (idx >= 0) & (idx < n)

    def loss(t):
        rows = jnp.where(jnp.asarray(valid)[:, None], jnp.take(t, jnp.asarray(idx), axis=0,
                                                               mode="clip"), 0.0)
        return jnp.vdot(rows, jnp.asarray(probe))

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    got = port_grad(table, idx, probe, torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_backward_reference_sums_in_the_kernels_chunk_order():
    """The plain backward sums as ``csrc/gather_rows.cu`` does: the rows
    sorted stably by index and cut into chunks of ``_CHUNK``; each index's
    run inside a chunk summed in row order; an index whose rows span chunks
    (here the padding row 0, named by half the rows, as in a padded
    batch) adds its chunks' run sums in chunk order.  Held bit for bit
    against that order written out with numpy f32 sums; a long segment
    summed in plain row order lands elsewhere."""
    from transformer_recommenders_tpu_torch.ops.gather_matmul import _CHUNK

    rng = np.random.default_rng(9)
    r, d, n = 5 * _CHUNK + 7, 16, 50
    idx = rng.integers(-2, n + 2, size=r)
    idx[rng.random(r) < 0.5] = 0
    g = (1000.0 * rng.normal(size=(r, d))).astype(np.float32)
    g[idx == 0] *= 1e-3 * rng.random(((idx == 0).sum(), 1)).astype(np.float32)
    order = np.argsort(idx, kind="stable")
    sorted_idx = idx[order]
    want = np.zeros((n, d), np.float32)
    for key in range(n):
        pos = np.flatnonzero(sorted_idx == key)
        total = None
        for c in sorted(set(pos // _CHUNK)):
            run = None
            for j in pos[pos // _CHUNK == c]:
                run = g[order[j]].copy() if run is None else np.float32(run + g[order[j]])
            total = run if total is None else np.float32(total + run)
        if total is not None:
            want[key] = total
    got = gather_rows_backward_reference(torch.from_numpy(g), torch.from_numpy(idx), n,
                                         torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    rows_in_order = np.zeros(d, np.float32)
    for j in np.flatnonzero(idx == 0):
        rows_in_order = np.float32(rows_in_order + g[j])
    assert (idx == 0).sum() > 2 * _CHUNK and not np.array_equal(rows_in_order, want[0])


def test_backward_reference_sums_in_row_order_and_skips_out_of_range():
    g = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]])
    idx = torch.tensor([2, -1, 2, 5])
    got = gather_rows_backward_reference(g, idx, 4, torch.float32)
    torch.testing.assert_close(got, torch.tensor([[0.0, 0.0], [0.0, 0.0], [6.0, 8.0], [0.0, 0.0]]))
    assert gather_rows_backward_reference(g, idx, 4, torch.bfloat16).dtype == torch.bfloat16


def _grouping_case(case: str, rng):
    """(indices, N) for one grouping case."""
    if case == "skewed":  # a train batch: a third of the rows on the padding row 0
        n, r = 3707, 4096
        idx = rng.integers(1, n, size=r)
        idx[rng.random(r) < 1 / 3] = 0
    elif case == "out_of_range":  # negative and >= N indices of several values
        n, r = 50, 999
        idx = rng.integers(-7, n + 7, size=r)
    elif case == "one_row":
        n, idx = 20, np.array([13])
    elif case == "one_table_row":
        n, idx = 1, rng.integers(-2, 3, size=300)
    elif case == "all_equal":
        n, idx = 300, np.full(1000, 17)
    else:  # "ragged": R a multiple of no warp step, part or chunk
        n, r = 257, 32 * 64 * 3 + 17
        idx = rng.integers(-1, n + 1, size=r)
    return idx, n


def _assert_bounds(bounds, idx, n):
    """Each bucket's first position and one past its last (an empty
    bucket's two equal), against the counts of ``clamp(idx, -1, n) + 1``."""
    counts = torch.bincount(idx.long().clamp(-1, n) + 1, minlength=n + 2)
    first = torch.cat([counts.new_zeros(1), counts.cumsum(0)[:-1]])
    assert torch.equal(bounds[:, 1] - bounds[:, 0], counts)
    assert torch.equal(bounds[counts > 0, 0], first[counts > 0])


@pytest.mark.parametrize("case", ["skewed", "out_of_range", "one_row", "one_table_row",
                                  "all_equal", "ragged"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize(("bits", "items"), [(4, 4), (4, 12), (8, 16), (3, 5)])
def test_grouping_reference_is_the_stable_sort(case, idx_dtype, bits, items):
    """The backward's grouping as ``csrc/gather_rows.cu`` runs it (an LSD
    radix sort of the buckets ``clamp(idx, -1, N) + 1``, ``bits`` a pass,
    each owner of ``items`` consecutive positions counting its own; the
    one-block kernel's 4 and the tiled kernel's 8 and 16, and an odd
    plan), in torch ops, against ``torch.sort(stable=True)``: the same keys
    and rows on every in-range position, every out-of-range key as -1 or N,
    and each bucket's bounds."""
    idx, n = _grouping_case(case, np.random.default_rng(len(case) + bits + items))
    idx = torch.from_numpy(idx).to(idx_dtype)
    keys, order, bounds = group_rows_reference(idx, n, bits=bits, items=items)
    sorted_idx, sorted_rows = torch.sort(idx.long(), stable=True)
    valid = (sorted_idx >= 0) & (sorted_idx < n)
    assert torch.equal(keys[valid], sorted_idx[valid])
    assert torch.equal(order[valid], sorted_rows[valid])
    assert torch.equal(keys, sorted_idx.clamp(-1, n))
    assert sorted(order.tolist()) == list(range(idx.numel()))
    _assert_bounds(bounds, idx, n)
