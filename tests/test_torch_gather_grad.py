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


def test_backward_reference_sums_in_row_order_and_skips_out_of_range():
    g = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]])
    idx = torch.tensor([2, -1, 2, 5])
    got = gather_rows_backward_reference(g, idx, 4, torch.float32)
    torch.testing.assert_close(got, torch.tensor([[0.0, 0.0], [0.0, 0.0], [6.0, 8.0], [0.0, 0.0]]))
    assert gather_rows_backward_reference(g, idx, 4, torch.bfloat16).dtype == torch.bfloat16
