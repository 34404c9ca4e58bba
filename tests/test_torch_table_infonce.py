"""The port's table-scored InfoNCE (the plain versions its wrappers run on
CPU tensors) against the JAX package: ``neg_pool_counts``, the per-row
``ce``/``lse`` and the ``dq``/``dT`` gradients against
``table_infonce_rowwise`` in interpret mode with its bf16 products, and
the summed loss against the pool oracle ``losses.compute_losses`` over
gathered rows.

Tolerances:
- counts: exact (sums of 0/1 weights);
- ce, lse against the JAX kernel: 1e-5 relative.  Both score bf16
  operands with f32 sums in other orders (~1e-7 relative), then exp/log;
- dq, dT: 2**-7 of each gradient's max abs value.  The logit gradient is
  rounded to bf16 before both products; where the two packages' f32 dl
  straddle a rounding boundary one entry moves by one bf16 ulp (2**-8
  relative), and a sum of such entries by less;
- the pool oracle scores in f32, so its inputs are made bf16-exact, and
  pos and neg come from disjoint index ranges: the oracle computes the
  positive's logit in another way than its pool logits, so a copy of the
  positive in the pool can tie by one ulp there.  1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.configs import LossConfig
from transformer_recommenders_tpu.ops import fused_table_infonce as JFT
from transformer_recommenders_tpu.ops import losses as JL
from transformer_recommenders_tpu_torch.ops import fused_table_infonce as TFT


def make_case(seed, r=48, n=21, d=32, dup_heavy=True, disjoint=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(r, d)).astype(np.float32)
    table = (0.5 * rng.normal(size=(n, d))).astype(np.float32)
    table[0] = 0.0
    half = n // 2
    pos = rng.integers(1, half if disjoint else n, size=r).astype(np.int32)
    lo, hi = (half, n) if disjoint else (1, 5 if dup_heavy else n)
    neg = rng.integers(lo, hi, size=r).astype(np.int32)
    row_valid = rng.random(r) > 0.25
    neg_valid = rng.random(r) > 0.25
    pos = np.where(row_valid, pos, 0).astype(np.int32)
    return q, table, pos, neg, row_valid, neg_valid


def t(a):
    return torch.from_numpy(np.array(a))


def test_neg_pool_counts_match_jax():
    neg = np.asarray([0, 1, 1, 3, 3, 3, 5, 7, -2, 9], np.int32)
    valid = np.asarray([1, 1, 1, 1, 0, 1, 1, 1, 1, 1], bool)
    want = np.asarray(JFT.neg_pool_counts(jnp.asarray(neg), jnp.asarray(valid), 8))
    got = TFT.neg_pool_counts(t(neg), t(valid), 8)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [0, 2, 0, 2, 0, 1, 0, 1])


@pytest.mark.parametrize("mask_fn", [True, False], ids=["fnmask", "nofnmask"])
@pytest.mark.parametrize("scale", [1.0, 5.0])
def test_rowwise_and_gradients_match_jax_kernel(mask_fn, scale):
    q, table, pos, neg, _, neg_valid = make_case(int(scale) + mask_fn)
    r, n = q.shape[0], table.shape[0]
    counts = np.asarray(JFT.neg_pool_counts(jnp.asarray(neg), jnp.asarray(neg_valid), n))
    table_bf16 = jnp.asarray(table).astype(jnp.bfloat16)
    g = np.random.default_rng(0).normal(size=r).astype(np.float32)

    # the JAX kernel wants N a multiple of 128 (zero rows of count 0)
    np_ = 128
    t_pad = jnp.pad(table_bf16, ((0, np_ - n), (0, 0)))
    c_pad = jnp.pad(jnp.asarray(counts), (0, np_ - n)).reshape(1, -1)

    def rowwise(q_, t_):
        return JFT.table_infonce_rowwise(q_, t_, jnp.asarray(pos).reshape(1, -1), c_pad, scale,
                                         mask_fn, 16, True)

    ce_want, vjp = jax.vjp(rowwise, jnp.asarray(q), t_pad)
    dq_want, dt_want = vjp(jnp.asarray(g))
    _, lse_want = JFT._fwd_with_lse(jnp.asarray(q), t_pad, jnp.asarray(pos).reshape(1, -1),
                                    c_pad, scale, mask_fn, 16, True)

    tq = t(q).requires_grad_()
    tt = t(table_bf16.astype(jnp.float32)).bfloat16().requires_grad_()
    ce = TFT.table_infonce_rowwise(tq, tt, t(pos), t(counts), scale, mask_fn)
    ce_ref, lse = TFT.table_infonce_reference(tq.detach(), tt.detach(), t(pos), t(counts),
                                              scale=scale, mask_false_negatives=mask_fn)
    ce.backward(t(g))
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(ce_want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ce.detach().numpy(), ce_ref.numpy())
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), rtol=1e-5)
    assert tq.grad.dtype == torch.float32 and tt.grad.dtype == torch.bfloat16
    for got, want in ((tq.grad, dq_want), (tt.grad, dt_want[:n])):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= 2.0**-7, err


@pytest.mark.parametrize("mask_fn", [True, False], ids=["fnmask", "nofnmask"])
def test_summed_loss_matches_pool_oracle(mask_fn):
    q, table, pos, neg, row_valid, neg_valid = make_case(11, r=40, n=24, disjoint=True)
    # bf16-exact inputs: the oracle's f32 products then equal the kernel's
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    table = np.asarray(jnp.asarray(table).astype(jnp.bfloat16).astype(jnp.float32))
    cfg = LossConfig(mask_false_negatives=mask_fn, scale=2.0)
    want = JL.compute_losses(
        cfg, jnp.asarray(q), jnp.asarray(table[pos]), jnp.asarray(table[neg]),
        jnp.asarray(row_valid), jnp.asarray(neg_valid), loss_names=("InfoNCELoss",),
    )["InfoNCELoss"]
    got = TFT.fused_table_infonce_loss(t(q), t(table), t(pos), t(neg), t(row_valid),
                                       t(neg_valid), scale=2.0, mask_false_negatives=mask_fn)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_every_copy_of_the_positive_is_masked():
    """With the positive's item also in the pool, masking drops all its
    copies: the loss equals the loss of the pool without them."""
    q, table, pos, neg, row_valid, neg_valid = make_case(5, r=16, n=12)
    neg[:8] = pos[0] if pos[0] else 3
    pos[:] = neg[0]
    row_valid[:] = True
    counts = TFT.neg_pool_counts(t(neg), t(neg_valid), table.shape[0])
    ce = TFT.table_infonce_rowwise(t(q), t(table), t(pos), counts, 1.0, True)
    without = counts.clone()
    without[int(neg[0])] = 0.0
    ce_without = TFT.table_infonce_rowwise(t(q), t(table), t(pos), without, 1.0, True)
    torch.testing.assert_close(ce, ce_without, rtol=0, atol=0)


def test_workspace_sizes():
    """The wrappers' f32 workspaces: the forward's pos and per-split (max,
    sum); the backward's pos and per-split partial dq and dT, none where a
    pass takes one split."""
    assert TFT.workspace_elems(4096, 3707, 128, 4, 3, 1) == {
        "fwd_pos": 4096, "fwd_part": 4 * 4096 * 2, "bwd_pos": 4096,
        "dq_part": 3 * 4096 * 128, "dt_part": 0}
    assert TFT.workspace_elems(10, 7, 4, 1, 1, 2) == {
        "fwd_pos": 10, "fwd_part": 20, "bwd_pos": 10, "dq_part": 0, "dt_part": 2 * 7 * 4}


def test_plain_scores_do_not_depend_on_summation_order():
    """On values k/8 every partial sum of a score is exact in f32, so the
    plain version's increasing-k chain gives the scores of any other order
    (a matmul in f64, k in reverse, the kernels' steps of 16) bit for bit:
    the card checks' exact-sum inputs hold every row."""
    rng = np.random.default_rng(8)
    q = (rng.integers(-8, 9, size=(48, 128)) / 8).astype(np.float32)
    table = (rng.integers(-8, 9, size=(37, 128)) / 8).astype(np.float32)
    pos = rng.integers(0, 37, size=48).astype(np.int32)
    counts = torch.ones(37)
    x, p, _, _ = TFT._scores(t(q), t(table), t(pos), counts, 2.0, True)
    want = (torch.from_numpy(q).double() @ torch.from_numpy(table).double().T * 2.0).float()
    assert torch.equal(x, want)
    rev = torch.zeros_like(x)
    for k in reversed(range(128)):
        rev.addcmul_(t(q)[:, k:k + 1], t(table)[None, :, k])
    assert torch.equal(x, rev * 2.0)
    steps = sum(t(q)[:, k:k + 16] @ t(table)[:, k:k + 16].T for k in range(0, 128, 16))
    assert torch.equal(x, steps * 2.0)
    assert torch.equal(p, x[torch.arange(48), t(pos).long()])
