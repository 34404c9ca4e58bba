"""The port's pool InfoNCE (the plain versions its wrappers run on CPU
tensors) against the JAX package's ``fused_infonce_loss`` with its Pallas
kernels in interpret mode and their bf16 products, and its ``jax.grad``
in q, p and n.

Inputs are drawn with numpy and rounded to bf16-representable values, so
both packages' bf16 casts are exact and the two differ only in the order
of their f32 sums (the port sums every score in increasing k; the JAX
kernel sums the positive on the VPU and the pool on the MXU).

Tolerances:
- the loss and each row's ce: 1e-5 relative (scores ~1e-7 apart, then
  exp/log);
- dq, dp, dn: 2**-7 of each gradient's max abs value.  The logit gradient
  is rounded to bf16 before both products; where the two packages' f32
  values straddle a rounding boundary one entry moves by one bf16 ulp
  (2**-8 relative), and a sum of such entries by less.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.ops import fused_infonce as JFI
from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops import fused_infonce as TFI


def bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def make_case(seed, r=50, rn=37, d=32):
    """Ragged R and Rn (no multiple of any tile); row 0's positive is far
    below every pool score, so with the mask on it counts no negative."""
    rng = np.random.default_rng(seed)
    q = bf16_exact(rng.normal(size=(r, d)))
    p = bf16_exact(rng.normal(size=(r, d)))
    n = bf16_exact(0.5 * rng.normal(size=(rn, d)))
    p[0] = -4.0 * q[0]
    row_valid = rng.random(r) > 0.2
    row_valid[0] = True
    neg_valid = rng.random(rn) > 0.2
    return q, p, n, row_valid, neg_valid


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize(("mask_fn", "scale"), [(True, 1.0), (False, 1.0), (True, 3.0),
                                                (False, 0.5)])
def test_loss_and_gradients_match_jax_kernel(mask_fn, scale):
    q, p, n, row_valid, neg_valid = make_case(int(4 * scale) + mask_fn)

    def jax_loss(q_, p_, n_):
        return JFI.fused_infonce_loss(q_, p_, n_, jnp.asarray(row_valid), jnp.asarray(neg_valid),
                                      scale=scale, mask_false_negatives=mask_fn, interpret=True)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(n))

    tq, tp, tn = (t(a).requires_grad_() for a in (q, p, n))
    cuda_build.reset_launches()
    got = TFI.fused_infonce_loss(tq, tp, tn, t(row_valid), t(neg_valid), scale=scale,
                                 mask_false_negatives=mask_fn)
    got.backward()
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())  # CPU tensors: the plain versions
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for name, g, w in zip("qpn", (tq.grad, tp.grad, tn.grad), want_grads):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 2.0**-7, (name, err)


def make_exact_case(seed, r=50, rn=37, d=32):
    """Values k/8 with |k| <= 8: every partial sum of a score is exact in
    f32, so any order of summing gives the same scores (the JAX kernel's
    VPU and MXU sums, the plain version's increasing k, the card's tensor
    cores).  Every fifth pool row, valid, copies some row's positive."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 9, size=(r, d)) / 8
    p = rng.integers(-8, 9, size=(r, d)) / 8
    n = rng.integers(-8, 9, size=(rn, d)) / 8
    n[::5] = p[rng.integers(0, r, size=len(range(0, rn, 5)))]
    row_valid = rng.random(r) > 0.2
    neg_valid = rng.random(rn) > 0.2
    neg_valid[::5] = True
    return q.astype(np.float32), p.astype(np.float32), n.astype(np.float32), row_valid, neg_valid


@pytest.mark.parametrize(("mask_fn", "scale"), [(True, 1.0), (True, 2.5), (False, 1.0)])
def test_exact_sums_with_copies_of_positives_match_jax_kernel(mask_fn, scale):
    """Pool rows that copy a positive score exactly pos in both packages,
    so the mask drops them in both and the two agree with no disjoint
    pos/neg ranges: the premise of the card's exact-sum check."""
    q, p, n, row_valid, neg_valid = make_exact_case(11)
    x, pos = TFI._scores(t(q), t(p), t(n), scale)
    np.testing.assert_array_equal(x.numpy(), (q.astype(np.float64) @ n.T * scale).astype(np.float32))
    ties = (x == pos[:, None]) & t(neg_valid)[None, :]
    assert int(ties.sum()) >= len(range(0, n.shape[0], 5))  # each copy ties its positive's row

    def jax_loss(q_, p_, n_):
        return JFI.fused_infonce_loss(q_, p_, n_, jnp.asarray(row_valid), jnp.asarray(neg_valid),
                                      scale=scale, mask_false_negatives=mask_fn, interpret=True)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(n))
    tq, tp, tn = (t(a).requires_grad_() for a in (q, p, n))
    got = TFI.fused_infonce_loss(tq, tp, tn, t(row_valid), t(neg_valid), scale=scale,
                                 mask_false_negatives=mask_fn)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for name, g, w in zip("qpn", (tq.grad, tp.grad, tn.grad), want_grads):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 2.0**-7, (name, err)


@pytest.mark.parametrize("mask_fn", [True, False], ids=["fnmask", "nofnmask"])
def test_rowwise_ce_and_lse_match_jax(mask_fn):
    q, p, n, _, neg_valid = make_case(7)
    nv = jnp.asarray(neg_valid, jnp.float32)
    # the JAX kernel wants R and Rn multiples of its tiles: pad with zero
    # rows of no validity, as fused_infonce_loss does
    qp, pp = (jnp.pad(jnp.asarray(a), ((0, 14), (0, 0))) for a in (q, p))
    npad = jnp.pad(jnp.asarray(n), ((0, 128 - n.shape[0]), (0, 0)))
    nvp = jnp.pad(nv, (0, 128 - n.shape[0])).reshape(1, -1)
    ce_want, lse_want = JFI._fwd_with_lse(qp, pp, npad, nvp, 2.0, mask_fn, 16, 128, True)
    ce, lse, pos = TFI.fused_infonce_reference(t(q), t(p), t(n), t(neg_valid), scale=2.0,
                                               mask_false_negatives=mask_fn)
    r = q.shape[0]
    np.testing.assert_allclose(ce.numpy(), np.asarray(ce_want)[:r], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want)[:r], rtol=1e-5)
    np.testing.assert_allclose(pos.numpy(), 2.0 * (q * p).sum(axis=1), rtol=1e-6)
    if mask_fn:  # row 0 counts no negative: its ce is 0 exactly, in both
        assert ce[0].item() == 0.0 == float(ce_want[0])
    rowwise = TFI.fused_infonce_rowwise(t(q), t(p), t(n), t(neg_valid), 2.0, mask_fn)
    assert torch.equal(rowwise, ce)


def test_every_copy_of_the_positive_is_masked():
    """Pool rows that are copies of a row's positive score exactly its
    ``pos`` and the mask drops them: the loss equals the loss of the pool
    with those rows marked invalid."""
    q, p, n, row_valid, neg_valid = make_case(3, r=8, rn=20)
    p[:] = p[1]
    n[[2, 5, 11]] = p[1]
    neg_valid[[2, 5, 11]] = True
    without = neg_valid.copy()
    without[[2, 5, 11]] = False
    got = TFI.fused_infonce_rowwise(t(q), t(p), t(n), t(neg_valid), 1.0, True)
    want = TFI.fused_infonce_rowwise(t(q), t(p), t(n), t(without), 1.0, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_skips_gradients_nobody_needs():
    """Pool rows of a frozen table take no gradient: only dq and dp run."""
    q, p, n, row_valid, neg_valid = make_case(5)
    tq = t(q).requires_grad_()
    tp, tn = t(p).bfloat16(), t(n).bfloat16()
    TFI.fused_infonce_loss(tq, tp, tn, t(row_valid), t(neg_valid)).backward()
    assert tq.grad is not None and tq.grad.dtype == torch.float32
    # dp and dn come back in the dtypes of p and n (bf16 under bf16 compute)
    tp.requires_grad_()
    tn.requires_grad_()
    TFI.fused_infonce_loss(tq, tp, tn, t(row_valid), t(neg_valid)).backward()
    assert tp.grad.dtype == torch.bfloat16 and tn.grad.dtype == torch.bfloat16


def test_wrapper_rejects_mismatched_shapes():
    q = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="do not agree"):
        TFI._check_cuda(q, torch.zeros(4, 8), torch.zeros(5, 7), torch.ones(5))
    with pytest.raises(ValueError, match="D <= 512"):
        TFI._check_cuda(torch.zeros(2, 600), torch.zeros(2, 600), torch.zeros(3, 600),
                        torch.ones(3))


def test_workspace_sizes():
    """The wrappers' f32 workspaces: the forward's per-split (max, sum),
    and the partial dq and dn of each split, none where a pass takes one
    split."""
    assert TFI.workspace_elems(4096, 4096, 128, 4, 3, 7) == {
        "fwd_part": 4 * 4096 * 2, "dq_part": 3 * 4096 * 128, "dn_part": 7 * 4096 * 128}
    assert TFI.workspace_elems(10, 7, 4, 1, 1, 1) == {"fwd_part": 20, "dq_part": 0, "dn_part": 0}
    assert TFI.workspace_elems(1000, 777, 384, 2, 1, 3) == {
        "fwd_part": 2 * 1000 * 2, "dq_part": 0, "dn_part": 3 * 777 * 384}
