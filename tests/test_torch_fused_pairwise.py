"""The port's pairwise pool heads (the plain versions its wrappers run on
CPU tensors) against the JAX package's ``fused_pairwise_loss`` with its
Pallas kernels in interpret mode and their bf16 products, and its
``jax.grad`` in q, p and n.

Inputs are drawn with numpy and rounded to bf16-representable values, so
both packages' bf16 casts are exact and the two differ only in the order
of their f32 sums (the port sums every score in increasing k; the JAX
kernel sums the positive on the VPU and the pool on the MXU).  No pool row
copies a positive, so the false-negative mask sees no ties the two orders
could decide differently.

Tolerances:
- the loss and each row's value: 1e-5 relative (scores ~1e-7 apart, then
  softplus or relu and a weighted mean);
- dq, dp, dn: 2**-7 of each gradient's max abs value.  The score gradient
  is rounded to bf16 before both products; where the two packages' f32
  values straddle a rounding boundary one entry moves by one bf16 ulp
  (2**-8 relative), and a sum of such entries by less.  A gradient that is
  zero in JAX (dp of the heads without the positive in their score, every
  gradient of the hinge at margin 0 with the mask on) is zero in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.ops import fused_pairwise as JFP
from transformer_recommenders_tpu_torch.configs import LossConfig
from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops import fused_pairwise as TFP
from transformer_recommenders_tpu_torch.ops import losses as TL


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


def assert_grad_close(name, got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape, name
    scale = np.abs(want).max()
    if scale == 0.0:
        assert not got.abs().max().item(), name
        return
    err = np.abs(got.numpy() - want).max() / scale
    assert err <= 2.0**-7, (name, err)


@pytest.mark.parametrize("head", TFP.HEADS)
@pytest.mark.parametrize("margin", [0.0, 0.3], ids=["m0", "m03"])
@pytest.mark.parametrize("mask_fn", [True, False], ids=["fnmask", "nofnmask"])
def test_loss_and_gradients_match_jax_kernel(head, margin, mask_fn):
    q, p, n, row_valid, neg_valid = make_case(TFP.HEADS.index(head) + 7 * mask_fn)

    def jax_loss(q_, p_, n_):
        return JFP.fused_pairwise_loss(q_, p_, n_, jnp.asarray(row_valid), jnp.asarray(neg_valid),
                                       head=head, margin=margin, mask_false_negatives=mask_fn,
                                       tile_rows=16, tile_cols=128, interpret=True)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(n))

    tq, tp, tn = (t(a).requires_grad_() for a in (q, p, n))
    cuda_build.reset_launches()
    got = TFP.fused_pairwise_loss(tq, tp, tn, t(row_valid), t(neg_valid), head=head,
                                  margin=margin, mask_false_negatives=mask_fn)
    got.backward()
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())  # CPU tensors: the plain versions
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for name, g, w in zip("qpn", (tq.grad, tp.grad, tn.grad), want_grads):
        assert_grad_close(name, g, w)
    if head == "PairwiseHingeLoss" and margin == 0.0 and mask_fn:
        # every counted score is below its positive: s = l - pos < 0
        assert got.item() == 0.0
    else:
        assert got.item() > 0.0 and tq.grad.abs().max() > 0


@pytest.mark.parametrize("head", TFP.HEADS)
def test_rowwise_out_and_den_match_jax(head):
    """Per-row values and counts against the JAX forward kernel, the mask
    on: row 0 counts no negative, so its den and out are 0 exactly in
    both."""
    q, p, n, _, neg_valid = make_case(11)
    nv = jnp.asarray(neg_valid, jnp.float32)
    # the JAX kernel wants R and Rn multiples of its tiles: pad with zero
    # rows of no validity, as fused_pairwise_loss does
    qp, pp = (jnp.pad(jnp.asarray(a), ((0, 14), (0, 0))) for a in (q, p))
    npad = jnp.pad(jnp.asarray(n), ((0, 128 - n.shape[0]), (0, 0)))
    nvp = jnp.pad(nv, (0, 128 - n.shape[0])).reshape(1, -1)
    out_want, den_want = JFP._fwd(qp, pp, npad, nvp, head, 0.3, True, 16, 128, True)
    out, den, pos = TFP.fused_pairwise_reference(t(q), t(p), t(n), t(neg_valid), head=head,
                                                 margin=0.3)
    r = q.shape[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(out_want)[:r], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(den.numpy(), np.asarray(den_want)[:r])
    np.testing.assert_allclose(pos.numpy(), (q * p).sum(axis=1), rtol=1e-6)
    assert den[0].item() == 0.0 == float(den_want[0])
    assert out[0].item() == 0.0 == float(out_want[0])
    rowwise = TFP.fused_pairwise_rowwise(t(q), t(p), t(n), t(neg_valid), head=head, margin=0.3)
    assert torch.equal(rowwise, out)


@pytest.mark.parametrize("head", ["ContrastiveLoss", "PairwiseHingeLoss",
                                  "PairwiseLogisticLoss"])
def test_plain_version_is_the_loss_head(head):
    """Without bf16 rounding in the way (f32 inputs that are bf16 values)
    the pool reduction is the loss library's head over the same scores:
    f32, 1e-5 relative."""
    q, p, n, row_valid, neg_valid = make_case(5)
    args = [t(q), t(p), t(n)]
    margin = 0.3
    if head == "ContrastiveLoss":  # cosine: normalized rows, as the kernel takes them
        args = [TL._l2_normalize(a).to(torch.bfloat16).float() for a in args]
        margin = 1.2  # cosines of random rows are small: count those above -0.2
    cfg = LossConfig(margin=margin)
    pos, neg = TL.compute_pair_logits(*args, similarity="dot")
    want = TL.LOSS_FNS[head][0](cfg, pos, neg, TL.negative_mask(cfg, pos, neg, t(neg_valid)),
                                t(row_valid).float())
    got = TFP.fused_pairwise_loss(*args, t(row_valid), t(neg_valid), head=head, margin=margin)
    assert want.item() > 0.0
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)


def test_every_copy_of_the_positive_is_masked():
    """Pool rows that are copies of a row's positive score exactly its
    ``pos`` and the mask drops them: the loss equals the loss of the pool
    with those rows marked invalid."""
    q, p, n, _, neg_valid = make_case(3, r=8, rn=20)
    p[:] = p[1]
    n[[2, 5, 11]] = p[1]
    neg_valid[[2, 5, 11]] = True
    without = neg_valid.copy()
    without[[2, 5, 11]] = False
    for head in TFP.HEADS:
        got = TFP.fused_pairwise_rowwise(t(q), t(p), t(n), t(neg_valid), head=head, margin=0.0)
        want = TFP.fused_pairwise_rowwise(t(q), t(p), t(n), t(without), head=head, margin=0.0)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_skips_gradients_nobody_needs(monkeypatch):
    """Pool rows of a frozen table take no gradient: only dq and dp run."""
    q, p, n, row_valid, neg_valid = make_case(5)
    tq = t(q).requires_grad_()
    tp, tn = t(p).bfloat16(), t(n).bfloat16()

    def no_dn(*args, **kwargs):
        raise AssertionError("the dn pass ran for a pool that takes no gradient")

    with monkeypatch.context() as m:
        m.setattr(TFP, "fused_pairwise_dn_reference", no_dn)
        TFP.fused_pairwise_loss(tq, tp, tn, t(row_valid), t(neg_valid),
                                head="PairwiseLogisticLoss").backward()
    assert tq.grad is not None and tq.grad.dtype == torch.float32 and tn.grad is None
    # dp and dn come back in the dtypes of p and n (bf16 under bf16 compute)
    tp.requires_grad_()
    tn.requires_grad_()
    TFP.fused_pairwise_loss(tq, tp, tn, t(row_valid), t(neg_valid),
                            head="PairwiseLogisticLoss").backward()
    assert tp.grad.dtype == torch.bfloat16 and tn.grad.dtype == torch.bfloat16


def test_wrapper_rejects_heads_and_shapes_it_does_not_take():
    q = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="unsupported head"):
        TFP.fused_pairwise_rowwise(q, q, q, torch.ones(4), head="InfoNCELoss")
    with pytest.raises(ValueError, match="fused_pairwise: .* do not agree"):
        TFP._check_cuda(q, torch.zeros(4, 8), torch.zeros(5, 7), torch.ones(5), "fused_pairwise")


def near_tie_case():
    """Rows built for near_tie_rows (D=16, bf16 values): row 1 scores 0.5
    against pool row 7 (ContrastiveLoss's s = 0 at margin 0.5); pool row 3
    copies row 2's positive; pool row 5 scores row 4's pos + 2**-14 (a near
    tie of the mask, and of the hinge's s at margin 0); invalid pool row 9
    does the same for row 5."""
    gen = torch.Generator().manual_seed(21)
    q, p, n = (torch.randn(*shape, generator=gen).bfloat16().float()
               for shape in ((6, 16), (6, 16), (10, 16)))
    q[1] = 0.0
    q[1, 0] = 1.0
    n[7] = 0.0
    n[7, 0] = 0.5
    n[3] = p[2]
    for row, j in ((4, 5), (5, 9)):
        q[row, 0], p[row, 0] = 2.0**-14, 1.0
        n[j] = p[row]
        n[j, 0] = 2.0
    neg_valid = torch.ones(10, dtype=torch.bool)
    neg_valid[9] = False
    return q, p, n, neg_valid


@pytest.mark.parametrize(("head", "margin", "mask_fn", "want"), [
    ("PairwiseLogisticLoss", 0.0, True, [4]),
    ("PairwiseLogisticLoss", 0.0, False, []),
    ("NCELoss", 0.5, True, [4]),
    ("PairwiseHingeLoss", 0.0, True, [4]),
    ("PairwiseHingeLoss", 0.0, False, [4]),  # row 2's copy: s = 0 exactly in both
    ("PairwiseHingeLoss", 0.5, False, []),
    ("ContrastiveLoss", 0.5, False, [1]),
    ("ContrastiveLoss", 0.5, True, [1, 4]),
    ("ContrastiveLoss", 0.0, False, []),
])
def test_near_tie_rows_flags_what_two_sum_orders_may_decide_otherwise(head, margin, mask_fn,
                                                                     want):
    """The rows the card checks leave out of ``out`` on Gaussian inputs: a
    valid pool score within delta of pos that is no copy of the positive
    (mask on), or a relu head's s within its delta of 0."""
    q, p, n, neg_valid = near_tie_case()
    rows = TFP.near_tie_rows(q, p, n, neg_valid, head=head, margin=margin,
                             mask_false_negatives=mask_fn)
    assert rows.nonzero().flatten().tolist() == want


def test_workspace_sizes():
    """The wrappers' f32 workspaces: the forward's per-split (sum of f v,
    sum of v); the per-row sums of w f' of each dq split, and its partial
    dq where the dq pass takes more than one split; the partial dn of each
    dn split, none where it takes one."""
    assert TFP.workspace_elems(4096, 4096, 64, 4, 3, 5) == {
        "fwd_part": 4 * 4096 * 2, "dq_part": 3 * 4096 * 65, "dn_part": 5 * 4096 * 64}
    assert TFP.workspace_elems(10, 7, 4, 1, 1, 1) == {"fwd_part": 20, "dq_part": 10, "dn_part": 0}
    assert TFP.workspace_elems(0, 7, 4, 1, 1, 1) == {"fwd_part": 0, "dq_part": 0, "dn_part": 0}
    assert TFP.workspace_elems(1000, 777, 64, 2, 2, 1) == {
        "fwd_part": 2 * 1000 * 2, "dq_part": 2 * 1000 * 65, "dn_part": 0}
