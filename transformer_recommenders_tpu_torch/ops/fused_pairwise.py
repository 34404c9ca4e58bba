"""Pairwise loss heads over the in-batch pool: each query row's weighted
mean of a pairwise score over the pool rows it counts as negatives.  The
plain PyTorch versions and the wrappers around the CUDA kernels of
``csrc/fused_pairwise.cu``.

Counterpart of ``transformer_recommenders_tpu/ops/fused_pairwise.py``
(``fused_pairwise_rowwise`` with its Pallas ``_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dn_kernel``, and ``fused_pairwise_loss``).
For a query row with positive score ``pos`` and pool scores ``l``:

- ``ContrastiveLoss``:       f = relu(l - 1 + margin)  (cosine: pass
  L2-normalized rows)
- ``PairwiseHingeLoss``:     f = relu(l - pos * (1 - margin))
- ``PairwiseLogisticLoss``:  f = softplus(l - pos * (1 - margin))  (BPR at
  margin 0)
- ``NCELoss``:               f = softplus(l), the pool term only (the
  positive's term is added by the caller)

each reduced per row as ``sum(f * v) / (sum(v) + 1e-9)``, where a pool row
counts (``v``) when ``neg_valid > 0`` and, with the false-negative mask,
when its score is below the positive's.  The same function as the heads of
``ops.losses`` with their weighted mean.

Numerics follow the JAX kernels: ``q``, ``p`` and ``n`` rounded to bf16
with f32 sums; ``1 - margin`` taken in Python and rounded to f32 (JAX's
weak-typed constant); the score gradient ``dl`` rounded to bf16 before
both products, the positive's ``dpos`` kept in f32; ``dq``, ``dp`` and
``dn`` cast to the dtypes of ``q``, ``p`` and ``n``.

Each version scores the positive and every pool row by one chain, so a
copy of the positive in the pool scores exactly ``pos`` and the mask
drops it.  The kernels' chain is the tensor cores' (``xrt::score_tile``,
the pool InfoNCE kernels' chain: k-steps of 16 in increasing order); the
plain version's is one exact bf16 product at a time in increasing k.  The
two agree to rounding, not bit for bit: a pool score within a rounding
step of ``pos`` may count in one and not in the other, and a relu head's
score within a rounding step of 0 may take f' = 1 in one and 0 in the
other (:func:`near_tie_rows` finds such rows).  Where every partial sum
is exact in f32 they agree bit for bit.  The JAX kernel sums the positive
on the VPU and the pool on the MXU, so a copy may escape its mask there.
The TPU version pads R and Rn to its tiles; the kernels here mask their
own edges.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops.fused_infonce import (
    _bf16,
    _check_cuda,
    _counted,
    _f32,
    _scores,
)
from transformer_recommenders_tpu_torch.ops.losses import _softplus

# the heads whose pool reduction the kernels implement, in the order of
# the kernels' head argument; NCELoss's positive term and the alignment
# term of AlignmentContrastiveLoss are composed by the caller
# (training.train_state._fused_objective)
HEADS = (
    "ContrastiveLoss",
    "PairwiseHingeLoss",
    "PairwiseLogisticLoss",
    "NCELoss",
)
_SMOOTH = ("PairwiseLogisticLoss", "NCELoss")  # softplus; the others relu
_WITH_POS = ("PairwiseHingeLoss", "PairwiseLogisticLoss")  # pos enters the score


def _pair_scores(head: str, x: torch.Tensor, pos: torch.Tensor, margin: float) -> torch.Tensor:
    """(R, Rn) s of the head from the scores ``x`` and the positives'."""
    if head == "ContrastiveLoss":
        return (x - 1.0) + margin
    if head == "NCELoss":
        return x
    return x - (pos * (1.0 - margin))[:, None]


def _terms(q, p, n, neg_valid, head: str, margin: float, mask_false_negatives: bool):
    """s (R, Rn), the counted mask v and the positives' scores (R,)."""
    x, pos = _scores(q, p, n, 1.0)
    v = _counted(x, pos, neg_valid, mask_false_negatives)
    return _pair_scores(head, x, pos, margin), v, pos


def fused_pairwise_reference(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, neg_valid: torch.Tensor, *, head: str,
    margin: float = 0.5, mask_false_negatives: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: per-row ``(out, den,
    pos)``, (R,) f32 each.  A row without a counted negative gets
    ``out = 0`` exactly."""
    s, v, pos = _terms(q, p, n, neg_valid, head, margin, mask_false_negatives)
    f = _softplus(s) if head in _SMOOTH else F.relu(s)
    vf = v.float()
    den = vf.sum(dim=1)
    return (f * vf).sum(dim=1) / (den + 1e-9), den, pos


def _weighted_slope(q, p, n, neg_valid, den, g, head, margin, mask_false_negatives):
    """w f' (R, Rn) unrounded (``w = v g / (den + 1e-9)``) and the bf16
    operands as f32."""
    s, v, _ = _terms(q, p, n, neg_valid, head, margin, mask_false_negatives)
    slope = torch.sigmoid(s) if head in _SMOOTH else (s > 0).float()
    w = torch.where(v, (g.float() / (den + 1e-9))[:, None], 0.0)
    return w * slope, tuple(t.to(torch.bfloat16).float() for t in (q, p, n))


def fused_pairwise_dq_reference(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, neg_valid: torch.Tensor,
    den: torch.Tensor, g: torch.Tensor, *, head: str, margin: float = 0.5,
    mask_false_negatives: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dq/dp kernel: ``(dq, dp)`` for the
    cotangent ``g`` of ``out``, in ``q.dtype`` and ``p.dtype``."""
    wf, (qm, pm, nm) = _weighted_slope(q, p, n, neg_valid, den, g, head, margin,
                                       mask_false_negatives)
    dl = wf.to(torch.bfloat16).float()
    if head in _WITH_POS:
        dpos = wf.sum(dim=1) * -(1.0 - margin)
    else:
        dpos = torch.zeros_like(den)
    dq = dl @ nm + dpos[:, None] * pm
    dp = dpos[:, None] * qm
    return dq.to(q.dtype), dp.to(p.dtype)


def fused_pairwise_dn_reference(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, neg_valid: torch.Tensor,
    den: torch.Tensor, g: torch.Tensor, *, head: str, margin: float = 0.5,
    mask_false_negatives: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the dn kernel: ``dn`` for the cotangent
    ``g`` of ``out``, in ``n.dtype``."""
    wf, (qm, _, _) = _weighted_slope(q, p, n, neg_valid, den, g, head, margin,
                                     mask_false_negatives)
    return (wf.to(torch.bfloat16).float().T @ qm).to(n.dtype)


def near_tie_rows(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, neg_valid: torch.Tensor, *, head: str,
    margin: float = 0.5, mask_false_negatives: bool = True,
) -> torch.Tensor:
    """(R,) bool: the rows where the kernels and the plain version may
    decide a valid pool row differently, from the plain scores.  The two
    sum a score in other orders (the tensor cores' k-steps of 16, or one
    product at a time), so its two values differ by a few ulps of its
    partial sums (|l| < 2**5 at D <= 512: ulp <= 2**-18, D/16 and D
    roundings).  delta = 2**-13 per 128 of D bounds that with room.  A row
    is a near tie where a valid pool row that is not a copy of the row's
    positive has, with the mask on, |l - pos| <= delta (the mask l < pos
    may decide otherwise), or, for the relu heads, |s| <= delta_s (f'
    steps from 0 to 1 at s = 0): delta for ContrastiveLoss, whose s is l
    shifted, and delta (1 + |c|) for the hinge, whose s = l - pos c carries
    pos's error times c.  A copy of the positive scores exactly pos in
    each version; under the hinge with c = 1 its s is exactly 0 in both."""
    x, pos = _scores(q, p, n, 1.0)
    delta = 2.0**-13 * math.ceil(q.shape[1] / 128)
    c = 1.0 - margin
    valid = neg_valid.reshape(1, -1) > 0
    none = torch.zeros_like(x, dtype=torch.bool)
    by_mask = (x - pos[:, None]).abs() <= delta if mask_false_negatives else none
    by_slope = none
    if head in ("ContrastiveLoss", "PairwiseHingeLoss"):
        delta_s = delta * (1.0 + abs(c)) if head == "PairwiseHingeLoss" else delta
        by_slope = _pair_scores(head, x, pos, margin).abs() <= delta_s
    copies_alike = head == "PairwiseHingeLoss" and c == 1.0
    # the ties a copy of the positive cannot make: drop the copies there
    near = (by_mask | (by_slope if copies_alike else none)) & valid
    r, j = near.nonzero(as_tuple=True)
    copy = (p.to(torch.bfloat16)[r] == n.to(torch.bfloat16)[j]).all(dim=1)
    near[r[copy], j[copy]] = False
    if not copies_alike:
        near = near | (by_slope & valid)
    return near.any(dim=1)


def _head_args(head: str, margin: float) -> tuple[int, float, float]:
    """The kernels' head index, margin and ``c = 1 - margin`` (taken in
    Python's double, rounded to f32 by ctypes)."""
    return HEADS.index(head), float(margin), 1.0 - float(margin)


def _splits(device_index: int, r: int, rn: int, d: int, kernel_pass: int) -> int:
    """The splits of the forward (pass 0, over the pool), the dn kernel (1,
    over the query rows) or the dq kernel (2, over the pool)."""
    return cuda_build.splits("fused_pairwise", "pairwise_splits", device_index, r, rn, d,
                             kernel_pass)


def workspace_elems(r: int, rn: int, d: int, splits_fwd: int, splits_dq: int,
                    splits_dn: int) -> dict[str, int]:
    """f32 elements of the kernels' workspaces: the forward's per-split
    (sum of f v, sum of v); each dq split's per-row sums of w f' and, with
    more than one split, its partial dq (one split writes dq itself); the
    partial dn of each dn split (none with one split: the kernel writes dn
    itself)."""
    return {
        "fwd_part": splits_fwd * r * 2,
        "dq_part": splits_dq * r * (d + 1) if splits_dq > 1 else r,
        "dn_part": splits_dn * rn * d if splits_dn > 1 else 0,
    }


def _fwd_cuda(q, p, n, neg_valid, head, margin, mask_false_negatives):
    _check_cuda(q, p, n, neg_valid, "fused_pairwise")
    qb, pb, nb, nv = _bf16(q), _bf16(p), _bf16(n), _f32(neg_valid)
    r, d = qb.shape
    rn = nb.shape[0]
    out, den, pos = (torch.empty(r, dtype=torch.float32, device=q.device) for _ in range(3))
    splits = _splits(q.device.index or 0, r, rn, d, 0)
    part = cuda_build.workspace(workspace_elems(r, rn, d, splits, 1, 1)["fwd_part"], q.device)
    status = cuda_build.library("fused_pairwise").pairwise_fwd(
        qb.data_ptr(), pb.data_ptr(), nb.data_ptr(), nv.data_ptr(), out.data_ptr(),
        den.data_ptr(), pos.data_ptr(), cuda_build.pointer(part), r, rn, d,
        *_head_args(head, margin), int(mask_false_negatives), splits,
        cuda_build.stream_handle(q.device),
    )
    cuda_build.check(status, "pairwise_fwd launch")
    cuda_build.LAUNCHES["pairwise_fwd"] += 1
    return out, den, pos


def _dq_cuda(q, p, n, neg_valid, den, g, pos, head, margin, mask_false_negatives):
    _check_cuda(q, p, n, neg_valid, "fused_pairwise")
    qb, pb, nb, nv = _bf16(q), _bf16(p), _bf16(n), _f32(neg_valid)
    r, d = qb.shape
    rn = nb.shape[0]
    dq = torch.empty((r, d), dtype=torch.float32, device=q.device)
    dp = torch.empty_like(dq)
    splits = _splits(q.device.index or 0, r, rn, d, 2)
    part = cuda_build.workspace(workspace_elems(r, rn, d, 1, splits, 1)["dq_part"], q.device)
    status = cuda_build.library("fused_pairwise").pairwise_dq(
        qb.data_ptr(), pb.data_ptr(), nb.data_ptr(), nv.data_ptr(), _f32(den).data_ptr(),
        _f32(g).data_ptr(), _f32(pos).data_ptr(), dq.data_ptr(), dp.data_ptr(),
        cuda_build.pointer(part), r, rn, d, *_head_args(head, margin), int(mask_false_negatives),
        splits,
        cuda_build.stream_handle(q.device),
    )
    cuda_build.check(status, "pairwise_dq launch")
    cuda_build.LAUNCHES["pairwise_dq"] += 1
    return dq.to(q.dtype), dp.to(p.dtype)


def _dn_cuda(q, p, n, neg_valid, den, g, pos, head, margin, mask_false_negatives):
    _check_cuda(q, p, n, neg_valid, "fused_pairwise")
    qb, nb, nv = _bf16(q), _bf16(n), _f32(neg_valid)
    r, d = qb.shape
    rn = nb.shape[0]
    dn = torch.empty((rn, d), dtype=torch.float32, device=q.device)
    splits = _splits(q.device.index or 0, r, rn, d, 1)
    part = cuda_build.workspace(workspace_elems(r, rn, d, 1, 1, splits)["dn_part"], q.device)
    status = cuda_build.library("fused_pairwise").pairwise_dn(
        qb.data_ptr(), nb.data_ptr(), nv.data_ptr(), _f32(den).data_ptr(), _f32(g).data_ptr(),
        _f32(pos).data_ptr(), dn.data_ptr(), cuda_build.pointer(part), r, rn, d,
        *_head_args(head, margin), int(mask_false_negatives), splits,
        cuda_build.stream_handle(q.device),
    )
    cuda_build.check(status, "pairwise_dn launch")
    cuda_build.LAUNCHES["pairwise_dn"] += 1
    return dn.to(n.dtype)


class _PairwiseLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, p, n, neg_valid, head, margin, mask_false_negatives):
        if q.device.type == "cpu":
            out, den, pos = fused_pairwise_reference(
                q, p, n, neg_valid, head=head, margin=margin,
                mask_false_negatives=mask_false_negatives)
        else:
            out, den, pos = _fwd_cuda(q, p, n, neg_valid, head, margin, mask_false_negatives)
        ctx.save_for_backward(q, p, n, neg_valid, den, pos)
        ctx.args = (head, margin, mask_false_negatives)
        return out

    @staticmethod
    def backward(ctx, g):
        q, p, n, neg_valid, den, pos = ctx.saved_tensors
        head, margin, mask_fn = ctx.args
        kw = dict(head=head, margin=margin, mask_false_negatives=mask_fn)
        dq = dp = dn = None
        cpu = q.device.type == "cpu"
        # each pass runs only for gradients that are needed: pool rows of a
        # frozen table take none, and the dn kernel is then not launched
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            if cpu:
                dq, dp = fused_pairwise_dq_reference(q, p, n, neg_valid, den, g, **kw)
            else:
                dq, dp = _dq_cuda(q, p, n, neg_valid, den, g, pos, head, margin, mask_fn)
        if ctx.needs_input_grad[2]:
            if cpu:
                dn = fused_pairwise_dn_reference(q, p, n, neg_valid, den, g, **kw)
            else:
                dn = _dn_cuda(q, p, n, neg_valid, den, g, pos, head, margin, mask_fn)
        return dq, dp, dn, None, None, None, None


def fused_pairwise_rowwise(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, neg_valid: torch.Tensor, *, head: str,
    margin: float = 0.5, mask_false_negatives: bool = True,
) -> torch.Tensor:
    """(R,) f32 per-row weighted mean of ``head``'s pairwise score of ``q``
    (R, D) and its positive ``p`` (R, D) against the shared pool ``n``
    (Rn, D) with validity ``neg_valid`` (Rn,); the count of counted pool
    rows and the positives' scores are kept for the backward.
    Differentiable in ``q``, ``p`` and ``n``.  CPU tensors run the plain
    versions; CUDA tensors launch the kernels or raise."""
    if head not in HEADS:
        msg = f"unsupported head: {head}"
        raise ValueError(msg)
    return _PairwiseLoss.apply(q, p, n, neg_valid.reshape(-1), head, float(margin),
                               bool(mask_false_negatives))


def fused_pairwise_loss(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, row_valid: torch.Tensor,
    neg_valid: torch.Tensor, *, head: str, margin: float = 0.5,
    mask_false_negatives: bool = True,
) -> torch.Tensor:
    """Scalar sum over valid rows: the ContrastiveLoss, hinge and logistic
    heads of ``ops.losses`` (and NCELoss's pool term) without the (R, Rn)
    score matrix.  ``ContrastiveLoss`` is a cosine head: pass L2-normalized
    rows."""
    rows = fused_pairwise_rowwise(q, p, n, neg_valid, head=head, margin=margin,
                                  mask_false_negatives=mask_false_negatives)
    return (rows * row_valid.reshape(-1).float()).sum()
