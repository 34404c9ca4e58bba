"""In-batch (pool) InfoNCE: every query row scored against its positive
and a shared pool of gathered negative rows.  The plain PyTorch versions
and the wrappers around the CUDA kernels of ``csrc/fused_infonce.cu``.

Counterpart of ``transformer_recommenders_tpu/ops/fused_infonce.py``
(``fused_infonce_rowwise`` with its Pallas ``_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dn_kernel``, and ``fused_infonce_loss``).
The same function as ``ops.losses.infonce_loss`` with ``similarity="dot"``:
the per-row cross-entropy over ``[positive, counted pool rows]``, where a
pool row counts when ``neg_valid > 0`` and, with the false-negative mask,
when its score is below the positive's.

Numerics follow the JAX kernels: ``q``, ``p`` and ``n`` rounded to bf16
with f32 sums, times ``scale``; uncounted scores guarded by ``_NEG_BIG``
before ``exp``; the logit gradient ``dl`` rounded to bf16 before both
products, the positive's ``dpos`` kept in f32; ``dq``, ``dp`` and ``dn``
cast to the dtypes of ``q``, ``p`` and ``n``.

Each version scores the positive and every pool row by one chain, so a
copy of the positive in the pool scores exactly ``pos`` and the mask
drops it.  The kernels' chain is the tensor cores' (``xrt::score_tile``:
k-steps of 16 in increasing order); the plain version's is one exact
bf16 product at a time in increasing k.  The two sum in other orders, so
their scores agree to rounding, not bit for bit: a pool score within a
rounding step of ``pos`` may count in one and not in the other.  Where
every partial sum is exact in f32 (small multiples of a power of two)
they agree bit for bit.  The JAX kernel sums the positive on the VPU and
the pool on the MXU, so a copy may escape its mask there.  The TPU
version pads R and Rn to its tiles; the kernels here mask their own
edges.
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.ops import cuda_build

_NEG_BIG = -1e30
_MAX_D = 512  # kMaxD of csrc/fused_infonce.cu and csrc/fused_pairwise.cu


def _scores(q, p, n, scale: float):
    """x (R, Rn) and pos (R,): each one chain, one exact bf16 product at a
    time in increasing k, then times ``scale``."""
    qm, pm, nm = (t.to(torch.bfloat16).float() for t in (q, p, n))
    x = torch.zeros((qm.shape[0], nm.shape[0]), dtype=torch.float32, device=q.device)
    pos = torch.zeros(qm.shape[0], dtype=torch.float32, device=q.device)
    for k in range(qm.shape[1]):
        x.addcmul_(qm[:, k:k + 1], nm[None, :, k])
        pos.addcmul_(qm[:, k], pm[:, k])
    return x * scale, pos * scale


def _counted(x, pos, neg_valid, mask_false_negatives: bool):
    """(R, Rn) bool: the pool scores that count as negatives."""
    v = (neg_valid.reshape(1, -1).float() > 0).expand_as(x)
    if mask_false_negatives:
        v = v & (x < pos[:, None])
    return v


def fused_infonce_reference(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, neg_valid: torch.Tensor, *,
    scale: float = 1.0, mask_false_negatives: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: per-row ``(ce, lse,
    pos)``, (R,) f32 each.  A row without a counted negative gets
    ``ce = 0`` exactly."""
    x, pos = _scores(q, p, n, scale)
    v = _counted(x, pos, neg_valid, mask_false_negatives)
    xm = torch.where(v, x, _NEG_BIG)
    m = torch.maximum(pos, xm.amax(dim=1)) if x.shape[1] else pos
    a = torch.exp(pos - m) + torch.where(v, torch.exp(xm - m[:, None]), 0.0).sum(dim=1)
    lse = m + torch.log(a)
    return lse - pos, lse, pos


def _grad_logits(q, p, n, neg_valid, lse, g, scale: float, mask_false_negatives: bool):
    """The bf16-rounded logit gradient dl (R, Rn) as f32, the positive's
    f32 ``dpos`` (R,) and the bf16 operands."""
    x, pos = _scores(q, p, n, scale)
    v = _counted(x, pos, neg_valid, mask_false_negatives)
    gs = g.float() * scale
    qprob = torch.where(v, torch.exp(x - lse[:, None]), 0.0)
    dl = (qprob * gs[:, None]).to(torch.bfloat16).float()
    dpos = gs * (torch.exp(pos - lse) - 1.0)
    return dl, dpos, tuple(t.to(torch.bfloat16).float() for t in (q, p, n))


def fused_infonce_dq_reference(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, neg_valid: torch.Tensor,
    lse: torch.Tensor, g: torch.Tensor, *, scale: float = 1.0, mask_false_negatives: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dq/dp kernel: ``(dq, dp)`` for the
    cotangent ``g`` of ``ce``, in ``q.dtype`` and ``p.dtype``."""
    dl, dpos, (qm, pm, nm) = _grad_logits(q, p, n, neg_valid, lse, g, scale,
                                          mask_false_negatives)
    dq = dl @ nm + dpos[:, None] * pm
    dp = dpos[:, None] * qm
    return dq.to(q.dtype), dp.to(p.dtype)


def fused_infonce_dn_reference(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, neg_valid: torch.Tensor,
    lse: torch.Tensor, g: torch.Tensor, *, scale: float = 1.0, mask_false_negatives: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the dn kernel: ``dn`` for the cotangent
    ``g`` of ``ce``, in ``n.dtype``."""
    dl, _, (qm, _, _) = _grad_logits(q, p, n, neg_valid, lse, g, scale, mask_false_negatives)
    return (dl.T @ qm).to(n.dtype)


def _check_cuda(q, p, n, neg_valid, what: str = "fused_infonce") -> None:
    """Raise on operands the pool kernels (``what``: this module's or
    ``fused_pairwise``'s, which share the layout) do not take."""
    r, d = q.shape
    if any(t.device != q.device for t in (p, n, neg_valid)):
        msg = f"{what}: q, p, n and neg_valid must be on one device"
        raise ValueError(msg)
    if p.shape != q.shape or n.dim() != 2 or n.shape[1] != d or neg_valid.numel() != n.shape[0]:
        msg = (f"{what}: q {tuple(q.shape)}, p {tuple(p.shape)}, n {tuple(n.shape)} and "
               f"neg_valid {tuple(neg_valid.shape)} do not agree")
        raise ValueError(msg)
    if d > _MAX_D:
        msg = f"{what}: the kernels take D <= {_MAX_D}, got {d}"
        raise ValueError(msg)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).float().contiguous()


def _splits(device_index: int, r: int, rn: int, d: int, kernel_pass: int) -> int:
    """The splits of the forward (pass 0, over the pool), the dq kernel (1,
    over the pool) or the dn kernel (2, over the query rows)."""
    return cuda_build.splits("fused_infonce", "pool_infonce_splits", device_index, r, rn, d,
                             kernel_pass)


def workspace_elems(r: int, rn: int, d: int, splits_fwd: int, splits_dq: int,
                    splits_dn: int) -> dict[str, int]:
    """f32 elements of the kernels' workspaces: the forward's per-split
    (max, sum), and the partial dq and dn of each split (none with one
    split: the kernel writes dq or dn itself)."""
    return {
        "fwd_part": splits_fwd * r * 2,
        "dq_part": splits_dq * r * d if splits_dq > 1 else 0,
        "dn_part": splits_dn * rn * d if splits_dn > 1 else 0,
    }


def _fwd_cuda(q, p, n, neg_valid, scale, mask_false_negatives):
    _check_cuda(q, p, n, neg_valid)
    qb, pb, nb, nv = _bf16(q), _bf16(p), _bf16(n), _f32(neg_valid)
    r, d = qb.shape
    rn = nb.shape[0]
    ce, lse, pos = (torch.empty(r, dtype=torch.float32, device=q.device) for _ in range(3))
    splits = _splits(q.device.index or 0, r, rn, d, 0)
    part = cuda_build.workspace(workspace_elems(r, rn, d, splits, 1, 1)["fwd_part"], q.device)
    status = cuda_build.library("fused_infonce").pool_infonce_fwd(
        qb.data_ptr(), pb.data_ptr(), nb.data_ptr(), nv.data_ptr(), ce.data_ptr(),
        lse.data_ptr(), pos.data_ptr(), cuda_build.pointer(part), r, rn, d, float(scale),
        int(mask_false_negatives), splits, cuda_build.stream_handle(q.device),
    )
    cuda_build.check(status, "pool_infonce_fwd launch")
    cuda_build.LAUNCHES["pool_infonce_fwd"] += 1
    return ce, lse, pos


def _dq_cuda(q, p, n, neg_valid, lse, g, pos, scale, mask_false_negatives):
    _check_cuda(q, p, n, neg_valid)
    qb, pb, nb, nv = _bf16(q), _bf16(p), _bf16(n), _f32(neg_valid)
    r, d = qb.shape
    rn = nb.shape[0]
    dq = torch.empty((r, d), dtype=torch.float32, device=q.device)
    dp = torch.empty_like(dq)
    splits = _splits(q.device.index or 0, r, rn, d, 1)
    part = cuda_build.workspace(workspace_elems(r, rn, d, 1, splits, 1)["dq_part"], q.device)
    status = cuda_build.library("fused_infonce").pool_infonce_dq(
        qb.data_ptr(), pb.data_ptr(), nb.data_ptr(), nv.data_ptr(), _f32(lse).data_ptr(),
        _f32(g).data_ptr(), _f32(pos).data_ptr(), dq.data_ptr(), dp.data_ptr(),
        cuda_build.pointer(part), r, rn, d, float(scale), int(mask_false_negatives), splits,
        cuda_build.stream_handle(q.device),
    )
    cuda_build.check(status, "pool_infonce_dq launch")
    cuda_build.LAUNCHES["pool_infonce_dq"] += 1
    return dq.to(q.dtype), dp.to(p.dtype)


def _dn_cuda(q, p, n, neg_valid, lse, g, pos, scale, mask_false_negatives):
    _check_cuda(q, p, n, neg_valid)
    qb, nb, nv = _bf16(q), _bf16(n), _f32(neg_valid)
    r, d = qb.shape
    rn = nb.shape[0]
    dn = torch.empty((rn, d), dtype=torch.float32, device=q.device)
    splits = _splits(q.device.index or 0, r, rn, d, 2)
    part = cuda_build.workspace(workspace_elems(r, rn, d, 1, 1, splits)["dn_part"], q.device)
    status = cuda_build.library("fused_infonce").pool_infonce_dn(
        qb.data_ptr(), nb.data_ptr(), nv.data_ptr(), _f32(lse).data_ptr(), _f32(g).data_ptr(),
        _f32(pos).data_ptr(), dn.data_ptr(), cuda_build.pointer(part), r, rn, d, float(scale),
        int(mask_false_negatives), splits, cuda_build.stream_handle(q.device),
    )
    cuda_build.check(status, "pool_infonce_dn launch")
    cuda_build.LAUNCHES["pool_infonce_dn"] += 1
    return dn.to(n.dtype)


class _PoolInfonce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, p, n, neg_valid, scale, mask_false_negatives):
        kw = dict(scale=scale, mask_false_negatives=mask_false_negatives)
        if q.device.type == "cpu":
            ce, lse, pos = fused_infonce_reference(q, p, n, neg_valid, **kw)
        else:
            ce, lse, pos = _fwd_cuda(q, p, n, neg_valid, scale, mask_false_negatives)
        ctx.save_for_backward(q, p, n, neg_valid, lse, pos)
        ctx.kw = kw
        return ce

    @staticmethod
    def backward(ctx, g):
        q, p, n, neg_valid, lse, pos = ctx.saved_tensors
        kw = ctx.kw
        dq = dp = dn = None
        cpu = q.device.type == "cpu"
        # each pass runs only for gradients that are needed: pool rows of a
        # frozen table take none, and the dn kernel is then not launched
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            if cpu:
                dq, dp = fused_infonce_dq_reference(q, p, n, neg_valid, lse, g, **kw)
            else:
                dq, dp = _dq_cuda(q, p, n, neg_valid, lse, g, pos, kw["scale"],
                                  kw["mask_false_negatives"])
        if ctx.needs_input_grad[2]:
            if cpu:
                dn = fused_infonce_dn_reference(q, p, n, neg_valid, lse, g, **kw)
            else:
                dn = _dn_cuda(q, p, n, neg_valid, lse, g, pos, kw["scale"],
                              kw["mask_false_negatives"])
        return dq, dp, dn, None, None, None


def fused_infonce_rowwise(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, neg_valid: torch.Tensor,
    scale: float = 1.0, mask_false_negatives: bool = True,
) -> torch.Tensor:
    """(R,) f32 per-row InfoNCE CE of ``q`` (R, D) against its positive
    ``p`` (R, D) and the shared pool ``n`` (Rn, D) with validity
    ``neg_valid`` (Rn,); the lse is kept for the backward.  Differentiable
    in ``q``, ``p`` and ``n``.  CPU tensors run the plain versions; CUDA
    tensors launch the kernels or raise."""
    return _PoolInfonce.apply(q, p, n, neg_valid.reshape(-1), float(scale),
                              bool(mask_false_negatives))


def fused_infonce_loss(
    q: torch.Tensor, p: torch.Tensor, n: torch.Tensor, row_valid: torch.Tensor,
    neg_valid: torch.Tensor, *, scale: float = 1.0, mask_false_negatives: bool = True,
) -> torch.Tensor:
    """Scalar InfoNCE sum over valid rows: ``ops.losses.infonce_loss`` with
    dot similarity, without the (R, Rn) logit matrix."""
    ce = fused_infonce_rowwise(q, p, n, neg_valid, scale, mask_false_negatives)
    return (ce * row_valid.reshape(-1).float()).sum()
