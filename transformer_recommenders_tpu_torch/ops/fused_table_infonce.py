"""Table-scored InfoNCE: queries scored against the whole catalog, each
catalog row weighted by its count in the negative pool.  The plain PyTorch
versions and the wrappers around the CUDA kernels of
``csrc/fused_table_infonce.cu``.

Counterpart of ``transformer_recommenders_tpu/ops/fused_table_infonce.py``
(``neg_pool_counts``, ``table_infonce_rowwise`` with its Pallas
``_fwd_kernel`` and ``_bwd_kernel``, ``fused_table_infonce_loss``).  Every
pool entry of item ``i`` gives the same logit, so the pool's sum over
negatives equals the catalog's sum over items weighted by their pool
counts, the false-negative mask ``logit < pos`` included.  The positive's
logit is read from the same score matrix, so the mask drops every copy of
the positive in the pool.

Numerics follow the JAX kernels: ``q`` and the table rounded to bf16 with
f32 sums, times ``scale``; masked columns guarded by ``_NEG_BIG`` before
``exp``; the logit gradient ``dl`` rounded to bf16 before both gradient
products; ``dq`` cast to ``q.dtype`` and ``dT`` to the table's.  The TPU
version pads rows to its tile and the catalog to 128; the kernels here
mask their own edges and need no padding.

Each version scores ``pos`` and every column by one chain, so the mask
drops column ``pos_idx`` and every copy of it.  The kernels' chain is the
tensor cores' (``xrt::score_tile``: k-steps of 16 in increasing order);
the plain version's is one exact bf16 product at a time in increasing k.
The two sum in other orders, so their scores agree to rounding, not bit
for bit: a column within a rounding step of ``pos`` may count in one and
not in the other.  Where every partial sum is exact in f32 (small
multiples of a power of two) they agree bit for bit.
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.ops import cuda_build

_NEG_BIG = -1e30
_MAX_D = 512  # csrc/fused_table_infonce.cu kMaxD


def neg_pool_counts(neg_idx: torch.Tensor, neg_valid: torch.Tensor, num_rows: int) -> torch.Tensor:
    """(N,) f32 histogram of the negative pool over table rows, each entry
    weighted by ``neg_valid``; row 0 (padding) always counts 0.  A sum of
    0/1 weights, so exact in any order."""
    idx = neg_idx.reshape(-1).long()
    keep = (idx >= 0) & (idx < num_rows)
    # out-of-range entries add a weight of 0 to row 0 (no boolean indexing,
    # so no wait for the device)
    w = torch.where(keep, neg_valid.reshape(-1).float(), 0.0)
    counts = torch.zeros(num_rows, dtype=torch.float32, device=idx.device)
    counts.index_add_(0, torch.where(keep, idx, 0), w)
    counts[:1].zero_()  # a fill on the device: no scalar copied from the host
    return counts


def _scores(q, table, pos_idx, counts, scale: float, mask_false_negatives: bool):
    """x (R, N), pos (R,), sel (R, N) and the masked weights w (R, N).

    The scores are summed one exact bf16 product at a time in increasing
    k, and pos is read off them, so pos is the score at ``pos_idx`` bit
    for bit and the mask drops every copy of the positive."""
    qm, tm = q.to(torch.bfloat16).float(), table.to(torch.bfloat16).float()
    x = torch.zeros((qm.shape[0], tm.shape[0]), dtype=torch.float32, device=q.device)
    for k in range(qm.shape[1]):
        x.addcmul_(qm[:, k:k + 1], tm[None, :, k])
    x = x * scale
    n = table.shape[0]
    pidx = pos_idx.reshape(-1).long()
    sel = torch.arange(n, device=x.device)[None, :] == pidx[:, None]
    pos = torch.where(sel, x, 0.0).sum(dim=1)  # x at pos_idx (exact: one nonzero term)
    w = counts.reshape(1, -1).float().expand_as(x)
    if mask_false_negatives:
        w = torch.where(x < pos[:, None], w, 0.0)
    return x, pos, sel, w


def table_infonce_reference(
    q: torch.Tensor, table: torch.Tensor, pos_idx: torch.Tensor, counts: torch.Tensor,
    *, scale: float = 1.0, mask_false_negatives: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: per-row ``(ce, lse)``,
    (R,) f32 each."""
    x, pos, _, w = _scores(q, table, pos_idx, counts, scale, mask_false_negatives)
    xm = torch.where(w > 0, x, _NEG_BIG)
    m = torch.maximum(pos, xm.amax(dim=1))
    a = torch.exp(pos - m) + (w * torch.exp(xm - m[:, None])).sum(dim=1)
    lse = m + torch.log(a)
    return lse - pos, lse


def table_infonce_backward_reference(
    q: torch.Tensor, table: torch.Tensor, pos_idx: torch.Tensor, counts: torch.Tensor,
    lse: torch.Tensor, g: torch.Tensor, *, scale: float = 1.0, mask_false_negatives: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: ``(dq, dtable)`` for
    the cotangent ``g`` of ``ce``, in ``q.dtype`` and ``table.dtype``."""
    x, pos, sel, w = _scores(q, table, pos_idx, counts, scale, mask_false_negatives)
    xm = torch.where(w > 0, x, _NEG_BIG)
    qprob = w * torch.exp(xm - lse[:, None])
    pprob = torch.exp(pos - lse)
    dl = (g.float() * scale)[:, None] * (qprob + torch.where(sel, (pprob - 1.0)[:, None], 0.0))
    dlm = dl.to(torch.bfloat16).float()
    dq = dlm @ table.to(torch.bfloat16).float()
    dt = dlm.T @ q.to(torch.bfloat16).float()
    return dq.to(q.dtype), dt.to(table.dtype)


def _check_cuda(q, table, pos_idx, counts) -> None:
    r, d = q.shape
    n = table.shape[0]
    if table.device != q.device or pos_idx.device != q.device or counts.device != q.device:
        msg = "table_infonce: q, table, pos_idx and counts must be on one device"
        raise ValueError(msg)
    if table.shape[1] != d or pos_idx.numel() != r or counts.numel() != n:
        msg = (f"table_infonce: q {tuple(q.shape)}, table {tuple(table.shape)}, pos_idx "
               f"{tuple(pos_idx.shape)} and counts {tuple(counts.shape)} do not agree")
        raise ValueError(msg)
    if d > _MAX_D:
        msg = f"table_infonce: the kernel takes D <= {_MAX_D}, got {d}"
        raise ValueError(msg)


def _cuda_operands(q, table, pos_idx, counts):
    return (q.to(torch.bfloat16).contiguous(), table.to(torch.bfloat16).contiguous(),
            pos_idx.reshape(-1).to(torch.int32).contiguous(),
            counts.reshape(-1).float().contiguous())


def _splits(device_index: int, r: int, n: int, d: int, kernel_pass: int) -> int:
    """The splits of the forward (pass 0, over the catalog), the dq pass
    (1, over the catalog) or the dT pass (2, over the query rows)."""
    return cuda_build.splits("fused_table_infonce", "table_infonce_splits", device_index, r, n,
                             d, kernel_pass)


def workspace_elems(r: int, n: int, d: int, splits_fwd: int, splits_dq: int,
                    splits_dt: int) -> dict[str, int]:
    """f32 elements of the kernels' workspaces: the forward's pos and
    per-split (max, sum); the backward's pos, and the partial dq and dT of
    each split (none with one split: the kernel writes dq or dT itself)."""
    return {
        "fwd_pos": r, "fwd_part": splits_fwd * r * 2, "bwd_pos": r,
        "dq_part": splits_dq * r * d if splits_dq > 1 else 0,
        "dt_part": splits_dt * n * d if splits_dt > 1 else 0,
    }


def _fwd_cuda(q, table, pos_idx, counts, scale, mask_false_negatives):
    _check_cuda(q, table, pos_idx, counts)
    qb, tb, pidx, cnt = _cuda_operands(q, table, pos_idx, counts)
    r, d = qb.shape
    n = tb.shape[0]
    splits = _splits(q.device.index or 0, r, n, d, 0)
    ws = workspace_elems(r, n, d, splits, 1, 1)
    ce = torch.empty(r, dtype=torch.float32, device=q.device)
    lse = torch.empty_like(ce)
    pos, part = (cuda_build.workspace(ws[k], q.device) for k in ("fwd_pos", "fwd_part"))
    status = cuda_build.library("fused_table_infonce").table_infonce_fwd(
        qb.data_ptr(), tb.data_ptr(), pidx.data_ptr(), cnt.data_ptr(), ce.data_ptr(),
        lse.data_ptr(), cuda_build.pointer(pos), cuda_build.pointer(part),
        r, n, d, float(scale), int(mask_false_negatives), splits,
        cuda_build.stream_handle(q.device),
    )
    cuda_build.check(status, "table_infonce_fwd launch")
    cuda_build.LAUNCHES["table_infonce_fwd"] += 1
    return ce, lse


def _bwd_cuda(q, table, pos_idx, counts, lse, g, scale, mask_false_negatives):
    _check_cuda(q, table, pos_idx, counts)
    qb, tb, pidx, cnt = _cuda_operands(q, table, pos_idx, counts)
    r, d = qb.shape
    n = tb.shape[0]
    index = q.device.index or 0
    splits_dq, splits_dt = _splits(index, r, n, d, 1), _splits(index, r, n, d, 2)
    ws = workspace_elems(r, n, d, 1, splits_dq, splits_dt)
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    dq = torch.empty((r, d), dtype=torch.float32, device=q.device)
    dt = torch.empty((n, d), dtype=torch.float32, device=q.device)
    pos, part_dq, part_dt = (cuda_build.workspace(ws[k], q.device)
                             for k in ("bwd_pos", "dq_part", "dt_part"))
    status = cuda_build.library("fused_table_infonce").table_infonce_bwd(
        qb.data_ptr(), tb.data_ptr(), pidx.data_ptr(), cnt.data_ptr(), lse.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dt.data_ptr(),
        *(cuda_build.pointer(t) for t in (pos, part_dq, part_dt)),
        r, n, d, float(scale), int(mask_false_negatives), splits_dq, splits_dt,
        cuda_build.stream_handle(q.device),
    )
    cuda_build.check(status, "table_infonce_bwd launch")
    cuda_build.LAUNCHES["table_infonce_bwd"] += 1
    return dq.to(q.dtype), dt.to(table.dtype)


class _TableInfonce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, table, pos_idx, counts, scale, mask_false_negatives):
        if q.device.type == "cpu":
            ce, lse = table_infonce_reference(
                q, table, pos_idx, counts, scale=scale, mask_false_negatives=mask_false_negatives)
        else:
            ce, lse = _fwd_cuda(q, table, pos_idx, counts, scale, mask_false_negatives)
        ctx.save_for_backward(q, table, pos_idx, counts, lse)
        ctx.scale, ctx.mask_false_negatives = scale, mask_false_negatives
        return ce

    @staticmethod
    def backward(ctx, g):
        q, table, pos_idx, counts, lse = ctx.saved_tensors
        kw = dict(scale=ctx.scale, mask_false_negatives=ctx.mask_false_negatives)
        if q.device.type == "cpu":
            dq, dt = table_infonce_backward_reference(q, table, pos_idx, counts, lse, g, **kw)
        else:
            dq, dt = _bwd_cuda(q, table, pos_idx, counts, lse, g, kw["scale"],
                               kw["mask_false_negatives"])
        return dq, dt, None, None, None, None


def table_infonce_rowwise(
    q: torch.Tensor, table: torch.Tensor, pos_idx: torch.Tensor, counts: torch.Tensor,
    scale: float = 1.0, mask_false_negatives: bool = True,
) -> torch.Tensor:
    """(R,) f32 per-row InfoNCE CE of ``q`` (R, D) against the
    count-weighted ``table`` (N, D, row 0 the zero padding row), with
    ``pos_idx`` (R,) the positive row of each query (0 for invalid rows)
    and ``counts`` (N,) the pool multiplicities.  Differentiable in ``q``
    and ``table``.  CPU tensors run the plain versions; CUDA tensors launch
    the kernels or raise."""
    return _TableInfonce.apply(q, table, pos_idx.reshape(-1), counts.reshape(-1),
                               float(scale), bool(mask_false_negatives))


def fused_table_infonce_loss(
    q: torch.Tensor, table: torch.Tensor, pos_idx: torch.Tensor, neg_idx: torch.Tensor,
    row_valid: torch.Tensor, neg_valid: torch.Tensor, *, scale: float = 1.0,
    mask_false_negatives: bool = True, counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scalar InfoNCE sum over valid rows: the pool objective over
    ``table[neg_idx]`` without gathering a pool row.  ``counts`` (N,), where
    given, is used as is in place of the pool's histogram (the parallel
    layer sums the ranks' histograms, so the pool is the global batch's)."""
    if counts is None:
        counts = neg_pool_counts(neg_idx, neg_valid, table.shape[0])
    ce = table_infonce_rowwise(q, table, pos_idx, counts, scale, mask_false_negatives)
    return (ce * row_valid.reshape(-1).float()).sum()
