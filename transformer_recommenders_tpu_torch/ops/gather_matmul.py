"""Embedding-row gather and its gradient: the plain PyTorch versions and
the wrappers around the CUDA kernels of ``csrc/gather_rows.cu``.

Counterpart of ``transformer_recommenders_tpu/ops/gather_matmul.py``
(``gather_rows``, its Pallas ``_fwd_kernel`` and the scatter-add
``_bwd_kernel`` of its custom VJP).  The TPU kernels compute ``table[idx]``
and its transpose as one-hot MXU matmuls because row gathers and scatters
are slow there; the functions are the same here (an index outside
``[0, N)`` gives a zero row and receives no gradient) and the kernels are a
row copy and a sorted, per-row segment sum.

Rows: a bf16 table is copied as it is; an f32 table gives bf16-rounded
rows (the JAX kernel's values) or exact f32 rows (the JAX package reaches
for ``jnp.take`` when it needs exact rows).

Gradient: ``dtable[n] = sum of g[r] over idx[r] == n``, summed in f32 and
cast to the table's dtype, as ``_vjp_bwd`` does.  The JAX kernel rounds
the cotangent to bf16 before its one-hot product.  With bf16 rows the
cotangent already is bf16, so summing it as given is the same function;
with f32 rows the port's gather stands for the ``jnp.take`` branch, whose
gradient is the exact f32 sum, and that is what the port computes.
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.ops import cuda_build

_DTYPES = (torch.bfloat16, torch.float32)


def gather_rows_reference(
    table: torch.Tensor, idx: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """(R, D) rows ``table[idx]`` in ``out_dtype``; out-of-range rows are 0."""
    n = table.shape[0]
    idx = idx.reshape(-1).long()
    valid = (idx >= 0) & (idx < n)
    rows = table.float()[idx.clamp(0, max(n - 1, 0))]
    return torch.where(valid[:, None], rows, 0.0).to(out_dtype)


def gather_rows_backward_reference(
    g: torch.Tensor, idx: torch.Tensor, num_rows: int, table_dtype=torch.float32
) -> torch.Tensor:
    """(num_rows, D) ``dtable``: the rows of ``g`` summed in f32 by index,
    in increasing row order; out-of-range indices contribute nothing."""
    idx = idx.reshape(-1).long()
    valid = (idx >= 0) & (idx < num_rows)
    # out-of-range rows add zeros to row 0 (no boolean indexing, so no wait
    # for the device)
    rows = torch.where(valid[:, None], g.float(), 0.0)
    dtable = torch.zeros((num_rows, g.shape[-1]), dtype=torch.float32, device=g.device)
    dtable.index_add_(0, torch.where(valid, idx, 0), rows)
    return dtable.to(table_dtype)


def _check(table: torch.Tensor, idx: torch.Tensor, out_dtype) -> None:
    if table.device.type != "cuda" or idx.device != table.device:
        msg = f"gather_rows: table on {table.device}, idx on {idx.device}"
        raise ValueError(msg)
    if table.dim() != 2 or table.dtype not in _DTYPES:
        msg = f"gather_rows: table must be 2-D bf16 or f32, got {tuple(table.shape)} {table.dtype}"
        raise ValueError(msg)
    if out_dtype not in _DTYPES:
        msg = f"gather_rows: out_dtype must be bf16 or f32, got {out_dtype}"
        raise ValueError(msg)


def _gather_cuda(table: torch.Tensor, idx: torch.Tensor, out_dtype) -> torch.Tensor:
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int64)
    n, d = table.shape
    table = table.contiguous()
    out = torch.empty((idx.numel(), d), dtype=out_dtype, device=table.device)
    lib = cuda_build.library("gather_rows")
    status = lib.gather_rows_fwd(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, d, idx.numel(),
        int(table.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(idx.dtype == torch.int64), cuda_build.stream_handle(table.device),
    )
    cuda_build.check(status, "gather_rows_fwd launch")
    cuda_build.LAUNCHES["gather_rows"] += 1
    return out


def _gather_bwd_cuda(g: torch.Tensor, idx: torch.Tensor, num_rows: int, table_dtype):
    g = g.contiguous()  # the cotangent of a bf16 or f32 output (``_check``)
    sorted_idx, order = torch.sort(idx.to(torch.int64), stable=True)
    dtable = torch.empty((num_rows, g.shape[1]), dtype=table_dtype, device=g.device)
    lib = cuda_build.library("gather_rows")
    status = lib.gather_rows_bwd(
        g.data_ptr(), sorted_idx.data_ptr(), order.data_ptr(), dtable.data_ptr(),
        num_rows, g.shape[1], g.shape[0], int(g.dtype == torch.bfloat16),
        int(table_dtype == torch.bfloat16), cuda_build.stream_handle(g.device),
    )
    cuda_build.check(status, "gather_rows_bwd launch")
    cuda_build.LAUNCHES["gather_rows_bwd"] += 1
    return dtable


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, out_dtype):
        ctx.save_for_backward(idx)
        ctx.num_rows, ctx.table_dtype = table.shape[0], table.dtype
        if table.device.type == "cpu":
            return gather_rows_reference(table, idx, out_dtype)
        return _gather_cuda(table, idx, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if g.device.type == "cpu":
            dtable = gather_rows_backward_reference(g, idx, ctx.num_rows, ctx.table_dtype)
        else:
            dtable = _gather_bwd_cuda(g, idx, ctx.num_rows, ctx.table_dtype)
        return dtable, None, None


def gather_rows(
    table: torch.Tensor, idx: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """``table[idx]`` for an (N, D) bf16 or f32 table and (R,) int indices,
    differentiable in ``table``.

    On CPU tensors this runs :func:`gather_rows_reference` (and
    :func:`gather_rows_backward_reference` for the gradient); on CUDA
    tensors it launches the kernels or raises."""
    idx = idx.reshape(-1)
    if table.device.type != "cpu":
        _check(table, idx, out_dtype)
    return _GatherRows.apply(table, idx, out_dtype)
