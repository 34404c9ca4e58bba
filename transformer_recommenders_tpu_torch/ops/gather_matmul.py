"""Embedding-row gather and its gradient: the plain PyTorch versions and
the wrappers around the CUDA kernels of ``csrc/gather_rows.cu``.

Counterpart of ``transformer_recommenders_tpu/ops/gather_matmul.py``
(``gather_rows``, its Pallas ``_fwd_kernel`` and the scatter-add
``_bwd_kernel`` of its custom VJP).  The TPU kernels compute ``table[idx]``
and its transpose as one-hot MXU matmuls because row gathers and scatters
are slow there; the functions are the same here (an index outside
``[0, N)`` gives a zero row and receives no gradient) and the kernels are a
row copy and a segmented reduction over the sorted indices.

Rows: a bf16 table is copied as it is; an f32 table gives bf16-rounded
rows (the JAX kernel's values) or exact f32 rows (the JAX package reaches
for ``jnp.take`` when it needs exact rows).

Gradient: ``dtable[n] = sum of g[r] over idx[r] == n``, summed in f32 and
cast to the table's dtype, as ``_vjp_bwd`` does, in a fixed order (a
segmented reduction over the sorted indices; see
:func:`gather_rows_backward_reference`).  The JAX kernel rounds
the cotangent to bf16 before its one-hot product.  With bf16 rows the
cotangent already is bf16, so summing it as given is the same function;
with f32 rows the port's gather stands for the ``jnp.take`` branch, whose
gradient is the exact f32 sum, and that is what the port computes.
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.ops import cuda_build

_DTYPES = (torch.bfloat16, torch.float32)
_CHUNK = 64  # csrc/gather_rows.cu kChunk: sorted positions a block of pass 1 sums


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
    in the kernel's order; out-of-range indices contribute nothing.

    The order of ``csrc/gather_rows.cu``: the rows sorted stably by index
    and cut into chunks of ``_CHUNK``; each run of one index inside a chunk
    summed in row order; an index whose rows span chunks adds its chunks'
    run sums in chunk order.  (Within one chunk that is row order.)"""
    idx = idx.reshape(-1).long()
    r, d = g.shape
    sorted_idx, order = torch.sort(idx, stable=True)
    chunks = -(-r // _CHUNK)
    pad = chunks * _CHUNK - r
    # padding positions take index -1: out of range, so they add nothing
    key = torch.cat([sorted_idx, sorted_idx.new_full((pad,), -1)]).view(chunks, _CHUNK)
    rows = torch.cat([g.float()[order], g.new_zeros((pad, d), dtype=torch.float32)])
    rows = rows.view(chunks, _CHUNK, d)
    # each chunk's runs summed in row order; a run's sum sits at its last position
    sums = torch.empty_like(rows)
    acc = rows[:, 0]
    for j in range(_CHUNK):
        if j:
            acc = torch.where((key[:, j] == key[:, j - 1])[:, None], acc + rows[:, j], rows[:, j])
        sums[:, j] = acc
    last = torch.ones_like(key, dtype=torch.bool)
    last[:, :-1] = key[:, 1:] != key[:, :-1]
    key, sums = key.reshape(-1), sums.reshape(-1, d)
    valid = last.reshape(-1) & (key >= 0) & (key < num_rows)
    # the run sums of one index lie in consecutive chunks: the k-th of them
    # is in chunk (its index's first position) // _CHUNK + k.  Adding them
    # rank by rank (each rank names a row at most once) keeps chunk order;
    # the rest go to a spare row
    chunk = torch.arange(chunks * _CHUNK, device=g.device) // _CHUNK
    first = torch.searchsorted(sorted_idx, key) // _CHUNK
    rank = torch.where(valid, chunk - first, -1)
    dtable = torch.zeros((num_rows + 1, d), dtype=torch.float32, device=g.device)
    for k in range(chunks):
        dtable.index_add_(0, torch.where(rank == k, key, num_rows), sums)
    return dtable[:num_rows].to(table_dtype)


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


def launch_floor(d: int, r: int, out_dtype, device) -> None:
    """An empty kernel launched on the forward kernel's grid for ``r`` rows
    of width ``d``: the launch cost under the kernel's time."""
    status = cuda_build.library("gather_rows").gather_rows_launch_floor(
        d, r, int(out_dtype == torch.bfloat16), cuda_build.stream_handle(torch.device(device)))
    cuda_build.check(status, "gather_rows_launch_floor launch")


def _gather_bwd_cuda(g: torch.Tensor, idx: torch.Tensor, num_rows: int, table_dtype):
    sorted_idx, order = torch.sort(idx.to(torch.int64), stable=True)
    return _segment_sum_cuda(g, sorted_idx, order, num_rows, table_dtype)


def _segment_sum_cuda(g: torch.Tensor, sorted_idx: torch.Tensor, order: torch.Tensor,
                      num_rows: int, table_dtype) -> torch.Tensor:
    """The backward kernel's two passes over stably sorted indices and the
    row each came from."""
    g = g.contiguous()  # the cotangent of a bf16 or f32 output (``_check``)
    r, d = g.shape
    dtable = torch.empty((num_rows, d), dtype=table_dtype, device=g.device)
    partial = torch.empty((2 * -(-r // _CHUNK), d), dtype=torch.float32, device=g.device)
    lib = cuda_build.library("gather_rows")
    status = lib.gather_rows_bwd(
        g.data_ptr(), sorted_idx.data_ptr(), order.data_ptr(), dtable.data_ptr(),
        partial.data_ptr(), num_rows, d, r, int(g.dtype == torch.bfloat16),
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
