"""Embedding-row gather and its gradient: the plain PyTorch versions and
the wrappers around the CUDA kernels of ``csrc/gather_rows.cu``.

Counterpart of ``transformer_recommenders_tpu/ops/gather_matmul.py``
(``gather_rows``, its Pallas ``_fwd_kernel`` and the scatter-add
``_bwd_kernel`` of its custom VJP).  The TPU kernels compute ``table[idx]``
and its transpose as one-hot MXU matmuls because row gathers and scatters
are slow there; the functions are the same here (an index outside
``[0, N)`` gives a zero row and receives no gradient) and the kernels are a
row copy and, for the gradient, a stable radix sort of the rows by index
(the grouping) and a segmented reduction over the sorted rows.

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
_GROUP_TILE = 4096  # csrc/gather_rows.cu kTile: positions a tile of the tiled grouping sorts


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


def _radix_pass_reference(keys, rows, shift: int, bits: int, items: int):
    """One pass of the grouping's radix sort (``csrc/gather_rows.cu``):
    ``keys`` (clamped indices) and ``rows`` stably sorted by the digit
    ``((keys + 1) >> shift) % 2**bits``.  Owner ``o`` holds positions
    ``[o * items, (o + 1) * items)`` and counts them by digit; the counts of
    (digit, owner) scanned in digit-major order give each its first
    position, and each owner places its positions in order."""
    n = keys.numel()
    digit = ((keys + 1) >> shift) & ((1 << bits) - 1)
    owners = -(-n // items)
    owner = torch.arange(n, device=keys.device) // items
    cell = digit * owners + owner
    counts = torch.bincount(cell, minlength=(1 << bits) * owners)
    first = counts.cumsum(0) - counts
    # a position's rank among its owner's earlier positions of its digit
    onehot = torch.nn.functional.one_hot(
        torch.cat([digit, digit.new_zeros(owners * items - n)]), 1 << bits).view(owners, items, -1)
    rank = (onehot.cumsum(1) - onehot).view(-1, 1 << bits)[:n].gather(1, digit[:, None])[:, 0]
    pos = first[cell] + rank
    out_keys, out_rows = torch.empty_like(keys), torch.empty_like(rows)
    out_keys[pos], out_rows[pos] = keys, rows
    return out_keys, out_rows


def group_rows_reference(idx: torch.Tensor, num_rows: int, bits: int = 4, items: int = 4):
    """The backward's grouping, the algorithm of ``csrc/gather_rows.cu``
    (``gather_rows_group``) in torch ops: ``(keys, order, bounds)``, the
    indices sorted stably (every negative one as -1, every one at or above
    ``num_rows`` as ``num_rows``), the row each came from, and, for each
    bucket ``clamp(idx, -1, num_rows) + 1``, its first position and one
    past its last (``(num_rows + 2, 2)``; an empty bucket's two are equal).
    On every in-range position, keys and order are ``torch.sort(idx,
    stable=True)``'s.

    An LSD radix sort of the buckets, ``bits`` a pass (the one-block kernel
    4 with ``items`` a thread, the tiled one 8 with 16), then the bounds
    from the positions where the bucket changes."""
    keys = idx.reshape(-1).long().clamp(-1, num_rows)
    order = torch.arange(keys.numel(), device=keys.device)
    top = max(1, int(num_rows + 1).bit_length())  # the bits of the largest bucket
    for shift in range(0, top, bits):
        keys, order = _radix_pass_reference(keys, order, shift, bits, items)
    # a position whose bucket differs from the one before starts its bucket
    # and ends that one
    bucket = keys + 1
    bounds = torch.zeros(num_rows + 2, 2, dtype=torch.long, device=keys.device)
    change = torch.ones_like(bucket, dtype=torch.bool)
    change[1:] = bucket[1:] != bucket[:-1]
    pos = torch.arange(keys.numel(), device=keys.device)
    bounds[bucket[change], 0] = pos[change]
    last = torch.roll(change, -1)
    last[-1:] = True
    bounds[bucket[last], 1] = pos[last] + 1
    return keys, order, bounds


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


def _group_cuda(idx: torch.Tensor, num_rows: int, tiled: bool = False):
    """The grouping kernel (``gather_rows_group``): ``(keys, order,
    bounds)`` as :func:`group_rows_reference` gives them, int32 views of
    one workspace.  One block where the shape allows it; ``tiled`` forces
    the tiled sort."""
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int64)
    idx = idx.contiguous()
    r, n = idx.numel(), num_rows
    tiles = -(-r // _GROUP_TILE)
    ws = torch.empty(4 * r + 2 * (n + 2) + 256 * tiles, dtype=torch.int32, device=idx.device)
    status = cuda_build.library("gather_rows").gather_rows_group(
        idx.data_ptr(), ws.data_ptr(), n, r, int(idx.dtype == torch.int64), int(tiled),
        cuda_build.stream_handle(idx.device),
    )
    cuda_build.check(status, "gather_rows_group launch")
    return ws[:r], ws[r:2 * r], ws[2 * r:2 * r + 2 * (n + 2)].view(n + 2, 2)


def _gather_bwd_cuda(g: torch.Tensor, idx: torch.Tensor, num_rows: int, table_dtype):
    keys, order, bounds = _group_cuda(idx, num_rows)
    dtable = _segment_sum_cuda(g, keys, order, num_rows, table_dtype, bounds)
    cuda_build.LAUNCHES["gather_rows_bwd"] += 1
    return dtable


def _segment_sum_cuda(g: torch.Tensor, sorted_idx: torch.Tensor, order: torch.Tensor,
                      num_rows: int, table_dtype, bounds: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The backward kernel's two passes over stably sorted indices and the
    row each came from (int32 or int64, one dtype), with each bucket's
    bounds from the grouping, or without (pass 2 then searches the sorted
    indices)."""
    g = g.contiguous()  # the cotangent of a bf16 or f32 output (``_check``)
    r, d = g.shape
    dtable = torch.empty((num_rows, d), dtype=table_dtype, device=g.device)
    partial = torch.empty((2 * -(-r // _CHUNK), d), dtype=torch.float32, device=g.device)
    lib = cuda_build.library("gather_rows")
    status = lib.gather_rows_bwd(
        g.data_ptr(), sorted_idx.data_ptr(), order.data_ptr(), cuda_build.pointer(bounds),
        int(sorted_idx.dtype == torch.int64), dtable.data_ptr(), partial.data_ptr(), num_rows,
        d, r, int(g.dtype == torch.bfloat16), int(table_dtype == torch.bfloat16),
        cuda_build.stream_handle(g.device),
    )
    cuda_build.check(status, "gather_rows_bwd launch")
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
