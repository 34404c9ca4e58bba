"""Row-sharded embedding-table lookup (JAX ``parallel/embedding.py``).

The item table is the one tensor that grows with the catalog, so it
shards by row over the ``model`` axis.  Each rank gathers the rows of the
lookup that it owns, writes zeros for the others, and one all-reduce over
``model`` combines the (..., D) results: a rank moves O(lookup) bytes,
whatever the table's size.
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.ops.gather_matmul import gather_rows
from transformer_recommenders_tpu_torch.parallel.collectives import psum
from transformer_recommenders_tpu_torch.parallel.mesh import Mesh, shard_rows
from transformer_recommenders_tpu_torch.params import MODEL_AXIS


def pad_rows_for_mesh(table, num_shards: int) -> torch.Tensor:
    """``table`` with zero rows appended up to a multiple of ``num_shards``."""
    table = torch.as_tensor(table)
    pad = (-table.shape[0]) % num_shards
    if pad:
        table = torch.cat([table, table.new_zeros((pad, table.shape[1]))])
    return table


def place_table(table, mesh: Mesh) -> torch.Tensor:
    """This rank's row shard of ``table`` (numpy or a tensor), padded for
    the mesh, on the mesh's device: rows ``[m * rows, (m + 1) * rows)`` at
    model coordinate ``m``."""
    table = pad_rows_for_mesh(table, mesh.shape[MODEL_AXIS])
    return shard_rows(table, mesh, MODEL_AXIS).to(mesh.device).contiguous()


def local_lookup(table_shard: torch.Tensor, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of ``idx`` that this rank's shard owns, zeros elsewhere, in
    the table's dtype (JAX's ``jnp.take`` gives exact rows): the gather
    kernel on the card, its plain version on the CPU."""
    rows = table_shard.shape[0]
    local = idx.long() - mesh.coordinate(MODEL_AXIS) * rows
    in_range = (local >= 0) & (local < rows)
    vals = gather_rows(table_shard, local.clamp(0, rows - 1).reshape(-1),
                       out_dtype=table_shard.dtype)
    vals = vals.reshape(*idx.shape, table_shard.shape[1])
    return torch.where(in_range[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                               device=vals.device))


def sharded_table_lookup(table_shard: torch.Tensor, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``table[idx]`` with the table row-sharded over ``model``
    (:func:`place_table`): each rank passes its shard and the same ``idx``
    as the other ranks of its model group, and gets every row.  Indices
    outside the (padded) table give zero rows.  Differentiable in the shard:
    the cotangent is summed over ``model`` and each rank keeps its rows'."""
    return psum(local_lookup(table_shard, idx, mesh), mesh, MODEL_AXIS)
