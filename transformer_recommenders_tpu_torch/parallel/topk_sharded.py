"""Exact MIPS top-k over a row-sharded catalog (JAX
``parallel/topk_sharded.py``).

Each rank of a model group scores its rows of the catalog, masks the
mesh's padding rows and the excluded items, and keeps a local top-k; only
the (U, k) candidates of each rank cross the ``model`` axis, in one
all-gather, before a merge top-k.  Both top-ks order ties as ``lax.top_k``
does (``ops/topk.top_k_columns``), so the result is JAX's, across shards
included: among equal scores the lower shard, then the lower column.
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.ops.topk import score_items, top_k_columns
from transformer_recommenders_tpu_torch.parallel.collectives import gather
from transformer_recommenders_tpu_torch.parallel.mesh import Mesh
from transformer_recommenders_tpu_torch.params import MODEL_AXIS

_NEG_INF = float("-inf")


def _local_topk(queries, item_shard, exclude_idx, *, k: int, mesh: Mesh, metric: str,
                num_items: int, items_prenormalized: bool):
    rows = item_shard.shape[0]
    lo = mesh.coordinate(MODEL_AXIS) * rows
    scores = score_items(queries, item_shard, metric=metric,
                         items_prenormalized=items_prenormalized)  # (U, rows)
    col_global = lo + torch.arange(rows, device=scores.device)
    scores = torch.where(col_global[None, :] < num_items, scores, _NEG_INF)
    # exclusion by GLOBAL 1-based index: local column idx - 1 - lo, others dropped
    cols = exclude_idx.long() - 1 - lo
    cols = torch.where((exclude_idx > 0) & (cols >= 0) & (cols < rows), cols, rows)
    scores = torch.cat([scores, scores.new_zeros(scores.shape[0], 1)], dim=1)
    scores = scores.scatter(1, cols, _NEG_INF)[:, :rows]

    k_local = min(k, rows)
    c = top_k_columns(scores, k_local)
    s = scores.gather(1, c)
    if k_local < k:  # every rank gives k candidates
        s = torch.cat([s, s.new_full((s.shape[0], k - k_local), _NEG_INF)], dim=1)
        c = torch.cat([c, c.new_zeros((c.shape[0], k - k_local))], dim=1)
    global_idx = (c + lo + 1).to(torch.int32)  # 1-based item index

    # one all-gather of (score bits, index) pairs over the model axis
    packed = torch.stack([s.contiguous().view(torch.int32), global_idx], dim=-1)  # (U, k, 2)
    m = mesh.shape[MODEL_AXIS]
    u = s.shape[0]
    everyone = gather(packed, mesh.group(MODEL_AXIS)).view(m, u, k, 2)
    everyone = everyone.permute(1, 0, 2, 3).reshape(u, m * k, 2)
    s_cat = everyone[..., 0].contiguous().view(torch.float32)
    i_cat = everyone[..., 1]
    pos = top_k_columns(s_cat, k)
    return s_cat.gather(1, pos), i_cat.gather(1, pos)


def sharded_topk(queries: torch.Tensor, item_shard: torch.Tensor, k: int, mesh: Mesh, *,
                 exclude_idx: torch.Tensor | None = None, metric: str = "cosine",
                 num_items: int | None = None,
                 items_prenormalized: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a catalog row-sharded over ``model``.

    Every rank of a model group passes the same ``queries`` (U, D) and
    ``exclude_idx`` (U, H) (global 1-based item indices, 0 = padding) and
    its own ``item_shard`` of the catalog WITHOUT the padding row
    (``parallel.embedding.place_table``); ``num_items`` is the catalog's
    size before the mesh padded it (default: every row).  Returns, on each
    rank, (scores (U, k) f32, item_idx (U, k) int32 1-based)."""
    if exclude_idx is None:
        exclude_idx = torch.zeros((queries.shape[0], 1), dtype=torch.int64,
                                  device=queries.device)
    if num_items is None:
        num_items = item_shard.shape[0] * mesh.shape[MODEL_AXIS]
    return _local_topk(queries, item_shard, exclude_idx, k=k, mesh=mesh, metric=metric,
                       num_items=num_items, items_prenormalized=items_prenormalized)
