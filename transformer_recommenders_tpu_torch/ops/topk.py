"""Exact MIPS retrieval on the device: scoring, exclusion and top-k.

Counterpart of ``transformer_recommenders_tpu/ops/topk.py``, which the JAX
package computes with plain XLA (no Pallas kernel): one (U, D) x (D, N)
f32 matmul, exclusion masking, ``top_k``.  Here that is ``torch.matmul``
(full f32: TF32 is off by default) and ``torch.topk``.  Equal scores come
back lower index first, as ``lax.top_k`` returns them (``torch.topk`` alone
promises no order among ties): the top-k runs on int64 keys that order by
score and then by index, so no two tie.  At batch 1 over a large catalog
the top-k runs in two stages, as JAX's does (:func:`use_two_stage`): a
top-k of each of 16 blocks, then a top-k of their candidates.  On the
distinct keys both routes give the same result bit for bit.
"""

from __future__ import annotations

import torch


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """L2-normalize rows (the catalog is normalized once, at index build)."""
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def score_items(
    queries: torch.Tensor,
    item_embeddings: torch.Tensor,
    *,
    metric: str = "cosine",
    items_prenormalized: bool = False,
) -> torch.Tensor:
    """(U, N) f32 scores of every catalog item (no padding row) per query;
    ``cosine`` normalizes the queries, and the items unless they already
    are unit-norm."""
    q = queries.float()
    t = item_embeddings.float()
    if metric == "cosine":
        q = normalize_rows(q)
        if not items_prenormalized:
            t = normalize_rows(t)
    return q @ t.T


def mask_excluded(scores: torch.Tensor, exclude_idx: torch.Tensor) -> torch.Tensor:
    """Scores of excluded items set to -inf.  ``exclude_idx`` (U, H) holds
    1-based item indices (column j scores item j + 1); 0 is padding, and
    it and any index past the catalog mask nothing."""
    u, n = scores.shape
    cols = torch.where((exclude_idx > 0) & (exclude_idx <= n), exclude_idx.long() - 1, n)
    padded = torch.cat([scores, scores.new_zeros(u, 1)], dim=1)
    padded.scatter_(1, cols, float("-inf"))
    return padded[:, :n]


def topk_items(
    queries: torch.Tensor,
    item_embeddings: torch.Tensor,
    k: int,
    *,
    exclude_idx: torch.Tensor | None = None,
    metric: str = "cosine",
    items_prenormalized: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with exclusion: (scores (U, k) f32, item_idx (U, k)
    int32, 1-based)."""
    scores = score_items(
        queries, item_embeddings, metric=metric, items_prenormalized=items_prenormalized
    )
    if exclude_idx is not None:
        scores = mask_excluded(scores, exclude_idx)
    if use_two_stage(scores.shape[0], scores.shape[-1], k):
        top_cols = _two_stage_topk(scores, k)
    else:
        top_cols = top_k_columns(scores, k)
    return scores.gather(-1, top_cols), (top_cols + 1).to(torch.int32)


def _order_keys(scores: torch.Tensor) -> torch.Tensor:
    """Distinct int64 keys of ``scores`` (..., n) that order as the scores,
    ties by column: the high word the score's f32 bits mapped to an
    order-preserving int32 (so -0.0 ranks below +0.0, as in
    ``lax.top_k``), the low word ``n - 1 - column``."""
    n = scores.shape[-1]
    bits = scores.float().contiguous().view(torch.int32)
    # negative floats: flip the magnitude bits so that larger means larger
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    low = n - 1 - torch.arange(n, device=scores.device, dtype=torch.int64)
    return (ordered << 32) | low


def top_k_columns(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(U, k) int64 columns of each row's k largest scores, highest first
    and, among equal scores, lower column first (``lax.top_k``'s order):
    ``torch.topk`` over :func:`_order_keys`."""
    return torch.topk(_order_keys(scores), k, dim=-1).indices


_TWO_STAGE_BLOCKS = 16


def use_two_stage(num_queries: int, num_items: int, k: int) -> bool:
    """JAX's gate of the blocked top-k, on the static shape: one query, and
    a catalog of at least 4 candidates per block per result
    (``num_items >= 16 * k * 4``), so the merge stage stays far smaller
    than the row.  Both routes give the same result; this one is JAX's
    batch-1 latency choice, kept whatever the card's times (``PERF.md``)."""
    return num_queries == 1 and num_items >= _TWO_STAGE_BLOCKS * k * 4


def _two_stage_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The columns of :func:`top_k_columns`, in two stages: the top-k keys
    of each of 16 blocks of the row (padded with keys below every score's),
    then the top-k of those 16 * k candidates.  Every global top-k key is a
    top-k key of its block, and the keys are distinct, so the result is the
    direct top-k's, ties and -0.0 included."""
    u, n = scores.shape
    nb = _TWO_STAGE_BLOCKS
    keys = _order_keys(scores)
    pad = (-n) % nb
    if pad:
        keys = torch.cat([keys, keys.new_full((u, pad), torch.iinfo(torch.int64).min)], dim=1)
    block_top = torch.topk(keys.view(u, nb, -1), k, dim=-1).values
    top = torch.topk(block_top.reshape(u, nb * k), k, dim=-1).values
    return n - 1 - (top & 0xFFFFFFFF)
