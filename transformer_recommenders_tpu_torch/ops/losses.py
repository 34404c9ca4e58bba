"""In-batch contrastive loss library: the 7 loss heads, the negative mask
with false-negative filtering and hard-negative mining, and the logits
statistics.

Counterpart of ``transformer_recommenders_tpu/ops/losses.py``, in plain
PyTorch as the JAX package computes it in XLA.  The shared negative pool
is one ``(R, D)`` matrix scored with one ``(R, D) @ (D, R)`` product; the
positive is a rowwise dot.  Validity is carried as fixed-shape masks:
``row_valid`` (positions whose positive is real) and ``neg_valid``
(positions in the shared pool).  Every loss is a SUM over valid rows.

Rounding follows the JAX functions: products of mixed dtypes promote as
JAX promotes them, the pool product sums in f32 whatever its operands
(``preferred_element_type=float32``), and the hard-negative top-k ranks
as ``jax.lax.top_k`` does: ties to the lower index, -0.0 below +0.0.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from transformer_recommenders_tpu_torch.configs import LossConfig
from transformer_recommenders_tpu_torch.ops.topk import top_k_columns

_NEG_INF = float("-inf")


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    # torch cosine_similarity clamps each norm at eps=1e-8
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-8)


def weighted_mean(values: torch.Tensor, weights: torch.Tensor, axis: int | None = None
                  ) -> torch.Tensor:
    """Weighted mean with the reference's epsilon: ``sum(v * w / (sum(w) +
    1e-9))``."""
    weights = weights.to(values.dtype)
    dims = tuple(range(values.dim())) if axis is None else axis
    denom = weights.sum(dim=dims, keepdim=True) + 1e-9
    return (values * weights / denom).sum(dim=dims)


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype's values with f32 products and sums
    (a bf16 value is exact in f32)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype).float() @ b.to(dtype).float()


def compute_pair_logits(query: torch.Tensor, pos_embed: torch.Tensor, neg_pool: torch.Tensor, *,
                        similarity: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Positive logits (R,) and shared-pool negative logits (R, N), f32;
    ``similarity`` is ``"dot"`` or ``"cosine"``."""
    if similarity == "cosine":
        query, pos_embed, neg_pool = (_l2_normalize(x) for x in (query, pos_embed, neg_pool))
    pos_logits = (query * pos_embed).sum(dim=-1).float()
    neg_logits = _f32_matmul(query, neg_pool.T)
    return pos_logits, neg_logits


def _top_k_mask(masked: torch.Tensor, k: int) -> torch.Tensor:
    """(R, N) bool, True at each row's ``k`` largest entries in
    ``jax.lax.top_k``'s order: -0.0 below +0.0, and among equal values the
    lower index first (``ops/topk.top_k_columns``, whose keys order the
    f32 bits; a sort of the floats would tie -0.0 with +0.0)."""
    top_idx = top_k_columns(masked, k)
    keep = torch.zeros_like(masked, dtype=torch.bool)
    return keep.scatter(1, top_idx, True)


def negative_mask(cfg: LossConfig, pos_logits: torch.Tensor, neg_logits: torch.Tensor,
                  neg_valid: torch.Tensor) -> torch.Tensor:
    """(R, N) valid-negative mask: pool validity, the false-negative filter
    (a candidate whose logit is not below the positive's is dropped) and,
    with ``num_hard_negatives = k``, only each row's top-k by logit."""
    mask = neg_valid.bool()[None, :].expand(neg_logits.shape[0], -1)
    if cfg.mask_false_negatives:
        mask = mask & (neg_logits < pos_logits[:, None])
    k = cfg.num_hard_negatives
    if 0 < k < neg_logits.shape[1]:
        mask = mask & _top_k_mask(torch.where(mask, neg_logits, _NEG_INF), k)
    return mask


# -- loss heads: (cfg, pos_logits, neg_logits, neg_mask, row_valid) -> a
# scalar summed over valid rows


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def alignment_loss(cfg, pos, neg, mask, row_valid):
    """AlignmentLoss (cosine): sum of ``1 - pos`` over valid rows."""
    return ((1.0 - pos) * row_valid).sum()


def contrastive_loss(cfg, pos, neg, mask, row_valid):
    """ContrastiveLoss (cosine margin): the per-row weighted mean of
    ``relu(neg - 1 + margin)`` over the masked pool."""
    hinge = F.relu(neg - 1.0 + cfg.margin)
    return (weighted_mean(hinge, mask, axis=1) * row_valid).sum()


def alignment_contrastive_loss(cfg, pos, neg, mask, row_valid):
    """AlignmentContrastiveLoss (cosine): alignment plus contrastive."""
    return (alignment_loss(cfg, pos, neg, mask, row_valid)
            + contrastive_loss(cfg, pos, neg, mask, row_valid))


def infonce_loss(cfg, pos, neg, mask, row_valid):
    """InfoNCELoss: cross-entropy over [positive, masked negatives] *
    scale."""
    neg_scaled = torch.where(mask, neg, _NEG_INF) * cfg.scale
    pos_scaled = pos * cfg.scale
    m = torch.maximum(pos_scaled, neg_scaled.amax(dim=1))
    lse = m + torch.log(torch.exp(pos_scaled - m) + torch.exp(neg_scaled - m[:, None]).sum(dim=1))
    return ((lse - pos_scaled) * row_valid).sum()


def nce_loss(cfg, pos, neg, mask, row_valid):
    """NCELoss: BCE-with-logits, the positive labelled 1, the masked pool
    labelled 0 (weighted mean per row)."""
    return ((_softplus(-pos) + weighted_mean(_softplus(neg), mask, axis=1)) * row_valid).sum()


def pairwise_hinge_loss(cfg, pos, neg, mask, row_valid):
    """PairwiseHingeLoss."""
    scores = neg - pos[:, None] * (1.0 - cfg.margin)
    return (weighted_mean(F.relu(scores), mask, axis=1) * row_valid).sum()


def pairwise_logistic_loss(cfg, pos, neg, mask, row_valid):
    """PairwiseLogisticLoss (BPR at margin 0)."""
    scores = neg - pos[:, None] * (1.0 - cfg.margin)
    return (weighted_mean(_softplus(scores), mask, axis=1) * row_valid).sum()


LossFn = Callable[[LossConfig, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]

# name -> (fn, similarity), in the JAX package's order
LOSS_FNS: dict[str, tuple[LossFn, str]] = {
    "AlignmentLoss": (alignment_loss, "cosine"),
    "AlignmentContrastiveLoss": (alignment_contrastive_loss, "cosine"),
    "ContrastiveLoss": (contrastive_loss, "cosine"),
    "InfoNCELoss": (infonce_loss, "dot"),
    "NCELoss": (nce_loss, "dot"),
    "PairwiseHingeLoss": (pairwise_hinge_loss, "dot"),
    "PairwiseLogisticLoss": (pairwise_logistic_loss, "dot"),
}


def compute_losses(cfg: LossConfig, query: torch.Tensor, pos_embed: torch.Tensor,
                   neg_pool: torch.Tensor, row_valid: torch.Tensor, neg_valid: torch.Tensor, *,
                   loss_names: tuple[str, ...] | None = None) -> dict[str, torch.Tensor]:
    """Every (or each named) loss head on logits computed once per
    similarity."""
    names = loss_names if loss_names is not None else tuple(LOSS_FNS)
    row_valid = row_valid.float()
    cached: dict[str, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
    out: dict[str, torch.Tensor] = {}
    for name in names:
        fn, sim = LOSS_FNS[name]
        if sim not in cached:
            pos, neg = compute_pair_logits(query, pos_embed, neg_pool, similarity=sim)
            cached[sim] = (pos, neg, negative_mask(cfg, pos, neg, neg_valid))
        pos, neg, mask = cached[sim]
        out[name] = fn(cfg, pos, neg, mask, row_valid)
    return out


def logits_statistics_moments(cfg: LossConfig, query: torch.Tensor, pos_embed: torch.Tensor,
                              neg_pool: torch.Tensor, row_valid: torch.Tensor,
                              neg_valid: torch.Tensor) -> dict[str, torch.Tensor]:
    """The additive moments (sums, two-pass squared deviations, counts)
    and extrema behind :func:`logits_statistics` over dot-product logits,
    restricted to valid rows and, for the negatives, to the mask."""
    pos, neg = compute_pair_logits(query, pos_embed, neg_pool, similarity="dot")
    rowv = row_valid.float()
    mask = negative_mask(cfg, pos, neg, neg_valid) & row_valid.bool()[:, None]
    maskf = mask.float()

    # the density's denominator: the reference's ``C - 1``, every valid
    # pool position
    num_negatives = neg_valid.float().sum()
    if cfg.num_hard_negatives > 0:
        num_negatives = torch.clamp(num_negatives, max=float(cfg.num_hard_negatives))
    per_row_density = maskf.sum(dim=1) / (num_negatives + 1e-9)

    def moments(prefix, x, w):
        n = w.sum()
        total = (x * w).sum()
        mean = total / n.clamp(min=1.0)
        return {
            f"{prefix}_sum": total,
            f"{prefix}_sse": ((x - mean).square() * w).sum(),
            f"{prefix}_meansq": total.square() / n.clamp(min=1.0),
            f"{prefix}_n": n,
        }

    inf = torch.full((), float("inf"), device=pos.device)
    return {
        "density_num": (per_row_density * rowv).sum(),
        **moments("pos", pos, rowv),
        "pos_min": torch.where(rowv > 0, pos, inf).amin(),
        "pos_max": torch.where(rowv > 0, pos, -inf).amax(),
        **moments("neg", neg, maskf),
        "neg_min": torch.where(mask, neg, inf).amin(),
        "neg_max": torch.where(mask, neg, -inf).amax(),
    }


def finish_logits_statistics(m: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Moments -> the reference's statistics (unbiased std)."""

    def stats(prefix: str) -> dict[str, torch.Tensor]:
        n = m[f"{prefix}_n"]
        safe_n = n.clamp(min=1.0)
        sse = m[f"{prefix}_sse"] + m[f"{prefix}_meansq"] - m[f"{prefix}_sum"].square() / safe_n
        var = sse.clamp(min=0.0) / (n - 1.0).clamp(min=1.0)
        return {
            f"logits/{prefix}/mean": m[f"{prefix}_sum"] / safe_n,
            f"logits/{prefix}/std": torch.sqrt(var),
            f"logits/{prefix}/min": m[f"{prefix}_min"],
            f"logits/{prefix}/max": m[f"{prefix}_max"],
        }

    return {"logits/neg/density": m["density_num"] / m["pos_n"].clamp(min=1.0),
            **stats("pos"), **stats("neg")}


def logits_statistics(cfg: LossConfig, query: torch.Tensor, pos_embed: torch.Tensor,
                      neg_pool: torch.Tensor, row_valid: torch.Tensor, neg_valid: torch.Tensor
                      ) -> dict[str, torch.Tensor]:
    """Negative density and mean/std/min/max of the positive and negative
    logits (the reference's ``LogitsStatistics``)."""
    return finish_logits_statistics(
        logits_statistics_moments(cfg, query, pos_embed, neg_pool, row_valid, neg_valid))


def loss_from_candidates(cfg: LossConfig, name: str, query_embed: torch.Tensor,
                         candidate_embed: torch.Tensor, target: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Loss ``name`` over an explicit ``(B, C, D)`` candidate tensor, the
    target at ``target`` or at ``cfg.target_position`` (``"first"``: column
    0, ``"diagonal"``: column b of row b)."""
    fn, sim = LOSS_FNS[name]
    b, c, _ = candidate_embed.shape
    device = candidate_embed.device
    if target is None:
        if cfg.target_position == "first":
            target = torch.zeros(b, dtype=torch.int64, device=device)
        elif cfg.target_position == "diagonal":
            target = torch.arange(b, device=device)
        else:
            msg = "either `target` or `cfg.target_position` must be provided"
            raise ValueError(msg)
    target = target.long()
    q = _l2_normalize(query_embed) if sim == "cosine" else query_embed
    cand = _l2_normalize(candidate_embed) if sim == "cosine" else candidate_embed
    logits = _f32_matmul(cand, q[:, :, None])[:, :, 0]
    pos_logits = logits.gather(1, target[:, None])[:, 0]
    if cfg.mask_false_negatives:
        mask = logits < pos_logits[:, None]
    else:
        mask = torch.arange(c, device=device)[None, :] != target[:, None]
    k = cfg.num_hard_negatives
    if 0 < k < c:
        mask = mask & _top_k_mask(torch.where(mask, logits, _NEG_INF), k)
    row_valid = torch.ones(b, dtype=torch.float32, device=device)
    return fn(cfg, pos_logits, logits, mask, row_valid)
