"""Retrieval metrics on the device (JAX ``ops/metrics.py``).

The reference protocol for one user: pad the ranked list to ``top_k``
with ``""`` (never relevant), append the targets missing from it at the
end, score the list with strictly decreasing scores, and run the seven
torchmetrics retrieval functionals at ``top_k``.  Since the appended
targets sit past ``top_k``, each metric is a closed-form function of
``rel``, the (top_k,) binary relevance of the ranked list, and
``n_targets``, the number of distinct target ids: this module computes
them for a batch of users at once, as torch tensors on their device.
Users without targets have no metrics (``valid`` is False).

- ``retrieval_average_precision``: mean over the j-th hit within top_k of
  ``j / position_j`` (1-based), torchmetrics' form;
- ``retrieval_auroc`` over the top_k-truncated list; a list without
  positives or without negatives gives 0.0, as torchmetrics' bail-out
  does.  Missed targets rank last in the protocol, so a low recall puts
  AUROC below 0.5;
- ``retrieval_normalized_dcg``: binary gains, the ideal DCG over
  ``min(top_k, n_targets)`` ones.
"""

from __future__ import annotations

import torch


def retrieval_metrics(rel: torch.Tensor, n_targets: torch.Tensor,
                      top_k: int) -> dict[str, torch.Tensor]:
    """Per-user metrics of ``rel`` (U, K) binary relevance (K >= top_k;
    the first ``top_k`` columns count) and ``n_targets`` (U,): a dict of
    (U,) f32 tensors keyed by torchmetrics names, plus ``"valid"``."""
    rel = rel[:, :top_k].float()
    n_targets = n_targets.float()
    k = rel.shape[1]
    positions = torch.arange(1, k + 1, dtype=torch.float32, device=rel.device)[None, :]

    hits = rel.sum(dim=1)
    any_hit = hits > 0
    zero = torch.zeros((), dtype=torch.float32, device=rel.device)

    precision = hits / k
    recall = hits / n_targets.clamp(min=1.0)
    hit_rate = any_hit.float()

    # MRR@k: the reciprocal rank of the first hit (argmax of 0/1 = first 1)
    first_pos = torch.argmax(rel, dim=1) + 1
    mrr = torch.where(any_hit, 1.0 / first_pos.float(), zero)

    discounts = 1.0 / torch.log2(positions + 1.0)
    dcg = (rel * discounts).sum(dim=1)
    ideal_len = torch.minimum(n_targets, torch.full_like(n_targets, float(k)))
    idcg = ((positions <= ideal_len[:, None]).float() * discounts).sum(dim=1)
    ndcg = torch.where(idcg > 0, dcg / idcg.clamp(min=1e-12), zero)

    cum_hits = torch.cumsum(rel, dim=1)
    ap_terms = torch.where(rel > 0, cum_hits / positions, zero)
    ap = torch.where(any_hit, ap_terms.sum(dim=1) / hits.clamp(min=1.0), zero)

    # for each positive, the negatives at later positions
    negs_after = (rel * torch.cumsum((1.0 - rel).flip(1), dim=1).flip(1)).sum(dim=1)
    pairs = hits * (k - hits)
    auroc = torch.where(pairs > 0, negs_after / pairs.clamp(min=1.0), zero)

    return {
        "retrieval_normalized_dcg": ndcg,
        "retrieval_average_precision": ap,
        "retrieval_auroc": auroc,
        "retrieval_precision": precision,
        "retrieval_recall": recall,
        "retrieval_hit_rate": hit_rate,
        "retrieval_reciprocal_rank": mrr,
        "valid": n_targets > 0,
    }


def aggregate_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Mean over the users with targets (the others are skipped)."""
    valid = metrics["valid"].float()
    denom = valid.sum().clamp(min=1.0)
    return {name: (values * valid).sum() / denom
            for name, values in metrics.items() if name != "valid"}


def compute_retrieval_metrics(rec_ids: list[str], target_ids, top_k: int) -> dict[str, float]:
    """One user's metrics on the host, the reference signature: ``{}``
    without targets."""
    if len(target_ids) == 0:
        return {}
    targets = set(target_ids)
    padded = list(rec_ids) + [""] * max(0, top_k - len(rec_ids))
    rel = torch.tensor([[item in targets for item in padded[:top_k]]], dtype=torch.float32)
    out = retrieval_metrics(rel, torch.tensor([len(targets)], dtype=torch.float32), top_k)
    return {k: float(v[0]) for k, v in out.items() if k != "valid"}
