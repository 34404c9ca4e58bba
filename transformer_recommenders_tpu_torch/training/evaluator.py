"""Batched retrieval evaluation on the device (JAX
``training/evaluator.py``).

Per eval pass the catalog is projected into the query space and
L2-normalized once.  Per batch of users: encode the last window, score the
whole catalog (``ops/topk.score_items``), mask each user's full history
(``mask_excluded``: -inf, so an excluded item never enters the top-k),
take the top-k with ties lower index first (``top_k_columns``, as
``lax.top_k``), compare with the padded target sets and compute the seven
metrics.  Each batch's per-user metrics are reduced on the device to one
small vector; the vectors stay there and are summed and copied to the host
once per pass, as JAX's deferred reduce does.  On the card the encoder
runs the fused-layer and gather kernels; on the CPU their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.data.module import EvalArrays
from transformer_recommenders_tpu_torch.models.recommender import (
    model_forward,
    retrieval_item_embeddings,
)
from transformer_recommenders_tpu_torch.ops.metrics import retrieval_metrics
from transformer_recommenders_tpu_torch.ops.topk import (
    mask_excluded,
    normalize_rows,
    score_items,
    top_k_columns,
)


def _device_reduce(metrics: dict[str, torch.Tensor]) -> torch.Tensor:
    """[sum(metric_i * valid) for the sorted names..., sum(valid)], on the
    metrics' device."""
    valid = metrics["valid"].float()
    names = sorted(k for k in metrics if k != "valid")
    return torch.stack([(metrics[k].float() * valid).sum() for k in names] + [valid.sum()])


def _finalize_deferred(names, vecs, stage: str) -> dict[str, float]:
    """Sum the per-batch vectors on the device, copy the sum to the host
    once, and divide by the count of users with targets."""
    if not vecs:
        return {}
    total = torch.stack(vecs).sum(dim=0).cpu().numpy()
    denom = max(float(total[-1]), 1.0)
    return {f"{stage}/{name}": float(v) / denom for name, v in zip(names, total[:-1])}


def make_eval_step(config: TrainConfig):
    """``(prepare_items, eval_step)``: the catalog in the query space,
    normalized, once per pass, and the per-batch step that gives the
    per-user metrics (and, with ``return_recs``, the top-k 1-based item
    indices and their scores)."""

    @torch.no_grad()
    def prepare_items(params, item_table: torch.Tensor) -> torch.Tensor:
        return normalize_rows(retrieval_item_embeddings(params, config, item_table))

    @torch.no_grad()
    def eval_step(params, item_table, items, history_window, history_full, targets, n_targets,
                  *, return_recs: bool = False):
        device = item_table.device

        def put(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int64)

        history_window, history_full, targets = map(put, (history_window, history_full, targets))
        n_targets = put(n_targets)
        queries = model_forward(params, config, item_table, history_window)["sentence_embedding"]
        scores = score_items(queries, items, metric="cosine", items_prenormalized=True)
        scores = mask_excluded(scores, history_full)
        top_cols = top_k_columns(scores, config.top_k)
        top_scores = scores.gather(1, top_cols)
        top_idx = top_cols + 1  # 1-based item idx
        rel = ((top_idx[:, :, None] == targets[:, None, :]) & (targets[:, None, :] > 0)).any(-1)
        metrics = retrieval_metrics(rel, n_targets, config.top_k)
        if return_recs:
            return metrics, top_idx.to(torch.int32), top_scores
        return metrics

    return prepare_items, eval_step


class Evaluator:
    def __init__(self, config: TrainConfig) -> None:
        self.config = config
        self._prepare_items, self._eval_step = make_eval_step(config)

    def run(self, params, item_table: torch.Tensor, arrays: EvalArrays, *,
            stage: str = "val") -> dict[str, float]:
        """Metrics of a split: the mean over the users with at least one
        target, keyed ``{stage}/{name}``.  One host sync per pass."""
        b = self.config.eval_batch_size
        u = len(arrays)
        names, vecs = None, []
        items = self._prepare_items(params, item_table)  # once per pass
        for lo in range(0, u, b):
            hw, hf, tg, nt = arrays.batch(lo, min(lo + b, u), b)
            metrics = self._eval_step(params, item_table, items, hw, hf, tg, nt)
            if names is None:
                names = sorted(k for k in metrics if k != "valid")
            vecs.append(_device_reduce(metrics))
        return _finalize_deferred(names, vecs, stage)

    def recommend_batch(self, params, item_table: torch.Tensor,
                        arrays: EvalArrays) -> tuple[np.ndarray, np.ndarray]:
        """Top-k recommendations for every user of ``arrays``, history
        excluded: (item_idx (U, k) int32 1-based, scores (U, k) f32)."""
        b = self.config.eval_batch_size
        u = len(arrays)
        all_idx, all_scores = [], []
        items = self._prepare_items(params, item_table)
        for lo in range(0, u, b):
            hw, hf, tg, nt = arrays.batch(lo, min(lo + b, u), b)
            _, top_idx, top_scores = self._eval_step(params, item_table, items, hw, hf, tg, nt,
                                                     return_recs=True)
            n_real = min(b, u - lo)
            all_idx.append(top_idx[:n_real])
            all_scores.append(top_scores[:n_real])
        if not all_idx:
            k = self.config.top_k
            return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
        return torch.cat(all_idx).cpu().numpy(), torch.cat(all_scores).cpu().numpy()
