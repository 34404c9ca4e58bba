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

:class:`ShardedEvaluator` does the same over a (data, model) mesh
(``parallel/``): each batch's users split over ``data``, the history
looked up and the catalog projected by row shard over ``model``, the top-k
sharded (``parallel.topk_sharded``), and the metric sums all-reduced over
``data``, so every rank holds the same means.
"""

from __future__ import annotations

import numpy as np
import torch

from transformer_recommenders_tpu_torch import tracing
from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.data.module import EvalArrays
from transformer_recommenders_tpu_torch.models.recommender import (
    model_forward,
    retrieval_item_embeddings,
)
from transformer_recommenders_tpu_torch.models.transformer import _dense, compute_dtype
from transformer_recommenders_tpu_torch.ops.metrics import retrieval_metrics
from transformer_recommenders_tpu_torch.parallel.collectives import gather, reduce
from transformer_recommenders_tpu_torch.parallel.embedding import sharded_table_lookup
from transformer_recommenders_tpu_torch.parallel.mesh import shard_rows
from transformer_recommenders_tpu_torch.parallel.topk_sharded import sharded_topk
from transformer_recommenders_tpu_torch.params import DATA_AXIS
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
        with tracing.span("eval_step", request=False):
            device = item_table.device

            def put(a):
                return torch.as_tensor(a).to(device=device, dtype=torch.int64)

            history_window, history_full, targets = map(put, (history_window, history_full,
                                                              targets))
            n_targets = put(n_targets)
            queries = model_forward(params, config, item_table,
                                    history_window)["sentence_embedding"]
            with tracing.span("retrieval", request=False):
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


def make_sharded_eval_step(config: TrainConfig, mesh):
    """``(prepare_items, eval_step)`` over the mesh, as
    :func:`make_eval_step`: ``prepare_items(params, items_shard)`` projects
    and normalizes this rank's row shard of the catalog (no padding row)
    once per pass; ``eval_step(params, table_shard, items_shard, ...,
    num_items=)`` encodes this rank's users through the row-sharded
    lookup and ranks the catalog by the sharded top-k."""

    @torch.no_grad()
    def prepare_items(params, items_shard: torch.Tensor) -> torch.Tensor:
        items = items_shard
        if "input_proj" in params:
            items = _dense(items, params["input_proj"], compute_dtype(config))
        return normalize_rows(items.float())

    @torch.no_grad()
    def eval_step(params, table_shard, items, history_window, history_full, targets, n_targets,
                  *, num_items: int, return_recs: bool = False):
        device = table_shard.device

        def put(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int64)

        history_window, history_full, targets = map(put, (history_window, history_full, targets))
        n_targets = put(n_targets)
        queries = model_forward(
            params, config, None, history_window,
            table_lookup=lambda idx: sharded_table_lookup(table_shard, idx, mesh),
        )["sentence_embedding"]
        top_scores, top_idx = sharded_topk(queries, items, config.top_k, mesh,
                                           exclude_idx=history_full, metric="cosine",
                                           num_items=num_items, items_prenormalized=True)
        top_idx = top_idx.long()
        rel = ((top_idx[:, :, None] == targets[:, None, :]) & (targets[:, None, :] > 0)).any(-1)
        metrics = retrieval_metrics(rel, n_targets, config.top_k)
        if return_recs:
            return metrics, top_idx.to(torch.int32), top_scores
        return metrics

    return prepare_items, eval_step


class ShardedEvaluator:
    """:class:`Evaluator` over a (data, model) mesh.  ``tables`` is this
    rank's pair of row shards (``parallel.embedding.place_table``): the
    item table (padding row first) and the catalog without it.  Every rank
    calls :meth:`run` and :meth:`recommend_batch` with the same arrays and
    gets the same results."""

    def __init__(self, config: TrainConfig, mesh, num_items: int) -> None:
        self.config = config
        self.mesh = mesh
        self.num_items = num_items
        self._prepare_items, self._eval_step = make_sharded_eval_step(config, mesh)

    def _batches(self, arrays: EvalArrays):
        """Each batch of ``eval_batch_size`` users (padded to a multiple of
        the data axis), as this rank's rows, with the count of real users."""
        n_data = self.mesh.shape[DATA_AXIS]
        b = self.config.eval_batch_size
        b_pad = -(-b // n_data) * n_data
        u = len(arrays)
        for lo in range(0, u, b):
            batch = arrays.batch(lo, min(lo + b, u), b_pad)
            yield [shard_rows(a, self.mesh) for a in batch], min(b, u - lo)

    def run(self, params, tables, arrays: EvalArrays, *, stage: str = "val") -> dict[str, float]:
        """Metrics of a split: the mean over the users with a target."""
        table_shard, items_shard = tables
        items = self._prepare_items(params, items_shard)
        names, vecs = None, []
        for (hw, hf, tg, nt), _ in self._batches(arrays):
            metrics = self._eval_step(params, table_shard, items, hw, hf, tg, nt,
                                      num_items=self.num_items)
            if names is None:
                names = sorted(k for k in metrics if k != "valid")
            vecs.append(_device_reduce(metrics))
        if not vecs:
            return {}
        total = reduce(torch.stack(vecs).sum(dim=0), self.mesh.group(DATA_AXIS))
        return _finalize_deferred(names, [total], stage)

    def recommend_batch(self, params, tables, arrays: EvalArrays) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`Evaluator.recommend_batch` over the mesh: every rank gets
        every user's recommendations."""
        table_shard, items_shard = tables
        group = self.mesh.group(DATA_AXIS)
        items = self._prepare_items(params, items_shard)
        all_idx, all_scores = [], []
        for (hw, hf, tg, nt), n_real in self._batches(arrays):
            _, top_idx, top_scores = self._eval_step(params, table_shard, items, hw, hf, tg, nt,
                                                     num_items=self.num_items, return_recs=True)
            all_idx.append(gather(top_idx, group)[:n_real])
            all_scores.append(gather(top_scores, group)[:n_real])
        if not all_idx:
            k = self.config.top_k
            return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
        return torch.cat(all_idx).cpu().numpy(), torch.cat(all_scores).cpu().numpy()


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
