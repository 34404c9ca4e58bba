"""Exact MIPS retrieval index on a torch device.

Counterpart of ``transformer_recommenders_tpu/index/device_index.py``.
The catalog is L2-normalized once at build time for the cosine metric,
kept on the device, and searched by ``ops.topk.topk_items``: one f32
matmul, exclusion masking, ``torch.topk``.  Scores are cosine
similarities.  With a mesh (``parallel.mesh.create_mesh``) the catalog is
row-sharded over its ``model`` axis and searched by
``parallel.topk_sharded.sharded_topk``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from transformer_recommenders_tpu_torch import resolve_device
from transformer_recommenders_tpu_torch.index.store import TableIndex
from transformer_recommenders_tpu_torch.ops.topk import normalize_rows, topk_items
from transformer_recommenders_tpu_torch.parallel.collectives import gather
from transformer_recommenders_tpu_torch.parallel.embedding import place_table
from transformer_recommenders_tpu_torch.parallel.topk_sharded import sharded_topk
from transformer_recommenders_tpu_torch.params import MODEL_AXIS


class DeviceIndex(TableIndex):
    backend = "device"

    def __init__(self, config, *, device=None, mesh=None) -> None:
        """``mesh``: search a catalog row-sharded over the mesh's ``model``
        axis, on the mesh's device.  The search is then SPMD: every rank of
        the mesh calls :meth:`search` and :meth:`search_batch` with the same
        queries, in the same order, and gets the same results."""
        super().__init__(config)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        # (N, D) on self.device; with a mesh this rank's row shard
        self.embeddings: torch.Tensor | None = None

    def _set_embeddings(self, embeddings: np.ndarray) -> None:
        if not self.config.embedding_col:
            return
        emb = torch.from_numpy(np.ascontiguousarray(embeddings)).to(self.device)
        emb = normalize_rows(emb) if self.config.metric == "cosine" else emb
        if self.mesh is not None:
            emb = place_table(emb, self.mesh)
        self.embeddings = emb

    def _embeddings_numpy(self) -> np.ndarray | None:
        if self.embeddings is None:
            return None
        emb = self.embeddings
        if self.mesh is not None:  # every rank's shard (a collective)
            emb = gather(emb, self.mesh.group(MODEL_AXIS))
        return emb[: self._num_items].cpu().numpy()

    def search(
        self,
        embedding: np.ndarray,
        exclude_item_ids: list[str] | None = None,
        top_k: int = 20,
    ) -> list[dict[str, Any]]:
        """Top-k rows by score with id exclusion: a batch of one."""
        return self.search_batch(
            np.asarray(embedding, np.float32)[None, :], [exclude_item_ids], top_k=top_k
        )[0]

    @torch.no_grad()
    def search_batch(
        self,
        embeddings: np.ndarray,
        exclude_item_ids_lists: list[list[str] | None],
        top_k: int = 20,
    ) -> list[list[dict[str, Any]]]:
        """B queries -> ONE device MIPS + top-k.  The batch is padded to a
        power of two and the exclusion lists to one power-of-two width, as
        in the JAX package, so the device sees few distinct shapes."""
        assert self.store is not None and self.embeddings is not None
        b = len(exclude_item_ids_lists)
        queries = np.zeros((1 << max(b - 1, 0).bit_length(), self.embeddings.shape[1]), np.float32)
        queries[:b] = np.asarray(embeddings, np.float32)
        exclude_pos = [
            [self.store._pos[i] + 1 for i in (ids or []) if i in self.store._pos]
            for ids in exclude_item_ids_lists
        ]
        max_w = max((len(p) for p in exclude_pos), default=0)
        width = 1 << max(max_w - 1, 0).bit_length() if max_w else 1
        padded = np.zeros((queries.shape[0], width), np.int64)
        for row, pos in enumerate(exclude_pos):
            padded[row, : len(pos)] = pos
        k = min(top_k, self._num_items)
        if k <= 0:
            return [[] for _ in range(b)]
        queries_t = torch.from_numpy(queries).to(self.device)
        exclude = torch.from_numpy(padded).to(self.device)
        if self.mesh is not None:
            scores, idx = sharded_topk(queries_t, self.embeddings, k, self.mesh,
                                       exclude_idx=exclude, metric=self.config.metric,
                                       num_items=self._num_items, items_prenormalized=True)
        else:
            scores, idx = topk_items(queries_t, self.embeddings, k, exclude_idx=exclude,
                                     metric=self.config.metric, items_prenormalized=True)
        scores = scores[:b].cpu().numpy()
        idx = idx[:b].cpu().numpy()
        out: list[list[dict[str, Any]]] = []
        for row in range(b):
            rows = []
            for s, i in zip(scores[row], idx[row]):
                if not np.isfinite(s):
                    continue
                payload = self.store.row(int(i) - 1)
                payload["score"] = float(s)
                rows.append(payload)
            out.append(rows)
        return out
