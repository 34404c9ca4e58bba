"""Sequential recommender model: frozen item table + causal encoder.

Counterpart of ``transformer_recommenders_tpu/models/recommender.py``.  The
frozen item table (a zero padding row at index 0, then one row per item)
lives outside the parameters; :class:`RecommenderModel` holds config,
parameters, the table and the id <-> index map on one device, and serves
under ``torch.no_grad``.  The training forwards are differentiable:
:func:`compute_embeds` (queries and the gathered candidate pool) for the
pool objective and the logged loss heads, :func:`compute_query_embeds`
(queries and index vectors) for the table-scored objective.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from transformer_recommenders_tpu_torch import resolve_device, tracing
from transformer_recommenders_tpu_torch.configs import ModelConfig
from transformer_recommenders_tpu_torch.models.transformer import (
    Params,
    _dense,
    compute_dtype,
    init_transformer_params,
    transformer_encode,
    tree_leaves,
    tree_unflatten,
)
from transformer_recommenders_tpu_torch.ops.gather_matmul import gather_rows


def model_forward(
    params: Params,
    cfg: ModelConfig,
    item_table: torch.Tensor | None,
    item_idx: torch.Tensor | None = None,
    *,
    item_embeds: torch.Tensor | None = None,
    dropout_seeds=None,
    table_lookup=None,
    inputs_projected: bool = False,
) -> dict[str, torch.Tensor]:
    """Forward pass from item indices or raw item embeddings: keep the LAST
    ``max_seq_length`` positions, look indices up in the table, encode."""
    lookup = table_lookup or (
        lambda idx: fast_table_lookup(item_table, idx, compute_dtype=cfg.compute_dtype)
    )
    if item_embeds is not None:
        input_embeds = item_embeds[:, -cfg.max_seq_length :, :]
    elif item_idx is not None:
        with tracing.span("embed", request=False):
            input_embeds = lookup(item_idx[:, -cfg.max_seq_length :])
    else:
        msg = "either `item_idx` or `item_embeds` must be provided"
        raise ValueError(msg)
    return transformer_encode(
        params, cfg, input_embeds,
        dropout_seeds=dropout_seeds, inputs_projected=inputs_projected,
    )


def _window(cfg: ModelConfig, history_item_idx, pos_item_idx, neg_item_idx):
    """The history cut to its LAST ``max_seq_length`` positions, and the
    positives and negatives of those positions flattened to (B*S,)."""
    hist_t = history_item_idx[:, -cfg.max_seq_length:]
    b, s = hist_t.shape
    return hist_t, pos_item_idx[:, -s:].reshape(b * s), neg_item_idx[:, -s:].reshape(b * s)


def _projected_table(params: Params, cfg: ModelConfig, item_table: torch.Tensor) -> torch.Tensor:
    """The whole table through the input projection, its padding row
    zeroed (the JAX ``.at[0].set(0.0)``, as a masked write: row 0 gets no
    gradient)."""
    table = _dense(item_table, params["input_proj"], compute_dtype(cfg))
    pad_row = torch.arange(table.shape[0], device=table.device)[:, None] == 0
    return torch.where(pad_row, torch.zeros((), dtype=table.dtype, device=table.device), table)


def _queries(cfg: ModelConfig, out: dict, pos_flat: torch.Tensor):
    """(R, D) f32 queries, ``row_valid`` (attention-valid and the positive
    is not padding) and ``neg_valid`` (attention-valid) of an encoder
    output."""
    b, s = out["attention_mask"].shape
    query = out["token_embeddings"].reshape(b * s, -1)
    if cfg.is_normalized:
        query = query / torch.linalg.vector_norm(query, dim=-1, keepdim=True).clamp(min=1e-12)
    neg_valid = out["attention_mask"].reshape(b * s)
    return query, (pos_flat != 0) & neg_valid, neg_valid


def compute_embeds(
    params: Params,
    cfg: ModelConfig,
    item_table: torch.Tensor,
    history_item_idx: torch.Tensor,
    pos_item_idx: torch.Tensor,
    neg_item_idx: torch.Tensor,
    *,
    dropout_seeds=None,
    table_lookup=None,
    lookup_projected: bool = False,
) -> dict[str, torch.Tensor]:
    """Per-position training queries and the shared candidate pool (JAX
    ``compute_embeds``), differentiable in ``params``.

    History, positive and negative rows are looked up with ONE gather of
    3 * B * S rows.  With an input projection, a catalog of at most that
    many rows is projected whole (its padding row zeroed) and the gather
    reads the projected rows; a larger catalog is gathered first and only
    the gathered rows are projected, the padding rows zeroed again by a
    multiply (the projection's bias would make them nonzero).

    ``table_lookup(idx)`` replaces the gather (the parallel layer passes
    its row-sharded lookup, ``parallel/embedding.py``); it is called once,
    on the 3 * B * S indices.  ``lookup_projected`` says its rows are
    already in the query space; otherwise, with an input projection, the
    encoder projects the history rows and the positives and negatives are
    projected here (JAX's branch, without re-zeroing their padding rows).
    Returns,
    with R = batch * seq flattened rows: ``query`` (R, D) f32,
    ``pos_embed`` and ``neg_pool`` (R, D) in the compute dtype,
    ``row_valid`` and ``neg_valid`` (R,) bool, ``attention_mask`` and
    ``positive_mask`` (B, S) bool."""
    with tracing.span("embed", request=False):
        hist_t, pos_flat, neg_flat = _window(cfg, history_item_idx, pos_item_idx, neg_item_idx)
        b, s = hist_t.shape
        all_idx = torch.cat([hist_t.reshape(-1), pos_flat, neg_flat])
        r = b * s
        if table_lookup is not None:
            rows = table_lookup(all_idx)
            projected = lookup_projected
            pos_embed, neg_pool = rows[r:2 * r], rows[2 * r:]
            if "input_proj" in params and not projected:
                dtype = compute_dtype(cfg)
                pos_embed = _dense(pos_embed, params["input_proj"], dtype)
                neg_pool = _dense(neg_pool, params["input_proj"], dtype)
        else:
            projected = "input_proj" in params
            if projected and item_table.shape[0] > all_idx.numel():
                raw = fast_table_lookup(item_table, all_idx, compute_dtype=cfg.compute_dtype)
                rows = _dense(raw, params["input_proj"], compute_dtype(cfg))
                rows = rows * (all_idx != 0)[:, None].to(rows.dtype)
            else:
                table = _projected_table(params, cfg, item_table) if projected else item_table
                rows = fast_table_lookup(table, all_idx, compute_dtype=cfg.compute_dtype)
            pos_embed, neg_pool = rows[r:2 * r], rows[2 * r:]
    out = model_forward(
        params, cfg, None, item_embeds=rows[:r].reshape(b, s, -1),
        dropout_seeds=dropout_seeds, inputs_projected=projected,
    )
    with tracing.span("encoder", request=False):
        query, row_valid, neg_valid = _queries(cfg, out, pos_flat)
    query = tracing.mark_backward(query, "encoder")
    return {
        "query": query,
        "pos_embed": pos_embed,
        "neg_pool": neg_pool,
        "row_valid": row_valid,
        "neg_valid": neg_valid,
        "attention_mask": out["attention_mask"],
        "positive_mask": row_valid.reshape(b, s),
    }


def compute_query_embeds(
    params: Params,
    cfg: ModelConfig,
    item_table: torch.Tensor,
    history_item_idx: torch.Tensor,
    pos_item_idx: torch.Tensor,
    neg_item_idx: torch.Tensor,
    *,
    dropout_seeds=None,
    table_projected: bool = False,
) -> dict[str, torch.Tensor]:
    """Per-position training queries for a table-scored loss, without
    gathering candidate rows (JAX ``compute_query_embeds``).

    The whole frozen table is projected into the query space once (when
    the model has an input projection) with its padding row zeroed, only
    the history rows are looked up, and the positives and negatives stay
    index vectors for the loss to score against ``table``.
    ``table_projected`` says ``item_table`` is in the query space already
    (the parallel layer projects each row shard and all-gathers them, so
    the projection's gradient flows through the shards).  Returns, with
    R = batch * seq flattened rows: ``query`` (R, D) f32, ``table`` (N, D)
    in the compute dtype, ``pos_idx``/``neg_idx`` (R,), ``row_valid``
    (attention-valid and the positive is not padding) and ``neg_valid``
    (attention-valid)."""
    with tracing.span("embed", request=False):
        hist_t, pos_flat, neg_flat = _window(cfg, history_item_idx, pos_item_idx, neg_item_idx)
        b, s = hist_t.shape
        projected = table_projected or "input_proj" in params
        table_use = item_table
        if "input_proj" in params and not table_projected:
            table_use = _projected_table(params, cfg, item_table)
        hist_rows = fast_table_lookup(table_use, hist_t.reshape(-1),
                                      compute_dtype=cfg.compute_dtype)
    out = model_forward(
        params, cfg, None, item_embeds=hist_rows.reshape(b, s, -1),
        dropout_seeds=dropout_seeds, inputs_projected=projected,
    )
    with tracing.span("encoder", request=False):
        query, row_valid, neg_valid = _queries(cfg, out, pos_flat)
    query = tracing.mark_backward(query, "encoder")
    return {
        "query": query,
        "table": table_use,
        "pos_idx": pos_flat,
        "neg_idx": neg_flat,
        "row_valid": row_valid,
        "neg_valid": neg_valid,
    }


# the JAX package's catalog cap on its bf16 lookup: above it, exact f32 rows
ONEHOT_LOOKUP_MAX_ITEMS = 16384


def fast_table_lookup(
    table: torch.Tensor, idx: torch.Tensor, *, compute_dtype: str
) -> torch.Tensor:
    """Embedding lookup through ``ops.gather_matmul.gather_rows`` (the CUDA
    row-copy kernel on the card), with the JAX package's values: under bf16
    compute and a catalog of at most ``ONEHOT_LOOKUP_MAX_ITEMS`` rows the
    rows come back bf16-rounded (the TPU's one-hot lookup); otherwise they
    are exact rows in the table's dtype (JAX's ``jnp.take``), and their
    gradient flows in that dtype.  The cap matters without an input
    projection: there an f32 catalog's rows go on as they are into the f32
    loss heads."""
    bf16 = compute_dtype == "bfloat16" and table.shape[0] <= ONEHOT_LOOKUP_MAX_ITEMS
    rows = gather_rows(table, idx.reshape(-1), out_dtype=torch.bfloat16 if bf16 else table.dtype)
    return rows.reshape(*idx.shape, table.shape[1])


def retrieval_item_embeddings(
    params: Params, cfg: ModelConfig, item_table: torch.Tensor
) -> torch.Tensor:
    """Catalog matrix in the QUERY (hidden) space, pad row excluded:
    projected when a learned input projection exists, raw otherwise."""
    items = item_table[1:]
    if "input_proj" in params:
        items = _dense(items, params["input_proj"], compute_dtype(cfg))
    return items.float()


def build_item_table(embeddings, *, device=None) -> torch.Tensor:
    """Frozen f32 item table with a zero row prepended as padding index 0."""
    emb = torch.as_tensor(np.asarray(embeddings, np.float32))
    table = torch.cat([torch.zeros_like(emb[:1]), emb], dim=0)
    return table.to(resolve_device(device))


class RecommenderModel:
    """Host-side wrapper (config + params + table + id maps) on one device.

    ``device=None`` means ``cuda``; without a card that raises."""

    def __init__(
        self,
        config: ModelConfig,
        *,
        params: Params | None = None,
        generator: torch.Generator | None = None,
        device=None,
    ) -> None:
        self.config = ModelConfig.from_dict(config)
        self.device = resolve_device(device)
        if params is None:
            generator = generator if generator is not None else torch.Generator().manual_seed(0)
            params = init_transformer_params(generator, self.config, device=self.device)
        self.params = params
        self.item_table: torch.Tensor | None = None
        self.id2idx: dict[str, int] | None = None
        self.item_ids: list[str] | None = None

    @property
    def max_seq_length(self) -> int:
        return self.config.max_seq_length

    def configure_embeddings(self, item_ids: list[str], embeddings: np.ndarray) -> None:
        """Install the frozen item table and id -> idx map (idx 0 = padding)."""
        if self.item_table is None:
            self.item_table = build_item_table(embeddings, device=self.device)
        if self.id2idx is None:
            self.item_ids = list(item_ids)
            self.id2idx = {item_id: i + 1 for i, item_id in enumerate(item_ids)}

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                               dtype=dtype).to(self.device)

    @torch.no_grad()
    def __call__(self, item_idx=None, *, item_embeds=None) -> dict[str, torch.Tensor]:
        if item_idx is not None:
            if self.item_table is None:
                msg = "call configure_embeddings first"
                raise RuntimeError(msg)
            return model_forward(
                self.params, self.config, self.item_table, self._tensor(item_idx, torch.int64)
            )
        if item_embeds is None:
            msg = "either `item_idx` or `item_embeds` must be provided"
            raise ValueError(msg)
        return model_forward(
            self.params, self.config, None, item_embeds=self._tensor(item_embeds, torch.float32)
        )

    def encode(self, item_ids: list[str]) -> torch.Tensor:
        """Pooled embedding of an item-id sequence, silently dropping
        unknown ids; the history is the LAST window, zero-padded at the
        tail to (1, max_seq_length)."""
        if self.id2idx is None:
            msg = "call configure_embeddings first"
            raise RuntimeError(msg)
        idx = [self.id2idx[i] for i in item_ids if i in self.id2idx]
        idx = idx[-self.max_seq_length :]
        arr = np.zeros((1, self.max_seq_length), np.int64)
        arr[0, : len(idx)] = idx
        return self(arr)["sentence_embedding"][0]

    def compute_embeds(self, history_item_idx, pos_item_idx, neg_item_idx, *,
                       dropout_seeds=None) -> dict[str, torch.Tensor]:
        """:func:`compute_embeds` of (B, S) index batches (numpy or
        tensors) on the model's table; differentiable in ``params``."""
        if self.item_table is None:
            msg = "call configure_embeddings first"
            raise RuntimeError(msg)
        return compute_embeds(
            self.params, self.config, self.item_table,
            *(self._tensor(a, torch.int64) for a in (history_item_idx, pos_item_idx,
                                                     neg_item_idx)),
            dropout_seeds=dropout_seeds,
        )

    # -- persistence: config.json + params.npz (leaves p0..pN in sorted-key
    # order, the JAX package's format, so either package loads the other's)

    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "config.json").write_text(self.config.to_json())
        leaves = tree_leaves(self.params)
        np.savez(
            path / "params.npz",
            **{f"p{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)},
        )

    @classmethod
    def load(cls, path: str | pathlib.Path, *, device=None) -> RecommenderModel:
        path = pathlib.Path(path)
        config = ModelConfig.from_json((path / "config.json").read_text())
        dev = resolve_device(device)
        # the structure is a function of the config: a template init (on the
        # CPU, cheap at these sizes) gives the order to unflatten into
        template = init_transformer_params(torch.Generator(), config, device="cpu")
        with np.load(path / "params.npz") as data:
            leaves = [
                torch.from_numpy(data[f"p{i}"].astype(np.float32)).to(dev)
                for i in range(len(data.files))
            ]
        return cls(config, params=tree_unflatten(template, leaves), device=dev)
