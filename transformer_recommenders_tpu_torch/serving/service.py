"""Serving services: Model / ItemIndex / UserIndex / composite Service.

Counterpart of ``transformer_recommenders_tpu/serving/service.py``: the
same four services and nine HTTP APIs (``recommend_with_query``,
``recommend_with_item_id``, ``recommend_with_user_id``, ``embed_query``,
``search_item_text``, ``item_id``, ``user_id``, ``model_name``,
``model_version``) on the dependency-free ASGI layer, with the encoder and
the retrieval index on a torch device (``cuda`` unless the caller passes
``device="cpu"``).  The IO schemas are dataclasses with hand-written
validation (the JAX package uses pydantic); a malformed field raises
``TypeError``/``ValueError``, which the ASGI layer answers with 400.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import numpy as np

from transformer_recommenders_tpu_torch import resolve_device, tracing
from transformer_recommenders_tpu_torch.configs import IndexConfig
from transformer_recommenders_tpu_torch.index import INDEX_BACKENDS
from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel
from transformer_recommenders_tpu_torch.params import (
    INDEX_PATH,
    ITEMS_TABLE_NAME,
    MODEL_NAME,
    TOP_K,
    TRANSFORMER_PATH,
    USERS_TABLE_NAME,
)
from transformer_recommenders_tpu_torch.serving.asgi import JSONApp, NotFound

# -- IO schemas ---------------------------------------------------------------


def _str(name: str, value: Any) -> str:
    if not isinstance(value, str):
        msg = f"{name} must be a string, got {type(value).__name__}"
        raise TypeError(msg)
    return value


def _float(name: str, value: Any) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        msg = f"{name} must be a number, got {type(value).__name__}"
        raise TypeError(msg)
    return float(value)


def _int(name: str, value: Any) -> int:
    if isinstance(value, float) and value.is_integer():
        value = int(value)
    if isinstance(value, bool) or not isinstance(value, int):
        msg = f"{name} must be an integer, got {value!r}"
        raise TypeError(msg)
    return value


def _list(name: str, value: Any, item) -> list | None:
    if value is None:
        return None
    if not isinstance(value, list):
        msg = f"{name} must be a list, got {type(value).__name__}"
        raise TypeError(msg)
    return [item(f"{name}[{i}]", v) for i, v in enumerate(value)]


def _floats(name: str, value: Any) -> list[float]:
    if not isinstance(value, list):
        msg = f"{name} must be a list, got {type(value).__name__}"
        raise TypeError(msg)
    return _list(name, value, _float)


def _fields(cls, payload: Any) -> dict[str, Any]:
    """The payload's known keys (unknown keys are ignored)."""
    if not isinstance(payload, dict):
        msg = f"{cls.__name__} must be a JSON object"
        raise TypeError(msg)
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in payload.items() if k in names}


class _Schema:
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Activity(_Schema):
    item_id: list[str]
    item_text: list[str]


@dataclasses.dataclass
class Query(_Schema):
    embedding: list[float] | None = None
    item_ids: list[str] | None = None
    item_texts: list[str] | None = None
    input_embeds: list[list[float]] | None = None
    exclude_item_ids: list[str] | None = None
    top_k: int = TOP_K

    @classmethod
    def from_dict(cls, payload: Any) -> Query:
        f = _fields(cls, payload)
        return cls(
            embedding=_list("embedding", f.get("embedding"), _float),
            item_ids=_list("item_ids", f.get("item_ids"), _str),
            item_texts=_list("item_texts", f.get("item_texts"), _str),
            input_embeds=_list("input_embeds", f.get("input_embeds"), _floats),
            exclude_item_ids=_list("exclude_item_ids", f.get("exclude_item_ids"), _str),
            top_k=_int("top_k", f.get("top_k", TOP_K)),
        )


@dataclasses.dataclass
class UserQuery(_Schema):
    user_id: str = "0"
    user_text: str = ""
    history: Activity | None = None
    target: Activity | None = None


@dataclasses.dataclass
class ItemQuery(_Schema):
    item_id: str = "0"
    item_text: str = ""
    embedding: list[float] | None = None


@dataclasses.dataclass
class ItemCandidate(_Schema):
    item_id: str
    item_text: str
    score: float


# -- services ------------------------------------------------------------------


class MicroBatcher:
    """Dynamic request batching: concurrent calls within a small window
    coalesce into ONE call of ``fn`` over the list of their items, so the
    device sees large batches even when clients send single queries.

    The threaded HTTP server runs each request on its own thread with its
    own event loop, so waiters of one window live on DIFFERENT loops: the
    queue is lock-guarded and each future is resolved on its own loop via
    ``call_soon_threadsafe``."""

    def __init__(self, fn, *, max_batch: int = 64, window_ms: float = 2.0,
                 span: str = "encode") -> None:
        import threading

        self._fn = fn
        self._max_batch = max_batch
        self._window = window_ms / 1000.0
        self._span = span  # trace-span name for the shared fn time
        self._lock = threading.Lock()
        self._queue: list = []
        self._flusher = None
        # each timer is armed for one batch generation; a stale timer from
        # an already flushed window never flushes a fresh batch early
        self._generation = 0

    async def submit(self, item):
        import asyncio

        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        with self._lock:
            self._queue.append((item, fut, loop))
            flush_now = len(self._queue) >= self._max_batch
            if not flush_now and self._flusher is None:
                self._flusher = loop.call_later(self._window, self._flush, self._generation)
        if flush_now:
            self._flush()
        wait_span = "batch_wait" if self._span == "encode" else f"{self._span}_wait"
        with tracing.span(wait_span):
            res, fn_s, batch_n = await fut
        tr = tracing.CURRENT_TRACE.get()
        if tr is not None:
            # the batched fn is SHARED by batch_n waiters: each reports its
            # amortized share to the aggregate, the full time on its header
            tr.add(self._span, fn_s / batch_n)
            tr.add_header_only(f"{self._span}_batch", fn_s)
            tr.add_metric(
                f"{self._span}_batch_size" if self._span != "encode" else "batch_size", batch_n
            )
        return res

    def _flush(self, generation: int | None = None) -> None:
        with self._lock:
            if generation is not None and generation != self._generation:
                return  # stale timer from a window that was already flushed
            batch, self._queue = self._queue, []
            self._flusher = None
            self._generation += 1
        if not batch:
            return
        items = [item for item, _, _ in batch]
        import time

        t0 = time.perf_counter()
        try:
            results = self._fn(items)
            error = None
        except Exception as exc:  # noqa: BLE001 — propagate to every waiter
            results, error = [None] * len(batch), exc
        fn_s = time.perf_counter() - t0

        def resolve(fut, res) -> None:
            if fut.done():
                return
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result((res, fn_s, len(batch)))

        for (_, fut, floop), res in zip(batch, results):
            try:
                floop.call_soon_threadsafe(resolve, fut, res)
            except RuntimeError:
                pass  # owning loop already closed (client gone)


class ModelService:
    """Trained-encoder service; ``embed`` is the batched encoder API."""

    def __init__(self, artifact_dir: str | pathlib.Path, *, device=None) -> None:
        self.model = RecommenderModel.load(
            pathlib.Path(artifact_dir) / TRANSFORMER_PATH, device=device
        )
        self.embed_dim = self.model.config.resolved_input_dim
        self.batcher = MicroBatcher(lambda qs: self.embed(qs))

    def max_seq_length(self) -> int:
        return self.model.max_seq_length

    def embed(self, queries: list[Query]) -> list[Query]:
        """Pad variable-length ``input_embeds`` to one (B, S, D) batch (B a
        power of two, so the device sees few shapes), run one forward,
        write back ``embedding``.

        Under bf16 on the card a query's embedding does not depend on the
        batch it is encoded in: the input projection's product
        (``models/transformer._dense``, the kernel of ``ops/dense.py``)
        sums each row in one order whatever the row count, and for the
        flagship on an H100 no query encoded in a batch of 64 or 256
        rather than alone moved (``tools/batch_invariance.py``).  The
        plain products (f32 configurations) are cuBLAS's, picked by the
        row count B * S, so their sums' last bit can move with the batch;
        recommendation scores stay within 2**-10 (``chip_smoke.py``'s
        ``BURST_SCORE_TOL``)."""
        s = self.max_seq_length()
        b = 1 << (len(queries) - 1).bit_length() if queries else 1
        batch = np.zeros((b, s, self.embed_dim), np.float32)
        for i, query in enumerate(queries):
            if query.input_embeds is not None:
                window = np.asarray(query.input_embeds, np.float32)[-s:]
                batch[i, : len(window)] = window
        out = self.model(item_embeds=batch)
        embeddings = out["sentence_embedding"][: len(queries)].cpu().numpy()
        for query, emb in zip(queries, embeddings):
            query.embedding = [float(x) for x in emb]
        return queries


class ItemIndexService:
    """Item retrieval service.  With ``mesh``, the device index is
    row-sharded over the mesh (``DeviceIndex(mesh=)``), and every rank
    must search the same queries in the same order."""

    def __init__(self, artifact_dir: str | pathlib.Path, *, device=None, mesh=None) -> None:
        config = IndexConfig(
            index_path=str(pathlib.Path(artifact_dir) / INDEX_PATH),
            table_name=ITEMS_TABLE_NAME,
            id_col="item_id",
            text_col="item_text",
            embedding_col="embedding",
        )
        backend = INDEX_BACKENDS[config.backend]
        kwargs = {"device": device, "mesh": mesh} if config.backend == "device" else {}
        self.index = backend.load(config, **kwargs)
        # frozen INPUT-space embeddings back the query-normalization chain;
        # the index's own embeddings are the query-space retrieval matrix,
        # which differs when a learned projection exists
        table_dir = pathlib.Path(artifact_dir) / INDEX_PATH / ITEMS_TABLE_NAME
        input_emb = table_dir / "input_embeddings.npy"
        self._embeddings = np.load(
            input_emb if input_emb.exists() else table_dir / "embeddings.npy"
        )
        # concurrent requests coalesce into ONE batched device search
        self.search_batcher = MicroBatcher(self._search_many, span="search_device")

    def _search_many(self, queries: list[Query]):
        """Batched search body with per-request failure isolation: a
        malformed embedding gets an exception OBJECT as its result (raised
        again in :meth:`search_batched`), and only valid rows hit the
        device."""
        dim = self.index.embeddings.shape[1]
        results: list = [None] * len(queries)
        valid: list[int] = []
        for i, q in enumerate(queries):
            emb = np.asarray(q.embedding, np.float32)
            if emb.shape != (dim,):
                results[i] = ValueError(
                    f"query embedding must have shape ({dim},), got {emb.shape}"
                )
            elif q.top_k <= 0:
                results[i] = []  # the unbatched path's non-positive top_k guard
            else:
                valid.append(i)
        if valid:
            top_k = max(queries[i].top_k for i in valid)
            batched = self.index.search_batch(
                np.asarray([queries[i].embedding for i in valid], np.float32),
                [queries[i].exclude_item_ids for i in valid],
                top_k=top_k,
            )
            for i, rows in zip(valid, batched):
                results[i] = [
                    ItemCandidate(item_id=r["item_id"], item_text=r["item_text"], score=r["score"])
                    for r in rows[: queries[i].top_k]
                ]
        return results

    async def search_batched(self, query: Query) -> list[ItemCandidate]:
        assert query.embedding is not None
        res = await self.search_batcher.submit(query)
        if isinstance(res, Exception):
            raise res
        return res

    def search(self, query: Query) -> list[ItemCandidate]:
        """The unbatched search: one query, one device search (a batch of
        one, so the two-stage top-k at a large catalog)."""
        assert query.embedding is not None
        results = self.index.search(
            np.asarray(query.embedding, np.float32),
            exclude_item_ids=query.exclude_item_ids,
            top_k=query.top_k,
        )
        return [
            ItemCandidate(item_id=r["item_id"], item_text=r["item_text"], score=r["score"])
            for r in results
        ]

    def search_text(
        self, text: str, exclude_item_ids: list[str] | None = None, top_k: int = TOP_K
    ) -> list[ItemCandidate]:
        """Lexical BM25 search over ``item_text``."""
        results = self.index.search_text(text, exclude_item_ids=exclude_item_ids, top_k=top_k)
        return [
            ItemCandidate(item_id=r["item_id"], item_text=r["item_text"], score=r["score"])
            for r in results
        ]

    def _attach_embedding(self, row: dict[str, Any]) -> ItemQuery:
        pos = self.index.store._pos[row["item_id"]]
        return ItemQuery(
            item_id=row["item_id"],
            item_text=row["item_text"],
            embedding=[float(x) for x in self._embeddings[pos]],
        )

    def get_id(self, item_id: str) -> ItemQuery:
        row = self.index.get_id(item_id)
        if not row:
            msg = f"item not found: item_id = {item_id!r}"
            raise NotFound(msg)
        return self._attach_embedding(row)

    def get_ids(self, item_ids: list[str]) -> dict[str, ItemQuery]:
        items = [self._attach_embedding(r) for r in self.index.get_ids(item_ids)]
        return {item.item_id: item for item in items}


class UserIndexService:
    """User lookup service (host index, no embeddings)."""

    def __init__(self, artifact_dir: str | pathlib.Path) -> None:
        config = IndexConfig(
            index_path=str(pathlib.Path(artifact_dir) / INDEX_PATH),
            table_name=USERS_TABLE_NAME,
            id_col="user_id",
            text_col="user_text",
            embedding_col=None,
            backend="host",
        )
        self.index = INDEX_BACKENDS["host"].load(config)

    def get_id(self, user_id: str) -> UserQuery:
        row = self.index.get_id(user_id)
        if not row:
            msg = f"user not found: user_id = {user_id!r}"
            raise NotFound(msg)
        return UserQuery(
            user_id=row["user_id"],
            user_text=row.get("user_text") or "",
            history=_activity(row.get("history")),
            target=_activity(row.get("target")),
        )


def _activity(struct: dict | None) -> Activity | None:
    if not struct:
        return None
    return Activity(
        item_id=[str(x) for x in struct.get("item_id") or []],
        item_text=[str(x) for x in struct.get("item_text") or []],
    )


class Service:
    """Composite service.  ``device=None`` means ``cuda``; without a card
    that raises (pass ``device="cpu"`` for the plain path).  ``mesh``
    shards the item index (see :class:`ItemIndexService`)."""

    def __init__(self, artifact_dir: str | pathlib.Path, *, device=None, mesh=None) -> None:
        self.artifact_dir = pathlib.Path(artifact_dir)
        self.device = resolve_device(device)
        self.model = ModelService(artifact_dir, device=self.device)
        self.item_index = ItemIndexService(artifact_dir, device=self.device, mesh=mesh)
        self.user_index = UserIndexService(artifact_dir)
        manifest_path = self.artifact_dir / "manifest.json"
        self.manifest = (
            json.loads(manifest_path.read_text())
            if manifest_path.exists()
            else {"name": MODEL_NAME, "version": "unversioned"}
        )

    # -- async APIs ------------------------------------------------------------

    async def recommend_with_query(self, query: Query) -> list[ItemCandidate]:
        with tracing.span("process"):
            query = await self.process_query(query)
        query = await self.embed_query(query)
        # query item ids are always excluded from the results
        query.exclude_item_ids = [*(query.exclude_item_ids or []), *(query.item_ids or [])]
        if query.embedding is None:
            return []
        with tracing.span("search"):
            return await self.item_index.search_batched(query)

    async def process_query(self, query: Query) -> Query:
        """item_ids -> stored frozen embeddings, cut to the last window."""
        if query.item_ids is None or query.input_embeds is not None:
            return query
        items = self.item_index.get_ids(query.item_ids)
        item_ids = [i for i in query.item_ids if i in items]
        query.item_ids = item_ids[-self.model.max_seq_length() :]
        embeddings = [items[i].embedding for i in query.item_ids]
        query.input_embeds = embeddings if embeddings else None
        return query

    async def embed_query(self, query: Query) -> Query:
        if query.input_embeds is None or query.embedding is not None:
            return query
        return await self.model.batcher.submit(query)

    async def recommend_with_item_id(
        self, item_id: str, exclude_item_ids: list[str] | None = None, top_k: int = TOP_K
    ) -> list[ItemCandidate]:
        item = await self.item_id(item_id)
        query = Query(
            item_ids=[item.item_id],
            item_texts=[item.item_text],
            input_embeds=[item.embedding] if item.embedding is not None else None,
            exclude_item_ids=exclude_item_ids,
            top_k=top_k,
        )
        return await self.recommend_with_query(query)

    async def recommend_with_user_id(
        self, user_id: str, exclude_item_ids: list[str] | None = None, top_k: int = TOP_K
    ) -> list[ItemCandidate]:
        user = await self.user_id(user_id)
        item_ids: list[str] = []
        item_texts: list[str] = []
        for activity in (user.history, user.target):
            if activity:
                item_ids += activity.item_id
                item_texts += activity.item_text
        query = Query(
            item_ids=item_ids,
            item_texts=item_texts,
            exclude_item_ids=exclude_item_ids,
            top_k=top_k,
        )
        return await self.recommend_with_query(query)

    async def search_item_text(
        self, text: str, exclude_item_ids: list[str] | None = None, top_k: int = TOP_K
    ) -> list[ItemCandidate]:
        # "search" is the vector search's span; lexical search has its own
        with tracing.span("search_text"):
            return self.item_index.search_text(
                text, exclude_item_ids=exclude_item_ids, top_k=top_k
            )

    async def item_id(self, item_id: str) -> ItemQuery:
        return self.item_index.get_id(item_id)

    async def user_id(self, user_id: str) -> UserQuery:
        return self.user_index.get_id(user_id)

    async def model_version(self) -> str:
        return str(self.manifest["version"])

    async def model_name(self) -> str:
        return str(self.manifest["name"])

    # -- HTTP surface ------------------------------------------------------------

    def to_asgi(self) -> JSONApp:
        app = JSONApp()

        def args(payload: dict) -> dict[str, Any]:
            return {
                "exclude_item_ids": _list(
                    "exclude_item_ids", payload.get("exclude_item_ids"), _str
                ),
                "top_k": _int("top_k", payload.get("top_k", TOP_K)),
            }

        @app.route("recommend_with_query")
        async def _recommend_with_query(payload: dict):
            query = Query.from_dict(payload.get("query") or payload)
            return [r.to_dict() for r in await self.recommend_with_query(query)]

        @app.route("recommend_with_item_id")
        async def _recommend_with_item_id(payload: dict):
            recs = await self.recommend_with_item_id(
                item_id=_str("item_id", payload["item_id"]), **args(payload)
            )
            return [r.to_dict() for r in recs]

        @app.route("recommend_with_user_id")
        async def _recommend_with_user_id(payload: dict):
            recs = await self.recommend_with_user_id(
                user_id=_str("user_id", payload["user_id"]), **args(payload)
            )
            return [r.to_dict() for r in recs]

        @app.route("embed_query")
        async def _embed_query(payload: dict):
            query = Query.from_dict(payload.get("query") or payload)
            query = await self.process_query(query)
            return (await self.embed_query(query)).to_dict()

        @app.route("search_item_text")
        async def _search_item_text(payload: dict):
            recs = await self.search_item_text(
                text=_str("text", payload["text"]), **args(payload)
            )
            return [r.to_dict() for r in recs]

        @app.route("item_id")
        async def _item_id(payload: dict):
            return (await self.item_id(_str("item_id", payload["item_id"]))).to_dict()

        @app.route("user_id")
        async def _user_id(payload: dict):
            return (await self.user_id(_str("user_id", payload["user_id"]))).to_dict()

        @app.route("model_name")
        async def _model_name(payload: dict):
            return await self.model_name()

        @app.route("model_version")
        async def _model_version(payload: dict):
            return await self.model_version()

        return app
