"""Deploy: serving artifact -> composite Service -> in-process smoke tests.

Counterpart of ``transformer_recommenders_tpu/serving/deploy.py``.
:func:`save_artifact` writes the serving artifact for a model and its
item/user records in the JAX trainer's layout (``Trainer.save``)::

    transformer/{config.json,params.npz}
    index_store/items/{records.json,embeddings.npy,input_embeddings.npy,
                       config.json,fts_postings.npz,fts_meta.json}
    index_store/users/{records.json,config.json}
    manifest.json

(the JAX package writes ``records.parquet``; the port reads either).
:func:`main` gets an artifact (the one in ``artifact_dir``; else one
exported from the checkpoint ``ckpt_path`` through a trainer rebuilt from
its ``config.json``; else one from a one-batch synthetic fit), loads it
into ``Service`` and drives all nine APIs through the in-process ASGI
client::

    python -m transformer_recommenders_tpu_torch.serving.deploy [ARTIFACT_DIR] \\
        [--ckpt_path CKPT] [--device cuda|cpu] [--serve --port 3000]
"""

from __future__ import annotations

import argparse
import datetime
import json
import pathlib
import tempfile
from typing import Any

import numpy as np
import torch

from transformer_recommenders_tpu_torch.configs import IndexConfig
from transformer_recommenders_tpu_torch.index.device_index import DeviceIndex
from transformer_recommenders_tpu_torch.index.host_index import HostIndex
from transformer_recommenders_tpu_torch.models.recommender import (
    RecommenderModel,
    retrieval_item_embeddings,
)
from transformer_recommenders_tpu_torch.params import (
    INDEX_PATH,
    ITEMS_TABLE_NAME,
    MODEL_NAME,
    TOP_K,
    TRANSFORMER_PATH,
    USERS_TABLE_NAME,
)
from transformer_recommenders_tpu_torch.serving.asgi import TestClient
from transformer_recommenders_tpu_torch.serving.service import Service


def save_artifact(
    model: RecommenderModel,
    items: list[dict[str, Any]],
    users: list[dict[str, Any]],
    path: str | pathlib.Path,
    *,
    step: int = 0,
) -> None:
    """Persist model + item index + user store + manifest (``step``: the
    train step of the parameters).

    ``items`` are the item records (``item_id``, ``item_text``, ...) in the
    order of the model's item table (``configure_embeddings``); ``users``
    are user records (``user_id``, ``user_text``, ``history``/``target``
    activities of ``item_id``/``item_text`` lists)."""
    if model.item_table is None or model.item_ids is None:
        msg = "call model.configure_embeddings first"
        raise ValueError(msg)
    if [r["item_id"] for r in items] != model.item_ids:
        msg = "items must follow the model's item table order"
        raise ValueError(msg)
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    model.save(path / TRANSFORMER_PATH)
    store = path / INDEX_PATH

    # the retrieval index ranks in the QUERY space (projected embeddings
    # when a learned projection exists)
    with torch.no_grad():
        index_embeddings = retrieval_item_embeddings(
            model.params, model.config, model.item_table
        ).cpu().numpy()
    items_index = DeviceIndex(
        IndexConfig(
            index_path=str(store),
            table_name=ITEMS_TABLE_NAME,
            id_col="item_id",
            text_col="item_text",
            embedding_col="embedding",
            # ship BM25 postings: search_item_text routes this table
            persist_fts=True,
        ),
        device=model.device,
    )
    items_index.index_data(items, embeddings=index_embeddings)
    items_index.save(store)
    # raw frozen inputs back the serving query-normalization chain
    np.save(
        store / ITEMS_TABLE_NAME / "input_embeddings.npy",
        model.item_table[1:].cpu().numpy(),
    )

    users_index = HostIndex(
        IndexConfig(
            index_path=str(store),
            table_name=USERS_TABLE_NAME,
            id_col="user_id",
            text_col="user_text",
            embedding_col=None,
            backend="host",
        )
    )
    users_index.index_data(users)
    users_index.save(store)

    (path / "manifest.json").write_text(
        json.dumps(
            {
                "name": MODEL_NAME,
                "version": datetime.datetime.now(datetime.UTC).strftime("%Y%m%d%H%M%S"),
                "step": int(step),
            },
            indent=2,
        )
    )


def test_service(service: Service, name: str, payload: dict):
    """POST one API through the in-process client."""
    client = TestClient(service.to_asgi())
    response = client.post(name, payload)
    if not response.ok:
        msg = f"{name}: {response.status_code} {response.json()}"
        raise AssertionError(msg)
    return response.json()


def api_requests(service: Service) -> list[tuple[str, dict]]:
    """One request for each of the nine APIs, on the artifact's first item
    and user: ``(name, payload)`` pairs, for a client of a running server."""
    item_id = str(service.item_index.index.store.records[0]["item_id"])
    user_id = str(service.user_index.index.store.records[0]["user_id"])
    item_ids = [str(r["item_id"]) for r in service.item_index.index.store.records[:3]]
    text = service.item_index.get_id(item_id).item_text
    return [
        ("item_id", {"item_id": item_id}),
        ("user_id", {"user_id": user_id}),
        ("recommend_with_item_id", {"item_id": item_id}),
        ("recommend_with_user_id", {"user_id": user_id}),
        ("recommend_with_query", {"query": {"item_ids": [item_id], "top_k": 7}}),
        ("embed_query", {"query": {"item_ids": item_ids}}),
        ("search_item_text", {"text": text, "top_k": TOP_K}),
        ("model_name", {}),
        ("model_version", {}),
    ]


def test_queries(service: Service) -> None:
    """Smoke assertions over all nine APIs."""
    first_item_id = str(service.item_index.index.store.records[0]["item_id"])
    first_user_id = str(service.user_index.index.store.records[0]["user_id"])

    def check(cond: bool, what) -> None:
        if not cond:
            raise AssertionError(what)

    item = test_service(service, "item_id", {"item_id": first_item_id})
    check(item["item_id"] == first_item_id and item["item_text"], item)

    user = test_service(service, "user_id", {"user_id": first_user_id})
    check(user["user_id"] == first_user_id, user)

    recs = test_service(service, "recommend_with_item_id", {"item_id": first_item_id})
    check(len(recs) == TOP_K, f"expected {TOP_K} recs, got {len(recs)}")

    recs = test_service(service, "recommend_with_user_id", {"user_id": first_user_id})
    check(len(recs) == TOP_K, f"expected {TOP_K} recs, got {len(recs)}")

    recs = test_service(
        service, "recommend_with_query", {"query": {"item_ids": [first_item_id], "top_k": 7}}
    )
    check(len(recs) == 7, f"expected 7 recs, got {len(recs)}")
    check(all(r["item_id"] != first_item_id for r in recs), "query item not excluded")

    item_ids = [str(r["item_id"]) for r in service.item_index.index.store.records[:3]]
    emb = test_service(service, "embed_query", {"query": {"item_ids": item_ids}})
    hidden = service.model.model.config.hidden_size
    check(emb["embedding"] is not None and len(emb["embedding"]) == hidden, "embed_query")

    # lexical search: the first item's own text finds it
    hits = test_service(service, "search_item_text", {"text": item["item_text"], "top_k": TOP_K})
    check(any(h["item_id"] == first_item_id for h in hits), hits)

    name = test_service(service, "model_name", {})
    version = test_service(service, "model_version", {})
    check(isinstance(name, str) and isinstance(version, str), (name, version))


def _fast_dev_trainer(work_dir: str, device=None):
    """A one-batch synthetic fit (the JAX package's fast-dev trainer)."""
    from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig, TrainConfig
    from transformer_recommenders_tpu_torch.data.module import SeqDataModule
    from transformer_recommenders_tpu_torch.training.trainer import Trainer

    data_config = SeqDataModuleConfig(
        data_dir=str(pathlib.Path(work_dir) / "data"), dataset="synthetic", embedder="hash",
        embedding_dim=64, max_seq_length=8, batch_size=8, synthetic_num_users=40,
        synthetic_num_items=60, synthetic_num_events=2000,
    )
    config = TrainConfig(
        hidden_size=64, num_hidden_layers=1, num_attention_heads=4, intermediate_size=64,
        max_seq_length=8, compute_dtype="float32", max_epochs=1, limit_train_batches=1,
        eval_batch_size=16, top_k=TOP_K, log_every_n_steps=1000,
        ckpt_dir=str(pathlib.Path(work_dir) / "ckpt"),
    )
    trainer = Trainer(config, SeqDataModule(data_config),
                      log_dir=str(pathlib.Path(work_dir) / "logs"), device=device)
    trainer.fit()
    return trainer


def _trainer_from_checkpoint(ckpt_path: str, device=None):
    """A trainer and datamodule rebuilt from the ``config.json`` beside the
    checkpoint, restored from it."""
    from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig, TrainConfig
    from transformer_recommenders_tpu_torch.data.module import SeqDataModule
    from transformer_recommenders_tpu_torch.training.trainer import Trainer

    ckpt = pathlib.Path(ckpt_path)
    payload = json.loads((ckpt.parent / "config.json").read_text())
    trainer = Trainer(TrainConfig.from_dict(payload["model"]),
                      SeqDataModule(SeqDataModuleConfig.from_dict(payload["data"])),
                      log_dir=str(ckpt.parent / "deploy_logs"), device=device)
    trainer.restore(str(ckpt))
    return trainer


def main(artifact_dir: str | pathlib.Path = "", device=None, *, ckpt_path: str = "") -> Service:
    """Serve an artifact and drive all nine APIs.  Without ``ckpt_path``,
    an artifact already in ``artifact_dir`` is served as it is; otherwise
    the artifact is exported first (into ``artifact_dir``, or a temporary
    directory), from ``ckpt_path`` or a one-batch synthetic fit."""
    with tempfile.TemporaryDirectory() as tmp:
        artifact = pathlib.Path(artifact_dir or pathlib.Path(tmp) / "artifact")
        if ckpt_path or not (artifact / "manifest.json").exists():
            trainer = (_trainer_from_checkpoint(ckpt_path, device) if ckpt_path
                       else _fast_dev_trainer(tmp, device))
            try:
                trainer.save(artifact)
            finally:
                trainer.close()
        service = Service(artifact, device=device)
        test_queries(service)
        print(f"deploy OK: artifact={artifact} device={service.device}")
        return service


def cli_main() -> None:
    parser = argparse.ArgumentParser(prog="xrt-torch-deploy")
    parser.add_argument("artifact_dir", nargs="?", default="")
    parser.add_argument("--ckpt_path", default="", help="checkpoint to export the artifact from")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--serve", action="store_true", help="start the HTTP server")
    parser.add_argument("--port", type=int, default=3000)
    args = parser.parse_args()
    service = main(args.artifact_dir, args.device, ckpt_path=args.ckpt_path)
    if args.serve:
        from transformer_recommenders_tpu_torch.serving.asgi import serve

        serve(service.to_asgi(), port=args.port)


if __name__ == "__main__":
    cli_main()
