"""Train CLI (JAX ``training/cli.py``)::

    xrt-torch-train {fit,validate,test,predict} [--config cfg.yaml] [--model.key value ...]
        [--data.key value ...] [--ckpt_path DIR] [--log_dir DIR] [--save_path DIR]
        [--predict_output FILE] [--print_config] [--device cuda|cpu]

A subcommand, a YAML file (``configs/*.yaml``: ``model`` and ``data``
sections), dotted overrides of any field, ``--ckpt_path`` to resume.  The
run goes on ``--device`` (default ``cuda``, which raises without a card).
Under ``torchrun --nproc_per_node N -m
transformer_recommenders_tpu_torch.training.cli ...`` the N ranks train
over a (data, model) mesh (``--model.mesh.model_axis_size`` sets its model
axis), and rank 0 writes.
``predict --predict_output`` writes one JSON line per user (``user_id``,
``item_ids``, ``scores``), or parquet with those columns where the path
ends in ``.parquet`` and pandas imports.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
from typing import Any

from transformer_recommenders_tpu_torch.configs import (
    parse_yaml,
    parse_yaml_scalar,
    SeqDataModuleConfig,
    TrainConfig,
)
from transformer_recommenders_tpu_torch.data.module import SeqDataModule
from transformer_recommenders_tpu_torch.training.trainer import Trainer


def _apply_overrides(payload: dict, overrides: list[str]) -> dict:
    it = iter(overrides)
    for key in it:
        if not key.startswith("--"):
            msg = f"expected --dotted.key, got {key!r}"
            raise SystemExit(msg)
        key = key[2:]
        raw = next(it, "true")
        node = payload
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_yaml_scalar(raw)
    return payload


def build(args: argparse.Namespace, overrides: list[str]) -> Trainer:
    payload: dict = {"model": {}, "data": {}}
    if args.config:
        payload.update(parse_yaml(pathlib.Path(args.config).read_text()) or {})
    payload = _apply_overrides(payload, overrides)

    train_config = TrainConfig.from_dict(payload.get("model") or {})
    data_config = SeqDataModuleConfig.from_dict(payload.get("data") or {})
    if args.print_config:
        print(json.dumps({"model": dataclasses.asdict(train_config),
                          "data": dataclasses.asdict(data_config)}, indent=2))
        raise SystemExit(0)
    trainer = Trainer(train_config, SeqDataModule(data_config), log_dir=args.log_dir,
                      device=args.device)
    if args.ckpt_path:
        trainer.restore(args.ckpt_path)
    return trainer


def main(argv: list[str] | None = None) -> dict[str, float]:
    parser = argparse.ArgumentParser(prog="xrt-torch-train")
    parser.add_argument(
        "command", choices=["fit", "validate", "test", "predict"], nargs="?", default="fit"
    )
    parser.add_argument("--config", default=None, help="YAML config file")
    parser.add_argument("--ckpt_path", default=None, help="checkpoint dir to resume from")
    parser.add_argument("--log_dir", default="runs/default")
    parser.add_argument("--save_path", default=None, help="artifact dir to export after fit")
    parser.add_argument("--predict_output", default=None,
                        help="JSON Lines (or .parquet) path for predict results")
    parser.add_argument("--print_config", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, overrides = parser.parse_known_args(argv)

    trainer = build(args, overrides)
    try:
        return _dispatch(trainer, args)
    finally:
        trainer.close()  # marks the MLflow run FINISHED


def write_predictions(recs: dict, path: str | pathlib.Path) -> None:
    """One row per user: ``user_id``, ``item_ids``, ``scores``."""
    path = pathlib.Path(path)
    rows = [
        {"user_id": str(u), "item_ids": [str(i) for i in ids], "scores": [float(s) for s in sc]}
        for u, ids, sc in zip(recs["user_ids"], recs["item_ids"], recs["scores"])
    ]
    if path.suffix == ".parquet":
        import pandas as pd  # only where it is installed

        pd.DataFrame(rows).to_parquet(path, index=False)
        return
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def _dispatch(trainer: Trainer, args) -> dict[str, Any]:
    if args.command == "fit":
        result = trainer.fit()
        if args.save_path:
            trainer.save(args.save_path)
    elif args.command == "validate":
        result = trainer.validate()
    elif args.command == "test":
        result = trainer.test()
    else:
        recs = trainer.predict()
        if args.predict_output and trainer.primary:  # rank 0 writes
            write_predictions(recs, args.predict_output)
        result = {"num_users": float(len(recs["user_ids"]))}
    print(json.dumps({k: float(v) for k, v in result.items()}, indent=2))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
