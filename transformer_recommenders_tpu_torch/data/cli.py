"""Data CLI (JAX ``data/cli.py``)::

    xrt-torch-data [--data_dir data] [--dataset ml-1m] [--embedder hash] [--overwrite]

MovieLens datasets are processed from the raw files under
``<data_dir>/<dataset>/`` when they are there, and downloaded otherwise.
``--embedder`` picks the item-text embedder that ``setup`` runs (the
config's default, ``sentence-transformer``, needs its model on the
machine).
"""

from __future__ import annotations

import argparse

from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig
from transformer_recommenders_tpu_torch.data.module import SeqDataModule


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="xrt-torch-data")
    parser.add_argument("--data_dir", default="data")
    parser.add_argument(
        "--dataset", default="ml-1m", choices=["ml-1m", "ml-100k", "ml-25m", "synthetic"]
    )
    parser.add_argument("--embedder", default="sentence-transformer",
                        choices=["sentence-transformer", "hash"])
    parser.add_argument("--overwrite", action="store_true")
    args = parser.parse_args(argv)

    dm = SeqDataModule(SeqDataModuleConfig(data_dir=args.data_dir, dataset=args.dataset,
                                           embedder=args.embedder))
    dm.prepare_data(overwrite=args.overwrite)
    dm.setup()
    print(
        f"dataset={args.dataset} items={len(dm.items)} users={len(dm.users)} "
        f"train_rows={len(dm.train_data)}"
    )


if __name__ == "__main__":
    main()
