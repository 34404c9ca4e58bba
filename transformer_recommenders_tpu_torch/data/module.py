"""Data module: artifacts -> frozen embeddings -> train sampler + eval
arrays (JAX ``data/module.py``).

``prepare_data`` writes the processed artifacts under a file lock
(``fcntl``), the synthetic generator's or MovieLens' from raw files on
disk; ``setup`` loads the item and user records (``items.json``,
``users.json``), embeds the item texts once and builds the train sampler
from the ``is_train`` users.  Each eval split becomes padded arrays
(:class:`EvalArrays`): the full history for exclusion, the last window
for encoding and the distinct targets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import pathlib

import numpy as np

from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig
from transformer_recommenders_tpu_torch.data import movielens, synthetic
from transformer_recommenders_tpu_torch.data.dataset import SeqData
from transformer_recommenders_tpu_torch.data.embeddings import embed_item_texts
from transformer_recommenders_tpu_torch.params import (
    MOVIELENS_1M_URL,
    MOVIELENS_25M_URL,
    MOVIELENS_100K_URL,
)

SPLIT_FLAGS = {"val": "is_val", "test": "is_test", "predict": "is_predict"}


@dataclasses.dataclass
class EvalArrays:
    """Eval-split arrays for U users.

    ``history_window``/``n_targets`` are dense; full histories and target
    sets are ragged (lists of int32 arrays) and padded per batch by
    :meth:`batch` to power-of-two widths."""

    user_ids: list[str]
    histories: list[np.ndarray]  # ragged full histories (exclusion masks)
    history_window: np.ndarray  # (U, S) int32; last window, for encoding
    target_lists: list[np.ndarray]  # ragged distinct target idx
    n_targets: np.ndarray  # (U,) int32: number of DISTINCT target ids

    def __len__(self) -> int:
        return len(self.user_ids)

    @property
    def history_full(self) -> np.ndarray:
        """Densely padded full histories (small splits and tests)."""
        h_max = max((len(h) for h in self.histories), default=1) or 1
        out = np.zeros((len(self.user_ids), h_max), np.int32)
        for i, h in enumerate(self.histories):
            out[i, : len(h)] = h
        return out

    @property
    def targets(self) -> np.ndarray:
        t_max = max((len(t) for t in self.target_lists), default=1) or 1
        out = np.zeros((len(self.user_ids), t_max), np.int32)
        for i, t in enumerate(self.target_lists):
            out[i, : len(t)] = t
        return out

    def batch(self, lo: int, hi: int, batch_size: int) -> tuple[np.ndarray, ...]:
        """(history_window, history_full, targets, n_targets) for users
        [lo, hi), zero-padded to ``batch_size`` rows and power-of-two
        widths.  Padded users have n_targets == 0 (excluded downstream)."""
        rows = range(lo, hi)
        h_max = _next_pow2(max((len(self.histories[i]) for i in rows), default=1))
        t_max = _next_pow2(max((len(self.target_lists[i]) for i in rows), default=1))
        hw = np.zeros((batch_size, self.history_window.shape[1]), np.int32)
        hf = np.zeros((batch_size, h_max), np.int32)
        tg = np.zeros((batch_size, t_max), np.int32)
        nt = np.zeros((batch_size,), np.int32)
        for j, i in enumerate(rows):
            hw[j] = self.history_window[i]
            h = self.histories[i]
            hf[j, : len(h)] = h
            t = self.target_lists[i]
            tg[j, : len(t)] = t
            nt[j] = self.n_targets[i]
        return hw, hf, tg, nt

    def head(self, n: int) -> EvalArrays:
        """The first ``n`` users."""
        return dataclasses.replace(
            self, user_ids=self.user_ids[:n], histories=self.histories[:n],
            history_window=self.history_window[:n], target_lists=self.target_lists[:n],
            n_targets=self.n_targets[:n],
        )


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


@contextlib.contextmanager
def _file_lock(path: str):
    """An exclusive ``fcntl`` lock on ``path`` (created if missing)."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


class SeqDataModule:
    def __init__(self, config: SeqDataModuleConfig) -> None:
        self.config = SeqDataModuleConfig.from_dict(config)
        self.items: list[dict] | None = None
        self.users: list[dict] | None = None
        self.item_embeddings: np.ndarray | None = None
        self.train_data: SeqData | None = None

    # -- prepare / setup -----------------------------------------------------

    @property
    def dataset_dir(self) -> pathlib.Path:
        return pathlib.Path(self.config.data_dir, self.config.dataset)

    def prepare_data(self, *, overwrite: bool = False) -> None:
        """Write the processed artifacts, one process at a time."""
        data_dir = self.config.data_dir
        pathlib.Path(data_dir).mkdir(parents=True, exist_ok=True)
        with _file_lock(f"{data_dir}.lock"):
            if (self.dataset_dir / "users.json").exists() and not overwrite:
                return
            if self.config.dataset == "synthetic":
                synthetic.prepare_synthetic(
                    data_dir,
                    num_users=self.config.synthetic_num_users,
                    num_items=self.config.synthetic_num_items,
                    num_events=self.config.synthetic_num_events,
                    seed=self.config.seed,
                    overwrite=overwrite,
                )
            else:
                url = {
                    "ml-1m": MOVIELENS_1M_URL,
                    "ml-100k": MOVIELENS_100K_URL,
                    "ml-25m": MOVIELENS_25M_URL,
                }[self.config.dataset]
                if not self.dataset_dir.exists():
                    movielens.download_unpack_data(url, data_dir, overwrite=overwrite)
                movielens.prepare_movielens(data_dir, self.config.dataset, overwrite=overwrite)

    def setup(self) -> None:
        """Load the artifacts and compute the frozen item embeddings once."""
        if self.items is None:
            self.items = movielens.read_records(self.dataset_dir / "items.json")
            self.item_embeddings = embed_item_texts(
                [r["item_text"] for r in self.items],
                embedder=self.config.embedder,
                dim=self.config.embedding_dim,
                model_name=self.config.pretrained_model_name,
            )
        if self.users is None:
            self.users = movielens.read_records(self.dataset_dir / "users.json")
        if self.train_data is None:
            histories = [
                (np.asarray(u["history"]["item_id"]), np.asarray(u["history"]["label"], bool))
                for u in self.users if u["is_train"]
            ]
            self.train_data = SeqData(
                self.config, item_ids=self.item_ids, histories=histories,
                seed=self.config.seed,
            )

    @property
    def item_ids(self) -> list[str]:
        assert self.items is not None
        return [r["item_id"] for r in self.items]

    # -- train side ----------------------------------------------------------

    def train_batches(self, epoch: int, *, drop_remainder: bool = False):
        assert self.train_data is not None, "call setup() first"
        return self.train_data.epoch_batches(
            epoch, self.config.batch_size, drop_remainder=drop_remainder
        )

    # -- eval side -----------------------------------------------------------

    def eval_arrays(self, split: str) -> EvalArrays:
        """Padded arrays for ``split`` in {"val", "test", "predict"}.

        Target set per user = the distinct positive-labeled non-train item
        ids.  ``n_targets`` counts distinct ids even where they are missing
        from the item vocabulary (they can never be hit), as the JAX
        package's string-membership protocol does."""
        assert self.users is not None and self.train_data is not None
        flag = SPLIT_FLAGS[split]
        id2idx = self.train_data.id2idx
        s = self.config.max_seq_length

        user_ids, hists, targets, n_targets = [], [], [], []
        for row in self.users:
            if not row[flag]:
                continue
            user_ids.append(row["user_id"])
            hists.append(np.asarray(
                [id2idx[i] for i in row["history"]["item_id"] if i in id2idx], np.int32))
            t = row["target"]
            distinct = list(dict.fromkeys(i for i, lab in zip(t["item_id"], t["label"]) if lab))
            n_targets.append(len(distinct))
            targets.append(np.asarray([id2idx[i] for i in distinct if i in id2idx], np.int32))

        history_window = np.zeros((len(user_ids), s), np.int32)
        for i, h in enumerate(hists):
            w = h[-s:]
            history_window[i, : len(w)] = w
        return EvalArrays(
            user_ids=user_ids,
            histories=hists,
            history_window=history_window,
            target_lists=targets,
            n_targets=np.asarray(n_targets, np.int32),
        )
