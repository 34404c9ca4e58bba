"""Training-example factory: fixed-shape batched sequence sampling (JAX
``data/dataset.py``).

A whole batch is sampled at once on host numpy (or by the native sampler)
and emitted as fixed-shape ``(batch_size, max_seq_length)`` int32 arrays
with trailing zero padding.  Sampling is stateless per (seed, epoch), and
each backend gives the JAX package's batches from the same seed: the numpy
backend draws numpy's ``Generator`` in the JAX order, and the native
backend is the same C++ source.

Sampling semantics:
- item idx are contiguous with 0 reserved for padding;
- histories are trimmed after the last positive label;
- rows with an empty trimmed history are dropped;
- users with histories longer than ``max_seq_length`` are duplicated
  ``ceil(len/max_seq_length)`` times per epoch;
- per row: a sorted sample (without replacement) of at most
  ``max_seq_length`` positions from ``arange(len-1)``: the final event is
  never a query position;
- positive per position: uniform over future positive-labeled events
  within ``pos_lookahead`` (0 = unbounded); 0 when none;
- negatives: uniform without replacement from the items not in the user's
  full history; all items when the complement is empty, and with
  replacement when it is smaller than the sequence.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from transformer_recommenders_tpu_torch.configs import SeqDataConfig


class SeqData:
    """Preprocessed per-user training rows + stateless batch sampler."""

    def __init__(
        self,
        config: SeqDataConfig,
        *,
        item_ids: list[str],
        histories: list[tuple[np.ndarray, np.ndarray]],
        seed: int = 0,
        backend: str = "auto",
    ) -> None:
        """
        Args:
            config: sampling config (max_seq_length, pos_lookahead).
            item_ids: item vocabulary; idx = position + 1 (0 = padding).
            histories: per training user, (item_id array[str], label array[bool])
                in time order — the ``history`` struct from users.parquet.
            seed: base seed for stateless per-epoch sampling.
        """
        self.config = config
        self.seed = seed
        self.id2idx = {item_id: i + 1 for i, item_id in enumerate(item_ids)}
        self.num_items = len(item_ids)

        rows: list[tuple[np.ndarray, np.ndarray]] = []
        for ids, labels in histories:
            labels = np.asarray(labels, bool)
            idx = np.asarray(
                [self.id2idx.get(i, 0) for i in ids], np.int32
            )
            known = idx != 0
            idx, labels = idx[known], labels[known]
            # trim away events after the last positive label
            positive_positions = np.flatnonzero(labels)
            last = positive_positions.max(initial=-1) + 1
            idx, labels = idx[:last], labels[:last]
            if len(idx) == 0:
                continue
            copies = (len(idx) - 1) // config.max_seq_length + 1
            rows.extend([(idx, labels)] * copies)
        self.rows = rows

        # flat row arrays for the native batched sampler (+ its handle).
        # backend="auto" uses the C++ sampler when a toolchain exists and
        # falls back to numpy; "numpy" forces the python path.  Both
        # implement the same sampling distributions; their RNG streams
        # differ (splitmix64 vs numpy Philox), so batches are reproducible
        # per backend but not identical across backends.
        self._native = None
        if backend in ("auto", "native"):
            from transformer_recommenders_tpu_torch.native import load_native_sampler

            self._native = load_native_sampler()
            if self._native is None and backend == "native":
                msg = "native sampler requested but no C++ toolchain available"
                raise RuntimeError(msg)
        if self._native is not None:
            self._offsets = np.zeros(len(rows) + 1, np.int64)
            for i, (idx, _) in enumerate(rows):
                self._offsets[i + 1] = self._offsets[i] + len(idx)
            self._values = np.concatenate(
                [idx for idx, _ in rows] or [np.zeros(0, np.int32)]
            ).astype(np.int32)
            self._labels = np.concatenate(
                [lab for _, lab in rows] or [np.zeros(0, bool)]
            ).astype(np.uint8)

    def __len__(self) -> int:
        return len(self.rows)

    def num_batches(self, batch_size: int) -> int:
        return -(-len(self.rows) // batch_size)

    # -- per-row sampling (reference distribution) --------------------------

    def _sample_row(
        self, rng: np.random.Generator, hist: np.ndarray, labels: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        s = self.config.max_seq_length
        n = len(hist)

        positions = np.arange(n - 1)
        if len(positions) > s:
            positions = np.sort(rng.choice(positions, size=s, replace=False))
        seq_len = len(positions)

        # positives from the future (optionally windowed), positive-labeled
        lookahead = self.config.pos_lookahead
        positives = np.zeros(seq_len, np.int32)
        pos_positions = np.flatnonzero(labels)
        for i, p in enumerate(positions):
            start = p + 1
            end = start + lookahead if lookahead > 0 else n
            lo = np.searchsorted(pos_positions, start)
            hi = np.searchsorted(pos_positions, end)
            if hi > lo:
                positives[i] = hist[pos_positions[lo + rng.integers(hi - lo)]]

        # negatives outside the FULL history (reference data.py:723-747):
        # uniform without replacement from the complement; when the
        # complement is empty fall back to ALL items (still without
        # replacement when possible); with replacement only when the
        # candidate set is smaller than the sequence.
        hist_set = np.unique(hist)
        n_candidates = self.num_items - len(hist_set)
        if n_candidates <= 0:
            if self.num_items >= seq_len:
                negatives = (
                    rng.choice(self.num_items, size=seq_len, replace=False) + 1
                ).astype(np.int32)
            else:
                negatives = rng.integers(
                    1, self.num_items + 1, size=seq_len
                ).astype(np.int32)
        elif n_candidates < seq_len:
            complement = np.setdiff1d(
                np.arange(1, self.num_items + 1, dtype=np.int32), hist_set
            )
            negatives = rng.choice(complement, size=seq_len, replace=True)
        else:
            # true rejection sampling: keep the FIRST occurrence of each
            # accepted draw (i.i.d. uniform draws deduplicated in draw
            # order == uniform without replacement from the complement).
            # NOTE: np.unique alone sorts — truncating a sorted array
            # would bias toward small indices, so order must be restored
            # from the first-occurrence positions.
            negatives = np.empty(0, np.int32)
            while len(negatives) < seq_len:
                draw = rng.integers(1, self.num_items + 1, size=4 * seq_len + 16)
                draw = draw[~np.isin(draw, hist_set)].astype(np.int32)
                cat = np.concatenate([negatives, draw])
                _, first = np.unique(cat, return_index=True)
                negatives = cat[np.sort(first)]
            negatives = negatives[:seq_len]

        return hist[positions], positives, negatives

    # -- epoch iteration -----------------------------------------------------

    def epoch_batches(
        self, epoch: int, batch_size: int, *, drop_remainder: bool = False
    ) -> Iterator[dict[str, np.ndarray]]:
        """Yield shuffled fixed-shape batches for one epoch.

        The final partial batch is zero-padded to ``batch_size`` (padded
        rows have empty histories and are masked out by the loss) unless
        ``drop_remainder``.
        """
        s = self.config.max_seq_length
        if self._native is not None:
            yield from self._native_epoch_batches(epoch, batch_size, drop_remainder)
            return
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, len(self.rows)])
        )
        order = rng.permutation(len(self.rows))
        for lo in range(0, len(order), batch_size):
            chunk = order[lo : lo + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                return
            hist = np.zeros((batch_size, s), np.int32)
            pos = np.zeros((batch_size, s), np.int32)
            neg = np.zeros((batch_size, s), np.int32)
            for b, row_idx in enumerate(chunk):
                h, p, ng = self._sample_row(rng, *self.rows[row_idx])
                hist[b, : len(h)] = h
                pos[b, : len(p)] = p
                neg[b, : len(ng)] = ng
            yield {
                "history_item_idx": hist,
                "pos_item_idx": pos,
                "neg_item_idx": neg,
            }

    def _native_epoch_batches(
        self, epoch: int, batch_size: int, drop_remainder: bool
    ) -> Iterator[dict[str, np.ndarray]]:
        n = len(self.rows)
        order = self._native.shuffled_order(n, self.seed, epoch)
        for lo in range(0, n, batch_size):
            chunk = order[lo : lo + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                return
            if len(chunk) < batch_size:  # pad with out-of-range rows -> zeros
                chunk = np.concatenate(
                    [chunk, np.full(batch_size - len(chunk), -1, np.int64)]
                )
            hist, pos, neg = self._native.sample_batch(
                self._values,
                self._labels,
                self._offsets,
                chunk,
                max_seq=self.config.max_seq_length,
                pos_lookahead=self.config.pos_lookahead,
                num_items=self.num_items,
                seed=self.seed,
                epoch=epoch,
            )
            yield {
                "history_item_idx": hist,
                "pos_item_idx": pos,
                "neg_item_idx": neg,
            }
