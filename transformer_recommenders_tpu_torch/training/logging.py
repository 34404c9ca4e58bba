"""Experiment logging: JSONL + CSV + stdout (JAX ``training/logging.py``).

A host logger writes ``metrics.jsonl`` (one record per log call) and
``metrics.csv``, mirrors a compact line to stdout, and feeds its sinks
(the MLflow file store).  TensorBoard event files are written too where
``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import csv
import json
import pathlib
import time


class MetricsLogger:
    def __init__(
        self,
        log_dir: str | pathlib.Path,
        *,
        echo: bool = True,
        sinks: list | None = None,
    ) -> None:
        """``sinks``: more loggers, each with ``log(metrics, *, step)``
        and ``close()``; the Trainer plugs an
        :class:`~..training.mlflow_logging.MLflowRun` in here."""
        self.log_dir = pathlib.Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a", buffering=1)
        self._csv_path = self.log_dir / "metrics.csv"
        self._csv_fields: list[str] | None = None
        self._echo = echo
        self._t0 = time.time()
        self._tb = _maybe_tensorboard(self.log_dir)
        self.sinks = list(sinks or [])

    def log(self, metrics: dict[str, float], *, step: int, prefix: str = "") -> None:
        record = {
            "step": step,
            "time": round(time.time() - self._t0, 3),
            **{f"{prefix}{k}": _to_float(v) for k, v in metrics.items()},
        }
        self._jsonl.write(json.dumps(record) + "\n")
        self._write_csv(record)
        scalars = {k: v for k, v in record.items() if k not in {"step", "time"}}
        for sink in self.sinks:
            sink.log(scalars, step=step)
        if self._tb is not None:
            for k, v in record.items():
                if k not in {"step", "time"}:
                    self._tb.add_scalar(k, v, step)
        if self._echo:
            shown = {
                k: round(v, 4)
                for k, v in record.items()
                if k not in {"time"} and ("loss/" in k or "retrieval" in k or k == "step")
            }
            print(f"[metrics] {shown}", flush=True)

    def _write_csv(self, record: dict) -> None:
        if self._csv_fields is None:
            self._csv_fields = list(record)
            with open(self._csv_path, "a", newline="") as f:
                csv.DictWriter(f, self._csv_fields).writeheader()
        with open(self._csv_path, "a", newline="") as f:
            csv.DictWriter(f, self._csv_fields, extrasaction="ignore").writerow(record)

    def close(self) -> None:
        """Idempotent: flush the files and close the sinks (the MLflow sink
        marks its run FINISHED here)."""
        if self._jsonl.closed:
            return
        self._jsonl.close()
        for sink in self.sinks:
            sink.close()
        if self._tb is not None:
            self._tb.close()


def _maybe_tensorboard(log_dir: pathlib.Path):
    """TensorBoard writer where ``torch.utils.tensorboard`` imports (it
    needs the ``tensorboard`` package), else None."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:  # noqa: BLE001 — any import failure disables TB
        return None
    try:
        # a deep queue and flush on close: the default queue blocks
        # add_scalar when the writer thread is starved by the producer
        return SummaryWriter(str(log_dir / "tb"), max_queue=100_000,
                             flush_secs=86_400)
    except Exception:  # noqa: BLE001
        return None


def _to_float(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")
