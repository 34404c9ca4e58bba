"""Training orchestration: fit / validate / test / predict / save (JAX
``training/trainer.py``).

A plain loop around the port's train steps and evaluator:

- non-logging steps run the hot step (``make_train_step(config,
  full_logs=False)``), or with ``steps_per_dispatch = K > 1`` windows of K
  hot steps as CUDA-graph replays (``training/scan_steps.py``; eager on the
  CPU), fed by a producer thread that samples and stacks the next window
  while the card runs the current one;
- every ``log_every_n_steps`` the logging step runs (``make_train_step``'s
  default, every loss head and statistic), on JAX's cadence: in the
  single-step loop the step that reaches the cadence, in the windowed loop
  the last step of a window that reaches it (K - 1 graphed steps, then the
  logging step); the ragged tail of an epoch is one graphed call at its
  length;
- the logged values stay on the device and are copied to the host in one
  transfer per 16 events (and at each epoch's end);
- validation each epoch (and every ``val_check_interval`` steps), early
  stopping and the best checkpoint on ``monitor``, the best weights
  restored at the end; the same parameters are never validated twice;
- ``phase_seconds`` attributes the windowed loop's wall time to host
  sampling, waiting for a window, upload, dispatch, logging and the tail,
  and both loops' to epochs, validation and checkpoints; ``epoch_walls``
  holds each epoch's wall time without its validations, ``val_history``
  each validation's metrics with its epoch, step and the wall seconds
  since the fit began.

The trainer runs on ``device`` (``None`` means ``cuda``, which raises
without a card; the tests pass ``device="cpu"``).

Dropout seeds: one ``train_state.draw_dropout_seeds`` draw per step from a
``torch.Generator`` seeded with ``config.seed`` at the start of ``fit``.
JAX folds ``jax.random.key(seed)`` with the step instead; the two streams
differ by design (the port cannot compute JAX's without JAX), so a fit
with dropout matches JAX's in distribution, not bit for bit.

The mesh path (JAX's multi-chip branch): where the process group that
``torchrun`` describes has more than one rank, or ``config.mesh`` asks for
a model axis above 1, the trainer builds the (data, model) mesh
(``parallel/``).  Every rank draws the same global batches and keeps its
rows; the steps are the sharded ones (``parallel/train.py``), the windows
capture the sharded hot step, and validation, test and predict run
through ``ShardedEvaluator``, whose metrics every rank holds alike, so
early stopping and the best checkpoint decide alike on every rank.  Rank 0
alone writes the logs, the MLflow run, the checkpoints and the saved
artifact; every rank restores.  Launch::

    torchrun --nproc_per_node N -m transformer_recommenders_tpu_torch.training.cli fit ...
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import queue as queue_mod
import threading
import time
import warnings

import numpy as np
import torch

from transformer_recommenders_tpu_torch import resolve_device
from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.data.module import EvalArrays, SeqDataModule
from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel
from transformer_recommenders_tpu_torch.parallel import mesh as pmesh
from transformer_recommenders_tpu_torch.parallel.embedding import place_table
from transformer_recommenders_tpu_torch.parallel.train import make_sharded_train_step, place_state
from transformer_recommenders_tpu_torch.params import DATA_AXIS
from transformer_recommenders_tpu_torch.training import checkpoint as ckpt_lib
from transformer_recommenders_tpu_torch.training import train_state as ts
from transformer_recommenders_tpu_torch.training.evaluator import Evaluator, ShardedEvaluator
from transformer_recommenders_tpu_torch.training.logging import MetricsLogger
from transformer_recommenders_tpu_torch.training.scan_steps import (
    make_scanned_train_steps,
    stack_batches,
)

class Trainer:
    def __init__(
        self,
        config: TrainConfig,
        datamodule: SeqDataModule,
        *,
        log_dir: str | None = None,
        device=None,
    ) -> None:
        self.config = TrainConfig.from_dict(config)
        self.datamodule = datamodule
        self.device = resolve_device(device)
        self.log_dir = pathlib.Path(log_dir or "runs/default")
        # rank 0 alone writes (read from the launcher's environment: the
        # group is joined later, in configure)
        self.primary = pmesh.is_primary()
        sinks = []
        self.mlflow_run = None
        if self.config.use_mlflow and self.primary:
            from transformer_recommenders_tpu_torch.training.mlflow_logging import MLflowRun

            self.mlflow_run = MLflowRun(
                self.config.mlflow_dir or self.log_dir / "mlruns",
                experiment_name=self.config.mlflow_experiment,
            )
            sinks.append(self.mlflow_run)
        self.logger = MetricsLogger(self.log_dir, sinks=sinks) if self.primary else _NoLogger()
        self.model: RecommenderModel | None = None
        self.mesh: pmesh.Mesh | None = None
        # this rank's row shards of the item table and of the catalog
        self._tables: tuple[torch.Tensor, torch.Tensor] | None = None
        self.state: ts.TrainState | None = None
        self._train_step = None  # the logging step
        self._fast_step = None  # the hot step
        self._scan_step = None
        self._host_step: int | None = None
        self._midepoch_validate = None
        self._evaluator: Evaluator | ShardedEvaluator | None = None
        self._seed_gen: torch.Generator | None = None
        # wall seconds per phase of the LAST fit(): host_sample (producer
        # thread), queue_wait (the card waiting for a window), upload,
        # dispatch (the step calls), log (logging steps' transfers and sink
        # writes), tail_dispatch, epoch_wall, validate, checkpoint,
        # final_checkpoint
        self.phase_seconds: dict[str, float] = self._fresh_phases()
        # counts behind the phases: windows, log events (the logging steps,
        # in both loops), log flushes, tail steps
        self.phase_counts: dict[str, int] = {}
        self.epoch_walls: list[float] = []
        # every validation of the LAST fit(): epoch, step, wall_s (since the
        # fit began, the validation included) and the metrics
        self.val_history: list[dict] = []
        # deferred log events: (step, examples, wall_s, device vector)
        self._pending_logs: list = []
        self._pending_log_keys: list[str] | None = None

    @staticmethod
    def _fresh_phases() -> dict[str, float]:
        return {
            k: 0.0
            for k in (
                "host_sample", "queue_wait", "upload", "dispatch", "log",
                "tail_dispatch", "epoch_wall", "validate", "checkpoint",
                "final_checkpoint",
            )
        }

    # -- setup ---------------------------------------------------------------

    def configure(self) -> None:
        """Join the launcher's process group, if any, then build the
        datamodule's artifacts, the model on the device, the mesh where
        there is more than one rank (or a model axis), the train state and
        the steps.  Idempotent."""
        pmesh.maybe_initialize_distributed(self.device)
        dm = self.datamodule
        dm.prepare_data()
        dm.setup()

        emb_dim = dm.item_embeddings.shape[1]
        cfg = self.config
        if cfg.input_dim is None and emb_dim != cfg.hidden_size:
            cfg = cfg.replace(input_dim=emb_dim)  # a learned input projection
        self.config = cfg

        if self.model is None:
            self.model = RecommenderModel(
                cfg, generator=torch.Generator().manual_seed(cfg.seed), device=self.device)
        self.model.configure_embeddings(dm.item_ids, dm.item_embeddings)
        if self.mesh is None and (pmesh.world_size() > 1 or cfg.mesh.model_axis_size > 1):
            self.mesh = pmesh.create_mesh(cfg.mesh, self.device)
            if dm.config.batch_size % self.mesh.shape[DATA_AXIS] != 0:
                msg = (f"batch_size={dm.config.batch_size} must be divisible by the data axis "
                       f"({self.mesh.shape[DATA_AXIS]})")
                raise ValueError(msg)
            table = self.model.item_table
            self._tables = (place_table(table, self.mesh), place_table(table[1:], self.mesh))
        if self.state is None:
            self.state = ts.init_train_state(cfg, self.model.params)
            if self.mesh is not None:
                self.state = place_state(self.state, self.mesh)
                self.model.params = self.state.params
        if self._train_step is None:
            self._train_step = self._make_step(full_logs=True)
        if self._evaluator is None:
            self._evaluator = (Evaluator(cfg) if self.mesh is None else
                               ShardedEvaluator(cfg, self.mesh, self.model.item_table.shape[0] - 1))

    def _make_step(self, *, full_logs: bool):
        if self.mesh is None:
            return ts.make_train_step(self.config, full_logs=full_logs)
        return make_sharded_train_step(self.config, self.mesh, full_logs=full_logs)

    @property
    def _step_table(self) -> torch.Tensor:
        """The table the train steps read: the item table, or this rank's
        row shard of it."""
        return self.model.item_table if self.mesh is None else self._tables[0]

    @property
    def _eval_tables(self):
        return self.model.item_table if self.mesh is None else self._tables

    def close(self) -> None:
        """Close the logger's sinks (marks the MLflow run FINISHED).
        Idempotent."""
        self.logger.close()

    def restore(self, ckpt_path: str) -> dict:
        """Resume from a checkpoint directory."""
        self.configure()
        self.state, meta = ckpt_lib.load_checkpoint(ckpt_path, self.state)
        self.model.params = self.state.params
        self._host_step = meta.get("step", int(self.state.step))
        return meta

    def _dropout_seeds(self) -> list[int]:
        """The next step's dropout site seeds."""
        return ts.draw_dropout_seeds(self._seed_gen, self.config)

    def _to_device(self, batch: dict, *, window: bool = False) -> dict:
        """A host batch (B, S), or a window of them (K, B, S), on the
        device: with a mesh, this rank's rows of the batch dimension."""
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if self.mesh is not None:
                v = v.swapaxes(0, 1) if window else v
                v = pmesh.shard_rows(v, self.mesh)
                v = np.ascontiguousarray(v.swapaxes(0, 1) if window else v)
            out[k] = torch.from_numpy(v).to(self.device)
        return out

    def _save_checkpoint(self, path: pathlib.Path, state, *, epoch: int, metrics: dict) -> None:
        """Rank 0 writes; every rank waits for it."""
        if self.primary:
            ckpt_lib.save_checkpoint(path, state, epoch=epoch, metrics=metrics,
                                     backend=self.config.checkpoint_backend)
        pmesh.barrier()

    # -- fit -----------------------------------------------------------------

    def fit(self) -> dict[str, float]:
        self.configure()
        cfg = self.config
        dm = self.datamodule
        assert self.state is not None and self.model is not None

        monitor_best = -np.inf if cfg.monitor_mode == "max" else np.inf
        patience_left = cfg.early_stopping_patience
        best_ckpt = pathlib.Path(cfg.ckpt_dir) / "best"
        # the configs beside the checkpoints, so deploy can rebuild the
        # trainer and datamodule from a checkpoint alone
        configs = {"model": dataclasses.asdict(cfg), "data": dataclasses.asdict(dm.config)}
        if self.primary:
            best_ckpt.parent.mkdir(parents=True, exist_ok=True)
            (best_ckpt.parent / "config.json").write_text(json.dumps(configs, indent=2))
        if self.mlflow_run is not None:
            self.mlflow_run.log_params(configs)
            self.mlflow_run.log_artifact(best_ckpt.parent / "config.json")
        last_val: dict[str, float] = {}
        self._seed_gen = torch.Generator().manual_seed(cfg.seed)
        t_start = time.time()
        self.phase_seconds = self._fresh_phases()
        self.phase_counts = {}
        self._pending_logs = []
        self._pending_log_keys = None
        self.epoch_walls = []
        self.val_history = []
        examples = 0
        stop = False
        epoch = 0
        best_device_state = None
        last_validated_step = -1  # never score the same parameters twice

        def on_validation(val: dict[str, float], at_epoch: int) -> bool:
            """Monitor, early stopping and the best checkpoint, for epoch-end
            and mid-epoch validations.  True when early stopping fires.  A
            missing monitor raises: a silent NaN would count every epoch
            as an improvement."""
            nonlocal monitor_best, patience_left, best_device_state, last_val
            last_val = val
            self.val_history.append({"epoch": at_epoch, "step": self._host_step,
                                     "wall_s": time.time() - t_start, **val})
            if cfg.monitor not in val:
                msg = (
                    f"monitor metric {cfg.monitor!r} missing from validation "
                    f"results {sorted(val)}; fix TrainConfig.monitor or the "
                    "validation split"
                )
                raise KeyError(msg)
            score = val[cfg.monitor]
            if not np.isfinite(score):
                warnings.warn(
                    f"monitor metric {cfg.monitor!r} is non-finite ({score}) "
                    f"at epoch {at_epoch}; counting as not-improved "
                    f"(patience {patience_left - 1} left)",
                    RuntimeWarning,
                    stacklevel=2,
                )
            improved = np.isfinite(score) and (
                score > monitor_best if cfg.monitor_mode == "max" else score < monitor_best
            )
            if improved:
                monitor_best = score
                patience_left = cfg.early_stopping_patience
                if cfg.checkpoint_every_epoch:
                    t_ck = time.time()
                    self._save_checkpoint(best_ckpt, self.state, epoch=at_epoch, metrics=val)
                    self.phase_seconds["checkpoint"] += time.time() - t_ck
                else:  # a reference to the device state: no transfer
                    best_device_state = (self.state, at_epoch, dict(val))
            else:
                patience_left -= 1
                if patience_left <= 0:
                    return True
            return False

        self._midepoch_validate = None
        if cfg.val_check_interval > 0:

            def midepoch_validate(at_epoch: int) -> bool:
                nonlocal last_validated_step
                self.model.params = self.state.params
                t_val = time.time()
                val = self.validate(stage="val")
                self.phase_seconds["validate"] += time.time() - t_val
                last_validated_step = self._host_step
                self.logger.log(val, step=last_validated_step)
                return on_validation(val, at_epoch)

            self._midepoch_validate = midepoch_validate

        profiler = self._start_profiler()
        try:
            for epoch in range(cfg.max_epochs):
                t_ep = time.perf_counter()
                val_before = self.phase_seconds["validate"]
                if cfg.steps_per_dispatch > 1:
                    stop, examples = self._run_epoch_scanned(epoch, t_start, examples)
                    self._flush_pending_logs()
                else:
                    stop, examples = self._run_epoch(epoch, t_start, examples)
                # mid-epoch validation is already in "validate"
                dt_ep = time.perf_counter() - t_ep
                dt_ep -= self.phase_seconds["validate"] - val_before
                self.phase_seconds["epoch_wall"] += dt_ep
                self.epoch_walls.append(round(dt_ep, 3))

                self.model.params = self.state.params
                cur_step = self._host_step
                if cur_step != last_validated_step:
                    t_val = time.time()
                    val = self.validate(stage="val")
                    self.phase_seconds["validate"] += time.time() - t_val
                    last_validated_step = cur_step
                    self.logger.log(val, step=cur_step)
                    stop = on_validation(val, epoch) or stop
                if cfg.checkpoint_every_epoch:
                    t_ck = time.time()
                    self._save_checkpoint(pathlib.Path(cfg.ckpt_dir) / "last", self.state,
                                          epoch=epoch, metrics=last_val)
                    self.phase_seconds["checkpoint"] += time.time() - t_ck
                if stop:
                    break
        finally:
            self._midepoch_validate = None
            self._stop_profiler(profiler)

        if not cfg.checkpoint_every_epoch:
            t_ck = time.time()
            self._save_checkpoint(pathlib.Path(cfg.ckpt_dir) / "last", self.state, epoch=epoch,
                                  metrics=last_val)
            if best_device_state is not None:
                state, best_epoch, best_val = best_device_state
                self._save_checkpoint(best_ckpt, state, epoch=best_epoch, metrics=best_val)
                self.state = state
            self.phase_seconds["final_checkpoint"] += time.time() - t_ck

        # the best weights (Lightning's ckpt_path="best")
        if cfg.checkpoint_every_epoch and (best_ckpt / "state.npz").exists():
            self.state, _ = ckpt_lib.load_checkpoint(best_ckpt, self.state)
        self.model.params = self.state.params
        return {**last_val,
                "train/examples_per_s": examples / max(time.time() - t_start, 1e-9)}

    def _start_profiler(self):
        """A ``torch.profiler`` session over the fit when ``profile_dir``
        is set."""
        if not self.config.profile_dir:
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        if profiler is None:
            return
        profiler.__exit__(None, None, None)
        out = pathlib.Path(self.config.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(out / "trace.json"))

    def _check_stop(self, t_start: float) -> bool:
        return (0 <= self.config.max_steps <= self._host_step
                or time.time() - t_start > self.config.max_time_seconds)

    def _run_epoch(self, epoch: int, t_start: float, examples: int) -> tuple[bool, int]:
        """One epoch of single-step calls: the hot step, and the logging
        step on the logging cadence.  The step counter lives on the host."""
        cfg = self.config
        if self._host_step is None:
            self._host_step = int(self.state.step)
        if self._fast_step is None:
            self._fast_step = self._make_step(full_logs=False)
        data_ranks = 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]

        batches = _prefetch(_limit(self.datamodule.train_batches(epoch), cfg.limit_train_batches),
                            self._to_device)
        for batch in batches:
            will_log = (self._host_step + 1) % cfg.log_every_n_steps == 0
            step_fn = self._train_step if will_log else self._fast_step
            self.state, logs = step_fn(self.state, self._step_table, batch,
                                       self._dropout_seeds())
            examples += batch["history_item_idx"].shape[0] * data_ranks
            self._host_step += 1
            if will_log:
                logs = self._fetch_log_means(logs)
                logs["train/examples_per_s"] = examples / max(time.time() - t_start, 1e-9)
                self.logger.log(logs, step=self._host_step)
                self.phase_counts["log_events"] = self.phase_counts.get("log_events", 0) + 1
            if (
                self._midepoch_validate is not None
                and self._host_step % cfg.val_check_interval == 0
                and self._midepoch_validate(epoch)
            ):
                return True, examples
            if self._check_stop(t_start):
                return True, examples
        return False, examples

    def _run_epoch_scanned(self, epoch: int, t_start: float, examples: int) -> tuple[bool, int]:
        """One epoch of K-step windows.  A producer thread samples and
        stacks the next windows while the card runs the current one."""
        cfg = self.config
        if self._scan_step is None:
            self._scan_step = make_scanned_train_steps(cfg, mesh=self.mesh)
        if self._host_step is None:
            self._host_step = int(self.state.step)
        k = cfg.steps_per_dispatch

        window_queue: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        done = object()
        stop = threading.Event()
        phases = self.phase_seconds

        def produce() -> None:
            try:
                buf: list[dict] = []
                t0 = time.perf_counter()
                for i, batch in enumerate(self.datamodule.train_batches(epoch)):
                    if 0 <= cfg.limit_train_batches <= i or stop.is_set():
                        break
                    buf.append(batch)
                    if len(buf) == k:
                        stacked = stack_batches(buf)
                        # sampling and stacking only: put() can block on a full queue
                        phases["host_sample"] += time.perf_counter() - t0
                        window_queue.put(("full", stacked, k, _examples(buf)))
                        buf = []
                        t0 = time.perf_counter()
                phases["host_sample"] += time.perf_counter() - t0
                if buf and not stop.is_set():  # the ragged tail
                    window_queue.put(("tail", stack_batches(buf), len(buf), _examples(buf)))
                window_queue.put(done)
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                window_queue.put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            return self._consume_windows(window_queue, done, epoch, t_start, examples)
        finally:
            # an early stop leaves the producer blocked on a full queue: free it
            stop.set()
            while producer.is_alive():
                try:
                    window_queue.get(timeout=0.1)
                except queue_mod.Empty:
                    pass

    def _consume_windows(self, window_queue, done, epoch: int, t_start: float,
                         examples: int) -> tuple[bool, int]:
        """The windowed loop's consumer: each window's upload and graphed
        steps, the logging step where the cadence falls in the window, the
        tail, mid-epoch validation and the stop conditions."""
        cfg = self.config
        k = cfg.steps_per_dispatch
        log_every = max(cfg.log_every_n_steps // k, 1)
        phases, counts = self.phase_seconds, self.phase_counts

        def bump(name: str, n: int = 1) -> None:
            counts[name] = counts.get(name, 0) + n

        table = self._step_table
        while True:
            t0 = time.perf_counter()
            item = window_queue.get()
            phases["queue_wait"] += time.perf_counter() - t0
            if item is done:
                self._flush_pending_logs()
                return False, examples
            if isinstance(item, BaseException):
                raise item
            kind, payload, n_steps, n_examples = item
            seeds = torch.tensor([self._dropout_seeds() for _ in range(n_steps)])
            t0 = time.perf_counter()
            payload = self._to_device(payload, window=True)
            phases["upload" if kind == "full" else "tail_dispatch"] += time.perf_counter() - t0
            if kind == "full":
                will_log = (self._host_step + n_steps) // k % log_every == 0
                graphed = n_steps - 1 if will_log else n_steps
                t0 = time.perf_counter()
                self.state, _ = self._scan_step(
                    self.state, table, {key: v[:graphed] for key, v in payload.items()},
                    seeds[:graphed])
                phases["dispatch"] += time.perf_counter() - t0
                bump("windows")
                examples += n_examples
                self._host_step += n_steps
                if will_log:
                    # the window's last step is the logging step; its logs
                    # stay on the device until the next flush
                    t0 = time.perf_counter()
                    self.state, logs = self._train_step(
                        self.state, table, {key: v[-1] for key, v in payload.items()},
                        seeds[-1].tolist())
                    self._queue_log_event(logs, examples, time.time() - t_start)
                    phases["log"] += time.perf_counter() - t0
                    bump("log_events")
            else:  # the ragged tail: one graphed call at its length
                t0 = time.perf_counter()
                self.state, _ = self._scan_step(self.state, table, payload, seeds)
                examples += n_examples
                self._host_step += n_steps
                phases["tail_dispatch"] += time.perf_counter() - t0
                bump("tail_steps", n_steps)
            if (
                self._midepoch_validate is not None
                and self._host_step // cfg.val_check_interval
                > (self._host_step - n_steps) // cfg.val_check_interval
            ):
                # queued train rows first, so the sinks stay in step order
                self._flush_pending_logs()
                if self._midepoch_validate(epoch):
                    return True, examples
            if self._check_stop(t_start):
                return True, examples

    def _queue_log_event(self, logs: dict, examples: int, wall_s: float) -> None:
        """The logs' per-key means as one vector on the device, queued;
        :meth:`_flush_pending_logs` copies every queued event at once."""
        keys = sorted(logs)
        if self._pending_log_keys is None:
            self._pending_log_keys = keys
        vec = torch.stack([logs[key].float().mean() for key in keys])
        self._pending_logs.append((self._host_step, examples, wall_s, vec))
        if len(self._pending_logs) >= 16:  # bounds what a crash can lose
            self._flush_pending_logs()

    def _flush_pending_logs(self) -> None:
        """Emit every queued log event with ONE device-to-host copy."""
        if not self._pending_logs:
            return
        t0 = time.perf_counter()
        keys = self._pending_log_keys
        rows = torch.stack([v for (_, _, _, v) in self._pending_logs]).cpu().numpy()
        for (step, examples, wall_s, _), row in zip(self._pending_logs, rows):
            means = {key: float(x) for key, x in zip(keys, row)}
            means["train/examples_per_s"] = examples / max(wall_s, 1e-9)
            self.logger.log(means, step=step)
        self._pending_logs = []
        self.phase_seconds["log"] += time.perf_counter() - t0
        self.phase_counts["log_flushes"] = self.phase_counts.get("log_flushes", 0) + 1

    @staticmethod
    def _fetch_log_means(logs: dict) -> dict[str, float]:
        """Per-key means of a dict of device tensors, in one copy."""
        keys = sorted(logs)
        means = torch.stack([logs[key].float().mean() for key in keys]).cpu().numpy()
        return {key: float(v) for key, v in zip(keys, means)}

    # -- eval ----------------------------------------------------------------

    def _limited(self, arrays: EvalArrays, limit: int) -> EvalArrays:
        return arrays.head(limit * self.config.eval_batch_size) if limit >= 0 else arrays

    def validate(self, stage: str = "val") -> dict[str, float]:
        self.configure()
        arrays = self.datamodule.eval_arrays(stage)
        limit = self.config.limit_val_batches if stage == "val" else self.config.limit_test_batches
        return self._evaluator.run(self.model.params, self._eval_tables,
                                   self._limited(arrays, limit), stage=stage)

    def test(self) -> dict[str, float]:
        return self.validate(stage="test")

    def predict(self, split: str = "predict") -> dict[str, np.ndarray]:
        """Top-k recommendations for every user of ``split``, history
        excluded."""
        self.configure()
        arrays = self._limited(self.datamodule.eval_arrays(split),
                               self.config.limit_predict_batches)
        idx, scores = self._evaluator.recommend_batch(self.model.params, self._eval_tables,
                                                      arrays)
        item_ids = np.asarray(self.datamodule.item_ids, object)
        return {
            "user_ids": np.asarray(arrays.user_ids, object),
            "item_idx": idx,
            "item_ids": item_ids[idx - 1],
            "scores": scores,
        }

    # -- artifacts -----------------------------------------------------------

    def save(self, path: str | pathlib.Path) -> None:
        """The serving artifact (``serving/deploy.save_artifact``): the
        model, the item index in the query space, the user store and the
        manifest, which the port's ``Service`` serves.  Rank 0 writes; every
        rank waits for it."""
        from transformer_recommenders_tpu_torch.serving.deploy import save_artifact

        assert self.model is not None
        if not self.primary:
            pmesh.barrier()
            return
        dm = self.datamodule
        save_artifact(self.model, dm.items, dm.users, path,
                      step=int(self.state.step) if self.state is not None else 0)
        pmesh.barrier()


class _NoLogger:
    """The logger of a rank other than 0: it writes nothing."""

    def log(self, metrics, *, step: int, prefix: str = "") -> None:
        pass

    def close(self) -> None:
        pass


def _examples(batches: list[dict]) -> int:
    return sum(b["history_item_idx"].shape[0] for b in batches)


def _limit(iterator, limit: int):
    for i, item in enumerate(iterator):
        if 0 <= limit <= i:
            return
        yield item


def _prefetch(iterator, put, depth: int = 3):
    """Keep ``depth`` batches staged on the device ahead of the loop."""
    staged = collections.deque()
    it = iter(iterator)
    for item in it:
        staged.append(put(item))
        if len(staged) >= depth:
            break
    while staged:
        batch = staged.popleft()
        for item in it:
            staged.append(put(item))
            break
        yield batch

