"""MLflow-compatible experiment tracking without the ``mlflow`` package
(JAX ``training/mlflow_logging.py``).

:class:`MLflowRun` writes mlflow's file-store layout::

    <tracking_dir>/<experiment_id>/meta.yaml
    <tracking_dir>/<experiment_id>/<run_id>/meta.yaml
    .../metrics/<key>     one line per point: "<ts_ms> <value> <step>"
    .../params/<key>      single-line value
    .../tags/mlflow.runName
    .../artifacts/<files>

which ``mlflow ui --backend-store-uri <tracking_dir>`` reads as it is.  A
run launched under mlflow is adopted: ``MLFLOW_RUN_ID`` names the run to
log into.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import time
import uuid


def _now_ms() -> int:
    return int(time.time() * 1000)


class MLflowRun:
    """One tracked run in an mlflow file store (package-free)."""

    def __init__(
        self,
        tracking_dir: str | pathlib.Path,
        *,
        experiment_name: str = "default",
        run_name: str | None = None,
        run_id: str | None = None,
    ) -> None:
        self.tracking_dir = pathlib.Path(tracking_dir)
        # run adoption: an externally launched run wins over a fresh one
        run_id = run_id or os.environ.get("MLFLOW_RUN_ID") or None
        self._init_filestore(experiment_name, run_name, run_id)

    # -- backends --------------------------------------------------------

    def _init_filestore(self, experiment_name, run_name, run_id) -> None:
        # experiment id: stable slot per name (0, 1, ... in creation order)
        self.experiment_id = None
        if self.tracking_dir.exists():
            for entry in sorted(self.tracking_dir.iterdir()):
                meta = entry / "meta.yaml"
                if meta.exists() and f"name: {experiment_name}\n" in meta.read_text():
                    self.experiment_id = entry.name
                    break
        if self.experiment_id is None:
            taken = {
                p.name
                for p in (
                    self.tracking_dir.iterdir() if self.tracking_dir.exists() else []
                )
                if p.is_dir()
            }
            n = 0
            while str(n) in taken:
                n += 1
            self.experiment_id = str(n)
        exp_dir = self.tracking_dir / self.experiment_id
        exp_dir.mkdir(parents=True, exist_ok=True)
        if not (exp_dir / "meta.yaml").exists():
            (exp_dir / "meta.yaml").write_text(
                f"artifact_location: {exp_dir.absolute().as_uri()}\n"
                f"creation_time: {_now_ms()}\n"
                f"experiment_id: '{self.experiment_id}'\n"
                f"last_update_time: {_now_ms()}\n"
                "lifecycle_stage: active\n"
                f"name: {experiment_name}\n"
            )

        adopted = run_id is not None and (exp_dir / run_id).is_dir()
        self.run_id = run_id if adopted else (run_id or uuid.uuid4().hex)
        run_dir = exp_dir / self.run_id
        for sub in ("metrics", "params", "tags", "artifacts"):
            (run_dir / sub).mkdir(parents=True, exist_ok=True)
        if not (run_dir / "meta.yaml").exists():
            run_name = run_name or time.strftime("%Y-%m-%dT%H:%M:%S")
            (run_dir / "meta.yaml").write_text(
                f"artifact_uri: {(run_dir / 'artifacts').absolute().as_uri()}\n"
                "end_time: null\n"
                "entry_point_name: ''\n"
                f"experiment_id: '{self.experiment_id}'\n"
                "lifecycle_stage: active\n"
                f"run_id: {self.run_id}\n"
                f"run_name: {run_name}\n"
                f"run_uuid: {self.run_id}\n"
                "source_name: ''\n"
                "source_type: 4\n"
                "source_version: ''\n"
                f"start_time: {_now_ms()}\n"
                "status: 1\n"
                "user_id: ''\n"
            )
            (run_dir / "tags" / "mlflow.runName").write_text(run_name)

    @property
    def run_dir(self) -> pathlib.Path:
        return self.tracking_dir / self.experiment_id / self.run_id

    # -- logging surface ---------------------------------------------------

    def log_metrics(self, metrics: dict[str, float], *, step: int) -> None:
        ts = _now_ms()
        for key, value in metrics.items():
            path = self.run_dir / "metrics" / key
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "a") as f:
                f.write(f"{ts} {float(value)} {step}\n")

    def log_params(self, params: dict[str, object]) -> None:
        """Hyperparameters, flattened to dotted keys."""
        flat = _flatten(params)
        for key, value in flat.items():
            path = self.run_dir / "params" / key
            path.parent.mkdir(parents=True, exist_ok=True)
            if not path.exists():  # mlflow params are write-once
                path.write_text(str(value))

    def log_artifact(self, local_path: str | pathlib.Path) -> None:
        """Copy a file into the run's artifact store."""
        local_path = pathlib.Path(local_path)
        dest = self.run_dir / "artifacts" / local_path.name
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(local_path, dest)

    def end(self, status: str = "FINISHED") -> None:
        meta = self.run_dir / "meta.yaml"
        if meta.exists():
            code = {"FINISHED": 3, "FAILED": 4, "KILLED": 5}.get(status, 3)
            text = meta.read_text()
            text = text.replace("end_time: null", f"end_time: {_now_ms()}")
            text = text.replace("status: 1", f"status: {code}")
            meta.write_text(text)

    # MetricsLogger sink protocol ------------------------------------------

    def log(self, metrics: dict[str, float], *, step: int) -> None:
        self.log_metrics(metrics, step=step)

    def close(self) -> None:
        self.end()


def _flatten(tree: dict, prefix: str = "") -> dict[str, object]:
    out: dict[str, object] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out |= _flatten(value, f"{name}.")
        else:
            out[name] = value
    return out
