"""Everything a cell names, found by name under a checkout's root: the
cell in ``BENCHMARK.json``, its configuration file, its traffic mix
(``recbench/traffic/<name>.json``) and the driver its ``kind`` names
(``recbench/drivers/<kind>.py``), its limits
(``recbench/limits/<cell>.json``) and the readers of its per-layer metrics
(``recbench/metrics/<metric>.py``, each with ``read(trace)``; where a
metric's name ends in the kind of cell it is read in, as
``step_mfu.train`` and ``step_mfu.recommend``, one reader without that
ending, ``step_mfu.py``, may serve both: which cells report a metric is
its ``workloads`` list).  A new cell,
configuration, traffic mix or metric is new files and entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.PurePath("recbench")


@dataclasses.dataclass
class Spec:
    root: pathlib.Path
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.cell["name"]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path) -> dict:
    return _json(root / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: pathlib.Path, cell_name: str) -> Spec:
    bench = benchmark(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        msg = f"no workload {cell_name!r} in BENCHMARK.json (has {sorted(cells)})"
        raise KeyError(msg)
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    traffic = _json(root / HERE / "traffic" / f"{cell['traffic']}.json")
    limits = _json(root / HERE / "limits" / f"{cell_name}.json")
    return Spec(root=root, cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if applies(m, cell_name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, cell_name)])


def metric(root: pathlib.Path, name: str) -> dict:
    """The per-layer metric ``name``'s entry in BENCHMARK.json."""
    return next(m for m in benchmark(root)["per_layer"] if m["name"] == name)


def _module(path: pathlib.Path, name: str):
    module_spec = importlib.util.spec_from_file_location(
        "recbench_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    sys.modules[module_spec.name] = module
    module_spec.loader.exec_module(module)
    return module


def driver(root: pathlib.Path, kind: str):
    """The module that drives traffic of ``kind`` (its ``Session``)."""
    return _module(root / HERE / "drivers" / f"{kind}.py", f"driver_{kind}")


def reader(root: pathlib.Path, metric: str):
    """``read(trace) -> float | None`` of the per-layer metric ``metric``:
    ``metrics/<metric>.py``, else the shared ``metrics/<metric less its
    last part>.py``."""
    path = root / HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(f"{metric.rsplit('.', 1)[0]}.py")
    return _module(path, f"metric_{metric}").read
