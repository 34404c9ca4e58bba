"""One run of one cell:

    python -m recbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (the import, the kernels' build, the
traffic, the weights, the cell's own first steps or calls, the capture)
is timed from the start of this module to the window's start as
``setup_s``.  ``--trace 0`` measures the window and prints the cell's
end-to-end metrics; ``--trace 1`` traces a shorter window with
``torch.profiler`` and prints its per-layer metrics.  Either way, once the
window has closed and the peak memory has been read, the program's state
is freed and the plain reference checks what the window's path produced
(``correct``).  The last line of standard output is the result, one JSON
object; the numbers compared, each beside its limit, are also the last
lines of standard error.  Without a CUDA card (or with fewer cards than
the cell asks for) it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# libraries the port uses must not load JAX by themselves
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "transformer_recommenders_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """What a driver needs of the run: the cell's files, the seed and the
    device, and the set-up clock."""

    root: pathlib.Path
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seeds: dict
    device: object
    phases: dict = dataclasses.field(default_factory=dict)

    def phase(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + now - since
        return now

    def log(self, msg: str) -> None:
        log(msg)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def run(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda") -> dict:
    """One run; returns the result object (the last line's)."""
    import torch

    from recbench import check, spec
    from recbench.traffic import derived_seeds
    from recbench import trace as tracing

    s = spec.load(root, workload)
    dev = torch.device(device)
    ctx = Context(root, s.cell, s.config, s.traffic, seed, derived_seeds(seed), dev)
    ctx.phases["import"] = time.perf_counter() - START
    if dev.type == "cuda":
        from transformer_recommenders_tpu_torch.ops import cuda_build

        t = time.perf_counter()
        built = cuda_build.build_all()
        ctx.phase("build", t)
        log(f"kernels: {len(built)} libraries under {cuda_build.BUILD_DIR}")
        torch.cuda.reset_peak_memory_stats(dev)
    driver = spec.driver(root, s.kind)
    session = driver.Session(ctx)
    setup_s = time.perf_counter() - START
    log("set-up s: " + ", ".join(f"{k} {v:.6f}" for k, v in ctx.phases.items())
        + f"; total {setup_s:.6f}")
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": s.cell["chips"]}
    if trace:
        fn, least = session.traced()
        reduced, host_s = tracing.record(fn, root)
        tr = tracing.Trace(units=reduced["units"], window_s=reduced["window_s"],
                           busy_s=reduced["busy_s"], library_s=reduced["library_s"],
                           span_s=reduced["span_s"], least_s=least(),
                           breakdown=reduced["breakdown"])
        log(f"traced window: {tr.units} units, {reduced['kernel_events']} device events, "
            f"window {tr.window_s:.6f} s (host {host_s:.6f}), busy {tr.busy_s:.6f} s; device s "
            "by library: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(tr.library_s.items()))
            + "; least s: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(tr.least_s.items())))
        for m in s.per_layer:
            value = spec.reader(root, m["name"])(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["attempted"] = tr.units
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        out = session.window(seconds)
        result["attempted"], result["failed"] = out["attempted"], out["failed"]
        values = dict(out["values"], setup_s=setup_s)
        for m in s.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    if dev.type == "cuda":
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    t = time.perf_counter()
    numbers = _check(driver, ctx, session)
    log(f"check: {time.perf_counter() - t:.6f} s")
    ok, table = check.judge(numbers, s.limits["numbers"])
    result["correct"] = ok
    result["device"] = device_info
    if trace:
        result["breakdown"] = tr.breakdown
    result["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                       for k, v in table.items()}
    for k, v in table.items():
        log(f"check {k}: {v['value']!r} limit {v['limit']!r}")
    return result


def _check(driver, ctx, session) -> dict:
    """The numbers compared: the program's state freed, the reference run."""
    inputs = session.inputs
    if session.kind == "train":
        program_out = session.program_out
        session.free()
        return driver.numbers(ctx, inputs, program_out)
    users = driver.sample_users(ctx, inputs, session.answers)
    items, scores = driver.program_answer(session, users)
    session.free()
    return driver.numbers(ctx, inputs, users, items, scores)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = pathlib.Path.cwd()

    import torch

    from recbench import spec

    chips = spec.load(root, args.workload).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"recbench: needs {chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    log(f"card: {_power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run(root, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"recbench: the run loaded {', '.join(found)}; no result")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
