"""The program's own spans in a traced window: device and idle time by the
layer of the program that spends them.

The port (``transformer_recommenders_tpu_torch/tracing.py``), once its
tracing is enabled, opens a profiler range ``xrt.<layer>`` at each layer
boundary (``xrt.steps``, ``xrt.state``, ``xrt.embed``, ``xrt.encoder``,
``xrt.loss``, ``xrt.optimizer``, ``xrt.eval_step``, ``xrt.retrieval``, and
``xrt.<layer>.backward`` where the backward reaches a layer's output) and
labels the nodes of every CUDA graph it captures with the path of the span
that captured them.  :func:`reduce` attributes each device event (kernels,
copies, fills) of the window:

- launched eagerly: to the innermost ``xrt.*`` range open on the
  launching thread when the launch was made (the launch is the runtime
  event that shares the device event's correlation id);
- replayed by a ``cudaGraphLaunch``: the replay's events in stream order
  are the graph's nodes in order, so the i-th takes the i-th node's label.
  A replay is matched to the captured graphs of its node count; where none
  or several labellings match, its events go to ``(unlabelled replay)``
  and the layers' totals are withheld (``complete`` false).

Each idle gap of the device is put down to the spans open on the window's
host thread at the gap's middle.  Device time in ``<layer>.backward``
counts towards the layer.

Until ``recbench/run.py`` enables the program's tracing and
``recbench/trace.py`` hands :func:`reduce` its events, this module's
entry point runs a cell with both done:

    python -m recbench.layers --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It is ``python -m recbench.run`` with the program's tracing enabled before
the session is built: ``--trace 0`` measures what the spans cost in the
untraced window; ``--trace 1`` adds to the result line each layer's device
ms and idle ms a step or a call (``<layer>.device_ms.<kind>``,
``<layer>.idle_ms.<kind>``) and ``breakdown.by_span``.
"""

from __future__ import annotations

import sys

from recbench import run as bench  # first: its clock, set-up's, starts before torch loads

from torch.autograd import DeviceType  # noqa: E402

from recbench.trace import WINDOW, _gaps, _union  # noqa: E402

_RUN = bench.run

PREFIX = "xrt."
UNLABELLED = "(unlabelled replay)"
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


def layer_of(path: str) -> str:
    """The layer of a span path: its innermost span's name without
    ``xrt.`` and ``.backward`` (``xrt.steps/xrt.loss.backward`` -> ``loss``);
    "" outside every span."""
    last = path.rsplit("/", 1)[-1]
    if not last.startswith(PREFIX):
        return last
    last = last[len(PREFIX):]
    return last[:-len(".backward")] if last.endswith(".backward") else last


def _paths(ranges: list, times: list) -> list[str]:
    """For each of ``times``, the path of the ranges ``(start, end, name)``
    of one host thread open then, outermost first (ranges on one thread
    nest); one sweep over both, in time order."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [""] * len(times), [], 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        t = times[j]
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[j] = "/".join(r[2] for r in stack if r[1] > t)
    return out


def _labelling(labels: list[dict], n: int) -> list[str] | None:
    """The path of each of ``n`` replayed nodes, from the one labelling of
    the captured graphs of ``n`` nodes; None where there is none or more
    than one."""
    found = {tuple(map(tuple, g["marks"])) for g in labels if g["nodes"] == n}
    if len(found) != 1:
        return None
    marks = list(found.pop())
    out = []
    for i, (first, path) in enumerate(marks):
        end = marks[i + 1][0] if i + 1 < len(marks) else n
        out += [path] * (end - first)
    return out if len(out) == n else None


def reduce(events, labels: list[dict], units: int) -> dict:
    """Device and idle time of the traced window by program span and
    layer (see the module docstring); ``events`` are the profiler's
    (``prof.events()``), ``labels`` the program's ``graph_labels()``."""
    window = next(e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    device, ranges, launches = [], {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append(e)
        elif e.device_type == DeviceType.CPU:
            if e.name.startswith(PREFIX):
                ranges.setdefault(e.thread, []).append(
                    (e.time_range.start, e.time_range.end, e.name))
            elif e.name.startswith("cu") and e.id:
                launches[e.id] = e
    device_s: dict[str, float] = {}
    replays: dict[int, list] = {}
    eager: dict[int, list] = {}  # launching thread -> [(launch time, seconds)]
    for e in device:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        launch = launches.get(e.id)
        if launch is None:
            device_s["(no launch)"] = device_s.get("(no launch)", 0.0) + (t - s) * 1e-6
        elif launch.name in GRAPH_LAUNCH:
            replays.setdefault(e.id, []).append((e.time_range.start, t - s))
        else:
            eager.setdefault(launch.thread, []).append((launch.time_range.start, t - s))
    for thread, launched in eager.items():
        paths = _paths(ranges.get(thread, []), [at for at, _ in launched])
        for path, (_, us) in zip(paths, launched):
            device_s[path] = device_s.get(path, 0.0) + us * 1e-6
    mismatched = 0
    for replay in replays.values():
        replay.sort()
        paths = _labelling(labels, len(replay))
        if paths is None:
            mismatched += 1
            paths = [UNLABELLED] * len(replay)
        for path, (_, us) in zip(paths, replay):
            device_s[path] = device_s.get(path, 0.0) + us * 1e-6
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device]
    busy = _union([(s, t) for s, t in intervals if t > s])
    gaps = _gaps(busy, w0, w1)
    idle_s: dict[str, float] = {}
    for path, (s, t) in zip(_paths(ranges.get(window.thread, []),
                                   [0.5 * (s + t) for s, t in gaps]), gaps):
        idle_s[path] = idle_s.get(path, 0.0) + (t - s) * 1e-6
    layer_s: dict[str, float] = {}
    for path, sec in device_s.items():
        layer_s[layer_of(path)] = layer_s.get(layer_of(path), 0.0) + sec
    layer_idle_s: dict[str, float] = {}
    for path, sec in idle_s.items():
        for layer in {layer_of(p) for p in path.split("/") if p}:
            layer_idle_s[layer] = layer_idle_s.get(layer, 0.0) + sec
    by_span = {p: [1e3 * device_s.get(p, 0.0) / units, 1e3 * idle_s.get(p, 0.0) / units]
               for p in sorted(set(device_s) | set(idle_s))}
    return {"complete": mismatched == 0, "layer_s": layer_s, "layer_idle_s": layer_idle_s,
            "by_span": by_span,
            "replays": {"replays": len(replays), "unlabelled": mismatched,
                        "events": sorted({len(r) for r in replays.values()}),
                        "nodes": sorted({g["nodes"] for g in labels})}}


# (metric, kind of cell, layer, device or idle time): the per-layer split
METRICS = (
    [(f"{layer}.device_ms.{kind}", kind, layer, "device")
     for layer in ("embed", "encoder") for kind in ("train", "recommend")]
    + [(f"{layer}.device_ms.train", "train", layer, "device")
       for layer in ("loss", "optimizer", "state")]
    + [("steps.idle_ms.train", "train", "steps", "idle"),
       ("retrieval.device_ms.recommend", "recommend", "retrieval", "device")]
    + [(f"{layer}.idle_ms.recommend", "recommend", layer, "idle")
       for layer in ("embed", "encoder", "retrieval")]
)


def metrics(reduced: dict, kind: str, units: int) -> dict:
    """The per-layer metrics of a cell of ``kind`` in ms a step or a call;
    none where a replay went unlabelled or the span never ran."""
    if not reduced["complete"]:
        return {}
    out = {}
    for name, k, layer, which in METRICS:
        table = reduced["layer_s" if which == "device" else "layer_idle_s"]
        if k == kind and layer in table:
            out[name] = {"value": 1e3 * table[layer] / units, "unit": "ms"}
    return out


def run(root, workload: str, seed: int, seconds: float, traced: bool, **kwargs) -> dict:
    """``recbench.run.run`` with the program's tracing enabled before the
    session is built and, traced, the window's spans reduced into the
    result (see the module docstring)."""
    from recbench import spec, trace
    from transformer_recommenders_tpu_torch import tracing as program

    kept = {}
    profile, record = trace.profile, trace.record

    def keep_profile(*args, **kw):
        kept["prof"] = profile(*args, **kw)
        return kept["prof"]

    def record_spans(window_fn, root):
        reduced, host_s = record(window_fn, root)
        kept["spans"] = reduce(kept["prof"].events(), program.graph_labels(),
                               reduced["units"])
        return reduced, host_s

    trace.profile, trace.record = keep_profile, record_spans
    program.enable()
    try:
        result = _RUN(root, workload, seed, seconds, traced, **kwargs)
    finally:
        program.disable()
        trace.profile, trace.record = profile, record
    spans = kept.get("spans")
    if spans is not None:
        result["metrics"].update(metrics(spans, spec.load(root, workload).kind,
                                         result["attempted"]))
        result["breakdown"]["by_span"] = spans["by_span"]
        result["breakdown"]["replays"] = spans["replays"]
    return result


def main(argv=None) -> int:
    try:
        import transformer_recommenders_tpu_torch.tracing  # noqa: F401
    except ImportError as e:
        print(f"recbench.layers: the program has no tracing module ({e})", file=sys.stderr)
        return 2
    bench.run = run
    return bench.main(argv)


if __name__ == "__main__":
    sys.exit(main())
