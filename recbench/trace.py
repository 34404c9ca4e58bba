"""The traced window: ``torch.profiler`` over a few calls, reduced to what
the per-layer metrics read.

Every device event (kernels, copies, fills; the profiler's own user
annotations left out) is attributed by its function's name to the port
library whose CUDA source defines it (``csrc/<library>.cu`` of the
program, read for its ``__global__`` names); a kernel that a shared header
(``csrc/*.cuh``) defines, to the library whose kernel ran before it on its
stream last, among the libraries whose sources launch it; else to ``library``
(PyTorch and cuBLAS kernels: products, casts, elementwise ops, AdamW,
sorts).
Kernels inside a device-side span named ``recbench.<part>`` are also
summed under that span.  Busy time is the union of device intervals inside
the window; each idle gap is put down to what the host thread that drove
the window was doing at its middle (the innermost profiler event there).
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import pathlib
import re
import time

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "recbench.window"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)\s*\(")


def port_kernels(root: pathlib.Path) -> tuple[dict[str, str], dict[str, set[str]]]:
    """(kernel name -> the port library whose ``csrc/<library>.cu`` defines
    it, kernel name -> the libraries whose sources launch it, for each
    kernel a shared header ``csrc/*.cuh`` defines)."""
    csrc = root / "transformer_recommenders_tpu_torch" / "csrc"
    sources = {src.stem: src.read_text() for src in sorted(csrc.glob("*.cu"))}
    own = {name: lib for lib, text in sources.items() for name in _GLOBAL.findall(text)}
    shared = {}
    for header in sorted(csrc.glob("*.cuh")):
        for name in _GLOBAL.findall(header.read_text()):
            shared[name] = {lib for lib, text in sources.items()
                            if re.search(rf"\b{name}\b", text)}
    return own, shared


def libraries(events: list[tuple], own: dict[str, str], shared: dict[str, set[str]]
              ) -> list[str]:
    """The library of each device event ``(stream, start, kernel name)``,
    in the events' order (see the module docstring)."""
    last, out = {}, [""] * len(events)
    for i in sorted(range(len(events)), key=lambda i: events[i][:2]):
        stream, _, name = events[i]
        if name in own:
            out[i] = last[stream] = own[name]
        elif name in shared and last.get(stream) in shared[name]:
            out[i] = last[stream]
        elif name in shared and len(shared[name]) == 1:
            out[i] = next(iter(shared[name]))
        else:
            out[i] = "library"
    return out


def _strip(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name[5:] if name.startswith("void ") else name


def bare_name(name: str) -> str:
    """A kernel's function name without namespaces, template arguments and
    parameters."""
    return re.split(r"[<(]", _strip(name), maxsplit=1)[0].rsplit("::", 1)[-1].strip()


def short_name(name: str) -> str:
    """A kernel's name with its template arguments, without its parameters."""
    name, depth = _strip(name), 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:160]


@dataclasses.dataclass
class Trace:
    units: int  # steps (training) or calls (recommendation) traced
    window_s: float
    busy_s: float
    library_s: dict  # port library (or "library") -> device seconds
    span_s: dict  # recbench.<part> -> device seconds of the kernels inside it
    least_s: dict  # function -> least seconds of the traced work (from the driver)
    breakdown: dict


def roofline_share(trace: Trace, library: str, function: str) -> float | None:
    """% of its roofline: the least seconds of ``function`` over the device
    seconds of ``library``'s kernels; None where either was not found."""
    spent, least = trace.library_s.get(library), trace.least_s.get(function)
    if not spent or not least:
        return None
    return 100.0 * least / spent


def ms_per_unit(trace: Trace, seconds: float | None) -> float | None:
    """Milliseconds a step or a call; None where nothing was found."""
    if not seconds:
        return None
    return 1e3 * seconds / trace.units


@contextlib.contextmanager
def spans(module, names: tuple[str, ...], span: str):
    """Wrap ``module``'s functions ``names`` in a profiler span ``span`` for
    the duration (a span around the calls into a layer, from outside it)."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(fn):
        def wrapped(*args, **kwargs):
            with record_function(span):
                return fn(*args, **kwargs)
        return wrapped

    for n, fn in saved.items():
        setattr(module, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def record(window_fn, root: pathlib.Path) -> tuple[dict, float]:
    """Run ``window_fn`` (which ends in a synchronize) under the profiler;
    returns (reduced events, host seconds of the window)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            units = window_fn()
        host_s = time.perf_counter() - t0
    events = prof.events()
    own, shared = port_kernels(root)
    window = next(e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    device, annotations, host = [], [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            (annotations if e.is_user_annotation else device).append(e)
        elif e.device_type == DeviceType.CPU and e.thread == window.thread:
            host.append(e)
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device]
    intervals = [(s, e) for s, e in intervals if e > s]
    busy = _union(intervals)
    busy_us = sum(e - s for s, e in busy)
    library_s, by_name = {}, {}
    libs = libraries([(e.device_resource_id, e.time_range.start, bare_name(e.name)) for e in device],
                     own, shared)
    for e, lib in zip(device, libs):
        sec = (e.time_range.end - e.time_range.start) * 1e-6
        library_s[lib] = library_s.get(lib, 0.0) + sec
        short = short_name(e.name)
        by_name[short] = by_name.get(short, 0.0) + sec
    span_s = {}
    marks = [(a.time_range.start, a.time_range.end, a.name) for a in annotations
             if a.name.startswith("recbench.") and a.name != WINDOW]
    for s, e, name in marks:
        inside = sum(min(k.time_range.end, e) - max(k.time_range.start, s) for k in device
                     if k.time_range.start < e and k.time_range.end > s)
        span_s[name] = span_s.get(name, 0.0) + inside * 1e-6
    gaps = _gaps(busy, w0, w1)
    idle = _idle_by_host(gaps, host)
    top = heapq.nlargest(10, by_name.items(), key=lambda kv: kv[1])
    breakdown = {"device_ops": [[n, s] for n, s in top],
                 "idle_gaps": [[n, s] for n, s in heapq.nlargest(10, idle.items(),
                                                                  key=lambda kv: kv[1])]}
    return {"units": units, "window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "library_s": library_s, "span_s": span_s, "breakdown": breakdown,
            "kernel_events": len(device)}, host_s


def _gaps(busy, w0, w1):
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


def _idle_by_host(gaps, host) -> dict:
    """Idle seconds by the name of the innermost host event at each gap's
    middle (events on one thread nest)."""
    host = sorted(host, key=lambda e: (e.time_range.start, -e.time_range.end))
    out, stack, i = {}, [], 0
    for s, e in sorted(gaps):
        mid = 0.5 * (s + e)
        while i < len(host) and host[i].time_range.start <= mid:
            ev = host[i]
            while stack and stack[-1].time_range.end <= ev.time_range.start:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1].time_range.end <= mid:
            stack.pop()
        name = stack[-1].name if stack else "(no host event)"
        out[name] = out.get(name, 0.0) + (e - s) * 1e-6
    return out
