"""Spans at the port's layer boundaries, and the labels of graph nodes.

One primitive, :func:`span`, with three sinks:

- a request's :class:`Trace` (serving): the span's wall seconds, which the
  ``Server-Timing`` header and ``/metrics`` show (``serving/asgi.py``);
- ``torch.profiler``, once :func:`enable` was called: a ``record_function``
  range ``xrt.<name>``, on the clock of the device's events;
- a CUDA-graph capture made under :func:`capture`, once enabled: every node
  captured inside a span is labelled with the span's path
  (``xrt.steps/xrt.encoder``).  A replay runs no Python, so no range
  brackets a replayed kernel; its label does (:func:`graph_labels`).

A span's parent is the span it nests in, in its thread or asyncio task.
Tracing is off by default: a span is then a shared null context after two
checks, and :func:`mark_backward` registers no hook.

Backward work belongs to the layer whose forward work it differentiates.
:func:`mark_backward` marks a layer's output; with tracing on, the backward
reaching that tensor opens ``xrt.<layer>.backward`` and closes the backward
span open before it, and the last one closes when the backward ends.

Labels are node counts: at each span's entry and exit inside a capture the
capture's graph is asked how many nodes it holds (``cuStreamGetCaptureInfo``
and ``cuGraphGetNodes`` of the CUDA driver, through ``ctypes``), which adds no
node.  A graph captured from one stream is a chain, so a replay's device
events (kernels, copies, fills), in stream order, are its nodes in order.

Nothing here imports torch at import time: ``serving/asgi.py`` re-exports
:class:`Trace`, ``CURRENT_TRACE`` and ``trace_span`` from this module, and a
serving worker sets its CPU affinity before torch loads.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
import functools
import threading
import time

PREFIX = "xrt."

_ENABLED = False
# the path of the innermost open span ("" outside every span), per thread
# and per asyncio task
_PATH: contextvars.ContextVar[str] = contextvars.ContextVar("xrt_span_path", default="")
_NULL = contextlib.nullcontext()


def enable() -> None:
    """Open a profiler range at every span, label captured graph nodes and
    mark the backward's layers, from now on."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


# -- request traces (serving) --------------------------------------------------
#
# Each dispatched request gets a Trace in a contextvar; service code wraps
# its stages in ``span`` (free when no request is active, so the same code
# paths run un-traced in scripts and tests).  Spans surface two ways:
# per-request on the standard ``Server-Timing`` response header
# (``span;dur=<ms>``), and aggregated at /metrics as
# ``xrt_span_seconds_total{span=...}``.


class Trace:
    __slots__ = ("spans", "metrics", "header_spans")

    def __init__(self) -> None:
        self.spans: list[tuple[str, float]] = []
        # count-valued annotations (e.g. batch_size) — rendered on the
        # header like spans (Server-Timing allows arbitrary metrics) but
        # aggregated separately so they never pollute the seconds counter
        self.metrics: list[tuple[str, float]] = []
        # header-only spans: shown per-request but NEVER aggregated into
        # /metrics — for quantities shared across requests (a micro-batch's
        # full encoder forward) that would overcount the aggregate if every
        # waiter added them
        self.header_spans: list[tuple[str, float]] = []

    def add(self, name: str, seconds: float) -> None:
        self.spans.append((name, seconds))

    def add_metric(self, name: str, value: float) -> None:
        self.metrics.append((name, value))

    def add_header_only(self, name: str, seconds: float) -> None:
        self.header_spans.append((name, seconds))

    def header(self) -> str:
        parts = [f"{n};dur={s * 1e3:.2f}" for n, s in self.spans]
        parts += [f"{n};dur={s * 1e3:.2f}" for n, s in self.header_spans]
        parts += [f"{n};dur={v:.2f}" for n, v in self.metrics]
        return ", ".join(parts)


CURRENT_TRACE: contextvars.ContextVar[Trace | None] = contextvars.ContextVar(
    "xrt_trace", default=None
)


# -- spans -----------------------------------------------------------------


def span(name: str, *, request: bool = True):
    """A context that times the enclosed block (awaits included) on the
    active request's trace, unless ``request`` is false (a layer of the
    model: a request's header names the service's stages, not the model's
    layers), and, with tracing on, opens the profiler range
    ``xrt.<name>`` and labels the graph nodes captured inside it."""
    trace = CURRENT_TRACE.get() if request else None
    if trace is None and not _ENABLED:
        return _NULL
    return _Span(name, trace)


trace_span = span  # the name the serving code has always used


class _Span:
    __slots__ = ("name", "trace", "t0", "range", "token")

    def __init__(self, name: str, trace: Trace | None) -> None:
        self.name, self.trace, self.range, self.token = name, trace, None, None

    def __enter__(self) -> _Span:
        if _ENABLED:
            path = _child(_PATH.get(), self.name)
            self.token = _PATH.set(path)
            self.range = _open_range(self.name)
            _mark(path)
        if self.trace is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.trace is not None:
            self.trace.add(self.name, time.perf_counter() - self.t0)
        if self.range is not None:
            _PATH.reset(self.token)
            _mark(_PATH.get())
            self.range.__exit__(*exc)
        return False


def _child(parent: str, name: str) -> str:
    return f"{parent}/{PREFIX}{name}" if parent else PREFIX + name


def _open_range(name: str):
    from torch.autograd.profiler import record_function

    rf = record_function(PREFIX + name)
    rf.__enter__()
    return rf


# -- the backward ------------------------------------------------------------


class _Backward:
    """The backward spans that one forward thread's marks open: one open at
    a time, the next closing it, the engine's end-of-backward callback
    closing the last."""

    def __init__(self) -> None:
        self.parent = ""
        self.stream: int | None = None
        self.range = None

    def reach(self, layer: str) -> None:
        if self.range is None:
            from torch.autograd import Variable

            Variable._execution_engine.queue_callback(self.close)
        else:
            self.range.__exit__(None, None, None)
        name = f"{layer}.backward"
        self.range = _open_range(name)
        _mark(_child(self.parent, name), self.stream)

    def close(self) -> None:
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
            _mark(self.parent, self.stream)


_BACKWARD = threading.local()


def mark_backward(tensor, layer: str):
    """``tensor``, the output of ``layer``; with tracing on and ``tensor``
    requiring a gradient, the backward opens ``xrt.<layer>.backward`` when
    it reaches ``tensor`` (a hook that launches nothing).  Call it outside
    the layer's span: the backward spans nest in the span around it."""
    if not _ENABLED or not tensor.requires_grad:
        return tensor
    rec = getattr(_BACKWARD, "recorder", None)
    if rec is None:
        rec = _BACKWARD.recorder = _Backward()
    rec.parent = _PATH.get()
    rec.stream = _current_stream() if _CAPTURES else None
    tensor.register_hook(lambda grad: rec.reach(layer))
    return tensor


# -- graph labels ------------------------------------------------------------


@dataclasses.dataclass
class GraphLabels:
    """One captured graph: ``nodes`` in all, and ``marks``, (first node,
    span path) in node order: the nodes from a mark's first node up to the
    next mark's belong to its path ("" outside every span)."""

    nodes: int
    marks: list


_CAPTURES: dict[int, GraphLabels] = {}  # capture id -> labels, while capturing
_GRAPHS: list[GraphLabels] = []  # every capture made under capture(), in order
_STATUS_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE


@functools.lru_cache(maxsize=None)
def _driver():
    """(cuStreamGetCaptureInfo in its newest form this driver has, its
    argument count, cuGraphGetNodes) of the CUDA driver torch runs on."""
    lib = ctypes.CDLL("libcuda.so.1")
    for name, n_args in (("cuStreamGetCaptureInfo_v3", 7), ("cuStreamGetCaptureInfo_v2", 6)):
        info = getattr(lib, name, None)
        if info is not None:
            break
    else:
        msg = "the CUDA driver has no cuStreamGetCaptureInfo_v2 or _v3"
        raise RuntimeError(msg)
    info.argtypes = [ctypes.c_void_p] * n_args
    info.restype = ctypes.c_int
    nodes = lib.cuGraphGetNodes
    nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    nodes.restype = ctypes.c_int
    return info, n_args, nodes


def _capturing(stream: int) -> tuple[int, int] | None:
    """(capture id, graph) of ``stream``'s active capture, or None."""
    info, n_args, _ = _driver()
    status, cid, graph = ctypes.c_int(0), ctypes.c_ulonglong(0), ctypes.c_void_p(0)
    args = [ctypes.c_void_p(stream), ctypes.addressof(status), ctypes.addressof(cid),
            ctypes.addressof(graph)] + [None] * (n_args - 4)
    err = info(*args)
    if err != 0:
        msg = f"cuStreamGetCaptureInfo: CUDA error {err}"
        raise RuntimeError(msg)
    return (cid.value, graph.value) if status.value == _STATUS_ACTIVE else None


def _node_count(graph: int) -> int:
    n = ctypes.c_size_t(0)
    err = _driver()[2](ctypes.c_void_p(graph), None, ctypes.byref(n))
    if err != 0:
        msg = f"cuGraphGetNodes: CUDA error {err}"
        raise RuntimeError(msg)
    return n.value


def _current_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def _mark(path: str, stream: int | None = None) -> None:
    """From the capture's next node on, nodes belong to ``path``."""
    if not _CAPTURES:
        return
    state = _capturing(_current_stream() if stream is None else stream)
    labels = _CAPTURES.get(state[0]) if state is not None else None
    if labels is None:
        return
    n = _node_count(state[1])
    if labels.marks[-1][0] == n:  # the segment before holds no node
        labels.marks[-1] = (n, path)
    else:
        labels.marks.append((n, path))


class _Capture:
    def __enter__(self) -> GraphLabels:
        self.stream = _current_stream()
        state = _capturing(self.stream)
        if state is None:
            msg = "tracing.capture() needs an active CUDA-graph capture on the current stream"
            raise RuntimeError(msg)
        self.id, graph = state
        self.labels = GraphLabels(nodes=0, marks=[(_node_count(graph), _PATH.get())])
        _CAPTURES[self.id] = self.labels
        return self.labels

    def __exit__(self, exc_type, *exc) -> bool:
        del _CAPTURES[self.id]
        state = _capturing(self.stream)
        if state is not None:
            self.labels.nodes = _node_count(state[1])
        if exc_type is None:
            _GRAPHS.append(self.labels)
        return False


def capture():
    """Enter inside ``torch.cuda.graph(...)``: with tracing on, label the
    nodes that the capture adds from here to its end."""
    return _Capture() if _ENABLED else _NULL


def graph_labels() -> list[dict]:
    """Every graph captured under :func:`capture` with tracing on, in the
    order of capture: ``{"nodes": n, "marks": [[first node, path], ...]}``."""
    return [{"nodes": g.nodes, "marks": [list(m) for m in g.marks]} for g in _GRAPHS]
