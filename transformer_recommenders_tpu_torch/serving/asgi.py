"""Minimal JSON-over-HTTP ASGI framework + in-process test client.

The reference serves through BentoML (``xfmr_rec/service.py``) and
smoke-tests by converting the service to ASGI and driving it with
starlette's TestClient in-process (``xfmr_rec/deploy.py:23-36``).  Neither
BentoML nor starlette is a dependency of this project, so this module
provides the minimal equivalent with zero dependencies:

- :class:`JSONApp`: an ASGI application mapping ``POST /<name>`` to async
  handlers taking/returning JSON;
- :class:`TestClient`: drives any ASGI app in-process (own event loop),
  starlette-TestClient style;
- :func:`serve`: a tiny threaded HTTP server for real serving without
  uvicorn (stdlib ``http.server`` bridging into the ASGI app), and
  :func:`make_server`, the same server bound but not yet serving;
- :func:`serve_workers`: a pool of such servers, one fresh process each,
  sharing one port.

A copy of ``transformer_recommenders_tpu/serving/asgi.py`` for the PyTorch
port: the accelerator check in :func:`serve` asks torch instead of jax,
the server's listen backlog is the system's maximum (not socketserver's
5), and the pool's workers run on the card unless asked for the CPU.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import time
from typing import Any, Awaitable, Callable

# request-level tracing lives in ``tracing.py`` (one span system for the
# requests, the profiler and graph captures); re-exported for its importers
from transformer_recommenders_tpu_torch.tracing import (  # noqa: F401
    CURRENT_TRACE,
    Trace,
    trace_span,
)

Handler = Callable[[dict], Awaitable[Any]]


class NotFound(Exception):
    """404 error for missing resources (parity: bentoml.exceptions.NotFound)."""


class JSONApp:
    def __init__(self) -> None:
        self.routes: dict[str, Handler] = {}
        # request counters surfaced at /metrics (Prometheus text format;
        # parity: BentoML exposes Prometheus metrics by default,
        # SURVEY.md §5.5)
        self.request_counts: dict[tuple[str, int], int] = {}
        self.request_seconds: dict[str, float] = {}
        # aggregated per-span totals from request-level tracing; non-time
        # span metrics (e.g. batch_size counts) aggregate separately so the
        # seconds counter stays dimensionally honest
        self.span_seconds: dict[str, float] = {}
        self.span_metrics: dict[str, float] = {}
        # serve() runs requests on ThreadingTCPServer threads — the
        # read-modify-write counter updates need a lock or concurrent
        # requests lose increments
        import threading

        self._counter_lock = threading.Lock()

    def route(self, name: str) -> Callable[[Handler], Handler]:
        def register(fn: Handler) -> Handler:
            self.routes[name.strip("/")] = fn
            return fn

        return register

    async def __call__(self, scope: dict, receive, send) -> None:
        if scope["type"] != "http":
            msg = f"unsupported scope type: {scope['type']}"
            raise RuntimeError(msg)
        path = scope["path"].strip("/")

        body = b""
        while True:
            event = await receive()
            body += event.get("body", b"")
            if not event.get("more_body"):
                break

        status, payload, timing = await self._dispatch(path, body)
        data = json.dumps(payload).encode()
        headers = [
            (b"content-type", b"application/json"),
            (b"content-length", str(len(data)).encode()),
        ]
        if timing:
            headers.append((b"server-timing", timing.encode()))
        await send(
            {
                "type": "http.response.start",
                "status": status,
                "headers": headers,
            }
        )
        await send({"type": "http.response.body", "body": data})

    async def _dispatch(self, path: str, body: bytes) -> tuple[int, Any, str]:
        t0 = time.perf_counter()
        trace = Trace()
        token = CURRENT_TRACE.set(trace)
        try:
            status, payload = await self._dispatch_inner(path, body)
        finally:
            CURRENT_TRACE.reset(token)
        # counters key on REGISTERED routes only: arbitrary client paths
        # all bucket under "unknown" (an unbounded label set would grow
        # memory forever on a 0.0.0.0-bound server and lets clients inject
        # exposition-format metacharacters)
        label = path if (path in self.routes or path == "metrics") else "unknown"
        with self._counter_lock:
            for name, secs in trace.spans:
                self.span_seconds[name] = self.span_seconds.get(name, 0.0) + secs
            for name, val in trace.metrics:
                self.span_metrics[name] = self.span_metrics.get(name, 0.0) + val
            self.request_counts[(label, status)] = (
                self.request_counts.get((label, status), 0) + 1
            )
            self.request_seconds[label] = self.request_seconds.get(
                label, 0.0
            ) + (time.perf_counter() - t0)
        return status, payload, trace.header()

    @staticmethod
    def _escape_label(value: str) -> str:
        """Prometheus text-format label escaping: backslash, quote, newline."""
        return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    def metrics_text(self) -> str:
        """Prometheus text exposition of the request counters."""
        # snapshot under the lock: concurrent request threads mutate these
        # dicts, and iterating live dicts can raise "dictionary changed size
        # during iteration" on a first-seen label
        with self._counter_lock:
            request_counts = dict(self.request_counts)
            request_seconds = dict(self.request_seconds)
            span_seconds = dict(self.span_seconds)
            span_metrics = dict(self.span_metrics)
        lines = [
            "# TYPE xrt_requests_total counter",
        ]
        for (path, status), n in sorted(request_counts.items()):
            route = self._escape_label(path)
            lines.append(
                f'xrt_requests_total{{route="{route}",status="{status}"}} {n}'
            )
        lines.append("# TYPE xrt_request_seconds_total counter")
        for path, secs in sorted(request_seconds.items()):
            route = self._escape_label(path)
            lines.append(f'xrt_request_seconds_total{{route="{route}"}} {secs:.6f}')
        lines.append("# TYPE xrt_span_seconds_total counter")
        for name, secs in sorted(span_seconds.items()):
            span = self._escape_label(name)
            lines.append(f'xrt_span_seconds_total{{span="{span}"}} {secs:.6f}')
        lines.append("# TYPE xrt_span_metric_total counter")
        for name, val in sorted(span_metrics.items()):
            span = self._escape_label(name)
            lines.append(f'xrt_span_metric_total{{metric="{span}"}} {val:.6f}')
        return "\n".join(lines) + "\n"

    async def _dispatch_inner(self, path: str, body: bytes) -> tuple[int, Any]:
        if path == "metrics":
            return 200, self.metrics_text()
        handler = self.routes.get(path)
        if handler is None:
            return 404, {"error": f"no such route: /{path}"}
        try:
            payload = json.loads(body) if body else {}
        except json.JSONDecodeError as exc:
            return 400, {"error": f"invalid JSON body: {exc}"}
        if not isinstance(payload, dict):
            return 400, {"error": "request body must be a JSON object"}
        try:
            result = await handler(payload)
        except NotFound as exc:
            return 404, {"error": str(exc)}
        except KeyError as exc:
            return 400, {"error": f"missing required field: {exc}"}
        except (TypeError, ValueError) as exc:
            return 400, {"error": str(exc)}
        return 200, result


class Response:
    def __init__(self, status_code: int, payload: Any,
                 headers: dict[str, str] | None = None) -> None:
        self.status_code = status_code
        self._payload = payload
        self.headers = headers or {}

    def json(self) -> Any:
        return self._payload

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300


class TestClient:
    """In-process ASGI client (parity: starlette TestClient usage in
    ``xfmr_rec/deploy.py:23-36``)."""

    def __init__(self, app: JSONApp) -> None:
        self.app = app

    def post(self, path: str, json_body: Any = None) -> Response:
        return asyncio.run(self._request("POST", path, json_body))

    async def _request(self, method: str, path: str, json_body: Any) -> Response:
        body = json.dumps(json_body or {}).encode()
        scope = {"type": "http", "method": method, "path": path}
        received = False

        async def receive():
            nonlocal received
            if received:
                return {"type": "http.disconnect"}
            received = True
            return {"type": "http.request", "body": body, "more_body": False}

        messages: list[dict] = []

        async def send(message):
            messages.append(message)

        await self.app(scope, receive, send)
        start = next(m for m in messages if m["type"] == "http.response.start")
        data = b"".join(
            m.get("body", b"") for m in messages if m["type"] == "http.response.body"
        )
        headers = {k.decode(): v.decode() for k, v in start.get("headers", [])}
        return Response(
            start["status"], json.loads(data) if data else None, headers
        )


def serve(
    app: JSONApp,
    host: str = "0.0.0.0",
    port: int = 3000,
    *,
    workers: int = 1,
    reuse_port: bool = False,
) -> None:
    """Blocking HTTP server bridging into the ASGI app (ONE process).

    Passing ``workers > 1`` raises: the process that owns the CUDA device
    must not fan out, and forking a process whose runtime has started
    threads is unsafe.  :func:`serve_workers` starts each worker fresh
    (each loading the artifact); they share one port with ``reuse_port``,
    which sets SO_REUSEPORT before bind (kernel load-balancing).
    """
    if workers > 1:
        import torch

        if torch.cuda.is_available():
            msg = (
                f"workers={workers} needs worker processes, but this process "
                "drives a CUDA device, which it must not fork. Run with "
                "workers=1, or start a pool of fresh worker processes with "
                "serve_workers()."
            )
            raise RuntimeError(msg)
        msg = (
            f"serve(workers={workers}) cannot fork an already-initialized "
            "app. Use serve_workers(artifact_dir, ...), which spawns fresh "
            "worker processes that each load the artifact."
        )
        raise RuntimeError(msg)

    with make_server(app, host, port, reuse_port=reuse_port) as server:
        server.serve_forever()


def make_server(app: JSONApp, host: str = "0.0.0.0", port: int = 3000, *,
                reuse_port: bool = False):
    """The bound threaded HTTP server of :func:`serve`, not yet serving:
    the caller runs ``serve_forever()`` (on a thread of its own, say) and
    ends it with ``shutdown()`` and ``server_close()``.  ``port`` 0 binds
    a free port, read back from ``server_address``."""
    import http.server
    import socketserver

    class Bridge(http.server.BaseHTTPRequestHandler):
        def _respond(self) -> None:
            length = int(self.headers.get("content-length", 0))
            body = self.rfile.read(length)
            status, payload, timing = asyncio.run(
                app._dispatch(self.path.strip("/"), body)
            )
            if isinstance(payload, str) and self.path.strip("/") == "metrics":
                data = payload.encode()
                ctype = b"text/plain; version=0.0.4"
            else:
                data = json.dumps(payload).encode()
                ctype = b"application/json"
            self.send_response(status)
            self.send_header("content-type", ctype.decode())
            self.send_header("content-length", str(len(data)))
            if timing:
                self.send_header("server-timing", timing)
            # which SO_REUSEPORT worker served this request — lets load
            # tests attribute per-worker queueing (round-3 verdict #4)
            self.send_header("x-worker-pid", str(os.getpid()))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self) -> None:  # noqa: N802
            self._respond()

        def do_GET(self) -> None:  # noqa: N802
            self._respond()

        def log_message(self, *args) -> None:  # quiet
            pass

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        # socketserver's backlog of 5 drops the connections of a burst, which
        # the clients retry after 1 s and 3 s (a pool's p50 of 1.1 s on the H100)
        request_queue_size = socket.SOMAXCONN

        def server_bind(self) -> None:
            if reuse_port and hasattr(socket, "SO_REUSEPORT"):
                self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            super().server_bind()

    return Server((host, port), Bridge)


def http_post(host: str, port: int, name: str, payload: Any = None, *,
              timeout: float = 60.0) -> tuple[int, Any, dict[str, str]]:
    """POST ``payload`` as JSON to ``http://host:port/name`` (a server of
    :func:`serve` or :func:`serve_workers`): ``(status, decoded body,
    headers)``."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps(payload or {}).encode()
        conn.request("POST", f"/{name}", body, {"content-type": "application/json"})
        response = conn.getresponse()
        data = response.read()
        return response.status, json.loads(data) if data else None, dict(response.getheaders())
    finally:
        conn.close()


# the kernel libraries a Service loads: the encoder's layer and the gather
SERVING_KERNELS = ("fused_layer", "gather_rows")


def serve_workers(
    artifact_dir: str,
    host: str = "0.0.0.0",
    port: int = 3000,
    *,
    workers: int = 2,
    pin_cpus: bool = False,
    device: str | None = None,
) -> None:
    """Multi-worker serving: spawn ``workers`` fresh processes of
    ``python -m transformer_recommenders_tpu_torch.serving.worker``, each
    loading the Service artifact and binding the same port with
    SO_REUSEPORT (the kernel balances connections).  Blocks until every
    worker has exited; a worker that exits with a non-zero code raises
    ``RuntimeError``.  On the way out (an interrupt included) every worker
    still running gets SIGTERM.

    Unlike JAX's pool, whose workers run on the CPU because a TPU cannot
    be shared between processes, these run on the card (``device=None``
    means ``cuda``, the port's rule for entry points): processes can share
    a CUDA card.  ``device="cpu"`` runs them on the plain path.  On the
    card the serving kernels are compiled here first
    (``cuda_build.build_all``), so the workers load them instead of each
    starting its own ``nvcc`` run.

    ``pin_cpus`` gives each worker a disjoint set of cores
    (``XRT_WORKER_CPUS``, applied by the worker before torch loads, with
    ``torch.set_num_threads`` to match), so N workers' thread pools do not
    oversubscribe the host.
    """
    import signal
    import subprocess
    import sys

    from transformer_recommenders_tpu_torch import resolve_device

    if not hasattr(socket, "SO_REUSEPORT"):  # pragma: no cover - non-Linux
        msg = "serve_workers needs SO_REUSEPORT (Linux)"
        raise RuntimeError(msg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        from transformer_recommenders_tpu_torch.ops import cuda_build

        cuda_build.build_all(SERVING_KERNELS)

    def worker_env(i: int) -> dict[str, str]:
        env = dict(os.environ)
        if pin_cpus:
            env["XRT_WORKER_CPUS"] = ",".join(str(c) for c in worker_cores(i, workers))
        return env

    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "transformer_recommenders_tpu_torch.serving.worker",
             str(artifact_dir), host, str(port), "--device", str(dev)],
            env=worker_env(i),
        )
        for i in range(workers)
    ]
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0, -signal.SIGTERM)]
            if bad:
                msg = f"serving worker exited with code {bad[0]}"
                raise RuntimeError(msg)
            if all(c is not None for c in codes):
                return  # every worker exited cleanly
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                p.kill()
                p.wait()


def worker_cores(i: int, workers: int) -> list[int]:
    """Worker ``i``'s cores under ``pin_cpus``: a block of the cores this
    process may run on, ``len(cores) // workers`` of them, disjoint from the
    other workers' (wrapping only where there are more workers than
    cores)."""
    cores = sorted(os.sched_getaffinity(0))
    per = max(1, len(cores) // workers)
    return [cores[(i * per + j) % len(cores)] for j in range(per)]
