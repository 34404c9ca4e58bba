"""The JAX repository's serving benchmarks on the port::

    python -m transformer_recommenders_tpu_torch.tools.bench_serving http \\
        [--clients 16] [--requests 200]
    python -m transformer_recommenders_tpu_torch.tools.bench_serving device \\
        [--clients 16] [--requests 480]
    python -m transformer_recommenders_tpu_torch.tools.bench_serving workers \\
        [--clients 16] [--requests 400] [--workers N]

each with ``[--device cuda|cpu] [--out PATH]``.  Every mode serves the
artifact of the deploy smoke's one-batch synthetic fit
(``serving/deploy._fast_dev_trainer``) and sends its clients' requests in
the JAX scripts' order: client ``w``'s ``i``-th request is
``recommend_with_item_id`` where ``w + i`` is even, else
``recommend_with_user_id``, over the artifact's items and users.  The
modes, with the JAX scripts' defaults and output keys:

- ``http`` (``scripts/bench_serving.py``): concurrent clients over HTTP
  against the socket server (``asgi.make_server``, the server of
  ``asgi.serve``) in this process, after a warm-up of 12 users and an
  item.  Keys: ``clients``, ``requests_ok``, ``errors``, ``qps``,
  ``p50_ms``, ``p95_ms``.
- ``device`` (``scripts/bench_serving_device.py``): no socket; each client
  a thread with its own event loop driving the ASGI app in process (the
  topology ``serve`` gives the micro-batcher), over the sweep
  :data:`SWEEP` of (``window_ms``, ``max_batch``) of the encoder's batcher,
  each point warmed on a throwaway app and measured on a fresh one, then
  one sequential client with both batchers at ``window_ms=0``.  Per point
  p50/p95/p99, the realised batch sizes and the span seconds from the
  app's ``/metrics``.  Keys: ``mode``, ``backend``, ``clients``,
  ``sweep``, ``best`` (the least p95), ``sequential_1_client``.
- ``workers`` (``scripts/bench_serving_workers.py``): ``asgi.serve_workers``
  in a process group of its own at workers=1, N and N pinned to disjoint
  cores, N = min(cpu_count, 4) unless ``--workers``; per arm QPS, latency
  percentiles, the ``Server-Timing`` spans', the client's overhead beyond
  them, each worker's requests and latencies, and the workers' kernel
  launches (their exit lines).  The JAX script's fourth arm sets an XLA
  flag of its CPU workers; the port's workers run on the card, which JAX's
  cannot (a TPU belongs to one process), so the arm is left out and the
  difference recorded (``workers_device``, ``left_out``).  Keys:
  ``backend``, ``host_cpus``, ``clients``, ``n_workers``, ``best_config``,
  ``speedup`` and one key an arm (``workers=1``, ...).

Each mode also records the kernel launches of its measured requests
(``ops/cuda_build.LAUNCHES``), the device and, on the card, its
``nvidia-smi`` name and power limit.  Numbers are not rounded.  The JSON
goes to stdout and to ``--out`` (default ``build/serving/<mode>.json``),
never to the JAX package's root records.  ``--device`` defaults to
``cuda``, which raises without a card; ``--device cpu`` runs the plain
path.
"""

from __future__ import annotations

import argparse
import asyncio
import http.client
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
# each mode's (clients, requests), the JAX scripts' defaults
DEFAULTS = {"http": (16, 200), "device": (16, 480), "workers": (16, 400)}
# (window_ms, max_batch) of the encoder's micro-batcher
# (scripts/bench_serving_device.py:170)
SWEEP = ((2.0, 64), (0.5, 64), (5.0, 64), (2.0, 16))
HOST = "127.0.0.1"


def make_artifact(work_dir: str, device) -> pathlib.Path:
    """The deploy smoke's one-batch synthetic fit, saved as an artifact."""
    from transformer_recommenders_tpu_torch.serving import deploy

    trainer = deploy._fast_dev_trainer(work_dir, device)
    artifact = pathlib.Path(work_dir) / "artifact"
    try:
        trainer.save(artifact)
    finally:
        trainer.close()
    return artifact


def catalog_ids(service) -> tuple[list[str], list[str]]:
    """The artifact's item and user ids, in store order."""
    items = [r["item_id"] for r in service.item_index.index.store.records]
    users = [r["user_id"] for r in service.user_index.index.store.records]
    return items, users


def request_for(worker: int, i: int, item_ids, user_ids) -> tuple[str, dict]:
    """Client ``worker``'s ``i``-th request: (route, payload)."""
    if (worker + i) % 2 == 0:
        return "/recommend_with_item_id", {"item_id": item_ids[(worker * 31 + i) % len(item_ids)]}
    return "/recommend_with_user_id", {"user_id": user_ids[(worker * 17 + i) % len(user_ids)]}


def percentiles(values_ms: list[float]) -> dict[str, float]:
    """p50, p95 and p99 of ``values_ms`` as the JAX scripts index them."""
    v = sorted(values_ms)
    n = len(v)
    if not n:
        return {}
    return {"p50_ms": v[n // 2], "p95_ms": v[min(int(n * 0.95), n - 1)],
            "p99_ms": v[min(int(n * 0.99), n - 1)]}


def run_clients(clients: int, requests: int, send) -> tuple[list, int, float]:
    """``clients`` threads each sending ``requests // clients`` requests by
    ``send(worker, i) -> (ok, sample)``: the samples of the requests that
    returned 200 (in completion order), the count of the others, and the
    wall seconds."""
    samples: list = []
    errors = [0]
    lock = threading.Lock()

    def client(worker: int) -> None:
        for i in range(requests // clients):
            ok, sample = send(worker, i)
            with lock:
                if ok:
                    samples.append(sample)
                else:
                    errors[0] += 1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(w,)) for w in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return samples, errors[0], time.perf_counter() - t0


def counted(fn):
    """``fn()`` and the kernel launches it made: ``(result, {kernel: n})``."""
    from transformer_recommenders_tpu_torch.ops import cuda_build

    cuda_build.reset_launches()
    result = fn()
    return result, {k: v for k, v in cuda_build.LAUNCHES.items() if v}


# -- http -------------------------------------------------------------------------


class Connection:
    """One client's keep-alive HTTP connection, opened again after an
    error (as the JAX scripts' clients do)."""

    def __init__(self, port: int, timeout: float = 120.0) -> None:
        self.port, self.timeout = port, timeout
        self.conn = http.client.HTTPConnection(HOST, port, timeout=timeout)

    def post(self, route: str, payload: dict):
        """``(ok, latency_ms, response headers)``."""
        t0 = time.perf_counter()
        try:
            self.conn.request("POST", route, json.dumps(payload))
            resp = self.conn.getresponse()
            resp.read()
            ok, headers = resp.status == 200, dict(resp.getheaders())
        except (OSError, http.client.HTTPException):
            ok, headers = False, {}
            self.conn.close()
            self.conn = http.client.HTTPConnection(HOST, self.port, timeout=self.timeout)
        return ok, (time.perf_counter() - t0) * 1e3, headers


def bench_http(service, clients: int, requests: int) -> dict:
    """``scripts/bench_serving.py``: the socket server in this process,
    warmed on 12 users and one item, then ``clients`` concurrent
    clients."""
    from transformer_recommenders_tpu_torch.serving.asgi import make_server

    item_ids, user_ids = catalog_ids(service)
    server = make_server(service.to_asgi(), HOST, 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        warm = Connection(port, timeout=600)
        for uid in user_ids[:12]:  # each exclusion-width bucket the users give
            warm.post("/recommend_with_user_id", {"user_id": uid})
        warm.post("/recommend_with_item_id", {"item_id": item_ids[0]})
        warm.conn.close()
        conns = [Connection(port) for _ in range(clients)]

        def send(worker: int, i: int):
            ok, ms, _ = conns[worker].post(*request_for(worker, i, item_ids, user_ids))
            return ok, ms

        (samples, errors, wall), launches = counted(lambda: run_clients(clients, requests, send))
        for c in conns:
            c.conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    n = len(samples)
    return {"clients": clients, "requests_ok": n, "errors": errors, "qps": n / wall,
            **percentiles(samples), "wall_s": wall, "launches": launches}


# -- device (in process) ------------------------------------------------------------


async def call_app(app, path: str, payload: dict) -> int:
    """One request through the ASGI callable: its status."""
    body = json.dumps(payload).encode()
    received = False

    async def receive():
        nonlocal received
        if received:
            return {"type": "http.disconnect"}
        received = True
        return {"type": "http.request", "body": body, "more_body": False}

    status = [0]

    async def send(event):
        if event["type"] == "http.response.start":
            status[0] = event["status"]

    await app({"type": "http", "method": "POST", "path": path, "headers": []}, receive, send)
    return status[0]


def run_point(app, item_ids, user_ids, clients: int, requests: int) -> dict:
    """``clients`` threads, each with its own event loop per request."""
    def send(worker: int, i: int):
        route, payload = request_for(worker, i, item_ids, user_ids)
        t0 = time.perf_counter()
        status = asyncio.run(call_app(app, route, payload))
        return status == 200, (time.perf_counter() - t0) * 1e3

    (samples, errors, wall), launches = counted(lambda: run_clients(clients, requests, send))
    n = len(samples)
    return {"requests_ok": n, "errors": errors, "qps": n / wall, **percentiles(samples),
            "wall_s": wall, "launches": launches}


def metric_lines(app):
    """The app's ``/metrics`` lines without the comments."""
    return [line for line in app.metrics_text().splitlines() if not line.startswith("#")]


def batch_stats(app) -> dict:
    """The realised encoder batch sizes: ``xrt_span_metric_total{metric=
    "batch_size"}`` sums each waiter's batch size, so its sum over the
    requests that encode (the item and query routes: a user id serves its
    stored embedding) is the request-weighted mean batch."""
    out: dict = {}
    encode_requests = 0
    for line in metric_lines(app):
        if 'metric="batch_size"' in line:
            out["batch_size_sum"] = float(line.rsplit(" ", 1)[-1])
        if line.startswith("xrt_requests_total") and (
                'route="recommend_with_item_id"' in line or 'route="recommend_with_query"' in line):
            encode_requests += int(float(line.rsplit(" ", 1)[-1]))
    if encode_requests and "batch_size_sum" in out:
        out["encode_requests"] = encode_requests
        out["mean_batch"] = out["batch_size_sum"] / encode_requests
    return out


def span_seconds(app) -> dict:
    """Each span's seconds summed over the requests (``encode`` is each
    waiter's share of its batch, so its sum is the encoder's wall)."""
    out = {}
    for line in metric_lines(app):
        if line.startswith("xrt_span_seconds_total"):
            name = line.split('span="', 1)[1].split('"', 1)[0]
            out[name] = float(line.rsplit(" ", 1)[-1])
    return out


def bench_device(service, clients: int, requests: int, log=print) -> dict:
    """``scripts/bench_serving_device.py``: the sweep, then one sequential
    client."""
    from transformer_recommenders_tpu_torch.serving.service import MicroBatcher, Query

    item_ids, user_ids = catalog_ids(service)
    nb = 1
    while nb <= 64:  # every power-of-two encoder batch once before the sweep
        service.model.embed([Query(item_ids=[item_ids[0]]) for _ in range(nb)])
        nb *= 2
    points = []
    for window_ms, max_batch in SWEEP:
        service.model.batcher = MicroBatcher(lambda qs: service.model.embed(qs),
                                             max_batch=max_batch, window_ms=window_ms)
        # warm on a throwaway app; measure on a fresh one, whose counters
        # hold the measured pass alone
        run_point(service.to_asgi(), item_ids, user_ids, clients, clients * 4)
        app = service.to_asgi()
        point = run_point(app, item_ids, user_ids, clients, requests)
        point |= {"window_ms": window_ms, "max_batch": max_batch, "batch": batch_stats(app),
                  "span_seconds_total": span_seconds(app)}
        points.append(point)
        log(json.dumps(point))
    best = min(points, key=lambda r: r.get("p95_ms", float("inf")))
    # one sequential client, both batchers at window 0: a lone client never
    # fills a batch, so a window would add its whole wait to each request
    service.model.batcher = MicroBatcher(lambda qs: service.model.embed(qs), max_batch=64,
                                         window_ms=0.0)
    service.item_index.search_batcher = MicroBatcher(
        service.item_index._search_many, span="search_device", max_batch=64, window_ms=0.0)
    run_point(service.to_asgi(), item_ids, user_ids, 1, 32)
    app = service.to_asgi()
    sequential = run_point(app, item_ids, user_ids, 1, 96)
    sequential["span_seconds_total"] = span_seconds(app)
    return {"mode": "in-process ASGI, no socket/HTTP client", "backend": service.device.type,
            "clients": clients, "sweep": points, "best": best,
            "sequential_1_client": sequential}


# -- workers ------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def wait_port(port: int, proc: subprocess.Popen, deadline: float = 240.0) -> None:
    """Until the pool accepts a connection on ``port``; raises where its
    process exits first or ``deadline`` seconds pass."""
    t0 = time.time()
    while time.time() - t0 < deadline:
        if proc.poll() is not None:
            msg = f"the worker pool exited with code {proc.returncode} before serving"
            raise RuntimeError(msg)
        try:
            with socket.create_connection((HOST, port), timeout=1):
                return
        except OSError:
            time.sleep(0.25)
    msg = f"the worker pool on :{port} did not come up in {deadline:.0f} s"
    raise TimeoutError(msg)


def parse_timing(header: str | None) -> dict[str, float]:
    """A ``Server-Timing`` header as ``{span: ms}``."""
    out: dict[str, float] = {}
    for part in (header or "").split(","):
        bits = part.strip().split(";")
        for b in bits[1:]:
            if b.startswith("dur="):
                try:
                    out[bits[0]] = float(b[4:])
                except ValueError:
                    pass
    return out


def load(port: int, item_ids, user_ids, clients: int, requests: int) -> dict:
    """Concurrent clients against the pool: each request's latency, the
    worker that served it (``x-worker-pid``) and its ``Server-Timing``
    spans, so that a tail can be put down to one worker's queue, the
    encoder or the client."""
    conns = [Connection(port) for _ in range(clients)]

    def send(worker: int, i: int):
        ok, ms, headers = conns[worker].post(*request_for(worker, i, item_ids, user_ids))
        return ok, (ms, headers.get("x-worker-pid", ""), parse_timing(headers.get("server-timing")))

    samples, errors, wall = run_clients(clients, requests, send)
    for c in conns:
        c.conn.close()
    names = sorted({k for _, _, spans in samples for k in spans} - {"batch_size"})
    by_pid: dict[str, list[float]] = {}
    for ms, pid, _ in samples:
        by_pid.setdefault(pid, []).append(ms)
    # the latency beyond the server's spans (batch_wait holds encode;
    # search and process are disjoint of it): socket and client threads
    overhead = [ms - sum(spans.get(k, 0.0) for k in ("process", "batch_wait", "search"))
                for ms, _, spans in samples if spans]
    return {"requests_ok": len(samples), "errors": errors, "qps": len(samples) / wall,
            **percentiles([s[0] for s in samples]), "wall_s": wall,
            "spans": {name: percentiles([sp[name] for _, _, sp in samples if name in sp])
                      for name in names},
            "client_overhead": percentiles(overhead),
            "per_worker": {pid: {"requests": len(v), **percentiles(v)}
                           for pid, v in sorted(by_pid.items())}}


def run_pool(artifact, workers: int, pin: bool, device: str, clients: int, requests: int,
             item_ids, user_ids) -> dict:
    """One arm: ``serve_workers`` in a new session (its own process group,
    which is ended as a whole), warmed by sequential requests over fresh
    connections, which land on different workers, then the load; the
    workers' launches read from their exit lines."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "transformer_recommenders_tpu_torch.tools.bench_serving",
         "--serve-pool", str(artifact), str(port), str(workers), "1" if pin else "0", device],
        cwd=REPO, start_new_session=True, stdout=subprocess.PIPE, text=True)
    try:
        wait_port(port, proc)
        for i in range(max(12, 4 * workers)):
            for route, payload in (("/recommend_with_user_id", {"user_id": user_ids[i % len(user_ids)]}),
                                   ("/recommend_with_item_id", {"item_id": item_ids[i % len(item_ids)]})):
                warm = Connection(port, timeout=600)
                warm.post(route, payload)
                warm.conn.close()
        result = load(port, item_ids, user_ids, clients, requests)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        out, _ = proc.communicate(timeout=120)
    launches: dict[str, int] = {}
    exited = 0
    for line in out.splitlines():
        if " launches " in line and line.startswith("worker "):
            exited += 1
            for k, v in json.loads(line.split(" launches ", 1)[1]).items():
                if v:
                    launches[k] = launches.get(k, 0) + v
    return result | {"launches": launches, "workers_exited": exited}


def bench_workers(artifact, service, clients: int, requests: int, workers: int | None,
                  log=print) -> dict:
    """``scripts/bench_serving_workers.py``: workers=1, N and N pinned."""
    item_ids, user_ids = catalog_ids(service)
    device = service.device.type
    n = workers or min(os.cpu_count() or 1, 4)
    arms = [("workers=1", 1, False), (f"workers={n}", n, False), (f"workers={n}_pinned", n, True)]
    if n == 1:  # the second arm would be the first again
        arms = [arms[0], arms[2]]
    results = {}
    for tag, w, pin in arms:
        results[tag] = run_pool(artifact, w, pin, device, clients, requests, item_ids, user_ids)
        log(f"{tag}: {json.dumps(results[tag])}")
    best = max((k for k in results if k != "workers=1"), key=lambda k: results[k]["qps"])
    return {"backend": device, "host_cpus": os.cpu_count(), "clients": clients, "n_workers": n,
            "best_config": best, "speedup": results[best]["qps"] / results["workers=1"]["qps"],
            **results,
            "workers_device": f"{device} (the JAX script's workers ran on the CPU: a TPU "
                              "belongs to one process; the port's workers share the card)",
            "left_out": {f"workers={n}_eigen1": "an XLA flag of the JAX package's CPU workers "
                                                "(one compute thread each); no counterpart"}}


# -- the entry point ----------------------------------------------------------------


def run(mode: str, *, device, clients: int | None = None, requests: int | None = None,
        workers: int | None = None, artifact=None, log=print) -> dict:
    """One mode at its defaults where ``clients`` or ``requests`` is None:
    the artifact (``artifact``, else a fresh one), the service on
    ``device``, the mode's measurement."""
    from transformer_recommenders_tpu_torch.serving.asgi import SERVING_KERNELS
    from transformer_recommenders_tpu_torch.serving.service import Service
    from transformer_recommenders_tpu_torch.tools.quality_run import device_record

    default_clients, default_requests = DEFAULTS[mode]
    clients, requests = clients or default_clients, requests or default_requests
    if device.type == "cuda":  # built before the artifact's fit, as serve_workers builds them
        from transformer_recommenders_tpu_torch.ops import cuda_build

        cuda_build.build_all(SERVING_KERNELS)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        artifact = artifact or make_artifact(tmp, device)
        service = Service(artifact, device=device)
        setup_s = time.time() - t0
        if mode == "http":
            out = bench_http(service, clients, requests)
        elif mode == "device":
            out = bench_device(service, clients, requests, log=log)
        else:
            out = bench_workers(artifact, service, clients, requests, workers, log=log)
    # each client sends requests // clients, as the JAX scripts' clients do
    return out | {"requests": requests, "requests_sent": clients * (requests // clients),
                  "device": device_record(device), "setup_s": setup_s,
                  "total_s": time.time() - t0}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--serve-pool"]:  # one arm's pool, in a session of its own
        from transformer_recommenders_tpu_torch.serving.asgi import serve_workers

        artifact, port, workers, pin, device = argv[1:6]
        serve_workers(artifact, HOST, int(port), workers=int(workers), pin_cpus=pin == "1",
                      device=device)
        return 0
    parser = argparse.ArgumentParser(prog="bench_serving", description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=sorted(DEFAULTS))
    parser.add_argument("--clients", type=int, default=None,
                        help="concurrent clients (default 16)")
    parser.add_argument("--requests", type=int, default=None,
                        help="requests in all (default http 200, device 480, workers 400)")
    parser.add_argument("--workers", type=int, default=None,
                        help="workers: N (default min(cpu_count, 4))")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None,
                        help="the JSON record (default build/serving/<mode>.json)")
    args = parser.parse_args(argv)

    from transformer_recommenders_tpu_torch import resolve_device

    device = resolve_device(args.device)
    out_path = pathlib.Path(args.out or REPO / "build" / "serving" / f"{args.mode}.json")
    if out_path.resolve().parent == REPO:
        msg = f"--out {out_path} is at the root of the repository, where the JAX records live"
        raise SystemExit(msg)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    out = run(args.mode, device=device, clients=args.clients, requests=args.requests,
              workers=args.workers, log=log)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
