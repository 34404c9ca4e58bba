"""The port's serving worker pool, the unbatched item search and the
batch-1 two-stage top-k, on the CPU.

- ``serve_workers(artifact, workers=2, device="cpu", pin_cpus=True)`` in a
  process of its own, over an artifact the JAX trainer wrote, on a free
  port: every one of the nine APIs, over HTTP, answers as the in-process
  ``Service(device="cpu")`` does (the same item ids in the same order,
  floats within 1e-5); each worker runs on its own cores; an interrupt of
  the pool stops every worker.
- A pool over a missing artifact raises "serving worker exited" (as JAX's
  ``tests/test_round3_fixes.py`` holds its pool); ``serve(workers > 1)``
  refuses and names ``serve_workers``; ``pin_cpus``'s core sets are
  disjoint.
- ``ItemIndexService.search`` (one query, one device search) against
  JAX's ``search`` on the same artifact and queries: the same item ids,
  scores within 1e-5; and against the port's batched path.
- The two-stage top-k against JAX's ``_two_stage_topk`` and the direct
  top-k, on rows with many ties and with -0.0 beside +0.0: equal columns
  and scores bit for bit (both order ties lower index first and -0.0
  below +0.0); ``use_two_stage`` against JAX's gate at the shapes of
  ``tests/test_round5_fixes.py``.
"""

import asyncio
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.ops import topk as jax_topk
from transformer_recommenders_tpu.serving import deploy as jax_deploy
from transformer_recommenders_tpu.serving.service import Query as JaxQuery
from transformer_recommenders_tpu.serving.service import Service as JaxService
from transformer_recommenders_tpu_torch.ops import topk as port_topk
from transformer_recommenders_tpu_torch.serving import asgi
from transformer_recommenders_tpu_torch.serving import deploy as port_deploy
from transformer_recommenders_tpu_torch.serving.service import Query, Service

TOL = 1e-5
POOL_START_TIMEOUT = 90


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    work = tmp_path_factory.mktemp("workers")
    trainer = jax_deploy._fast_dev_trainer(str(work))
    trainer.save(work / "artifact")
    trainer.close()
    return work / "artifact"


@pytest.fixture(scope="module")
def service(artifact):
    return Service(artifact, device="cpu")


def _same(got, want, where=""):
    if isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (where, got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), (where, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def start_pool(artifact, port: int) -> subprocess.Popen:
    code = ("import sys\nfrom transformer_recommenders_tpu_torch.serving.asgi import "
            "serve_workers\ntry:\n    serve_workers(sys.argv[1], '127.0.0.1', int(sys.argv[2]), "
            "workers=2, device='cpu', pin_cpus=True)\nexcept KeyboardInterrupt:\n    pass")
    return subprocess.Popen([sys.executable, "-c", code, str(artifact), str(port)],
                            env={**os.environ, "OMP_NUM_THREADS": "1"})


def wait_until_up(pool: subprocess.Popen, port: int, workers: int = 2) -> set[int]:
    """The workers' pids, once each has answered (fresh connections, which
    the kernel spreads over the workers' sockets)."""
    deadline = time.monotonic() + POOL_START_TIMEOUT
    pids: set[int] = set()
    while time.monotonic() < deadline:
        if pool.poll() is not None:
            pytest.fail(f"the pool exited with code {pool.returncode}")
        try:
            status, _, headers = asgi.http_post("127.0.0.1", port, "model_name", {}, timeout=5)
            if status == 200:
                pids.add(int(headers["x-worker-pid"]))
                if len(pids) == workers:
                    return pids
                continue
        except OSError:
            pass
        time.sleep(0.2)
    pytest.fail(f"{len(pids)} of {workers} workers answered within {POOL_START_TIMEOUT} s")


@pytest.fixture(scope="module")
def pool(artifact, service):
    """The pool's answers to the nine APIs (twice) and its workers' pids,
    and whether they are gone after an interrupt."""
    port = free_port()
    proc = start_pool(artifact, port)
    try:
        pids = wait_until_up(proc, port)
        answers = []
        for _ in range(2):
            for name, payload in port_deploy.api_requests(service):
                status, body, headers = asgi.http_post("127.0.0.1", port, name, payload)
                answers.append((name, payload, status, body))
                pids.add(int(headers["x-worker-pid"]))
        affinity = {pid: os.sched_getaffinity(pid) for pid in pids}
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    return {"answers": answers, "pids": pids, "affinity": affinity, "alive": alive}


def test_pool_answers_the_nine_apis_as_the_service(pool, service):
    names = {name for name, *_ in pool["answers"]}
    assert len(names) == 9
    for name, payload, status, body in pool["answers"]:
        assert status == 200, (name, body)
        _same(body, port_deploy.test_service(service, name, payload), name)


def test_pool_workers_pinned_and_stopped(pool):
    assert len(pool["pids"]) == 2  # both workers answered
    cores = sorted(pool["affinity"].values(), key=min)
    assert set(cores[0]).isdisjoint(cores[1])
    assert cores == [set(asgi.worker_cores(i, 2)) for i in range(2)]
    assert pool["alive"] == []


def test_pool_over_a_missing_artifact_raises(tmp_path):
    with pytest.raises(RuntimeError, match="worker exited"):
        asgi.serve_workers(str(tmp_path / "no-such-artifact"), "127.0.0.1", free_port(),
                           workers=2, device="cpu")


def test_serve_refuses_workers():
    with pytest.raises(RuntimeError, match="serve_workers"):
        asgi.serve(asgi.JSONApp(), workers=4)


@pytest.mark.parametrize("workers", [1, 2, 3, 4, 8])
def test_pinned_cores_are_disjoint(workers):
    sets = [set(asgi.worker_cores(i, workers)) for i in range(workers)]
    assert all(sets)
    if workers <= len(os.sched_getaffinity(0)):
        for i in range(workers):
            for j in range(i):
                assert sets[i].isdisjoint(sets[j])


# -- the unbatched search ------------------------------------------------------------------


def queries(service, n: int = 6):
    rng = np.random.default_rng(0)
    dim = service.item_index.index.embeddings.shape[1]
    ids = [str(r["item_id"]) for r in service.item_index.index.store.records]
    out = []
    for i in range(n):
        emb = rng.normal(size=dim).astype(np.float32)
        out.append(dict(embedding=[float(x) for x in emb],
                        exclude_item_ids=list(rng.choice(ids, size=i, replace=False)),
                        top_k=[5, 10, 20, 100, 3, 0][i]))
    return out


def test_item_search_matches_jax(artifact, service):
    jax_service = JaxService(artifact)
    for q in queries(service):
        got = service.item_index.search(Query(**q))
        want = jax_service.item_index.search(JaxQuery(**q))
        assert [c.item_id for c in got] == [c.item_id for c in want]
        for g, w in zip(got, want):
            assert abs(g.score - w.score) <= TOL


def test_item_search_matches_the_batched_path(service):
    for q in queries(service):
        got = service.item_index.search(Query(**q))
        want = asyncio.run(service.item_index.search_batched(Query(**q)))
        assert [c.to_dict() for c in got] == [c.to_dict() for c in want]


# -- the two-stage top-k ---------------------------------------------------------------------


def tie_rows(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = (rng.integers(-4, 5, size=(1, n)) / 4).astype(np.float32)  # many ties
    rows[0, rng.random(n) < 0.2] = -0.0
    rows[0, rng.random(n) < 0.05] = -np.inf  # excluded items
    return rows


@pytest.mark.parametrize("n", [6400, 7001, 62000])
@pytest.mark.parametrize("k", [1, 20, 100])
def test_two_stage_topk_matches_jax_and_direct(n, k):
    if not port_topk.use_two_stage(1, n, k):
        assert not jax_topk.use_two_stage(1, n, k)
        return
    scores = tie_rows(n, n + k)
    cols = port_topk._two_stage_topk(torch.from_numpy(scores), k)
    direct = port_topk.top_k_columns(torch.from_numpy(scores), k)
    assert torch.equal(cols, direct)
    want_s, want_c = jax_topk._two_stage_topk(jnp.asarray(scores), k)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want_c))
    got_s = torch.from_numpy(scores).gather(1, cols).numpy()
    np.testing.assert_array_equal(got_s.view(np.int32), np.asarray(want_s).view(np.int32))


def test_topk_items_routes_batch_one_through_two_stages(monkeypatch):
    rng = np.random.default_rng(5)
    items = torch.from_numpy(rng.normal(size=(7000, 16)).astype(np.float32))
    query = torch.from_numpy(rng.normal(size=(1, 16)).astype(np.float32))
    calls = []
    two_stage = port_topk._two_stage_topk
    monkeypatch.setattr(port_topk, "_two_stage_topk",
                        lambda s, k: calls.append(k) or two_stage(s, k))
    got = port_topk.topk_items(query, items, 100, metric="dot")
    assert calls == [100]
    want = jax_topk.topk_items(jnp.asarray(query.numpy()), jnp.asarray(items.numpy()), 100,
                               metric="dot")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)


def test_use_two_stage_matches_jax_gate():
    n, k = 62000, 100
    for batch in range(1, 33):
        assert port_topk.use_two_stage(batch, n, k) == jax_topk.use_two_stage(batch, n, k)
    floor = jax_topk._TWO_STAGE_BLOCKS * k * 4
    for items in (floor - 1, floor, 7000):
        assert port_topk.use_two_stage(1, items, k) == jax_topk.use_two_stage(1, items, k)
    assert port_topk._TWO_STAGE_BLOCKS == jax_topk._TWO_STAGE_BLOCKS


def test_chip_smoke_workers_phase_rehearsal(tmp_path):
    """chip_smoke.py's phase 15 (a pool of two workers against the
    in-process Service over HTTP, a concurrent burst, the pool stopped and
    every worker's launch line read, the unbatched search) at a small size
    on the CPU."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))
    tiny = dict(input_dim=48, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                intermediate_size=48, max_seq_length=8, compute_dtype="float32")
    chip_smoke.build_artifact(tmp_path / "artifact", device="cpu", num_items=80, num_users=30,
                              config=tiny)
    launches = chip_smoke.workers_phase(tmp_path / "artifact", device="cpu", requests=8)
    assert not any(launches.values())  # the plain path runs no kernel
