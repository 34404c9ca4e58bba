"""The port's spans (``transformer_recommenders_tpu_torch/tracing.py``).

On the CPU, at a small size (2 layers, d=128, S=8, B=4, two scanned
steps and an eval step), through the table-scored InfoNCE and through the
pool's pairwise head:

- tracing off: the outputs equal, bit for bit, those of the same code with
  every span taken out (the path as it was before the spans); no autograd
  hook is registered and no ``xrt.*`` event is recorded;
- tracing on: the same bits, and every span recorded inside its parent;
- the request sink: ``Server-Timing`` and ``/metrics`` carry the
  service's spans as before, through ``serving/asgi.py``'s re-export, and
  none of the model's layers; importing ``asgi`` loads no torch;
- graph labels: node counts read at each span's entry and exit make the
  marks ``graph_labels`` gives (the CUDA driver's capture queries faked).

On the card (``cuda``): the flagship's scanned steps captured with tracing
off, with tracing on and with the spans taken out give graphs of one node
count; with tracing on every node is labelled, and a profiled replay's
device events are as many as the labelled nodes.
"""

import contextlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from transformer_recommenders_tpu_torch import tracing
from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.serving import asgi
from transformer_recommenders_tpu_torch.training import evaluator as EV
from transformer_recommenders_tpu_torch.training import scan_steps as SS
from transformer_recommenders_tpu_torch.training import train_state as TS

SMALL = dict(input_dim=48, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_seq_length=8, learning_rate=1e-3)
LOSSES = {"table-infonce": {}, "pairwise": {"train_loss": "ContrastiveLoss", "margin": 0.5,
                                             "use_table_scored_loss": False}}
N_ITEMS = 40


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    tracing.disable()


def _case(loss: str):
    cfg = TrainConfig(**SMALL, **LOSSES[loss])
    gen = torch.Generator().manual_seed(0)
    params = TT.init_transformer_params(gen, cfg, device="cpu")
    emb = torch.nn.functional.normalize(torch.randn(N_ITEMS, cfg.input_dim, generator=gen), dim=1)
    table = torch.cat([torch.zeros(1, cfg.input_dim), emb])
    rng = np.random.default_rng(1)
    batches = {k: rng.integers(1, N_ITEMS + 1, size=(2, 4, 8))
               for k in ("history_item_idx", "pos_item_idx", "neg_item_idx")}
    batches["history_item_idx"][:, :, 6:] = 0
    seeds = torch.randint(0, 2**32, (2, 1 + 3 * cfg.num_hidden_layers), generator=gen)
    return cfg, params, table, batches, seeds


def _run(cfg, params, table, batches, seeds) -> list[torch.Tensor]:
    """Two scanned steps, then an eval step on their parameters: every
    output."""
    steps = SS.make_scanned_train_steps(cfg)
    state, logs = steps(TS.init_train_state(cfg, params), table, batches, seeds)
    prepare, eval_step = EV.make_eval_step(cfg)
    window = batches["history_item_idx"][0]
    metrics, idx, scores = eval_step(state.params, table, prepare(state.params, table), window,
                                     window, batches["pos_item_idx"][0][:, :3], np.full(4, 3),
                                     return_recs=True)
    return [TS.flatten(state.params), state.opt_state.mu, state.opt_state.nu, *logs.values(),
            idx, scores, *metrics.values()]


def _without_spans(monkeypatch) -> None:
    """The code path with every span taken out."""
    monkeypatch.setattr(tracing, "span", lambda name, request=True: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "mark_backward", lambda tensor, layer: tensor)
    monkeypatch.setattr(tracing, "capture", contextlib.nullcontext)


def _xrt_parent(event):
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith(tracing.PREFIX):
        parent = parent.cpu_parent
    return None if parent is None else parent.name


@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_tracing_off_changes_no_bit_and_records_nothing(monkeypatch, loss):
    case = _case(loss)
    hooks = []
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "register_hook", lambda self, hook: hooks.append(hook))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            off = _run(*case)
    assert hooks == []
    assert [e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)] == []
    with monkeypatch.context() as m:
        _without_spans(m)
        plain = _run(*case)
    tracing.enable()
    on = _run(*case)
    assert len(off) == len(plain) == len(on)
    for a, b, c in zip(off, plain, on):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_tracing_on_records_each_span_in_its_parent(loss):
    case = _case(loss)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(*case)
    parents: dict[str, set] = {}
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX):
            parents.setdefault(e.name, set()).add(_xrt_parent(e))
    in_steps = {"xrt.steps"}
    assert parents == {
        "xrt.steps": {None}, "xrt.state": in_steps, "xrt.embed": {"xrt.steps", "xrt.eval_step"},
        "xrt.encoder": {"xrt.steps", "xrt.eval_step"}, "xrt.loss": in_steps,
        "xrt.optimizer": in_steps, "xrt.loss.backward": in_steps,
        "xrt.encoder.backward": in_steps, "xrt.embed.backward": in_steps,
        "xrt.eval_step": {None}, "xrt.retrieval": {"xrt.eval_step"},
    }
    order = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.name.endswith(".backward")]
    assert order[:3] == ["xrt.loss.backward", "xrt.encoder.backward", "xrt.embed.backward"]


def _request(app: asgi.JSONApp) -> tuple[str, str]:
    client = asgi.TestClient(app)
    response = client.post("/encode", {})
    assert response.status_code == 200
    return response.headers["server-timing"], client.post("/metrics").json()


def test_request_spans_reach_server_timing_and_metrics():
    assert asgi.Trace is tracing.Trace and asgi.CURRENT_TRACE is tracing.CURRENT_TRACE
    assert asgi.trace_span is tracing.span
    app = asgi.JSONApp()

    @app.route("/encode")
    async def encode(_body):
        with asgi.trace_span("process"):
            with tracing.span("encoder", request=False):  # a model layer: not on the header
                pass
            with tracing.span("search"):
                tracing.CURRENT_TRACE.get().add_metric("batch_size", 3)
        return {}

    for enabled in (False, True):
        if enabled:
            tracing.enable()
        header, metrics = _request(app)
        names = [part.split(";")[0] for part in header.split(", ")]
        assert names == ["search", "process", "batch_size"]
        assert header.endswith("batch_size;dur=3.00")
        assert 'xrt_span_seconds_total{span="process"}' in metrics
        assert 'xrt_span_seconds_total{span="search"}' in metrics
        assert "encoder" not in metrics
    assert tracing.CURRENT_TRACE.get() is None


def test_serving_asgi_imports_no_torch():
    code = ("import sys\nimport transformer_recommenders_tpu_torch.serving.asgi\n"
            "assert 'torch' not in sys.modules, 'torch loaded'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])


def test_graph_labels_from_node_counts(monkeypatch):
    """A capture of 2 + 3 + 1 + 4 nodes: before the spans, in ``embed``, in
    ``encoder`` inside ``steps`` after ``embed``, then in a backward span;
    a span that captures nothing leaves no mark."""
    nodes = [0]
    monkeypatch.setattr(tracing, "_current_stream", lambda: 7)
    monkeypatch.setattr(tracing, "_capturing", lambda stream: (11, 99) if stream == 7 else None)
    monkeypatch.setattr(tracing, "_node_count", lambda graph: nodes[0])
    tracing.enable()
    n_before = len(tracing.graph_labels())
    with tracing.capture() as labels:
        nodes[0] += 2
        with tracing.span("steps", request=False):
            with tracing.span("embed", request=False):
                nodes[0] += 3
            with tracing.span("state", request=False):
                pass
            with tracing.span("encoder", request=False):
                nodes[0] += 1
            rec = tracing._Backward()
            rec.parent, rec.stream = "xrt.steps", 7
            rec.range = contextlib.nullcontext()  # a backward already under way
            rec.reach("loss")
            nodes[0] += 4
            rec.close()
    assert labels.nodes == 10
    assert tracing.graph_labels()[n_before:] == [{"nodes": 10, "marks": [
        [0, ""], [2, "xrt.steps/xrt.embed"], [5, "xrt.steps/xrt.encoder"],
        [6, "xrt.steps/xrt.loss.backward"], [10, ""]]}]
    assert tracing._CAPTURES == {}
    tracing.disable()
    assert tracing.capture() is tracing.span("steps", request=False)  # both the null context


@pytest.mark.cuda
def test_graph_labels_cover_every_replayed_node():
    """The flagship's scanned steps (K=2, B=128) captured with tracing off,
    with tracing on and with the spans taken out: one node count, the same
    results; with tracing on every node is labelled inside ``xrt.steps``,
    each layer has nodes, and each replay of a profiled call has one device
    event a labelled node."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: graphs are captured only on the card")
    from test_torch_cuda import SCAN_CONFIGS, _scan_case

    config, n_items, b = SCAN_CONFIGS["flagship"]
    cfg, table, state0, batches, seeds = _scan_case(torch.device("cuda"), config, n_items, b, 2)
    stacked = SS.stack_batches(batches)
    counts = []
    body = SS._GraphedWindow._body

    def counted(self, position):
        body(self, position)
        state = tracing._capturing(tracing._current_stream())
        if state is not None:
            counts.append(tracing._node_count(state[1]))

    outputs = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(SS._GraphedWindow, "_body", counted)
        for mode in ("off", "on", "without spans"):
            with pytest.MonkeyPatch.context() as inner:
                if mode == "without spans":
                    _without_spans(inner)
                if mode == "on":
                    tracing.enable()
                steps = SS.make_scanned_train_steps(cfg, with_logs=False)
                got, logs = steps(state0, table, stacked, torch.tensor(seeds))
                outputs.append([TS.flatten(got.params), got.opt_state.mu,
                                logs[f"loss/{cfg.train_loss}"]])
                if mode == "on":
                    labels = tracing.graph_labels()[-1]
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        steps(state0, table, stacked, torch.tensor(seeds))
                        torch.cuda.synchronize()
                tracing.disable()
    assert len(counts) == 3 and counts[0] == counts[1] == counts[2], counts
    for other in outputs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outputs[0], other))
    assert labels["nodes"] == counts[1]
    marks = labels["marks"]
    assert marks[0][0] == 0 and all(path.startswith("xrt.steps") for _, path in marks)
    layers = {path.rsplit("/", 1)[-1] for _, path in marks}
    assert layers >= {"xrt.state", "xrt.embed", "xrt.encoder", "xrt.loss", "xrt.optimizer",
                      "xrt.loss.backward", "xrt.encoder.backward", "xrt.embed.backward"}
    launches = {e.id for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU and e.name == "cudaGraphLaunch"}
    replayed: dict[int, int] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.id in launches:
            replayed[e.id] = replayed.get(e.id, 0) + 1
    assert sorted(replayed.values()) == [labels["nodes"]] * 2
