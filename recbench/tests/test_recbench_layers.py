"""The program's spans reduced to layers (``recbench/layers.py``) on
made-up profiler events: eager launches under nested ranges, a replay
mapped by its graph's labels, a replay whose node count matches no
labelling (the layers withheld), idle gaps put down to the spans open on
the window's host thread; and the entry point's run on the CPU."""

from __future__ import annotations

import dataclasses
import json

import pytest
from torch.autograd import DeviceType

from recbench import layers
from recbench.trace import WINDOW

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Event:
    name: str
    device_type: object
    start: float
    end: float
    thread: int = 1
    id: int = 0
    is_user_annotation: bool = False

    @property
    def time_range(self):
        return Range(self.start, self.end)


def _events() -> list[Event]:
    """A window of 1000 us on thread 1: an eval call (eager, launches at
    25, 70 and 140) and a call of the steps (one replay of 3 nodes, launched
    at 300); a backward span on the autograd thread 2."""
    host = [Event(WINDOW, CPU, 0, 1000),
            Event("xrt.eval_step", CPU, 10, 200), Event("xrt.embed", CPU, 20, 50),
            Event("xrt.encoder", CPU, 60, 120), Event("xrt.retrieval", CPU, 130, 190),
            Event("xrt.steps", CPU, 290, 600), Event("xrt.state", CPU, 295, 299),
            Event("xrt.encoder.backward", CPU, 700, 800, thread=2)]
    launches = [Event("cudaLaunchKernel", CPU, 25, 26, id=101),
                Event("cudaLaunchKernel", CPU, 70, 71, id=102),
                Event("cudaLaunchKernel", CPU, 140, 141, id=103),
                Event("cudaMemcpyAsync", CPU, 296, 297, id=104),
                Event("cudaGraphLaunch", CPU, 300, 305, id=200),
                Event("cudaLaunchKernel", CPU, 710, 711, thread=2, id=105)]
    device = [Event("embed_kernel", CUDA, 30, 40, id=101),
              Event("layer_kernel", CUDA, 80, 150, id=102),
              Event("topk_kernel", CUDA, 150, 160, id=103),
              Event("Memcpy DtoD", CUDA, 298, 300, id=104),
              Event("node 0", CUDA, 400, 410, id=200), Event("node 1", CUDA, 410, 430, id=200),
              Event("node 2", CUDA, 430, 460, id=200),
              Event("bwd_kernel", CUDA, 720, 740, id=105),
              Event("xrt.encoder", CUDA, 80, 150, is_user_annotation=True)]
    return host + launches + device


LABELS = [{"nodes": 3, "marks": [[0, "xrt.steps/xrt.embed"], [1, "xrt.steps/xrt.encoder"],
                                 [2, "xrt.steps/xrt.loss.backward"]]}]


def _ms(us: float, units: int = 2) -> float:
    return us * 1e-3 / units


def test_layer_of():
    assert layers.layer_of("xrt.steps/xrt.loss.backward") == "loss"
    assert layers.layer_of("xrt.eval_step/xrt.retrieval") == "retrieval"
    assert layers.layer_of("xrt.steps") == "steps"
    assert layers.layer_of("") == ""


def test_eager_and_replayed_events_by_span():
    out = layers.reduce(_events(), LABELS, units=2)
    assert out["complete"]
    assert out["replays"] == {"replays": 1, "unlabelled": 0, "events": [3], "nodes": [3]}
    assert out["layer_s"] == pytest.approx({
        "embed": 20e-6, "encoder": 110e-6, "retrieval": 10e-6, "state": 2e-6,
        "loss": 30e-6})
    by_span = out["by_span"]
    assert by_span["xrt.eval_step/xrt.embed"][0] == pytest.approx(_ms(10))
    assert by_span["xrt.steps/xrt.encoder"][0] == pytest.approx(_ms(20))
    assert by_span["xrt.encoder.backward"][0] == pytest.approx(_ms(20))
    # idle: [0, 30) mid 15 in eval_step; [40, 80) mid 60 in encoder; [160,
    # 298) mid 229 outside; [300, 400) mid 350 in steps; [460, 720) mid 590
    # in steps; [740, 1000) mid 870 outside
    assert out["layer_idle_s"] == pytest.approx({
        "eval_step": 70e-6, "encoder": 40e-6, "steps": 360e-6})
    assert by_span[""][1] == pytest.approx(_ms(138 + 260))
    assert by_span["xrt.steps"] == pytest.approx([0.0, _ms(360)])
    got = layers.metrics(out, "recommend", 2)
    assert set(got) == {"embed.device_ms.recommend", "encoder.device_ms.recommend",
                        "retrieval.device_ms.recommend", "encoder.idle_ms.recommend"}
    assert got["encoder.idle_ms.recommend"] == {"value": pytest.approx(_ms(40)), "unit": "ms"}
    train = layers.metrics(out, "train", 2)
    assert train["loss.device_ms.train"]["value"] == pytest.approx(_ms(30))
    assert train["steps.idle_ms.train"]["value"] == pytest.approx(_ms(360))


@pytest.mark.parametrize("labels", [
    [dict(LABELS[0], nodes=4)],  # no graph of the replay's node count
    LABELS + [{"nodes": 3, "marks": [[0, "xrt.steps/xrt.state"]]}],  # two labellings
], ids=["count", "ambiguous"])
def test_a_replay_its_labels_do_not_fit_withholds_the_layers(labels):
    out = layers.reduce(_events(), labels, units=2)
    assert not out["complete"] and out["replays"]["unlabelled"] == 1
    assert out["by_span"][layers.UNLABELLED][0] == pytest.approx(_ms(60))
    assert layers.metrics(out, "train", 2) == {}


def test_the_entry_point_on_the_cpu(tiny_root):
    """A traced run of a tiny recommend cell with the program's tracing on:
    the result line gains the spans (no device events on the CPU: all
    idle), and the program's tracing is off again after it."""
    from transformer_recommenders_tpu_torch import tracing

    result = json.loads(json.dumps(layers.run(tiny_root, "ml25m_ccl.recommend", 2**31 + 5,
                                              0.3, True, device="cpu")))
    assert result["breakdown"]["replays"] == {"replays": 0, "unlabelled": 0, "events": [],
                                              "nodes": []}
    assert any(p.startswith("xrt.eval_step") for p in result["breakdown"]["by_span"])
    assert result["correct"]
    assert not tracing.enabled()
