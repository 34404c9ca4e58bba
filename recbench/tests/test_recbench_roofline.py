"""The least-work arithmetic against hand counts at a small shape, and the
per-layer readers on a made-up trace."""

from __future__ import annotations

import json
import re

import pytest
import torch

from recbench import roofline, spec
from recbench.trace import Trace, bare_name, libraries, port_kernels, short_name
from recbench.tests.conftest import REPO

MODEL = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2, "input_dim": 6}
HIST = torch.tensor([[5, 7, 0], [1, 2, 3]])


def least(flops, nbytes, peak=989e12):
    return max(flops / peak, nbytes / 3.35e12)


def test_sequence_counts():
    assert roofline.sequence_counts(HIST) == {"rows": 5.0, "pairs": 9.0, "slots": 6.0}


def test_layer_counts():
    c = roofline.sequence_counts(HIST)
    # dense: 2 * 5 rows * (4 * 16 + 2 * 4 * 8); attention: 4 * 9 pairs * 4
    assert roofline.encoder_layer_flops(MODEL, 5, 9, False) == 1424
    assert roofline.encoder_layer_flops(MODEL, 5, 9, True) == 3 * 1424
    assert roofline.layer_params(4, 8) == 172
    # x, dy in and y, dx out at 2 bytes; the mask; parameters in, gradients out
    assert roofline.fused_layer_seconds(MODEL, c, True) == pytest.approx(
        2 * least(4272, 4 * 5 * 4 * 2 + 6 + 2 * 4 * 172))
    assert roofline.fused_layer_seconds(MODEL, c, False) == pytest.approx(
        2 * least(1424, 2 * 5 * 4 * 2 + 6 + 4 * 172))
    # q, k, v in (6 bytes a value a row), the f32 context out (4), the f32
    # cotangent in (4), dq, dk, dv out (6)
    assert roofline.attn_core_seconds(MODEL, c, True) == pytest.approx(
        2 * least(12 * 9 * 4, 20 * 5 * 4 + 6))
    assert roofline.attn_core_seconds(MODEL, c, False) == pytest.approx(
        2 * least(4 * 9 * 4, 10 * 5 * 4 + 6))


def test_loss_head_counts():
    assert roofline.table_infonce_seconds(4, 3, 5, 10) == pytest.approx(least(360, 204))
    assert roofline.pairwise_seconds(4, 3, 5) == pytest.approx(least(360, 208))


def test_model_flops():
    c = roofline.sequence_counts(HIST)
    # projection 4 * 7 items * 6 * 4, two layers forward and backward, the
    # loss head's 6 * 3 * 5 * 4
    assert roofline.train_step_flops(MODEL, c, 7, 3, 5) == 672 + 2 * 4272 + 360
    assert roofline.recommend_call_seconds(MODEL, c, 4, 2, 10) == pytest.approx(
        (2 * 4 * 6 * 4 + 2 * 1424) / 989e12 + 2 * 2 * 10 * 4 / 67e12)


def test_kernel_names():
    name = "void (anonymous namespace)::fused_layer_bwd_rows_kernel<3>((anonymous namespace)::BwdParams)"
    assert bare_name(name) == "fused_layer_bwd_rows_kernel"
    assert short_name(name) == "fused_layer_bwd_rows_kernel<3>"
    assert bare_name("void cutlass::Kernel2<cutlass_80_simt_sgemm>(Params)") == "Kernel2"
    own, shared = port_kernels(REPO)
    assert own["fused_layer_fwd_tc_kernel"] == "fused_layer"
    assert own["pairwise_dq_kernel"] == "fused_pairwise"
    assert own["gather_rows_kernel"] == "gather_rows"
    assert shared["sum_splits_kernel"] == {"fused_infonce", "fused_pairwise",
                                           "fused_table_infonce"}


def test_every_kernel_of_the_port_has_a_library():
    """Each ``__global__`` in the port's CUDA sources and headers maps to a
    library: its own source's, or, for a header's, the sources that launch it."""
    csrc = REPO / "transformer_recommenders_tpu_torch" / "csrc"
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")
    defined = {n for f in csrc.glob("*.cu*") for n in pattern.findall(f.read_text())}
    own, shared = port_kernels(REPO)
    assert defined and defined == set(own) | set(shared)
    assert all(shared.values())


def test_a_shared_kernel_goes_to_the_library_that_ran_before_it_on_its_stream():
    own = {"pairwise_dq_kernel": "fused_pairwise", "table_bwd_kernel": "fused_table_infonce"}
    shared = {"sum_splits_kernel": {"fused_pairwise", "fused_table_infonce"},
              "only_kernel": {"gather_rows"}}
    events = [(7, 5.0, "sum_splits_kernel"), (7, 1.0, "pairwise_dq_kernel"),
              (9, 2.0, "table_bwd_kernel"), (7, 3.0, "Kernel2"), (9, 4.0, "sum_splits_kernel"),
              (8, 0.5, "sum_splits_kernel"), (8, 0.6, "only_kernel")]
    assert libraries(events, own, shared) == [
        "fused_pairwise", "fused_pairwise", "fused_table_infonce", "library",
        "fused_table_infonce", "library", "gather_rows"]


def _trace():
    return Trace(units=4, window_s=2.0, busy_s=1.5,
                 library_s={"fused_layer": 0.5, "gather_rows": 0.02, "library": 0.8,
                            "fused_pairwise": 0.4, "fused_table_infonce": 0.1, "attn_core": 0.2},
                 span_s={"recbench.topk": 0.04},
                 least_s={"fused_layer": 0.05, "model": 0.1, "pairwise": 0.04,
                          "table_infonce": 0.01, "attn_core": 0.02},
                 breakdown={})


EXPECTED = {
    "device.idle_share.train": 25.0,
    "device.idle_share.recommend": 25.0,
    "step_mfu.train": 5.0,
    "step_mfu.recommend": 5.0,
    "fused_layer_roofline.train": 10.0,
    "fused_layer_roofline.recommend": 10.0,
    "table_infonce_roofline.train": 10.0,
    "pairwise_roofline.train": 10.0,
    "attn_core_roofline.train": 10.0,
    "attn_core_roofline.recommend": 10.0,
    "gather.device_ms.train": 5.0,
    "library_ops.device_ms.train": 200.0,
    "library_ops.device_ms.recommend": 200.0,
    "topk.device_ms.recommend": 10.0,
}


def test_every_metric_has_an_expected_reading():
    names = {m["name"] for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]}
    assert names == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_readers(name):
    read = spec.reader(REPO, name)
    assert read(_trace()) == pytest.approx(EXPECTED[name])
    # a metric named for a kind of cell is reported in cells of that kind alone
    kind = name.rsplit(".", 1)[1]
    metric = spec.metric(REPO, name)
    assert metric["workloads"]
    assert all(spec.load(REPO, c).kind == kind for c in metric["workloads"])
    empty = _trace()
    empty.library_s, empty.span_s, empty.least_s = {}, {}, {}
    if not name.startswith("device."):
        assert read(empty) is None  # never 0 for what was not measured
