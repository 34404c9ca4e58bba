"""Measurement entry points of the port, run on the card:

    python -m transformer_recommenders_tpu_torch.tools.calibrate_vpu [--out PATH]
    python -m transformer_recommenders_tpu_torch.tools.profile_fused_sections \\
        [--shape flagship|train|seed_spread|quality|path_b|path_c|tiny] \\
        [--dtype bfloat16|float32] [--dropout RATE] [--tree PATH] [--out PATH]

Each exits non-zero without a CUDA card (it never times the CPU), prints
its table with the card's name and power limit, and writes a JSON record
only where ``--out`` points (by default under ``build/`` at the root of the
repository).  Below: what both share.  ``quality_run`` (the JAX scripts'
quality protocols against the JAX package's records) and ``bench_serving``
(the JAX scripts' serving benchmarks) also write under ``build/`` and name
the card; they run on the CPU where told ``--device cpu``.
"""

from __future__ import annotations

import pathlib
import statistics
import subprocess
import sys

BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, the same data sheet


def nvidia_smi(query: str) -> list[str]:
    """One line per card of ``nvidia-smi --query-gpu=<query>`` (csv, no
    header, no units)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require_cuda(prog: str) -> bool:
    """True when a CUDA card is there; else says so on stderr."""
    import torch

    if torch.cuda.is_available():
        return True
    print(f"{prog}: no CUDA device available; this measures the card and does not run on "
          "the CPU", file=sys.stderr)
    return False


def graph_ms(fn, iters: int = 20, reps: int = 20) -> float:
    """Device time of one call of ``fn`` (ms): ``reps`` calls captured in a
    CUDA graph, the median of ``iters`` CUDA-event timings of a replay,
    divided by ``reps``.  The graph leaves out the host's launch overhead;
    inputs and weights stay L2-resident between calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up: lazy initialization, allocator
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)
