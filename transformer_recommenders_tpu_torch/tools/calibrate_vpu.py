"""Measure the card's CUDA-core and special-function dispatch rates with the
throughput probe (``ops/vpu_calibration.py``, ``csrc/vpu_calibration.cu``).

    python -m transformer_recommenders_tpu_torch.tools.calibrate_vpu [--out PATH]

Counterpart of the JAX package's ``scripts/calibrate_vpu.py``, with its
method: each mix's chain is timed at two lengths, K_LO and K_HI, over one
tile, and the slope between them cancels the launch, the load and the
store, so the rate is the marginal

    elems * (K_HI - K_LO) * OPS_PER_ITER[mix] / (t_hi - t_lo)

element operations per ms (the JAX unit).  The tile is (8 x SMs, 512) f32:
exactly one full wave of the kernel's blocks.  Times are CUDA-graph replays
timed with CUDA events (``tools.graph_ms``).

The plausibility gate holds every timed point, not only the slope, below
1.5 times this card's peak for the mix, from ``nvidia-smi``'s maximum SM
clock: 128 FP32 lanes per SM per clock for ``fma`` and ``select``; for
``exp``, whose iteration is one MUFU.EX2 among FP32 instructions, 16 MUFU
results per SM per clock (the CUDA C++ Programming Guide's throughput
table, compute capability 9.0), times its 2 counted operations.  A point
above it means the chain folded: the tool exits non-zero and writes
nothing.

Beside each mix it prints the share of that peak, the SM clock and power
draw ``nvidia-smi`` read while the mix ran, and what the kernel's loop
compiles to (``cuobjdump -sass``, where the toolkit has it).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import threading

from transformer_recommenders_tpu_torch import tools

K_LO, K_HI = 4096, 16384
STEPS_PER_LOOP = 16  # the kernel's loop body: 8 unrolled iterations of two chains
FP32_LANES_PER_SM = 128
MUFU_PER_SM = 16
HEADROOM = 1.5


class _Sampler(threading.Thread):
    """``clocks.sm`` (MHz) and ``power.draw`` (W) read by ``nvidia-smi``
    every ~50 ms until stopped."""

    def __init__(self):
        super().__init__(daemon=True)
        self.samples: list[tuple[float, float]] = []
        self._stop_event = threading.Event()

    def run(self):
        while not self._stop_event.is_set():
            line = tools.nvidia_smi("clocks.sm,power.draw")[0]
            self.samples.append(tuple(float(v) for v in line.split(",")))
            self._stop_event.wait(0.05)

    def stop(self) -> dict:
        self._stop_event.set()
        self.join()
        if not self.samples:
            msg = "calibrate_vpu: nvidia-smi read no clock beside the timing window"
            raise SystemExit(msg)
        clocks = [c for c, _ in self.samples]
        power = [p for _, p in self.samples]
        return {"samples": len(self.samples), "clocks_sm_mhz_median": statistics.median(clocks),
                "clocks_sm_mhz_min": min(clocks), "power_draw_w_max": max(power),
                "power_draw_w_median": statistics.median(power)}


def peaks(device) -> dict:
    """Each mix's peak in element operations per ms at the card's maximum
    SM clock, and what it is made of."""
    import torch

    from transformer_recommenders_tpu_torch.ops.vpu_calibration import OPS_PER_ITER

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(tools.nvidia_smi("clocks.max.sm")[0])
    fp32 = FP32_LANES_PER_SM * sms * mhz * 1e3  # per ms
    mufu = MUFU_PER_SM * sms * mhz * 1e3
    return {
        "sms": sms, "clocks_max_sm_mhz": mhz,
        "fma": fp32, "select": fp32, "exp": OPS_PER_ITER["exp"] * mufu,
        "fp32_lane_ops_per_s": fp32 * 1e3, "mufu_per_s": mufu * 1e3,
    }


def sass_loops(lib_path) -> dict:
    """Opcode counts of the innermost loop of each mix's kernel in the
    built library (``cuobjdump -sass``), or ``None`` where the toolkit has
    no ``cuobjdump``.  The loop is the longest backward branch's body: 8
    unrolled iterations of two chains."""
    from transformer_recommenders_tpu_torch.ops.vpu_calibration import MIXES

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(exe).exists():
        return None
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S):
        m = re.search(r"vpu_chain_kernelILi(\d)E", name)
        if m is None:
            continue
        instrs = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
        loop = instrs
        best = 0
        for addr, op, rest in instrs:
            t = re.match(r"\s*(0x[0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                span = [i for i in instrs if int(t.group(1), 16) <= i[0] <= addr]
                if len(span) > best:
                    best, loop = len(span), span
        counts = collections.Counter(op.split(".")[0] for _, op, _ in loop)
        out[MIXES[int(m.group(1))]] = {"instructions": len(loop),
                                       "opcodes": dict(counts.most_common())}
    return out


def calibrate(*, log=print) -> dict:
    """Time every mix at K_LO and K_HI over the one-wave tile, gate each
    point and each slope; returns the record (raises ``SystemExit`` when a
    point is implausible)."""
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.ops.vpu_calibration import (
        OPS_PER_ITER, vpu_chain, wave_tile)

    device = torch.device("cuda")
    shape = wave_tile(device)
    elems = shape[0] * shape[1]
    peak = peaks(device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(shape, generator=gen, device=device) + 0.5
    log(f"card {tools.card()}; {peak['sms']} SMs, max SM clock {peak['clocks_max_sm_mhz']:.0f} "
        f"MHz; tile {shape} f32 (one wave), K {K_LO} and {K_HI}")
    results = {}
    for mix, ops in OPS_PER_ITER.items():
        sampler = _Sampler()
        sampler.start()
        vpu_chain(x, iters=K_HI, mix=mix)  # bring the clocks up
        t_lo = tools.graph_ms(lambda m=mix: vpu_chain(x, iters=K_LO, mix=m))
        t_hi = tools.graph_ms(lambda m=mix: vpu_chain(x, iters=K_HI, mix=m))
        smi = sampler.stop()
        ceiling = HEADROOM * peak[mix]
        for label, t, k in (("K_LO", t_lo, K_LO), ("K_HI", t_hi, K_HI)):
            implied = elems * k * ops / t
            if implied > ceiling:
                msg = (f"calibrate_vpu: mix={mix} at {label} implies {implied:.4g} elemops/ms, "
                       f"above the ceiling {ceiling:.4g} (1.5x this card's peak): the chain "
                       "folded. Refusing to publish.")
                raise SystemExit(msg)
        rate = elems * (K_HI - K_LO) * ops / (t_hi - t_lo)
        if not 0.0 < rate < ceiling:
            msg = (f"calibrate_vpu: mix={mix} slope {rate:.4g} elemops/ms (t_lo {t_lo:.4f} ms, "
                   f"t_hi {t_hi:.4f} ms) is implausible (ceiling {ceiling:.4g}). Refusing to "
                   "publish.")
            raise SystemExit(msg)
        results[mix] = {"t_lo_ms": t_lo, "t_hi_ms": t_hi, "ops_per_iter": ops,
                        "elemops_per_ms": rate, "peak_elemops_per_ms": peak[mix],
                        "share_of_peak": rate / peak[mix], "ceiling_elemops_per_ms": ceiling,
                        **smi}
        log(f"  {mix:6s} {t_lo:.4f} ms @K={K_LO}  {t_hi:.4f} ms @K={K_HI}  "
            f"{rate:.5g} elemops/ms = {rate / peak[mix]:.3f} of the peak {peak[mix]:.5g} "
            f"(gate {ceiling:.5g} on every point); SM clock median "
            f"{smi['clocks_sm_mhz_median']:.0f} MHz (min {smi['clocks_sm_mhz_min']:.0f}), "
            "power draw max "
            f"{smi['power_draw_w_max']:.1f} W ({smi['samples']} samples)")
    fp32_rate = results["fma"]["elemops_per_ms"] * 1e3
    mufu_rate = results["exp"]["elemops_per_ms"] * 1e3 / OPS_PER_ITER["exp"]
    log(f"  CUDA-core rate (fma) {fp32_rate:.4g} f32 ops/s against "
        f"{peak['fp32_lane_ops_per_s']:.4g} (128 lanes/SM/clock; the 67 TFLOP/s data-sheet "
        "figure counts an FMA as 2); "
        f"special-function rate (exp iterations, one MUFU.EX2 each) {mufu_rate:.4g}/s against "
        f"{peak['mufu_per_s']:.4g} (16/SM/clock)")
    lib = cuda_build.build_all(["vpu_calibration"])["vpu_calibration"]
    sass = sass_loops(lib)
    if sass is None:
        log("  compiled loops: not inspected (no cuobjdump)")
    else:
        # the dispatch rate: instructions (any pipe) per lane per second
        # against 128 per SM per clock, the SM's four schedulers at one warp
        # instruction a clock each
        for mix, loop in sass.items():
            per_step = loop["instructions"] / STEPS_PER_LOOP
            steps_per_s = results[mix]["elemops_per_ms"] * 1e3 / OPS_PER_ITER[mix]
            results[mix]["sass_instructions_per_step"] = per_step
            results[mix]["dispatch_share"] = per_step * steps_per_s / peak["fp32_lane_ops_per_s"]
            log(f"  {mix} loop: {loop['instructions']} instructions for {STEPS_PER_LOOP} steps "
                f"{loop['opcodes']}; dispatch share {results[mix]['dispatch_share']:.3f}")
    return {"card": tools.card(), "device": torch.cuda.get_device_name(device),
            "shape": list(shape), "k_lo": K_LO, "k_hi": K_HI, "peaks": peak,
            "results": results, "fp32_ops_per_s": fp32_rate, "mufu_per_s": mufu_rate,
            "sass_loops": sass}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=pathlib.Path,
                        default=tools.BUILD_DIR / "vpu_calibration.json")
    args = parser.parse_args(argv)
    if not tools.require_cuda("calibrate_vpu"):
        return 2
    record = calibrate()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=2))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
