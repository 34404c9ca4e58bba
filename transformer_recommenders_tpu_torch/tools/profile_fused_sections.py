"""Section profile of the fused layer on the card: where the forward's and
the backward's time goes.

    python -m transformer_recommenders_tpu_torch.tools.profile_fused_sections \\
        [--shape flagship|train|seed_spread|quality|path_b|path_c|tiny]
        [--dtype bfloat16|float32] [--dropout RATE] [--tree PATH] [--out PATH]

Counterpart of the JAX package's ``scripts/profile_fused_sections.py``,
with its method: each cumulative section variant of the layer's kernels
(``ops/fused_sections.py``) is timed over the same inputs, and the
difference from the variant before it is the section's time.  For each
stage it prints the cumulative and the delta ms (CUDA-graph replays,
``tools.graph_ms``) and the least time of the delta's products: the
section's FLOPs from its shapes over 989 TFLOP/s (bf16 tensor cores) and
over 67 TFLOP/s (f32 CUDA cores).  The backward's ``full`` stage is four
launches under bf16 (three under f32); ``torch.profiler`` splits one call
of it by pass.  Where the FFN is narrower than D (the seed spread's F=48)
the ``ffn_gelu`` variant, which stores D columns of the FFN, does not run
and ``full`` takes its section.

Shapes: ``flagship`` is the JAX script's (B=256, S=32, D=128, 8 heads, FFN
512), ``train`` the flagship train step's batch (B=128), ``seed_spread``
the reference topology's layer at the seed spread's batch (B=32, S=32,
D=384, 12 heads, FFN 48), ``quality`` the same layer at the quality run's
batch (B=256, bf16, dropout 0.1: ``tools/quality_run.py``), ``path_b``
at ``ml1m_reference.yaml``'s train batch (B=32), ``path_c`` at
``ml100k_bpr.yaml``'s width (B=128, D=64, 4 heads, FFN 256), ``tiny`` a
smoke (4/8/32/4/64).  As in the JAX
script by default: bf16, causal, dropout 0.1 on the attention and the
hidden sites with seeds (1, 2, 3), every valid key, the weights of
``init_transformer_params`` (here from a seeded ``torch.Generator``)
rounded to bf16 (passed as f32, as the port's kernels take them).
``--dtype float32`` runs the f32 kernels on f32 inputs and unrounded
weights (the seed spread's layer: ``--shape seed_spread --dtype float32
--dropout 0``); the bounds are then the f32 CUDA-core ones.  ``--tree``
profiles the kernels of another checkout of the repository (its port
imported in place of this one's, its kernels built there) with this
tool, so that two commits compare on one card in one call.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from transformer_recommenders_tpu_torch import tools

SHAPES = {
    "flagship": dict(b=256, s=32, d=128, h=8, f=512),
    "train": dict(b=128, s=32, d=128, h=8, f=512),
    "seed_spread": dict(b=32, s=32, d=384, h=12, f=48),
    "quality": dict(b=256, s=32, d=384, h=12, f=48),
    "path_b": dict(b=32, s=32, d=384, h=12, f=48),
    "path_c": dict(b=128, s=32, d=64, h=4, f=256),
    "tiny": dict(b=4, s=8, d=32, h=4, f=64),
}
DTYPES = ("bfloat16", "float32")


def section_flops(shape: dict) -> dict:
    """FLOPs of each cumulative stage's new work, from the shapes: the
    dense products, the attention products (q k^T and P V forward; four
    S x S x dh products backward) and, for the backward's full stage, the
    four weight-gradient products."""
    b, s, d, f = (shape[k] for k in "bsdf")
    r = b * s
    dense = 2 * r * (3 * d * d + d * d + 2 * d * f)
    return {
        "fwd/qkv": 2 * r * d * 3 * d,
        "fwd/attn": 4 * r * s * d,
        "fwd/out_ln1": 2 * r * d * d,
        "fwd/ffn_gelu": 2 * r * d * f,
        "fwd/full": 2 * r * f * d,
        "bwd/recompute": dense + 4 * r * s * d,
        "bwd/ffn_bwd": 4 * r * d * f + 2 * r * d * d,
        "bwd/attn_bwd": 8 * r * s * d + 6 * r * d * d,
        "bwd/full": dense,
    }


def make_inputs(shape: dict, device, dtype: str = "bfloat16", dropout: float = 0.1):
    """The layer, inputs, cotangent and options of the profile at
    ``shape`` on ``device``: ``dtype`` activations (bf16: the weights
    rounded to bf16, as the JAX script casts them), ``dropout`` at every
    site (0: no seeds, dropout off)."""
    import torch

    from transformer_recommenders_tpu_torch.configs import ModelConfig
    from transformer_recommenders_tpu_torch.models.transformer import (
        init_transformer_params, unstack_layer)

    if dtype not in DTYPES:
        msg = f"profile_fused_sections: dtype must be one of {DTYPES}, got {dtype!r}"
        raise ValueError(msg)
    b, s, d, h, f = (shape[k] for k in "bsdhf")
    act = getattr(torch, dtype)
    cfg = ModelConfig(hidden_size=d, num_hidden_layers=1, num_attention_heads=h,
                      intermediate_size=f, max_seq_length=s, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = init_transformer_params(gen, cfg, device="cpu")
    layer = {m: {n: t.to(act).float().to(device) for n, t in v.items()}
             for m, v in unstack_layer(params, 0).items()}
    x = torch.randn(b, s, d, generator=gen).to(device, act)
    dy = torch.randn(b, s, d, generator=gen).to(device, act)
    mask = torch.ones(b, s, dtype=torch.bool, device=device)
    # the seeds on the device, as the encoder passes them: a timed call is
    # the kernels alone, with no fill writing a list of seeds there
    seeds = torch.tensor([1, 2, 3], device=device) if dropout else None
    opts = dict(num_heads=h, causal=True, attn_dropout=dropout, hidden_dropout=dropout,
                dropout_seeds=seeds, layer_norm_eps=1e-12)
    return layer, x, dy, mask, opts


def pass_split(fn, n: int = 5) -> dict | None:
    """Device ms per launch of each kernel ``fn`` launches, by
    ``torch.profiler`` over ``n`` calls (averaged over the launches it
    recorded, which may be fewer); ``None`` when the profiler recorded no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            out[e.key] = e.self_device_time_total / e.count / 1e3
    return out or None


# csrc/fused_layer.cu's backward kernels by pass, as the profiler names
# them: pass 0 (the weights rounded to bf16 and packed; round_weights before
# the packed layout, for --tree) runs only under bf16, and the last pass is
# vector_grad (f32) or grad_reduce (bf16)
PASS_KERNELS = {"pass0": ("pack_weights", "round_weights"), "pass1": ("fused_layer_bwd_rows",),
                "pass2": ("weight_grad",), "pass3": ("vector_grad", "grad_reduce")}


def backward_passes_ms(fn) -> dict | None:
    """Device ms per launch of each pass of the layer backward that ``fn``
    calls (:func:`pass_split`), or ``None`` when not measured."""
    split = pass_split(fn)
    if split is None:
        return None
    return {p: sum(v for k, v in split.items() if any(n in k for n in names))
            for p, names in PASS_KERNELS.items()}


def profile_sections(shape_name: str, *, dtype: str = "bfloat16", dropout: float = 0.1,
                     iters: int = 10, reps: int = 10, log=print) -> dict:
    """Cumulative and delta ms of every stage at ``shape_name`` in
    ``dtype`` with ``dropout``, with the least time of each delta's
    products and the backward's split by pass."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_sections as fs

    shape = SHAPES[shape_name]
    layer, x, dy, mask, opts = make_inputs(shape, torch.device("cuda"), dtype, dropout)
    flops = section_flops(shape)
    log(f"card {tools.card()}; shape {shape_name} {shape}, {dtype}, dropout {dropout}; "
        f"port {pathlib.Path(fs.__file__).resolve().parents[1]}")
    results = {}
    for direction, stages in (("fwd", fs.FWD_STAGES), ("bwd", fs.BWD_STAGES)):
        prev, carried = 0.0, 0
        for stage in stages:
            if stage == "ffn_gelu" and shape["f"] < shape["d"]:
                # the variant stores D columns of the FFN: its work is the
                # next section's
                carried = flops[f"{direction}/{stage}"]
                continue
            if direction == "fwd":
                def run(st=stage):
                    return fs.layer_stage_forward(x, layer, mask, stage=st, **opts)
            else:
                def run(st=stage):
                    return fs.layer_stage_backward(x, layer, mask, dy, stage=st, **opts)
            ms = tools.graph_ms(run, iters=iters, reps=reps)
            key = f"{direction}/{stage}"
            fl, carried = flops[key] + carried, 0
            results[key] = {
                "cumulative_ms": ms, "delta_ms": ms - prev, "delta_gflop": fl / 1e9,
                "delta_bound_bf16_ms": fl / tools.H100_BF16_FLOPS * 1e3,
                "delta_bound_f32_ms": fl / tools.H100_F32_FLOPS * 1e3,
            }
            r = results[key]
            log(f"  {key:14s} cumulative {ms:8.4f} ms  delta {ms - prev:8.4f} ms  "
                f"({r['delta_gflop']:.3f} GFLOP: {r['delta_bound_bf16_ms']:.5f} ms at bf16 "
                f"tensor-core peak, {r['delta_bound_f32_ms']:.5f} ms at f32 CUDA-core peak)")
            prev = ms
    passes = backward_passes_ms(
        lambda: fs.layer_stage_backward(x, layer, mask, dy, stage="full", **opts))
    if passes is None:
        log("  bwd/full by pass: not measured (the profiler recorded no device time)")
    else:
        log("  bwd/full by pass (torch.profiler, per launch): " + ", ".join(
            f"{p} {v:.4f} ms" for p, v in passes.items()))
    return {"card": tools.card(), "device": torch.cuda.get_device_name(0), "shape": shape,
            "shape_name": shape_name, "dtype": dtype, "dropout": dropout,
            "port": str(pathlib.Path(fs.__file__).resolve().parents[1]), "results": results,
            "bwd_full_passes_ms": passes}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", default="flagship", choices=sorted(SHAPES))
    parser.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    parser.add_argument("--dropout", type=float, default=0.1,
                        help="the rate at every dropout site (0: off)")
    parser.add_argument("--tree", type=pathlib.Path, default=None,
                        help="profile the port of the checkout at PATH")
    parser.add_argument("--out", type=pathlib.Path, default=None,
                        help="default: build/fused_sections_<shape>_<dtype>.json")
    args = parser.parse_args(argv)
    if not tools.require_cuda("profile_fused_sections"):
        return 2
    if args.tree is not None:  # the layer's modules imported anew from there
        sys.path.insert(0, str(args.tree.resolve()))
        for name in [m for m in sys.modules if m.startswith("transformer_recommenders_tpu_torch")]:
            del sys.modules[name]
    record = profile_sections(args.shape, dtype=args.dtype, dropout=args.dropout)
    out = args.out or tools.BUILD_DIR / f"fused_sections_{args.shape}_{args.dtype}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
