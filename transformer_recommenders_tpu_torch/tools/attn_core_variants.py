"""What binds a design of the attention core's kernels (#17, #18) that
keeps the bf16 probs y (B, H, S, S) in device memory as its residual: its
time with one cost taken out at a time.

    python3 -m transformer_recommenders_tpu_torch.tools.attn_core_variants \\
        --source PATH/attn_core.cu [--out FILE]

``--source`` is such a design's ``csrc/attn_core.cu`` beside its
``common.cuh`` (the repository's at commit e0ebf7e:
``git archive e0ebf7e transformer_recommenders_tpu_torch/csrc | tar -x -C
DIR``).  The script patches its text into variants, each a copy that is
built and timed here and never used by the port:

- ``no_y_store``: the forward without its 2-byte y stores;
- ``dropout_off``: rate 0 (no hash, no dropout division), both kernels;
- ``causal_skip``: every (16-row, 8-key) score tile and 16-key product
  step wholly in the future of its rows skipped, in the forward and in the
  backward's four products (exact for the masks used here, whose padding
  is at the tail);
- ``no_y_load``: the backward staging a constant in place of y;
- ``no_y_store+causal_skip``, the forward with both.

Each is built with the port's nvcc flags and timed by CUDA-graph replays
(``tools.graph_ms``) at the scale step's (256, 128, 8, 32), causal,
dropout 0.1 (but ``dropout_off``), on inputs made as ``chip_smoke.py``
makes them; the skipped variants' outputs are held bit for bit against
the unpatched kernels'.  Prints one JSON object with the card's name and
power limit; without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

from transformer_recommenders_tpu_torch.tools import BUILD_DIR, card, graph_ms, require_cuda

# the y-residual design's text, and what each variant puts in its place
_SKIP_FWD = [
    ("    if (nt < nt_n) {\n      const bf16* kb = Ks",
     "    if (nt < nt_n && 8 * nt <= r0 + 15) {\n      const bf16* kb = Ks"),
    ("      sc[nt][i] = expf(__fsub_rn(sc[nt][i], m[i >> 1]));",
     "      if (8 * nt > r0 + 15) { sc[nt][i] = 0.f; continue; }\n"
     "      sc[nt][i] = expf(__fsub_rn(sc[nt][i], m[i >> 1]));"),
    ("    float pv[4];",
     "    if (8 * nt > r0 + 15) { pp[nt][0] = pp[nt][1] = 0u; continue; }\n    float pv[4];"),
    ("    if (kk < Sp / 16) {", "    if (kk < Sp / 16 && 16 * kk <= r0 + 15) {"),
]
_SKIP_BWD = [
    ("      const int s0 = 16 * kk;\n",
     "      const int s0 = 16 * kk;\n      if (s0 + 15 < t0) continue;\n"),
    ("      if (nt < nt_n) {\n        const bf16* vb",
     "      if (nt < nt_n && 8 * nt <= r0 + 15) {\n        const bf16* vb"),
    ("        float v = c[i];\n        if (d.on",
     "        float v = c[i];\n        if (8 * nt > r0 + 15) v = 0.f;\n        else if (d.on"),
    ("      if (nt < nt_n) {\n#pragma unroll\n        for (int half",
     "      if (nt < nt_n && 8 * nt <= r0 + 15) {\n#pragma unroll\n        for (int half"),
    ("      xrt::mma_bf16(aq[nd], a, bk);\n      xrt::mma_bf16(aq[nd + 1], a, bk + 2);",
     "      if (k0 <= r0) {\n      xrt::mma_bf16(aq[nd], a, bk);\n"
     "      xrt::mma_bf16(aq[nd + 1], a, bk + 2);\n      }"),
    ("      xrt::mma_bf16(ak[nd], at, bq);\n      xrt::mma_bf16(ak[nd + 1], at, bq + 2);",
     "      if (k0 >= t0) {\n      xrt::mma_bf16(ak[nd], at, bq);\n"
     "      xrt::mma_bf16(ak[nd + 1], at, bq + 2);\n      }"),
]
_NO_Y_STORE = [
    ("      if (nt < nt_n && s < S && t < S)\n"
     "        y[((size_t)bh * S + s) * S + t] = __float2bfloat16_rn(yv);\n", ""),
]
_NO_Y_LOAD = [
    ("    Ys[i] = s < S && t < S ? yh[(size_t)s * S + t] : __float2bfloat16_rn(0.f);",
     "    Ys[i] = __float2bfloat16_rn(s < S && t < S ? 0.25f : 0.f);"),
]
VARIANTS = {
    "base": [],
    "no_y_store": _NO_Y_STORE,
    "causal_skip": _SKIP_FWD + _SKIP_BWD,
    "no_y_load": _NO_Y_LOAD,
    "no_y_store+causal_skip": _NO_Y_STORE + _SKIP_FWD,
}

_P, _I, _U, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
                      ctypes.c_longlong)
# the y-residual design's C entry points
SIGNATURES = {
    # q, k, v, strides, key mask, y, ctx, B S H dh causal, scale, seed
    # term, seed value, threshold, divisor, dropout, stream
    "attn_core_fwd": [_P] * 3 + [_L] * 3 + [_P] * 3 + [_I] * 5 + [_F, _P, _U, _U, _F, _I, _P],
    # q, k, v, strides, y, g, dq, dk, dv, B S H dh, scale, seed term, seed
    # value, threshold, bf16 and f32 divisors, dropout, stream
    "attn_core_bwd": [_P] * 3 + [_L] * 3 + [_P] * 5 + [_I] * 4
    + [_F, _P, _U, _U, _F, _F, _I, _P],
}


def patched(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            msg = f"the source does not hold this text once: {old!r}"
            raise ValueError(msg)
        text = text.replace(old, new)
    return text


def build(source: pathlib.Path, name: str, patches) -> ctypes.CDLL:
    from transformer_recommenders_tpu_torch.ops import cuda_build

    out = BUILD_DIR / "attn_core_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name.replace('+', '_')}.cu"
    cu.write_text(patched(source.read_text(), patches))
    lib = out / f"lib{cu.stem}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(source.parent), "-o", str(lib),
           str(cu)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in SIGNATURES.items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", required=True, help="a y-residual design's attn_core.cu")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()
    if not require_cuda("attn_core_variants"):
        return 2

    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.ops.hash_dropout import (
        keep_divisor,
        keep_threshold,
        seed_argument,
        seed_terms,
    )

    b, s, h, dh = 256, 128, 8, 32
    rate = 0.1
    gen = torch.Generator().manual_seed(20)
    d = h * dh
    qkv = torch.randn(b, s, 3 * d, generator=gen).to("cuda", torch.bfloat16)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, s, h, dh) for i in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    mask = (torch.arange(s)[None, :] < lengths[:, None]).cuda()
    g = torch.randn(b, s, h, dh, generator=gen).cuda()
    term = seed_terms(torch.full((1,), 12345, dtype=torch.int64, device="cuda"))[0]
    ptr, value = seed_argument(term, q.device)
    strides = (q.stride(0), q.stride(1), q.stride(2))
    scale = 1.0 / math.sqrt(dh)

    def fwd(lib, on):
        y = torch.empty((b, h, s, s), dtype=torch.bfloat16, device="cuda")
        ctx = torch.empty((b, s, h, dh), dtype=torch.float32, device="cuda")
        cuda_build.check(lib.attn_core_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, mask.data_ptr(), y.data_ptr(),
            ctx.data_ptr(), b, s, h, dh, 1, scale, ptr if on else None, value,
            keep_threshold(rate), keep_divisor(rate, torch.bfloat16), int(on),
            cuda_build.stream_handle(q.device)), "attn_core_fwd")
        return ctx, y

    def bwd(lib, y, on):
        grads = [torch.empty((b, s, h, dh), dtype=torch.bfloat16, device="cuda")
                 for _ in range(3)]
        cuda_build.check(lib.attn_core_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, y.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in grads), b, s, h, dh, scale, ptr if on else None, value,
            keep_threshold(rate), keep_divisor(rate, torch.bfloat16),
            keep_divisor(rate, torch.float32), int(on), cuda_build.stream_handle(q.device)),
            "attn_core_bwd")
        return grads

    source = pathlib.Path(args.source).resolve()
    libs = {name: build(source, name, patches) for name, patches in VARIANTS.items()}
    ctx0, y0 = fwd(libs["base"], True)
    grads0 = bwd(libs["base"], y0, True)
    record = {"device": card(), "shape": [b, s, h, dh], "causal": True, "rate": rate,
              "fwd_ms": {}, "bwd_ms": {}, "same_bits": {}}
    for name, lib in libs.items():
        if name != "no_y_load":
            record["fwd_ms"][name] = graph_ms(lambda lib=lib: fwd(lib, True))
        if "no_y_store" not in name:
            record["bwd_ms"][name] = graph_ms(lambda lib=lib: bwd(lib, y0, True))
        if name == "causal_skip":
            ctx, _ = fwd(lib, True)
            grads = bwd(lib, y0, True)
            record["same_bits"][name] = bool(torch.equal(ctx, ctx0)) and all(
                torch.equal(a.view(torch.int16), w.view(torch.int16))
                for a, w in zip(grads, grads0))
    record["fwd_ms"]["dropout_off"] = graph_ms(lambda: fwd(libs["base"], False))
    record["bwd_ms"]["dropout_off"] = graph_ms(lambda: bwd(libs["base"], y0, False))
    torch.cuda.synchronize()
    text = json.dumps(record, indent=1)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
