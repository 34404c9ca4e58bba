#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. build: compile every kernel of the serving and training paths from
   ``csrc/*.cu`` with ``nvcc`` for sm_90a (one process per source, all at
   once);
2. the serving path's kernels (the fused-layer and gather forwards)
   against their plain PyTorch versions on the card, at the serving shapes
   and the other shapes the configs use, printing the max and mean abs
   error beside the tolerance, then the times of the kernel, the plain
   version and a stock PyTorch yardstick (``library_ms``, never called by
   the port), the layer at each batch the paths launch it with (serving's
   64, training's 128, path B's 32 at D=384) and two calls bit for bit;
   the gather at every shape the paths and the bench give it (serving's
   f32 -> bf16 rows, the hot steps' and the pool objective's bf16 rows at
   B=128 and 256), beside an empty kernel on its grid (the launch floor)
   and a bound with int64 indices at 8 bytes;
3. serving: a synthetic artifact at MovieLens-1M scale (3,706 items with
   384-d text embeddings, 6,040 users) written by ``save_artifact`` for the
   flagship model (4 layers, d=128, 8 heads, FFN 512, seq 32, bf16) with
   weights from a seeded ``torch.Generator``; ``Service(device="cuda")``
   answers all nine APIs, then 256 concurrent ``recommend_with_user_id``
   requests go through the micro-batcher, and the launch counters show the
   path went through both forward kernels.  The card's embeddings are held
   against the plain path on the CPU for a few users.  Then retrieval's
   top-k with ties in ``lax.top_k``'s order, two ways, timed at 3,706 and
   62,423 items;
4. the training path's kernels (the fused-layer and gather backwards, the
   table-scored InfoNCE forward and backward) against their plain versions
   at the training shapes (the gather backward bit for bit: its plain
   version sums in the kernel's order; its grouping kernel against
   ``torch.sort(stable=True)``, and its time beside the grouping's own, the
   sort path (``torch.sort`` and the passes) and ``index_add_``,
   at the hot and logging steps' shapes; the table kernels as the pool
   kernels in phase 6: on Gaussian inputs ce on the rows without a
   near-tie, which alone take a cotangent, their count printed, and on
   exact-sum inputs every row; two calls bit for bit), with their times,
   the layer backward's by pass, as in phase 2;
5. training: the flagship's hot train step
   (``make_train_step(cfg, full_logs=False)``, configs/ml1m_ssm.yaml,
   dropout 0.1, batch 128) over the same synthetic catalog: one step's loss
   and raw gradients on the card against the same step on the CPU's plain
   path, the launch counts of one step (every kernel of the path), 30 steps
   on one fixed batch whose loss must fall, the eager step time, and the
   device time by kernel of a few steps under ``torch.profiler``;
6. the pool InfoNCE kernels (forward, dq/dp, dn) against their plain
   versions at the shapes of paths A and B and a ragged one, the mask on
   and off, scale 1 and 2.5, on Gaussian inputs (ce on the rows without a
   near-tie, which alone take a cotangent, their count printed) and on
   exact-sum inputs (every row); with every copy of a shared positive
   dropped bit for bit, and two calls bit for bit; then each kernel's
   ptxas registers and spills, and its splits and times beside a composite
   of stock calls (a bf16 matmul and a masked ``logsumexp``, autograd for
   the backward) and the bound;
7. training through the pool objective, as phase 5: path A, the
   flagship's logging step (``make_train_step(cfg)``, ``full_logs=True``:
   every loss head, the logits and batch statistics, the pool kernels),
   its logs held key for key against the CPU's; path B, the
   reference-equivalent hot step (configs/ml1m_reference.yaml: d=384, one
   layer, batch 32, whose 3,707-row catalog is more than twice its pool);
8. the pairwise kernels (forward, dq/dp, dn) against their plain versions
   for the four heads at path C's shape (R = Rn = 4,096, D = 64), the
   flagship's width and a ragged one, the mask on and off, margins 0 and
   0.5, as the pool kernels in phase 6: on Gaussian inputs out on the rows
   without a near tie (of the mask, or of a relu head's f' at s = 0),
   which alone take a cotangent, their count printed, and on exact-sum
   inputs every row; the copies of a shared positive dropped bit for bit,
   and two calls bit for bit; then each kernel's splits and ptxas
   registers and spills, and its times beside a composite of stock calls
   (a bf16 matmul, a masked softplus mean, autograd for the backward) and
   a bound that also counts the special functions (exp, log, reciprocal);
9. training through the pairwise objectives, as phase 5: path C,
   configs/ml100k_bpr.yaml's hot step (PairwiseLogisticLoss at margin 0,
   d=64, batch 128, over a synthetic catalog of ML-100K's 1,682 items;
   the fused-layer gate sends d=64 to the layer stack, so the step
   launches no fused-layer kernel), and its logging step; one step each
   of ContrastiveLoss, NCELoss and AlignmentContrastiveLoss at its widths
   and batch; then two flagship steps with
   ``accumulate_grad_batches=2``, held against the card's own flat update
   of the mean gradient;
10. the throughput probe (``ops/vpu_calibration.py``) against its plain
    version for each mix over the one-wave tile and the JAX package's
    (1024, 512) tile, then the calibration
    (``tools/calibrate_vpu.py``): the CUDA-core and special-function
    rates, every timed point gated below 1.5x the card's peak;
11. the section variants of the fused layer's kernels
    (``ops/fused_sections.py``) against their plain versions for every
    stage at the flagship's width and the JAX profile's batch of 256, bf16
    and f32, dropout 0.1, the full variants bit for bit against the
    production kernels; then the section profile
    (``tools/profile_fused_sections.py``) at ``flagship`` (B=256) and
    ``train`` (B=128);
12. the multi-step driver (``training/scan_steps.py``) for the flagship's
    and path C's hot steps at batch 128: K=8 steps as CUDA-graph replays
    bit for bit against 8 eager steps with the same batches and seeds,
    one counted call whose launches must be K times one eager step's, ms
    per step graphed and eager in turns in this call, and a graphed call's
    idle share under ``torch.profiler``;
13. one short window of each part of the bench
    (``python -m transformer_recommenders_tpu_torch.bench``): flagship
    examples/s at B=256 graphed and eager, retrieval top-100 over 62,000
    items at batches 1, 32 and 256;
14. the trainer: the flagship (configs/ml1m_ssm.yaml, bf16, dropout 0.1,
    batch 128) on synthetic data at MovieLens-1M's scale (3,706 items,
    6,040 users, 1,000,209 events, the hash embedder at 384-d) through
    ``SeqDataModule``: validate the untrained model, ``fit()`` 2 epochs
    with ``steps_per_dispatch=8`` (graphed windows, the logging steps,
    validation each epoch; every kernel of the flagship's path must
    launch), then test, predict and save; the card's ``Evaluator`` against
    the CPU's plain path on the first 256 val users; the deploy smoke on
    the saved artifact; a fresh trainer restored from the best checkpoint
    validates bit for bit as the fit did; one eager epoch of 50 batches
    (``steps_per_dispatch=1``) beside the graphed ones;
15. the serving worker pool: ``serve_workers(workers=2)`` on the card over
    phase 3's artifact, on a free port; the nine APIs (item ids equal,
    floats within 1e-5) and 64 concurrent ``recommend_with_user_id`` (scores
    within 2**-10, ids equal but at near ties: the pool encodes them in
    batches of other sizes) over HTTP, held against the in-process
    ``Service``, QPS and p50/p95; the pool interrupted, no worker left, their launch counts
    read from their exit lines; ``ItemIndexService.search`` against the
    batched path; the batch-1 two-stage top-k over 62,000 x 384 bit for bit
    against the direct one, both timed;
16. the parallel layer on a 1x1 mesh over a real NCCL group: the sharded
    lookup and top-k against the dense ones, the flagship's sharded hot
    step (the table branch) and logging step (the pool branch) at B=128
    against the one-device steps bit for bit, a graphed sharded window of
    K=8 against eager sharded steps bit for bit with ms per step beside the
    unsharded window's, ``ShardedEvaluator`` against ``Evaluator`` on 256
    users;
17. the scale configuration, configs/ml25m_ccl.yaml (6 layers, d=256, FFN
    1024, 8 heads, seq 128, ContrastiveLoss at margin 0.5, batch 256, a
    62k-item catalog behind a learned 384 -> 256 projection) at full width
    on a 1x1 mesh, as scripts/quality_run_25m.py overrides it: (a) the
    pairwise kernels at D=256 over R = Rn = 8,192 and 32,768 (B=64 and 256
    at seq 128) against their plain versions as phase 8 holds them, with
    splits, registers, times, the composite and the bounds; (b) the gather
    at the path's shapes (98,304 bf16 rows of the projected catalog at
    B=256, 24,576 f32 rows of the raw one at B=64, the evaluator's 65,536)
    and #2 at B=256, bit for bit, timed; (c) the layer stack's kernels:
    the hash dropout (#16) at the scale step's sites (its hidden and
    embedding sites, the probs in bf16 and f32, a permuted view), path C's
    f32 probs and the flagship's embedding site, forward and backward bit
    for bit against the plain int64 chain; the attention core (#17, #18)
    at (B, 128, 8, 32), B=256 and 64, dropout 0.1, against the plain core
    (y within one bf16 ulp in at most 1% of the probs, ctx, dq, dk, dv
    within 1e-2 of their max abs), two calls bit for bit, #18's y (rebuilt
    from #17's row statistics, read back through dv) bit for bit #17's,
    no (B, H, S, S) tensor allocated; each timed beside its plain
    version, its bound (the function's bytes) and (#17, #18)
    ``scaled_dot_product_attention`` without dropout, with the CTAs an SM
    holds; the dense (#19) as phase 20 checks it; (d) the hot step:
    loss and raw gradients against the CPU's plain path at B=8, one
    counted step at B=256 (#1, #2, #10-#12 and #16-#19; the layer stack,
    no fused layer), the zero rows at the cosine normalization, 30
    fixed-batch steps whose loss must fall, the device time by kernel, by
    PyTorch op and by part, eager with and without dropout, the
    multi-step driver's K=8 graphed window bit for bit against eager at
    B=64 and 256 with ms per step graphed and eager in turns, peak memory;
    (e) the logging step: its logs against the CPU's at B=8, its eager
    time and peak memory at B=256; (f) a fit through ``SeqDataModule``
    and ``Trainer`` (``steps_per_dispatch=8``; 96 of the epoch's batches)
    on synthetic data at ML-25M's users and items (162,000 and 62,000; 10M
    of its 25M events, for the smoke's time; the hash embedder; generated
    by a child process started before phase 1), validating the full val
    set, testing and predicting (4,096 users each), saving, serving the
    nine APIs over the artifact, and a fresh trainer restored from the
    checkpoint validating bit for bit;
18. the quality protocols (``tools/quality_run.py``) against the JAX
    package's records: (a) every kernel the two fits launch at the shapes
    and dtypes they give it (#1's gathers, #3 and #4 at B=32 f32 and B=256
    bf16 with dropout 0.1 and at the validation batches, #5/#6 at 8,192 x
    3,707 x 384, #7/#8 at 1,024 and 8,192 rows of 384, #16 at the
    embedding site) against its plain version with the earlier phases'
    tolerances, timed at the train steps' shapes (#4 by pass); the seed
    spread's f32 layer bit for bit at clusters of 1 to 4 CTAs, timed at
    each, and profiled by section in f32; (b) one hot step of each
    fit's model at its batch against the CPU's plain path; (c) the seed
    spread of
    ``scripts/parity_seed_spread.py`` in full (5 model seeds, 2 epochs at
    batch 32 over synthetic data of ML-1M's shape), whose mean val NDCG@10
    must lie within the JAX seeds' mean plus or minus half their spread
    (PARITY_SEED_SPREAD.json: [0.02022, 0.02584]); (d) the quality run of
    ``scripts/quality_run.py`` at seed 0 (batch 256, bf16, dropout 0.1, up
    to 8 epochs, K=8 windows), whose val NDCG@20 must be finite and above
    the untrained model's, printed beside JAX's 0.0389.  Each fit's
    launches must be exactly its hot steps' (graph warm-ups included),
    logging steps' and validations'; they are the kernels line's path
    ``quality``, and (a)'s times its rows' ``by_shape`` entries;
19. the ML-1M parity protocol of ``scripts/parity_ml1m.py``
    (``tools/quality_run.py parity-ml1m``) and the serving bench
    (``tools/bench_serving.py``): (a) #7-#9 at the d=64 configs' 1,024
    pool rows of 64, #10-#12 there and at the reference shape's 1,024 rows
    of 384, for BPR (margin 0) and CCL (margin 0.5), against their plain
    versions as phases 6 and 8 hold them, timed (``by_shape`` entries);
    (b) one hot step of each of the five d=64 configs (on the first batch
    of the fit's own data, the native sampler's where it builds) and of the
    reference shape's three, against the CPU's plain path; under the 32
    hard negatives the positions whose mask may differ between the card and
    the CPU are left out first (where the masks differ, and the near ties
    at the k-th place and at the positive), and the step must launch none
    of #5-#12; (c) the lookahead-8 fit's data keyed by its lookahead, and
    its sampler's positives all within 8 events of their query (the
    unbounded sampler's not); (d) seed 0 of the InfoNCE, hard32 and
    lookahead8 fits at ML-1M's shape, each mean at or above its range's
    lower edge (PARITY_ML1M.json's two columns widened by the seed spread's
    relative range) and hard32 above InfoNCE, each fit's launches exactly
    its steps' and validations', hard32's none of #5-#12; (e) one short run
    of each bench mode (http, device, workers; 4 clients, 64 requests, 2
    workers) on the card, every request answered 200 and the JAX scripts'
    keys in each record.

20. the layer stack's dense (#19; part of phase 17 (c), alone under
    ``--only-dense``): the forward, dgrad and wgrad kernels against the
    plain graph at every shape the benchmark's cells give them (the scale
    step's and recommend call's four denses a layer at T = 32,768 and
    65,536, the catalog's and the window rows' projections, the
    flagship's) and at K and N that no 64-wide block divides, y, dx and dW within one
    bf16 ulp (plus the f32 sum order's slack where a sum cancels), db
    within an f32 sum-order bound; a row's forward bit for bit at M = 64
    and inside M = 65,536; the wgrad twice bit for bit; each timed beside
    its bound, the plain graph's ops and ``torch.mm`` on bf16 with f32
    output plus the bias and the cast (never called by the port); one row
    a kernel in the kernels line, its shapes under ``by_shape``.

``--only-scale`` runs phases 1 and 17 alone (and prints no kernels line);
``--only-quality`` phases 1 and 18 (no kernels line either);
``--only-parity`` phases 1 and 19 (a)-(d), (d) with every config at 3
seeds and both shapes; ``--only-serving`` phases 1 and 19 (e) with each
mode at its defaults (neither prints a kernels line); ``--only-dense`` phases
1 and 20 (no kernels line);
``--scale-uncut`` runs phase 17's fit over all 25M events and the whole
epoch, and tests and predicts every user (~9 minutes more).

The last lines are the ``nvidia-smi`` name and power limit, one JSON object
with a ``kernels`` list, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3

# tolerances, kernel vs its plain PyTorch version on the same inputs (the
# same bounds as tests/test_torch_cuda.py).
# f32: both sum in f32 in different orders and the kernel's expf/sqrtf
# differ from torch's in the last bit; LayerNorm outputs are O(1).
# bf16: every dense, the probs, the residual adds and both LayerNorms
# round to bf16, and a one-ulp flip of an intermediate rounding moves an
# output (|y| < 8 after LayerNorm) by about one ulp: at most 2**-4 (two
# ulps at |y| in [4, 8)), at most 2**-8 on average.
TOL = {"float32": 2e-5, "bfloat16": 2.0**-4}
TOL_MEAN = {"float32": 2e-6, "bfloat16": 2.0**-8}
# backward kernels, each gradient's max abs error relative to its max abs
# value (the bounds of tests/test_torch_cuda.py).  f32: both sum in f32 in
# other orders, the parameter gradients over all B*S rows.  bf16: every
# gradient product rounds its operands to bf16, and a one-ulp flip of a
# rounding (2**-8 relative) in one of thousands of summands moves a sum by
# far less than one ulp of its largest term; the H100 runs read up to 6e-3.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, reps: int = 20) -> float:
    """Device time of one call of ``fn`` (ms), from CUDA-graph replays of
    ``reps`` calls (``tools.graph_ms``): the host's Python and launch
    overhead, which an eager call pays on top, is left out; inputs and
    weights stay L2-resident between calls, as in a serving loop."""
    from transformer_recommenders_tpu_torch.tools import graph_ms

    return graph_ms(fn, iters=iters, reps=reps)


def eager_ms(fn, iters: int = 50) -> float:
    """Wall time of one eager call of ``fn`` ending in a synchronize (ms),
    host overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- phases 2 and 4: kernels against their plain versions ----------------------


def _layer_params(gen, d: int, f: int, device):
    """Random layer weights with O(1) activations (std 1/sqrt(fan_in))."""
    import torch

    def dense(d_in, d_out):
        return {
            "w": (torch.randn(d_in, d_out, generator=gen) / math.sqrt(d_in)).to(device),
            "b": (0.1 * torch.randn(d_out, generator=gen)).to(device),
        }

    def ln(n):
        return {
            "scale": (1.0 + 0.1 * torch.randn(n, generator=gen)).to(device),
            "bias": (0.1 * torch.randn(n, generator=gen)).to(device),
        }

    return {"qkv": dense(d, 3 * d), "out": dense(d, d), "ffn_in": dense(d, f),
            "ffn_out": dense(f, d), "ln1": ln(d), "ln2": ln(d)}


def layer_case(gen, *, b, s, d, h, f, dtype, causal=True, dropout=0.0, seeds=None):
    import torch

    x = torch.randn(b, s, d, generator=gen).to("cuda", dtype)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[-1, s // 2:] = False  # a padded tail
    mask[0, s - 3:] = False
    params = _layer_params(gen, d, f, "cuda")
    kwargs = dict(num_heads=h, causal=causal, attn_dropout=dropout,
                  hidden_dropout=dropout, dropout_seeds=seeds, ffn_dim=f)
    return x, params, mask.cuda(), kwargs


def stock_layer(x, params, mask, *, num_heads, causal, **_):
    """The yardstick: the same post-LN layer from stock PyTorch calls
    (F.linear, scaled_dot_product_attention, F.layer_norm, F.gelu)."""
    import torch
    import torch.nn.functional as F

    b, s, d = x.shape
    p = params
    w = {k: (p[k]["w"].t().to(x.dtype), p[k]["b"].to(x.dtype))
         for k in ("qkv", "out", "ffn_in", "ffn_out")}
    qkv = F.linear(x, *w["qkv"]).view(b, s, 3, num_heads, d // num_heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.where(mask[:, None, None, :], 0.0, -1e9).to(x.dtype)
    if causal:
        bias = bias + torch.full((s, s), -1e9, device=x.device).triu(1).to(x.dtype)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    a = F.linear(ctx.transpose(1, 2).reshape(b, s, d), *w["out"])
    x1 = F.layer_norm(x + a, (d,), p["ln1"]["scale"].to(x.dtype), p["ln1"]["bias"].to(x.dtype))
    g = F.gelu(F.linear(x1, *w["ffn_in"]))
    f = F.linear(g, *w["ffn_out"])
    return F.layer_norm(x1 + f, (d,), p["ln2"]["scale"].to(x.dtype), p["ln2"]["bias"].to(x.dtype))


def layer_bound_ms(b, s, d, h, f, elem) -> tuple[float, str]:
    flops = 2 * b * s * (3 * d * d + d * d + 2 * d * f) + 4 * b * h * s * s * (d // h)
    params = 4 * (4 * d * d + 2 * d * f + 9 * d + f)
    nbytes = 2 * b * s * d * elem + 4 * b * s + params
    peak = H100_BF16_FLOPS if elem == 2 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare(name: str, got, want, dtype_name: str) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    ok = bool(torch.isfinite(got.float()).all()) and max_err <= TOL[dtype_name] \
        and mean_err <= TOL_MEAN[dtype_name]
    log(f"  {name}: max_abs_err={max_err:.3g} mean_abs_err={mean_err:.3g} "
        f"max_rel_err={float(err.max() / want.float().abs().max()):.3g} "
        f"tol={TOL[dtype_name]} mean_tol={TOL_MEAN[dtype_name]} {'ok' if ok else 'FAIL'}")
    if not ok:
        msg = f"{name}: kernel disagrees with its plain version"
        raise AssertionError(msg)
    return max_err


LAYER_SHAPES = {  # (B, S, D, H, F): where the bf16 forward is launched
    "serving": (64, 32, 128, 8, 512),  # the flagship, a serving batch (clusters of 2)
    "hot": (128, 32, 128, 8, 512),  # its training batch, the hot step and path A
    "B": (32, 32, 384, 12, 48),  # ml1m_reference.yaml's training batch (clusters of 4)
}


def time_fused_layer(gen, b, s, d, h, f, dtype_name: str = "bfloat16") -> dict:
    """Device times of the forward (bf16 by default), its plain version and
    the stock layer at one shape, dropout off, and the bound; then two calls
    (dropout 0.1) held bit for bit."""
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.ops import fused_layer as fl

    dtype = getattr(torch, dtype_name)
    x, params, mask, kwargs = layer_case(gen, b=b, s=s, d=d, h=h, f=f, dtype=dtype)
    with torch.no_grad():
        ms = time_ms(lambda: fl.fused_layer(x, params, mask, **kwargs))
        plain_ms = time_ms(lambda: fl.fused_layer_reference(x, params, mask, **kwargs))
        library_ms = time_ms(lambda: stock_layer(x, params, mask, **kwargs))
        call_ms = eager_ms(lambda: fl.fused_layer(x, params, mask, **kwargs))
        drop = dict(kwargs, attn_dropout=0.1, hidden_dropout=0.1, dropout_seeds=[9, 8, 7])
        first = fl.fused_layer(x, params, mask, **drop)
        second = fl.fused_layer(x, params, mask, **drop)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"fused_layer B={b} D={d}: two calls differ")
    bound_ms, bound_by = layer_bound_ms(b, s, d, h, f, x.element_size())
    cluster = (fl._tc_cluster(b, s, d, h, f, x.device) if dtype_name == "bfloat16"
               else fl._f32_cluster(b, s, d, h, f, x.device, backward=False))
    log(f"  fused_layer B={b} S={s} D={d} H={h} F={f} {dtype_name} (clusters of {cluster}), "
        "device time: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, stock layer {library_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}); one eager wrapper call {call_ms:.4f} ms; two calls "
        "bit for bit")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "cluster": cluster, "eager_call_ms": call_ms}


def time_by_cluster(gen, b, s, d, h, f, dtype_name: str, sizes) -> dict:
    """Device ms of the layer's forward (and, in f32, its backward) with
    each sequence forced onto a cluster of each of ``sizes`` CTAs, dropout
    off: what the planner's choice saves against the others."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_layer as fl

    x, params, mask, kwargs = layer_case(gen, b=b, s=s, d=d, h=h, f=f,
                                         dtype=getattr(torch, dtype_name))
    flat = [params[m][n] for m, n in fl._PARAM_ORDER]
    dy = torch.randn(x.shape, generator=gen).to("cuda", x.dtype)
    planner, out = fl.cluster_size, {}
    try:
        for c in sizes:
            fl.cluster_size = lambda *_, c=c: c
            with torch.no_grad():
                out[c] = {"fwd": time_ms(lambda: fl.fused_layer(x, params, mask, **kwargs))}
            if dtype_name == "float32":
                out[c]["bwd"] = time_ms(lambda: fl._bwd_cuda(x, flat, mask, dy, **kwargs,
                                                             layer_norm_eps=1e-12))
    finally:
        fl.cluster_size = planner
    log(f"  fused_layer B={b} D={d} {dtype_name} by forced cluster size, device ms: "
        + "; ".join(f"{c}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                    for c, t in out.items()))
    return out


def check_tc_cluster_plan(gen, timed: dict) -> None:
    """Path B's bf16 forward on the card's cluster plan (``_tc_cluster``,
    the occupancy API's count of co-resident clusters): its output bit for
    bit the same as on clusters of 4 (dropout 0.1), its time (``timed``,
    from time_fused_layer) within 3% of the fastest forced size (two
    timings of one kernel in one run differ by about 1%)."""
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.ops import fused_layer as fl

    b, s, d, h, f = LAYER_SHAPES["B"]
    device = torch.device("cuda")
    active = {c: fl._max_clusters(0, fl.TC_FWD, s, d, h, f, 0, c) for c in (2, 4)}
    x, params, mask, kwargs = layer_case(gen, b=b, s=s, d=d, h=h, f=f, dtype=torch.bfloat16,
                                         dropout=0.1, seeds=[3, 1, 4])
    planner = fl.cluster_size
    with torch.no_grad():
        planned = fl.fused_layer(x, params, mask, **kwargs)
        try:
            fl.cluster_size = lambda *_: 4
            four = fl.fused_layer(x, params, mask, **kwargs)
        finally:
            fl.cluster_size = planner
    torch.cuda.synchronize()
    best = min(t["fwd"] for t in timed["by_cluster_ms"].values())
    same = torch.equal(planned, four)
    ok = same and timed["ms"] <= 1.03 * best and b <= active.get(timed["cluster"], b)
    log(f"  fused_layer bf16 B={b} D={d}: the card holds {active} clusters of 2 and 4 at once "
        f"(of {cuda_build.sm_count(device)} SMs); planned {timed['cluster']}: {timed['ms']:.4f} "
        f"ms against the fastest forced size's {best:.4f} (tol 3%); output against clusters of "
        f"4 {'bit for bit' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 forward's cluster plan does not take the card's count")


def check_fused_layer() -> dict:
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.ops import fused_layer as fl
    from transformer_recommenders_tpu_torch.ops.fused_layer import (
        _f32_cluster, cluster_size, fused_layer, fused_layer_reference, heads_per_stage,
        smem_bytes)

    lib = cuda_build.library("fused_layer")
    gen = torch.Generator().manual_seed(0)
    seeds = [0x12345678, 0x9ABCDEF0, 4000000000]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8, 64):
            cases.append(dict(b=b, s=32, d=128, h=8, f=512, dtype=dtype))
        cases.append(dict(b=64, s=32, d=128, h=8, f=512, dtype=dtype, dropout=0.1, seeds=seeds))
        cases.append(dict(b=8, s=32, d=128, h=8, f=512, dtype=dtype, causal=False))
        # ml1m_reference.yaml: d=384, 12 heads, FFN 48
        cases.append(dict(b=8, s=32, d=384, h=12, f=48, dtype=dtype))
        cases.append(dict(b=8, s=32, d=384, h=12, f=48, dtype=dtype, dropout=0.1, seeds=seeds))
        # other lengths the kernel takes: s=8 (S not a multiple of 16), 48, 64
        cases.append(dict(b=4, s=8, d=128, h=8, f=48, dtype=dtype, dropout=0.1, seeds=seeds))
        cases.append(dict(b=4, s=48, d=64, h=4, f=256, dtype=dtype))
        cases.append(dict(b=4, s=64, d=128, h=8, f=512, dtype=dtype, dropout=0.1, seeds=seeds))
    max_err = 0.0
    sms = cuda_build.sm_count(torch.device("cuda"))
    for c in cases:
        dtype_name = str(c["dtype"]).removeprefix("torch.")
        x, params, mask, kwargs = layer_case(
            gen, b=c["b"], s=c["s"], d=c["d"], h=c["h"], f=c["f"], dtype=c["dtype"],
            causal=c.get("causal", True), dropout=c.get("dropout", 0.0), seeds=c.get("seeds"))
        elem = x.element_size()
        cluster = (fl._tc_cluster(c["b"], c["s"], c["d"], c["h"], c["f"], x.device) if elem == 2
                   else _f32_cluster(c["b"], c["s"], c["d"], c["h"], c["f"], x.device,
                                     backward=False))
        hg = heads_per_stage(c["s"], c["d"], c["f"], c["h"], elem,
                             cuda_build.max_shared_memory(x.device), cluster)
        c_smem = lib.fused_layer_smem_bytes(c["s"], c["d"], c["f"], hg, elem, c["h"])
        if c_smem != smem_bytes(c["s"], c["d"], c["f"], hg, elem, c["h"]):
            raise AssertionError("the kernel's and the wrapper's shared-memory layouts disagree")
        with torch.no_grad():
            got = fused_layer(x, params, mask, **kwargs)
            want = fused_layer_reference(x, params, mask, **kwargs)
        torch.cuda.synchronize()
        name = (f"fused_layer B={c['b']} S={c['s']} D={c['d']} H={c['h']} F={c['f']} "
                f"{dtype_name} causal={c.get('causal', True)} dropout={c.get('dropout', 0.0)} "
                f"cluster={cluster} heads/stage={hg} smem={c_smem}B")
        err = compare(name, got, want, dtype_name)
        if c["dtype"] == torch.bfloat16 and c["d"] == 128 and c["b"] == 64 and "seeds" not in c:
            max_err = err
    # times where the paths launch it: serving's B=64, training's B=128,
    # path B's B=32 at D=384; bf16, dropout off
    times = {name: time_fused_layer(gen, *shape) for name, shape in LAYER_SHAPES.items()}
    times["B"]["by_cluster_ms"] = time_by_cluster(gen, *LAYER_SHAPES["B"], "bfloat16",
                                                  fl.CLUSTER_SIZES)
    check_tc_cluster_plan(gen, times["B"])
    return {
        "name": "fused_layer", "route": "cuda",
        "source": "transformer_recommenders_tpu_torch/csrc/fused_layer.cu",
        "replaces": "transformer_recommenders_tpu/ops/fused_layer.py:552",
        "shape": "B=64 S=32 D=128 H=8 F=512 bf16",
        "max_abs_err": max_err, **{k: times["serving"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "by_shape": times,
    }


GATHER_SHAPES = {  # name: (R, N, D, table dtype, output dtype, parts), where the paths
    # launch #1; parts: the rows are a train batch's histories (1) or its
    # histories, positives and negatives (3), or random (0)
    "serving": (2048, 3707, 384, "float32", "bfloat16", 0),  # a (64, 32) batch of histories
    "hot": (4096, 3707, 128, "bfloat16", "bfloat16", 1),  # B*S history rows, projected table
    "pool_B128": (12288, 3707, 128, "bfloat16", "bfloat16", 3),  # 3*B*S: path A, pool objective
    "bench": (8192, 4097, 128, "bfloat16", "bfloat16", 1),  # the bench's B=256 table-path step
    "pool_B256": (24576, 4097, 128, "bfloat16", "bfloat16", 3),  # 3*B*S rows at B=256
}


def time_gather(gen, r: int, n: int, d: int, table_dtype, out_dtype, parts: int,
                seq: int = 32) -> dict:
    """Device times of #1 at one shape (CUDA-graph replays): the kernel,
    an empty kernel on its grid (the launch floor), the plain version and
    ``index_select``; the bound counts each int64 index (8 bytes), each
    distinct table row and each output row once.  ``parts`` of a (B,
    ``seq``) train batch give the rows (0: random rows)."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.ops import gather_matmul as gm

    tdt, odt = getattr(torch, table_dtype), getattr(torch, out_dtype)
    table = torch.randn(n, d, generator=gen).to("cuda", tdt)
    if not parts:
        idx = torch.randint(0, n, (r,), generator=gen)
    else:  # a (B, seq) train batch with its padding
        batch = train_batch(np.random.default_rng(r), r // seq // parts, seq, n - 1)
        keys = ("history_item_idx", "pos_item_idx", "neg_item_idx")[:parts]
        idx = torch.from_numpy(np.concatenate([batch[k].reshape(-1) for k in keys])).long()
    idx = idx.cuda()
    t = {"ms": time_ms(lambda: gm.gather_rows(table, idx, odt)),
         "floor_ms": time_ms(lambda: gm.launch_floor(d, r, odt, "cuda")),
         "plain_ms": time_ms(lambda: gm.gather_rows_reference(table, idx, odt)),
         "library_ms": time_ms(lambda: torch.index_select(table, 0, idx))}
    unique = int(torch.unique(idx[(idx >= 0) & (idx < n)]).numel())
    nbytes = r * 8 + unique * d * table.element_size() + r * d * odt.itemsize
    t["bound_ms"], t["bound_by"] = nbytes / H100_BYTES_PER_S * 1e3, "bytes"
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    log(f"  gather_rows R={r} of {n}x{d} {table_dtype}->{out_dtype} ({unique} distinct rows), "
        f"device time: kernel {t['ms']:.4f} ms, empty launch on its grid {t['floor_ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, index_select ({table_dtype} rows) {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.5f} ms (bytes, int64 indices at 8 bytes): {t['share_of_bound']:.2f} "
        "of the bound")
    return t


def check_gather() -> dict:
    import torch

    from transformer_recommenders_tpu_torch.ops.gather_matmul import (
        gather_rows, gather_rows_reference)

    gen = torch.Generator().manual_seed(1)
    for n, d, r in ((3707, 128, 2048), (3707, 384, 2048), (3707, 384, 32), (100, 6, 37)):
        for table_dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(n, d, generator=gen).to("cuda", table_dtype)
            idx = torch.randint(-5, n + 5, (r,), generator=gen).cuda()  # some out of range
            for out_dtype, idx_dtype in ((torch.bfloat16, torch.int64),
                                         (torch.float32, torch.int64),
                                         (torch.bfloat16, torch.int32)):
                got = gather_rows(table, idx.to(idx_dtype), out_dtype)
                want = gather_rows_reference(table, idx, out_dtype)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                ok = torch.equal(got, want) and got.dtype == out_dtype
                log(f"  gather_rows N={n} D={d} R={r} {table_dtype}->{out_dtype} {idx_dtype} idx: "
                    f"max_abs_err={err} tol=0 (a copy) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("gather_rows disagrees with its plain version")
    times = {name: time_gather(gen, *shape) for name, shape in GATHER_SHAPES.items()}
    return {
        "name": "gather_rows", "route": "cuda",
        "source": "transformer_recommenders_tpu_torch/csrc/gather_rows.cu",
        "replaces": "transformer_recommenders_tpu/ops/gather_matmul.py:52",
        "shape": "R=2048 N=3707 D=384 f32->bf16",
        "max_abs_err": 0.0, **{k: times["serving"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "by_shape": times,
    }


def compare_grad(name: str, got, want, dtype_name: str) -> tuple[float, float, float]:
    """Hold one gradient against its plain version: max abs error relative
    to the plain version's max abs value within ``GRAD_TOL``; returns the
    max abs, mean abs and relative errors."""
    import torch

    err = (got.float() - want.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    rel = max_err / max(float(want.float().abs().max()), 1e-30)
    ok = bool(torch.isfinite(got.float()).all()) and rel <= GRAD_TOL[dtype_name]
    if not ok:
        log(f"  {name}: max_abs_err={max_err:.3g} mean_abs_err={mean_err:.3g} max_rel_err="
            f"{rel:.3g} tol={GRAD_TOL[dtype_name]} (relative to max abs) FAIL")
        msg = f"{name}: kernel disagrees with its plain version"
        raise AssertionError(msg)
    return max_err, mean_err, rel


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time (ms) for ``flops`` operations at ``peak`` and
    ``nbytes`` of device memory at the HBM rate, and which one binds."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_backward_traps(gen) -> None:
    """The two places where the JAX bf16 backward is not autograd of its
    forward, each moving the gradients by less than ``GRAD_TOL`` admits:

    - it divides the hidden-dropout cotangent by the f32 ``1 - rate`` (the
      forward by its bf16 rounding), 0.38% apart at rate 0.4942.  The
      least-squares scale of the kernel's ``ffn_out`` gradients against the
      plain backward must be 1 within 1e-3 (the forward's divisor: 1.0038);
    - it recomputes the GELU with the A&S erf (Eigen's in the forward).
      The kernel's deviation from the plain backward, projected on the
      direction to the plain backward with Eigen's erf, must be within 0.25
      of 0 (a kernel with Eigen's erf reads about 1)."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_layer as fl

    x, params, mask, kwargs = layer_case(gen, b=128, s=32, d=128, h=8, f=512,
                                         dtype=torch.bfloat16, seeds=[5, 6, 7])
    kwargs["hidden_dropout"] = 0.4942
    dy = torch.randn(x.shape, generator=gen).to("cuda", torch.bfloat16)
    leaves = [params["ffn_out"][n].requires_grad_() for n in ("w", "b")]
    fl.fused_layer(x, params, mask, **kwargs).backward(dy)
    with torch.no_grad():
        _, want = fl.fused_layer_backward_reference(x, params, mask, dy, **kwargs)
    scales = {}
    for n, t in zip(("w", "b"), leaves):
        got, ref = t.grad.double(), want["ffn_out"][n].double()
        scales[n] = float((got * ref).sum() / (ref * ref).sum())
    ok = all(abs(v - 1.0) <= 1e-3 for v in scales.values())
    log(f"  fused_layer_bwd bf16 hidden dropout 0.4942, least-squares scale of the ffn_out "
        f"gradients against the plain backward: w {scales['w']:.5f}, b {scales['b']:.5f} "
        f"(tol 1 +- 1e-3; the forward's bf16 divisor would read 1.0038) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fused_layer_bwd divides by the wrong keep rate")

    x, params, mask, kwargs = layer_case(gen, b=128, s=32, d=128, h=8, f=512,
                                         dtype=torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen).to("cuda", torch.bfloat16)
    x.requires_grad_()
    fl.fused_layer(x, params, mask, **kwargs).backward(dy)
    erf_as = fl._erf_as
    with torch.no_grad():
        dx_as, _ = fl.fused_layer_backward_reference(x.detach(), params, mask, dy, **kwargs)
        fl._erf_as = fl._erf
        try:
            dx_eigen, _ = fl.fused_layer_backward_reference(x.detach(), params, mask, dy,
                                                            **kwargs)
        finally:
            fl._erf_as = erf_as
    got, a, e = x.grad.double(), dx_as.double(), dx_eigen.double()
    proj = float(((got - a) * (e - a)).sum() / ((e - a) ** 2).sum())
    ok = abs(proj) <= 0.25
    log(f"  fused_layer_bwd bf16, dx's deviation from the plain backward projected on the "
        f"A&S -> Eigen erf direction: {proj:.4f} (tol |p| <= 0.25; Eigen's erf reads about 1) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fused_layer_bwd does not recompute the GELU with the A&S erf")


def check_fused_layer_bwd() -> dict:
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_layer as fl

    gen = torch.Generator().manual_seed(5)
    seeds = [0x2468ACE0, 0x13579BDF, 3000000000]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal, dropout in ((True, 0.0), (True, 0.1), (False, 0.1)):
            cases.append(dict(b=128, s=32, d=128, h=8, f=512, dtype=dtype, causal=causal,
                              dropout=dropout))
        cases.append(dict(b=4, s=8, d=128, h=8, f=48, dtype=dtype, dropout=0.1))
        cases.append(dict(b=4, s=48, d=128, h=8, f=512, dtype=dtype))
        cases.append(dict(b=3, s=64, d=128, h=8, f=512, dtype=dtype, dropout=0.1))
        cases.append(dict(b=4, s=32, d=384, h=12, f=48, dtype=dtype, dropout=0.1))
        # ml100k_bpr.yaml, path C's train batch: d=64, 4 heads of 16, FFN 256
        cases.append(dict(b=128, s=32, d=64, h=4, f=256, dtype=dtype, dropout=0.1))
    max_err = 0.0
    for c in cases:
        dtype_name = str(c["dtype"]).removeprefix("torch.")
        dropout = c.get("dropout", 0.0)
        x, params, mask, kwargs = layer_case(
            gen, b=c["b"], s=c["s"], d=c["d"], h=c["h"], f=c["f"], dtype=c["dtype"],
            causal=c.get("causal", True), dropout=dropout, seeds=seeds if dropout else None)
        leaves = [params[m][n].requires_grad_() for m, n in fl._PARAM_ORDER]
        x.requires_grad_()
        dy = torch.randn(x.shape, generator=gen).to("cuda", c["dtype"])
        fl.fused_layer(x, params, mask, **kwargs).backward(dy)
        with torch.no_grad():
            dx_want, grads = fl.fused_layer_backward_reference(x.detach(), params, mask, dy,
                                                               **kwargs)
        torch.cuda.synchronize()
        name = (f"fused_layer_bwd B={c['b']} S={c['s']} D={c['d']} H={c['h']} F={c['f']} "
                f"{dtype_name} causal={c.get('causal', True)} dropout={dropout}")
        errs = {"dx": compare_grad(name + " dx", x.grad, dx_want, dtype_name)}
        for (m, n), t in zip(fl._PARAM_ORDER, leaves):
            errs[f"{m}/{n}"] = compare_grad(f"{name} {m}/{n}", t.grad, grads[m][n], dtype_name)
        worst = max(errs, key=lambda k: errs[k][2])
        log(f"  {name}: dx max_abs_err={errs['dx'][0]:.3g} mean_abs_err={errs['dx'][1]:.3g}; "
            f"worst of dx and 12 parameter gradients {worst} max_rel_err={errs[worst][2]:.3g} "
            f"mean_abs_err={errs[worst][1]:.3g}; tol={GRAD_TOL[dtype_name]} (relative to max "
            "abs) ok")
        if c["dtype"] == torch.bfloat16 and c["b"] == 128:
            max_err = max(max_err, max(e[0] for e in errs.values()))
    check_backward_traps(gen)
    check_bwd_plans(gen)
    # times at the train shapes: B=128 sequences, bf16, dropout 0.1, of the
    # flagship, and path B's B=32 at D=384; and at ml100k_bpr's width (D=64),
    # which no path sends to the layer (path C's gate runs the layer stack)
    times = {"flagship": time_layer_bwd(gen, seeds, b=128, s=32, d=128, h=8, f=512),
             "D64": time_layer_bwd(gen, seeds, b=128, s=32, d=64, h=4, f=256),
             "B": time_layer_bwd(gen, seeds, b=32, s=32, d=384, h=12, f=48)}
    return {
        "name": "fused_layer_bwd", "route": "cuda",
        "source": "transformer_recommenders_tpu_torch/csrc/fused_layer.cu",
        "replaces": "transformer_recommenders_tpu/ops/fused_layer.py:566",
        "shape": "B=128 S=32 D=128 H=8 F=512 bf16 dropout 0.1",
        "max_abs_err": max_err, **times["flagship"], "by_shape": times,
    }


BWD_PLAN_SHAPES = {  # (B, S, D, H, F) of the bf16 backward's plans
    "flagship": (128, 32, 128, 8, 512), "D64": (128, 32, 64, 4, 256),
    "B": (32, 32, 384, 12, 48), "quality": (256, 32, 384, 12, 48),
}


def check_bwd_plans(gen) -> dict:
    """The bf16 backward's first pass as planned at each train shape
    (``fl._bwd_tc_plan``: sequences a CTA, cluster, heads a stage) and at
    one sequence a CTA without a cluster, dropout 0.1: dx, the four weight
    gradients and the qkv and ffn_in bias gradients bit for bit the same
    (their sums' order does not depend on the plan); the six the row steps
    sum (the LayerNorms', out's and ffn_out's biases) within 1e-4 of their
    max abs (the warps' share of rows moves their order).  Logs the device
    time of the whole backward under each plan.  Returns the plans."""
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.ops import fused_layer as fl
    from transformer_recommenders_tpu_torch.ops.hash_dropout import seed_tensor

    device = torch.device("cuda")
    limit = cuda_build.max_shared_memory(device)
    planner, plans = fl._bwd_tc_plan, {}
    for name, (b, s, d, h, f) in BWD_PLAN_SHAPES.items():
        plans[name] = planner(b, s, d, h, f, device)
        x, params, mask, kwargs = layer_case(gen, b=b, s=s, d=d, h=h, f=f, dtype=torch.bfloat16,
                                             dropout=0.1, seeds=[4, 5, 6])
        kwargs["dropout_seeds"] = seed_tensor([4, 5, 6], "cuda")  # timed: the kernel alone
        flat = [params[m][n] for m, n in fl._PARAM_ORDER]
        dy = torch.randn(x.shape, generator=gen).to("cuda", torch.bfloat16)
        single = fl.bwd_tc_plan_for(s, d, h, f, 1, 1, limit)  # one sequence a CTA, no cluster
        outs, ms = [], []
        try:
            for plan in (plans[name], single):
                fl._bwd_tc_plan = lambda *_, plan=plan: plan
                dx, grads = fl._bwd_cuda(x, flat, mask, dy, **kwargs, layer_norm_eps=1e-12)
                outs.append([dx, *grads])
                ms.append(time_ms(lambda: fl._bwd_cuda(x, flat, mask, dy, **kwargs,
                                                       layer_norm_eps=1e-12)))
        finally:
            fl._bwd_tc_plan = planner
        torch.cuda.synchronize()
        names = [("dx", "")] + list(fl._PARAM_ORDER)
        by_rows = {("out", "b"), ("ffn_out", "b"), ("ln1", "scale"), ("ln1", "bias"),
                   ("ln2", "scale"), ("ln2", "bias")}
        same = all(torch.equal(a, c) for n, a, c in zip(names, *outs) if n not in by_rows)
        rel = max(float((a - c).abs().max() / c.abs().max().clamp(min=1e-30))
                  for n, a, c in zip(names, *outs) if n in by_rows)
        ok = same and rel <= 1e-4
        log(f"  fused_layer_bwd bf16 B={b} S={s} D={d} H={h} F={f}: plan {plans[name]} "
            f"{ms[0]:.4f} ms; against one sequence a CTA ({ms[1]:.4f} ms): dx, 4 weight and 2 "
            f"bias gradients "
            f"{'bit for bit' if same else 'DIFFER'}, the row steps' 6 within {rel:.3g} of their "
            f"max abs (tol 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the bf16 backward depends on its plan")
    return plans


def time_layer_bwd(gen, seeds, *, b, s, d, h, f, dtype_name: str = "bfloat16",
                   dropout: float = 0.1) -> dict:
    """Device times of the layer backward kernel, its plain version and
    the stock layer's autograd at one train shape (bf16, dropout 0.1 by
    default), and the bound from the shape."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_layer as fl
    from transformer_recommenders_tpu_torch.ops.hash_dropout import seed_tensor
    from transformer_recommenders_tpu_torch.tools.profile_fused_sections import (
        backward_passes_ms)

    dtype = getattr(torch, dtype_name)
    x, params, mask, kwargs = layer_case(gen, b=b, s=s, d=d, h=h, f=f, dtype=dtype,
                                         dropout=dropout, seeds=seeds if dropout else None)
    if dropout:
        # the seeds on the card, as the encoder passes them: the timed call
        # is the kernel alone, with no fill writing a list of seeds there
        kwargs["dropout_seeds"] = seed_tensor(seeds, "cuda")
    flat = [params[m][n] for m, n in fl._PARAM_ORDER]
    dy = torch.randn(x.shape, generator=gen).to("cuda", dtype)
    ms = time_ms(lambda: fl._bwd_cuda(x, flat, mask, dy, **kwargs, layer_norm_eps=1e-12))
    plain_ms = time_ms(lambda: fl.fused_layer_backward_reference(x, params, mask, dy, **kwargs))
    xr = x.detach().clone().requires_grad_()
    leaves = [t.detach().clone().requires_grad_() for t in flat]
    stock_params = fl._unflatten(leaves)
    library_ms = time_ms(lambda: torch.autograd.grad(
        stock_layer(xr, stock_params, mask, **kwargs), [xr, *leaves], dy))
    # the least work: the forward's products once (recompute) and two per
    # dense and four per attention product in the VJP
    flops = 6 * b * s * (4 * d * d + 2 * d * f) + 12 * b * s * s * d
    nparams = 4 * d * d + 2 * d * f + 9 * d + f
    nbytes = 3 * b * s * d * x.element_size() + 4 * b * s + 2 * 4 * nparams
    bound_ms, bound_by = bound(flops, nbytes,
                               H100_BF16_FLOPS if dtype_name == "bfloat16" else H100_F32_FLOPS)
    log(f"  fused_layer_bwd B={b} S={s} D={d} H={h} F={f} {dtype_name} dropout {dropout}, device "
        "time: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, stock layer forward + autograd backward "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, {flops / 1e9:.2f} GFLOP)")
    # the four passes of one call (pass 0 rounds the weights to bf16)
    passes = backward_passes_ms(
        lambda: fl._bwd_cuda(x, flat, mask, dy, **kwargs, layer_norm_eps=1e-12))
    if passes is None:
        log("    by pass: not measured (the profiler recorded no device time)")
    else:
        log("    by pass (torch.profiler, per launch): " + ", ".join(
            f"{p} {v:.4f} ms" for p, v in passes.items()))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "passes_ms": passes}


def time_gather_bwd(name: str, idx, g, n: int, plain: bool = True) -> dict:
    """#2 at one main-path shape (bf16 cotangents into an (n, D) bf16
    catalog), after holding its grouping against ``torch.sort(stable=True)``
    on every in-range position.  Device times (CUDA-graph replays): the
    function as the main path calls it (``ms``: the grouping kernel, then
    the two passes), the grouping alone, the sort path (``torch.sort`` of
    the int64 indices, then the passes with pass 2 searching the sorted
    indices: the same bits without the grouping kernel), ``torch.sort``
    alone, the plain version and ``index_add_``.
    Bounds: the function's rows and indices read and catalog written once;
    the grouping's indices read and order written once."""
    import torch

    from transformer_recommenders_tpu_torch.ops import gather_matmul as gm

    r, d = g.shape
    keys, order, _ = gm._group_cuda(idx, n)
    sorted_idx, sorted_rows = torch.sort(idx, stable=True)
    valid = (sorted_idx >= 0) & (sorted_idx < n)
    if not (torch.equal(keys.long()[valid], sorted_idx[valid])
            and torch.equal(order.long()[valid], sorted_rows[valid])):
        raise AssertionError(f"gather_rows_bwd {name}: the grouping is not the stable sort")
    acc = torch.zeros(n, d, dtype=torch.bfloat16, device="cuda")
    t = {
        "ms": time_ms(lambda: gm._gather_bwd_cuda(g, idx, n, torch.bfloat16)),
        "group_ms": time_ms(lambda: gm._group_cuda(idx, n)),
        "sort_path_ms": time_ms(lambda: gm._segment_sum_cuda(
            g, *torch.sort(idx, stable=True), n, torch.bfloat16)),
        "sort_ms": time_ms(lambda: torch.sort(idx, stable=True)),
        # the plain version is a loop over a chunk's rows: over a second a
        # call at the scale's shape
        "plain_ms": time_ms(lambda: gm.gather_rows_backward_reference(
            g, idx, n, torch.bfloat16)) if plain else None,
        "library_ms": time_ms(lambda: acc.index_add_(0, idx, g)),
        "padding_rows": int((idx == 0).sum()),
    }
    t["bound_ms"], t["bound_by"] = bound(0, r * (d * 2 + idx.element_size()) + n * d * 2,
                                         H100_BF16_FLOPS)
    t["group_bound_ms"], _ = bound(0, r * (idx.element_size() + 4), H100_BF16_FLOPS)
    log(f"  gather_rows_bwd {name} R={r} ({t['padding_rows']} on the padding row) N={n} D={d} "
        f"bf16, the grouping the stable sort's on every in-range position; device time: "
        f"function {t['ms']:.4f} ms (grouping {t['group_ms']:.4f} ms, bound "
        f"{t['group_bound_ms']:.6f}), the sort path (torch.sort and the passes) "
        f"{t['sort_path_ms']:.4f} ms, torch.sort(stable=True) {t['sort_ms']:.4f} ms, plain "
        + (f"{t['plain_ms']:.4f} ms" if plain else "not timed (over a second a call)")
        + f", index_add_ (bf16 atomics) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
        f"({t['bound_by']}); {t['sort_path_ms'] / t['ms']:.2f}x the sort path's speed, "
        f"{t['library_ms'] / t['ms']:.2f}x index_add_'s speed")
    return t


def check_gather_bwd() -> dict:
    """#2 against its plain version, which sums in the kernel's order: bit
    for bit, and two calls give the same bits.  Times at the hot step's
    shape (the 128 x 32 history rows into the projected 3,707 x 128 bf16
    catalog) and the logging step's (history, positives and negatives:
    3 x 128 x 32 rows), by ``time_gather_bwd``."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.ops import gather_matmul as gm

    gen = torch.Generator().manual_seed(2)
    for n, d, r, dtype in ((3707, 128, 4096, torch.bfloat16), (3707, 128, 4096, torch.float32),
                           (3707, 384, 2048, torch.float32), (3707, 384, 32, torch.float32),
                           (3707, 128, 12288, torch.bfloat16), (100, 6, 37, torch.bfloat16)):
        dtype_name = str(dtype).removeprefix("torch.")
        table = torch.randn(n, d, generator=gen).to("cuda", dtype).requires_grad_()
        idx = torch.randint(-5, 40, (r,), generator=gen)  # duplicates and out of range
        idx[: r // 2] = torch.randint(0, n, (r // 2,), generator=gen)
        if r == 12288:  # a 4,608-row padding segment, as in the logging step
            idx[torch.randperm(r, generator=gen)[:4608]] = 0
        idx = idx.cuda()
        g = torch.randn(r, d, generator=gen).to("cuda", dtype)
        gm.gather_rows(table, idx, dtype).backward(g)
        again = gm._gather_bwd_cuda(g, idx, n, dtype)
        want = gm.gather_rows_backward_reference(g, idx, n, dtype)
        torch.cuda.synchronize()
        err = float((table.grad.float() - want.float()).abs().max())
        ok = (table.grad.dtype == dtype and torch.equal(table.grad, want)
              and torch.equal(table.grad, again))
        log(f"  gather_rows_bwd N={n} D={d} R={r} {dtype_name}: max_abs_err={err:.3g} tol=0 "
            f"(the plain version sums in the kernel's order), two calls "
            f"{'bit for bit' if torch.equal(table.grad, again) else 'DIFFERENT'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("gather_rows_bwd disagrees with its plain version")
    times = {}
    batch = train_batch(np.random.default_rng(0), 128, 32, 3706)
    for name, keys in (("hot", ("history_item_idx",)),
                       ("logging", ("history_item_idx", "pos_item_idx", "neg_item_idx"))):
        idx = torch.from_numpy(np.concatenate([batch[k].reshape(-1) for k in keys])).long().cuda()
        g = torch.randn(idx.numel(), 128, generator=gen).to("cuda", torch.bfloat16)
        times[name] = time_gather_bwd(name, idx, g, 3707)
    return {
        "name": "gather_rows_bwd", "route": "cuda",
        "source": "transformer_recommenders_tpu_torch/csrc/gather_rows.cu",
        "replaces": "transformer_recommenders_tpu/ops/gather_matmul.py:75",
        "shape": "R=4096 N=3707 D=128 bf16", "max_abs_err": 0.0, **times["hot"],
        "by_shape": times,
    }


def composite_table_infonce(q, table, pos_idx, counts, mask_fn: bool):
    """The yardstick: per-row CE from stock calls, a bf16 ``q @ table.T``
    and a masked, count-weighted ``logsumexp`` (a composite of library
    calls, differentiable by autograd)."""
    import torch

    x = (q.to(torch.bfloat16) @ table.to(torch.bfloat16).T).float()
    pos = x.gather(1, pos_idx.long()[:, None])
    w = counts[None, :].expand_as(x)
    if mask_fn:
        w = torch.where(x < pos, w, 0.0)
    lse = torch.logsumexp(torch.cat([pos, x + torch.log(w)], dim=1), dim=1)
    return lse - pos[:, 0]


def table_case(gen, r: int, n: int, d: int, exact: bool = False):
    """Table InfoNCE operands as the hot step gives them (the same as
    tests/test_torch_cuda.py): f32 queries, a bf16 catalog with a zero pad
    row, a duplicate-heavy pool whose every seventh entry is its row's
    positive (both kernels must drop that column), a tenth of rows and
    pool entries invalid.  exact: values k/8 with |k| <= 8, every partial
    sum of a score exact in f32, so the kernels' tensor-core chain and the
    plain version's increasing-k chain give the same scores bit for bit."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_table_infonce as fti

    def draw(*shape):
        if exact:
            return torch.randint(-8, 9, shape, generator=gen).float() / 8
        return torch.randn(shape, generator=gen)

    q = draw(r, d)
    table = draw(n, d) * (1.0 if exact else 0.3)
    table[0] = 0
    pos = torch.randint(1, n, (r,), generator=gen)
    neg = torch.randint(1, 64, (r,), generator=gen)
    pos[::7] = neg[::7]  # positives with copies in the pool
    row_valid = torch.rand(r, generator=gen) > 0.1
    neg_valid = torch.rand(r, generator=gen) > 0.1
    pos = torch.where(row_valid, pos, 0)
    pos, neg, row_valid, neg_valid = (t.cuda() for t in (pos, neg, row_valid, neg_valid))
    counts = fti.neg_pool_counts(neg, neg_valid, n)
    return q.cuda(), table.to("cuda", torch.bfloat16), pos, counts, row_valid


def table_near_tie_rows(q, table, pos_idx, counts, scale: float):
    """(R,) bool: rows with a counted column within delta of their pos in
    the plain scores, that column neither pos_idx nor a copy of the
    positive's row (as tests/test_torch_cuda.py; delta as near_tie_rows:
    the kernels sum on the tensor cores, the plain version in increasing
    k)."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_table_infonce as fti

    x, pos, sel, _ = fti._scores(q, table, pos_idx, counts, scale, False)
    delta = scale * 2.0**-13 * math.ceil(q.shape[1] / 128)
    near = ((x - pos[:, None]).abs() <= delta) & (counts.reshape(1, -1) > 0) & ~sel
    r, j = near.nonzero(as_tuple=True)
    tb = table.to(torch.bfloat16)
    copy = (tb[pos_idx.long()[r]] == tb[j]).all(dim=1)
    near[r[copy], j[copy]] = False
    return near.any(dim=1)


def run_table_infonce(q, table, pos, counts, g, scale: float, mask_fn: bool):
    """ce and the gradients in q and the table through the wrapper."""
    from transformer_recommenders_tpu_torch.ops import fused_table_infonce as fti

    q, table = (t.detach().clone().requires_grad_() for t in (q, table))
    ce = fti.table_infonce_rowwise(q, table, pos, counts, scale, mask_fn)
    ce.backward(g)
    return ce.detach(), q.grad, table.grad


# of the max abs value: exp/log for ce and dl's bf16 rounding for the
# gradients.  The kernels and the plain version sum the scores in other
# orders: on Gaussian inputs with the mask on, ce is held on the rows
# without a near-tie and those rows take no cotangent (a flip of the mask
# there moves dl by about exp(-ce) g scale); on exact-sum inputs every row
# is held
TABLE_TOL = {"ce": 1e-5, "dq": 1e-2, "dtable": 1e-2}


def hold_table_infonce(gen, r: int, n: int, d: int, inputs: str, mask_fn: bool,
                       scale: float) -> dict:
    """#5 and #6 at (R, N, D) on ``inputs`` ("gaussian" or "exact", see
    :func:`table_case`) against their plain versions within TABLE_TOL;
    returns the max abs errors of ce, dq and dtable."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_table_infonce as fti

    q, table, pos, counts, row_valid = table_case(gen, r, n, d, exact=inputs == "exact")
    keep = torch.ones_like(row_valid)
    if mask_fn and inputs == "gaussian":
        with torch.no_grad():
            keep = ~table_near_tie_rows(q, table, pos, counts, scale)
    g = (row_valid & keep).float()
    ce, dq, dt = run_table_infonce(q, table, pos, counts, g, scale, mask_fn)
    kw = dict(scale=scale, mask_false_negatives=mask_fn)
    with torch.no_grad():
        ce_want, lse_want = fti.table_infonce_reference(q, table, pos, counts, **kw)
        dq_want, dt_want = fti.table_infonce_backward_reference(
            q, table, pos, counts, lse_want, g, **kw)
    torch.cuda.synchronize()
    parts, max_err = [], {}
    for key, got, want in (("ce", ce[keep], ce_want[keep]), ("dq", dq, dq_want),
                           ("dtable", dt, dt_want)):
        err = (got.float() - want.float()).abs()
        rel = float(err.max() / want.float().abs().max())
        ok = bool(torch.isfinite(got.float()).all()) and rel <= TABLE_TOL[key]
        parts.append(f"{key} max_abs_err={float(err.max()):.3g} "
                     f"mean_abs_err={float(err.mean()):.3g} max_rel_err={rel:.3g}")
        if not ok:
            log(f"  table_infonce {key} {inputs} R={r} N={n} D={d} mask={mask_fn} "
                f"scale={scale}: max_rel_err={rel:.3g} tol={TABLE_TOL[key]} FAIL")
            raise AssertionError(f"table_infonce {key} disagrees with its plain version")
        max_err[key] = float(err.max())
    log(f"  table_infonce {inputs} R={r} N={n} D={d} mask_false_negatives={mask_fn} "
        f"scale={scale}: " + "; ".join(parts) + " (tol ce 1e-5, gradients 1e-2 of the "
        f"max abs; near-tie rows left out: {int((~keep).sum())} of {r}) ok")
    return max_err


def hold_table_twice(gen, r: int, n: int, d: int):
    """Two calls of #5 and #6 at (R, N, D), mask on, give the same bits;
    returns the operands."""
    import torch

    q, table, pos, counts, row_valid = table_case(gen, r, n, d)
    g = row_valid.float()
    first = run_table_infonce(q, table, pos, counts, g, 1.0, True)
    second = run_table_infonce(q, table, pos, counts, g, 1.0, True)
    torch.cuda.synchronize()
    if not all(map(torch.equal, first, second)):
        raise AssertionError("the table kernels are not deterministic")
    log(f"  table_infonce R={r} N={n} D={d}: two calls bit for bit (ce, dq, dtable)")
    return q, table, pos, counts, row_valid


def check_table_infonce() -> list[dict]:
    import torch

    gen = torch.Generator().manual_seed(3)
    r, n, d = 4096, 3707, 128
    max_err = {}
    for inputs in ("gaussian", "exact"):
        for mask_fn, scale in ((True, 1.0), (False, 1.0), (True, 2.5)):
            errs = hold_table_infonce(gen, r, n, d, inputs, mask_fn, scale)
            max_err = {k: max(max_err.get(k, 0.0), v) for k, v in errs.items()}
    q, table, pos, counts, row_valid = hold_table_twice(gen, r, n, d)
    # times at the train shape, mask_false_negatives on
    times = time_table_infonce(q, table, pos, counts, row_valid.float())
    fwd, bwd = times["table_infonce_fwd"], times["table_infonce_bwd"]
    common = {"route": "cuda",
              "source": "transformer_recommenders_tpu_torch/csrc/fused_table_infonce.cu",
              "shape": f"R={r} N={n} D={d} bf16", "splits": times["splits"]}
    return [
        {"name": "table_infonce_fwd", **common,
         "replaces": "transformer_recommenders_tpu/ops/fused_table_infonce.py:83",
         "max_abs_err": max_err["ce"], **fwd},
        {"name": "table_infonce_bwd", **common,
         "replaces": "transformer_recommenders_tpu/ops/fused_table_infonce.py:137",
         "max_abs_err": max(max_err["dq"], max_err["dtable"]), **bwd},
    ]


# the plain InfoNCE versions sum one product per k (the kernels' order):
# over more than 2**24 scores a call takes tens of ms, and they are timed
# over 10 calls in place of 400
PLAIN_FEW_SCORES = 2**24
PLAIN_FEW = {"iters": 5, "reps": 2}


def time_table_infonce(q, table, pos, counts, g) -> dict:
    """Device times of #5 and #6 (mask on, scale 1), their plain versions
    and the composite yardstick on these operands, and the bounds from the
    shapes: ``{"table_infonce_fwd": ..., "table_infonce_bwd": ..., "splits":
    ...}``."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_table_infonce as fti

    (r, d), n = q.shape, table.shape[0]
    lse = fti._fwd_cuda(q, table, pos, counts, 1.0, True)[1]
    fwd_ms = time_ms(lambda: fti._fwd_cuda(q, table, pos, counts, 1.0, True))
    bwd_ms = time_ms(lambda: fti._bwd_cuda(q, table, pos, counts, lse, g, 1.0, True))
    few = PLAIN_FEW if r * n > PLAIN_FEW_SCORES else {}
    with torch.no_grad():
        fwd_plain = time_ms(lambda: fti.table_infonce_reference(q, table, pos, counts), **few)
        bwd_plain = time_ms(lambda: fti.table_infonce_backward_reference(q, table, pos, counts,
                                                                         lse, g), **few)
        fwd_lib = time_ms(lambda: composite_table_infonce(q, table, pos, counts, True))
    qr, tr = q.clone().requires_grad_(), table.clone().requires_grad_()
    bwd_lib = time_ms(lambda: torch.autograd.grad(
        (composite_table_infonce(qr, tr, pos, counts, True) * g).sum(), [qr, tr]))
    io = r * d * 2 + n * d * 2 + n * 4 + r * 4
    fwd_bound = bound(2 * r * n * d, io + 2 * r * 4, H100_BF16_FLOPS)
    # the backward's least work: the scores once, then dq and dT
    bwd_bound = bound(6 * r * n * d, io + 2 * r * 4 + (r + n) * d * 4, H100_BF16_FLOPS)
    splits = {k: fti._splits(0, r, n, d, i) for i, k in enumerate(("fwd", "dq", "dt"))}
    log(f"  table_infonce_fwd R={r} N={n} D={d} bf16 ({splits['fwd']} splits), device time: kernel "
        f"{fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, composite (bf16 matmul + masked logsumexp) "
        f"{fwd_lib:.4f} ms, bound {fwd_bound[0]:.5f} ms ({fwd_bound[1]})")
    log(f"  table_infonce_bwd ({splits['dq']} dq splits, {splits['dt']} dT splits), device time: "
        f"kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, composite forward + autograd "
        f"backward {bwd_lib:.4f} ms, bound {bwd_bound[0]:.5f} ms ({bwd_bound[1]})")
    return {"table_infonce_fwd": {"ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fwd_bound[0],
                                  "bound_by": fwd_bound[1], "library_ms": fwd_lib},
            "table_infonce_bwd": {"ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": bwd_bound[0],
                                  "bound_by": bwd_bound[1], "library_ms": bwd_lib},
            "splits": splits}


def composite_pool_infonce(q, p, n, neg_valid, mask_fn: bool, scale: float):
    """The yardstick: per-row CE from stock calls, a bf16 ``q @ n.T`` and a
    masked ``logsumexp`` over [positive, pool] (a composite of library
    calls, differentiable by autograd)."""
    import torch

    qb, pb, nb = (t.to(torch.bfloat16) for t in (q, p, n))
    x = (qb @ nb.T).float() * scale
    pos = (qb.float() * pb.float()).sum(dim=1) * scale
    valid = (neg_valid[None, :] > 0).expand_as(x)
    if mask_fn:
        valid = valid & (x < pos[:, None])
    lse = torch.logsumexp(torch.cat([pos[:, None], torch.where(valid, x, -math.inf)], dim=1), dim=1)
    return lse - pos


def pool_case(gen, r: int, rn: int, d: int):
    """Pool InfoNCE operands as the train step gives them (the same as
    tests/test_torch_cuda.py): f32 queries, bf16 positive and pool rows,
    every ninth pool row a copy of some positive (the mask must drop it),
    row 0's positive below every pool score (with the mask on it counts no
    negative: ce = 0), a tenth of rows and pool rows invalid."""
    import torch

    q = torch.randn(r, d, generator=gen)
    p = 0.3 * torch.randn(r, d, generator=gen)
    n = 0.3 * torch.randn(rn, d, generator=gen)
    n[::9] = p[torch.randint(0, r, (len(range(0, rn, 9)),), generator=gen)]
    p[0] = -4.0 * q[0]
    row_valid = torch.rand(r, generator=gen) > 0.1
    neg_valid = torch.rand(rn, generator=gen) > 0.1
    return (q.cuda(), p.to("cuda", torch.bfloat16), n.to("cuda", torch.bfloat16),
            row_valid.cuda(), neg_valid.cuda())


def exact_pool_case(gen, r: int, rn: int, d: int):
    """Pool InfoNCE operands whose every partial sum is exact in f32 (the
    same as tests/test_torch_cuda.py): values k/8 with |k| <= 8, so the
    kernels' tensor-core chain and the plain version's increasing-k chain
    give the same scores bit for bit; every ninth pool row a copy of some
    positive; row 0's query +-1 and its positive -4 times it."""
    import torch

    def draw(*shape):
        return torch.randint(-8, 9, shape, generator=gen).float() / 8

    q, p, n = draw(r, d), draw(r, d), draw(rn, d)
    n[::9] = p[torch.randint(0, r, (len(range(0, rn, 9)),), generator=gen)]
    q[0] = torch.where(torch.rand(d, generator=gen) < 0.5, -1.0, 1.0)
    p[0] = -4.0 * q[0]
    row_valid = torch.rand(r, generator=gen) > 0.1
    neg_valid = torch.rand(rn, generator=gen) > 0.1
    return (q.cuda(), p.to("cuda", torch.bfloat16), n.to("cuda", torch.bfloat16),
            row_valid.cuda(), neg_valid.cuda())


def near_tie_rows(q, p, n, neg_valid, scale: float):
    """(R,) bool: rows with a valid pool score within delta of their pos in
    the plain scores, that pool row not a copy of the row's positive (as
    tests/test_torch_cuda.py).  The kernels sum on the tensor cores, the
    plain version in increasing k: a score's two values differ by a few
    ulps of its partial sums (|s| < 2**5, ulp <= 2**-18; D/16 and D
    roundings), so only there can the mask x < pos decide otherwise, a
    chance equality in one version included.  delta = scale * 2**-13 per
    128 of D; copies of the positive (exactly pos in both) stay in the
    check."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    x, pos = fi._scores(q, p, n, scale)
    delta = scale * 2.0**-13 * math.ceil(q.shape[1] / 128)
    near = ((x - pos[:, None]).abs() <= delta) & (neg_valid.reshape(1, -1) > 0)
    r, j = near.nonzero(as_tuple=True)
    copy = (p.to(torch.bfloat16)[r] == n.to(torch.bfloat16)[j]).all(dim=1)
    near[r[copy], j[copy]] = False
    return near.any(dim=1)


def run_pool_infonce(q, p, n, neg_valid, g, scale: float, mask_fn: bool):
    """ce and the gradients in q, p and n through the wrapper."""
    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    q, p, n = (t.detach().clone().requires_grad_() for t in (q, p, n))
    ce = fi.fused_infonce_rowwise(q, p, n, neg_valid, scale, mask_fn)
    ce.backward(g)
    return ce.detach(), q.grad, p.grad, n.grad


POOL_SHAPES = {  # (R, Rn, D)
    "A": (4096, 4096, 128),  # the flagship's logging step: B=128, S=32, d=128
    "B": (1024, 1024, 384),  # ml1m_reference: B=32, S=32, d=384
    "ragged": (1000, 777, 128),
}


def check_pool_copies(gen, r: int, rn: int, d: int) -> None:
    """Every row shares one positive and every seventh pool row copies it:
    with the mask on, the three kernels give the same bits as with those
    rows marked invalid (each scores a copy exactly pos); then two calls
    give the same bits."""
    import torch

    q, p, n, row_valid, neg_valid = pool_case(gen, r, rn, d)
    g = row_valid.float()
    first = run_pool_infonce(q, p, n, neg_valid, g, 1.0, True)
    second = run_pool_infonce(q, p, n, neg_valid, g, 1.0, True)
    p = p[1].expand_as(p).contiguous()
    copies = torch.zeros(rn, dtype=torch.bool, device="cuda")
    copies[::7] = True
    n = torch.where(copies[:, None], p[0], n)
    same = {"two calls": all(map(torch.equal, first, second))}
    for scale in (1.0, 2.5):
        with_copies = run_pool_infonce(q, p, n, neg_valid | copies, g, scale, True)
        without = run_pool_infonce(q, p, n, (neg_valid | copies) & ~copies, g, scale, True)
        same[f"copies dropped, scale {scale}"] = all(map(torch.equal, with_copies, without))
    torch.cuda.synchronize()
    log(f"  pool_infonce R={r} Rn={rn} D={d}, bit for bit (ce, dq, dp, dn): "
        + ", ".join(f"{k} {'yes' if v else 'NO'}" for k, v in same.items()))
    if not all(same.values()):
        raise AssertionError("the pool kernels are not deterministic or count a copy of pos")


# of the max abs value: exp/log for ce and dl's bf16 rounding for the
# gradients (the bounds of tests/test_torch_cuda.py).  The kernels and the
# plain version sum the scores in other orders: on Gaussian inputs with the
# mask on, ce is held on the rows without a near-tie and those rows take no
# cotangent (a flip of the mask there moves dl by about exp(-ce) g scale);
# on exact-sum inputs every row is held
POOL_TOL = {"ce": 1e-5, "dq": 1e-2, "dp": 1e-2, "dn": 1e-2}


def hold_pool_infonce(gen, r: int, rn: int, d: int, inputs: str, mask_fn: bool,
                      scale: float) -> dict:
    """#7 and #8 (with the dn pass) at (R, Rn, D) on ``inputs``
    ("gaussian": :func:`pool_case`, "exact": :func:`exact_pool_case`)
    against their plain versions within POOL_TOL; returns the max abs
    errors of ce, dq, dp and dn."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    case = pool_case if inputs == "gaussian" else exact_pool_case
    q, p, n, row_valid, neg_valid = case(gen, r, rn, d)
    keep = torch.ones(r, dtype=torch.bool, device="cuda")
    if mask_fn and inputs == "gaussian":
        with torch.no_grad():
            keep = ~near_tie_rows(q, p, n, neg_valid, scale)
    g = (row_valid & keep).float()
    ce, dq, dp, dn = run_pool_infonce(q, p, n, neg_valid, g, scale, mask_fn)
    kw = dict(scale=scale, mask_false_negatives=mask_fn)
    with torch.no_grad():
        ce_want, lse, _ = fi.fused_infonce_reference(q, p, n, neg_valid, **kw)
        dq_want, dp_want = fi.fused_infonce_dq_reference(q, p, n, neg_valid, lse, g, **kw)
        dn_want = fi.fused_infonce_dn_reference(q, p, n, neg_valid, lse, g, **kw)
    torch.cuda.synchronize()
    if mask_fn and ce[0].item() != 0.0:
        raise AssertionError("a row with every negative masked must give ce = 0")
    parts, max_err = [], {}
    for key, got, want in (("ce", ce[keep], ce_want[keep]), ("dq", dq, dq_want),
                           ("dp", dp, dp_want), ("dn", dn, dn_want)):
        err = (got.float() - want.float()).abs()
        rel = float(err.max() / want.float().abs().max())
        if not (bool(torch.isfinite(got.float()).all()) and rel <= POOL_TOL[key]):
            log(f"  pool_infonce {key} {inputs} R={r} Rn={rn} D={d} mask={mask_fn} "
                f"scale={scale}: max_rel_err={rel:.3g} tol={POOL_TOL[key]} FAIL")
            if key == "ce":
                worst = int(keep.nonzero()[int(err.argmax())])
                x, pos = fi._scores(q, p, n, scale)
                gap = (x[worst] - pos[worst]).abs()[neg_valid > 0]
                log(f"  worst row {worst}: ce {float(ce[worst]):.7g}, plain "
                    f"{float(ce_want[worst]):.7g}, least |x - pos| over its valid "
                    f"pool in the plain scores {float(gap.min()):.3g}")
            raise AssertionError(f"pool_infonce {key} disagrees with its plain version")
        parts.append(f"{key} max_abs_err={float(err.max()):.3g} "
                     f"mean_abs_err={float(err.mean()):.3g} max_rel_err={rel:.3g}")
        max_err[key] = float(err.max())
    log(f"  pool_infonce {inputs} R={r} Rn={rn} D={d} mask_false_negatives={mask_fn} "
        f"scale={scale}: " + "; ".join(parts) + " (tol ce 1e-5, gradients 1e-2 of "
        f"the max abs; near-tie rows left out: {int((~keep).sum())} of {r}) ok")
    return max_err


def check_pool_infonce() -> list[dict]:
    import torch

    gen = torch.Generator().manual_seed(6)
    max_err = {}
    for shape, (r, rn, d) in POOL_SHAPES.items():
        for inputs in ("gaussian", "exact"):
            for mask_fn, scale in ((True, 1.0), (False, 1.0), (True, 2.5), (False, 2.5)):
                errs = hold_pool_infonce(gen, r, rn, d, inputs, mask_fn, scale)
                if shape != "ragged":
                    for key, err in errs.items():
                        max_err[(shape, key)] = max(max_err.get((shape, key), 0.0), err)
        check_pool_copies(gen, r, rn, d)
    log_registers("fused_infonce", ("pool_infonce_", "xrt::"))
    times = {shape: time_pool_infonce(gen, *POOL_SHAPES[shape]) for shape in ("A", "B")}
    common = {"route": "cuda", "source": "transformer_recommenders_tpu_torch/csrc/fused_infonce.cu"}
    rows = []
    for name, replaces, keys in (
        ("pool_infonce_fwd", "transformer_recommenders_tpu/ops/fused_infonce.py:85", ("ce",)),
        ("pool_infonce_dq", "transformer_recommenders_tpu/ops/fused_infonce.py:159", ("dq", "dp")),
        ("pool_infonce_dn", "transformer_recommenders_tpu/ops/fused_infonce.py:193", ("dn",)),
    ):
        a = times["A"][name]
        rows.append({
            "name": name, **common, "replaces": replaces,
            "shape": "R=Rn=4096 D=128 bf16 (path A), mask on",
            "max_abs_err": max(max_err[(s, k)] for s in ("A", "B") for k in keys),
            "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": a["library_ms"], "splits": a["splits"],
            "by_shape": {s: times[s][name] for s in times},
        })
    return rows


def time_pool_infonce(gen, r: int, rn: int, d: int) -> dict:
    """Device times of the three pool kernels, their plain versions and
    the composite yardstick at one shape, mask on, scale 1, and the
    bounds from the shapes."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    q, p, n, row_valid, neg_valid = pool_case(gen, r, rn, d)
    g = row_valid.float()
    _, lse, pos = fi._fwd_cuda(q, p, n, neg_valid, 1.0, True)
    out = {"pool_infonce_fwd": {}, "pool_infonce_dq": {}, "pool_infonce_dn": {}}
    few = PLAIN_FEW if r * rn > PLAIN_FEW_SCORES else {}
    out["pool_infonce_fwd"]["ms"] = time_ms(lambda: fi._fwd_cuda(q, p, n, neg_valid, 1.0, True))
    out["pool_infonce_dq"]["ms"] = time_ms(
        lambda: fi._dq_cuda(q, p, n, neg_valid, lse, g, pos, 1.0, True))
    out["pool_infonce_dn"]["ms"] = time_ms(
        lambda: fi._dn_cuda(q, p, n, neg_valid, lse, g, pos, 1.0, True))
    with torch.no_grad():
        out["pool_infonce_fwd"]["plain_ms"] = time_ms(
            lambda: fi.fused_infonce_reference(q, p, n, neg_valid), **few)
        out["pool_infonce_dq"]["plain_ms"] = time_ms(
            lambda: fi.fused_infonce_dq_reference(q, p, n, neg_valid, lse, g), **few)
        out["pool_infonce_dn"]["plain_ms"] = time_ms(
            lambda: fi.fused_infonce_dn_reference(q, p, n, neg_valid, lse, g), **few)
        out["pool_infonce_fwd"]["library_ms"] = time_ms(
            lambda: composite_pool_infonce(q, p, n, neg_valid, True, 1.0))
    qr, pr, nr = (t.clone().requires_grad_() for t in (q, p, n))

    def composite_grad(wrt):
        return torch.autograd.grad(
            (composite_pool_infonce(qr, pr, nr, neg_valid, True, 1.0) * g).sum(), wrt)

    out["pool_infonce_dq"]["library_ms"] = time_ms(lambda: composite_grad([qr, pr]))
    out["pool_infonce_dn"]["library_ms"] = time_ms(lambda: composite_grad([nr]))
    # bytes: each input read once (q, p, n as the kernels take them, bf16),
    # each output written once; operations: the scores (2 R Rn D), and for
    # each backward kernel one more product of the same size
    vec = 4 * r  # one (R,) f32 vector
    ins = 2 * d * (2 * r + rn) + 4 * rn
    for i, (name, flops, nbytes) in enumerate((
        ("pool_infonce_fwd", 2 * r * rn * d + 2 * r * d, ins + 3 * vec),
        ("pool_infonce_dq", 4 * r * rn * d + 2 * r * d, ins + 3 * vec + 2 * 4 * r * d),
        ("pool_infonce_dn", 4 * r * rn * d, ins - 2 * d * r + 3 * vec + 4 * rn * d),
    )):
        out[name]["bound_ms"], out[name]["bound_by"] = bound(flops, nbytes, H100_BF16_FLOPS)
        out[name]["gflop"] = flops / 1e9
        out[name]["splits"] = fi._splits(0, r, rn, d, i)
        t = out[name]
        log(f"  {name} R={r} Rn={rn} D={d} bf16 mask on ({t['splits']} splits of the "
            f"{'query rows' if name == 'pool_infonce_dn' else 'pool'}), device time: kernel "
            f"{t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, composite (bf16 matmul + masked logsumexp"
            f"{'' if name == 'pool_infonce_fwd' else ', forward + autograd backward'}) "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}, "
            f"{t['gflop']:.2f} GFLOP)")
    return out


# -- phases 8 and 9: the pairwise heads -------------------------------------------


PAIRWISE_SHAPES = {  # (R, Rn, D)
    "C": (4096, 4096, 64),  # ml100k_bpr's hot step: B=128, S=32, d=64
    "D128": (4096, 4096, 128),  # the flagship's width
    "ragged": (1000, 777, 64),
}
SMOOTH_HEADS = ("PairwiseLogisticLoss", "NCELoss")  # softplus: exp and log a score


def composite_pairwise(q, p, n, neg_valid, head: str, margin: float, mask_fn: bool):
    """The yardstick: per-row weighted mean from stock calls, a bf16
    ``q @ n.T``, the head's ``F.softplus`` or ``F.relu`` and a masked mean
    over the pool (a composite of library calls, differentiable by
    autograd)."""
    import torch
    import torch.nn.functional as F

    qb, pb, nb = (t.to(torch.bfloat16) for t in (q, p, n))
    x = (qb @ nb.T).float()
    pos = (qb.float() * pb.float()).sum(dim=1)
    valid = (neg_valid[None, :] > 0).expand_as(x)
    if mask_fn:
        valid = valid & (x < pos[:, None])
    if head == "ContrastiveLoss":
        s = x - 1.0 + margin
    elif head == "NCELoss":
        s = x
    else:
        s = x - pos[:, None] * (1.0 - margin)
    f = F.softplus(s) if head in SMOOTH_HEADS else F.relu(s)
    w = valid.float()
    return (f * w).sum(dim=1) / (w.sum(dim=1) + 1e-9)


def special_function_rate() -> tuple[float, str]:
    """Special-function results per second of the card: 16 per SM per
    clock (the CUDA C++ Programming Guide's arithmetic-instruction
    throughput table, compute capability 9.0: exp2, log2, reciprocal), on
    every SM at the card's maximum SM clock as ``nvidia-smi`` reads it."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * mhz * 1e6, f"16/SM/clock x {sms} SMs x {mhz:.0f} MHz"


def bound3(flops: float, nbytes: float, sfu: float, sfu_rate: float) -> tuple[float, str, str]:
    """As :func:`bound`, with a third term: ``sfu`` special-function
    results at ``sfu_rate``.  Returns the least time (ms), ``bytes`` or
    ``operations``, and which operations: the products or the special
    functions."""
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "products": flops / H100_BF16_FLOPS * 1e3,
             "special functions": sfu / sfu_rate * 1e3}
    kind = max(terms, key=terms.get)
    return terms[kind], "bytes" if kind == "bytes" else "operations", kind


def run_pairwise(q, p, n, neg_valid, g, head: str, margin: float, mask_fn: bool):
    """out and the gradients in q, p and n through the wrapper."""
    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    q, p, n = (t.detach().clone().requires_grad_() for t in (q, p, n))
    out = fp.fused_pairwise_rowwise(q, p, n, neg_valid, head=head, margin=margin,
                                    mask_false_negatives=mask_fn)
    out.backward(g)
    return out.detach(), q.grad, p.grad, n.grad


def check_pairwise_copies(gen, r: int, rn: int, d: int, heads=None) -> None:
    """check_pool_copies for the pairwise kernels, each of ``heads`` (every
    head by default) at margins 0 and 0.5: the copies of a shared positive
    dropped bit for bit against the same rows marked invalid, and two calls
    bit for bit."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    heads = heads or fp.HEADS
    q, p, n, row_valid, neg_valid = pool_case(gen, r, rn, d)
    g = row_valid.float()
    same = {}
    for head in heads:
        first = run_pairwise(q, p, n, neg_valid, g, head, 0.5, True)
        second = run_pairwise(q, p, n, neg_valid, g, head, 0.5, True)
        same[f"{head} two calls"] = all(map(torch.equal, first, second))
    ps = p[1].expand_as(p).contiguous()
    copies = torch.zeros(rn, dtype=torch.bool, device="cuda")
    copies[::7] = True
    ns = torch.where(copies[:, None], ps[0], n)
    for head in heads:
        for margin in (0.0, 0.5):
            with_copies = run_pairwise(q, ps, ns, neg_valid | copies, g, head, margin, True)
            without = run_pairwise(q, ps, ns, (neg_valid | copies) & ~copies, g, head, margin,
                                   True)
            same[f"{head} copies dropped, margin {margin}"] = all(
                map(torch.equal, with_copies, without))
    torch.cuda.synchronize()
    log(f"  pairwise R={r} Rn={rn} D={d}, bit for bit (out, dq, dp, dn): "
        + ", ".join(f"{k} {'yes' if v else 'NO'}" for k, v in same.items()))
    if not all(same.values()):
        raise AssertionError("the pairwise kernels are not deterministic or count a copy of pos")


# of the max abs value: relu or softplus and a weighted mean for out,
# dl's bf16 rounding for the gradients (the bounds of
# tests/test_torch_cuda.py).  The kernels sum the scores on the tensor
# cores and the plain version in increasing k: on Gaussian inputs, out is
# held on the rows without a near tie (fp.near_tie_rows: a pool score
# within 2**-13 per 128 of D of pos with the mask on, a relu head's s
# within that of 0, times 1 + |c| for the hinge's s = l - pos c) and those
# rows take no cotangent; on exact-sum inputs every row is held.  A
# gradient that is zero in the plain version (dp of the heads without pos
# in the score, everything of the hinge at margin 0 with the mask on) must
# be zero in the kernel.
PAIRWISE_TOL = {"out": 1e-5, "dq": 1e-2, "dp": 1e-2, "dn": 1e-2}
PAIRWISE_TOL_TEXT = ("  tol: out 1e-5 (Gaussian inputs: on the rows without a near tie), dq dp "
                     "dn 1e-2 of the plain version's max abs; exactly 0 where it is 0")


def hold_pairwise(operands, inputs: str, head: str, margin: float, mask_fn: bool) -> dict:
    """The three pairwise kernels through the wrapper against their plain
    versions on ``operands`` (``pool_case``'s), within ``PAIRWISE_TOL``;
    returns each output's max abs error."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    q, p, n, row_valid, neg_valid = operands
    r, d = q.shape
    kw = dict(head=head, margin=margin, mask_false_negatives=mask_fn)
    keep = torch.ones(r, dtype=torch.bool, device="cuda")
    if inputs == "gaussian":
        with torch.no_grad():
            keep = ~fp.near_tie_rows(q, p, n, neg_valid, **kw)
    g = (row_valid & keep).float()
    out, dq, dp, dn = run_pairwise(q, p, n, neg_valid, g, head, margin, mask_fn)
    with torch.no_grad():
        out_want, den, _ = fp.fused_pairwise_reference(q, p, n, neg_valid, **kw)
        dq_want, dp_want = fp.fused_pairwise_dq_reference(q, p, n, neg_valid, den, g, **kw)
        dn_want = fp.fused_pairwise_dn_reference(q, p, n, neg_valid, den, g, **kw)
    torch.cuda.synchronize()
    name = f"pairwise {head} {inputs} R={r} Rn={n.shape[0]} D={d} mask={mask_fn} margin={margin}"
    if mask_fn and out[0].item() != 0.0:
        raise AssertionError(f"{name}: a row with every negative masked must give 0")
    parts, errs = [], {}
    for key, got, want in (("out", out[keep], out_want[keep]), ("dq", dq, dq_want),
                           ("dp", dp, dp_want), ("dn", dn, dn_want)):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        rel = err / scale if scale else err
        ok = bool(torch.isfinite(got.float()).all()) and (
            rel <= PAIRWISE_TOL[key] if scale else err == 0.0)
        if not ok:
            log(f"  {name} {key}: max_abs_err={err:.3g} of max abs {scale:.3g}, "
                f"tol {PAIRWISE_TOL[key]} (0 where the plain version is 0) FAIL")
            raise AssertionError(f"{name} {key} disagrees with its plain version")
        parts.append(f"{key} {err:.3g}" + (f" ({rel:.3g} of max abs)" if scale else " (all 0)"))
        errs[key] = err
    log(f"  {name}: max_abs_err " + ", ".join(parts)
        + f"; near-tie rows left out: {int((~keep).sum())} of {r} ok")
    return errs


def check_pairwise() -> list[dict]:
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    gen = torch.Generator().manual_seed(8)
    max_err = {}
    for shape, (r, rn, d) in PAIRWISE_SHAPES.items():
        for inputs, case in (("gaussian", pool_case), ("exact", exact_pool_case)):
            for head in fp.HEADS:
                for mask_fn, margin in ((True, 0.0), (False, 0.0), (True, 0.5), (False, 0.5)):
                    errs = hold_pairwise(case(gen, r, rn, d), inputs, head, margin, mask_fn)
                    if shape != "ragged":
                        for key, err in errs.items():
                            max_err[key] = max(max_err.get(key, 0.0), err)
        check_pairwise_copies(gen, r, rn, d)
    log(PAIRWISE_TOL_TEXT)
    sfu_rate, sfu_src = special_function_rate()
    log(f"  special-function rate {sfu_rate:.4g}/s ({sfu_src})")
    c = time_pairwise(gen, *PAIRWISE_SHAPES["C"], sfu_rate, fp.HEADS)
    d128 = time_pairwise(gen, *PAIRWISE_SHAPES["D128"], sfu_rate, ("PairwiseLogisticLoss",))
    r, rn, d = PAIRWISE_SHAPES["C"]
    splits = {k: fp._splits(0, r, rn, d, i) for i, k in enumerate(("fwd", "dn", "dq"))}
    log(f"  pairwise R={r} Rn={rn} D={d}: {splits['fwd']} forward and {splits['dq']} dq splits "
        f"of the pool, {splits['dn']} dn splits of the query rows")
    log_registers("fused_pairwise", ("pairwise_", "xrt::"))
    common = {"route": "cuda",
              "source": "transformer_recommenders_tpu_torch/csrc/fused_pairwise.cu"}
    rows = []
    for name, replaces, keys in (
        ("pairwise_fwd", "transformer_recommenders_tpu/ops/fused_pairwise.py:66", ("out",)),
        ("pairwise_dq", "transformer_recommenders_tpu/ops/fused_pairwise.py:93", ("dq", "dp")),
        ("pairwise_dn", "transformer_recommenders_tpu/ops/fused_pairwise.py:127", ("dn",)),
    ):
        t = c[name]["PairwiseLogisticLoss"]
        rows.append({
            "name": name, **common, "replaces": replaces,
            "shape": "R=Rn=4096 D=64 bf16 (path C), PairwiseLogisticLoss, margin 0, mask on",
            "max_abs_err": max(max_err[k] for k in keys), **t,
            "splits": splits[name.removeprefix("pairwise_")],
            "by_head": {h: c[name][h]["ms"] for h in fp.HEADS},
            "by_shape": {"D128": d128[name]["PairwiseLogisticLoss"]},
        })
    return rows


def time_pairwise(gen, r: int, rn: int, d: int, sfu_rate: float, heads, *, margin: float = 0.0,
                  yardstick: str = "PairwiseLogisticLoss", plain: bool = True,
                  iters: int = 20, reps: int = 20) -> dict:
    """Device times of the three pairwise kernels for each of ``heads`` at
    one shape, mask on, at ``margin`` (path C's 0 by default), and the
    bounds from the shape and this run's counted scores; for the
    ``yardstick`` head also the composite of stock calls and, with
    ``plain``, the plain versions.  ``iters`` replays of ``reps`` calls
    each (fewer where a call of the plain version or the composite takes
    a large share of a second)."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    q, p, n, row_valid, neg_valid = pool_case(gen, r, rn, d)
    g = row_valid.float()
    out = {"pairwise_fwd": {}, "pairwise_dq": {}, "pairwise_dn": {}}
    # bytes: each input read once (q, p, n as the kernels take them, bf16),
    # each output written once; products: the scores (2 R Rn D), and for
    # each backward kernel one more product of the same size; special
    # functions: two per counted score for the smooth heads
    vec = 4 * r
    ins = 2 * d * (2 * r + rn) + 4 * rn
    work = {"pairwise_fwd": (2 * r * rn * d + 2 * r * d, ins + 3 * vec),
            "pairwise_dq": (4 * r * rn * d + 2 * r * d, ins + 3 * vec + 2 * 4 * r * d),
            "pairwise_dn": (4 * r * rn * d, ins - 2 * d * r + 3 * vec + 4 * rn * d)}

    def timed(fn):
        return time_ms(fn, iters=iters, reps=reps)

    for head in heads:
        args = (head, margin, True)
        _, den, pos = fp._fwd_cuda(q, p, n, neg_valid, *args)
        counted = float(den.sum())
        times = {
            "pairwise_fwd": timed(lambda: fp._fwd_cuda(q, p, n, neg_valid, *args)),
            "pairwise_dq": timed(lambda: fp._dq_cuda(q, p, n, neg_valid, den, g, pos, *args)),
            "pairwise_dn": timed(lambda: fp._dn_cuda(q, p, n, neg_valid, den, g, pos, *args)),
        }
        for name, (flops, nbytes) in work.items():
            sfu = 2 * counted if head in SMOOTH_HEADS else 0.0
            bound_ms, bound_by, kind = bound3(flops, nbytes, sfu, sfu_rate)
            out[name][head] = {"ms": times[name], "bound_ms": bound_ms, "bound_by": bound_by,
                               "bound_kind": kind, "gflop": flops / 1e9,
                               "special_functions": sfu}
        if head == yardstick:
            kw = dict(head=head, margin=margin, mask_false_negatives=True)
            with torch.no_grad():
                library = {"pairwise_fwd": timed(
                    lambda: composite_pairwise(q, p, n, neg_valid, *args))}
                if plain:
                    plain_ms = {
                        "pairwise_fwd": timed(
                            lambda: fp.fused_pairwise_reference(q, p, n, neg_valid, **kw)),
                        "pairwise_dq": timed(lambda: fp.fused_pairwise_dq_reference(
                            q, p, n, neg_valid, den, g, **kw)),
                        "pairwise_dn": timed(lambda: fp.fused_pairwise_dn_reference(
                            q, p, n, neg_valid, den, g, **kw)),
                    }
            qr, pr, nr = (t.clone().requires_grad_() for t in (q, p, n))

            def composite_grad(wrt):  # p takes none where pos is not in the score
                return torch.autograd.grad(
                    (composite_pairwise(qr, pr, nr, neg_valid, *args) * g).sum(), wrt,
                    allow_unused=True)

            library["pairwise_dq"] = timed(lambda: composite_grad([qr, pr]))
            library["pairwise_dn"] = timed(lambda: composite_grad([nr]))
            for name in out:
                out[name][head] |= {"plain_ms": plain_ms[name] if plain else None,
                                    "library_ms": library[name]}
        f_name = "softplus" if head in SMOOTH_HEADS else "relu"
        for name in out:
            t = out[name][head]
            extra = ""
            if "library_ms" in t:
                plain_text = ("not measured (a call takes most of a second)"
                              if t["plain_ms"] is None else f"{t['plain_ms']:.4f} ms")
                extra = (f", plain {plain_text}, composite (bf16 matmul + masked {f_name} mean"
                         f"{'' if name == 'pairwise_fwd' else ', forward + autograd backward'}) "
                         f"{t['library_ms']:.4f} ms")
            log(f"  {name} {head} R={r} Rn={rn} D={d} bf16 mask on margin {margin} ({counted:.0f} "
                f"counted scores), device time: kernel {t['ms']:.4f} ms{extra}, bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_kind']}: {t['gflop']:.2f} GFLOP, "
                f"{t['special_functions'] / 1e6:.1f} M special functions)")
    return out


# -- phases 10 and 11: the measurement kernels ----------------------------------


def ptxas_report(text: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name
    (demangled where ``c++filt`` is there), registers, barriers, shared
    memory and spills."""
    import re

    props: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            props[current] = []
        elif current and ("registers" in line or "spill" in line):
            props[current].append(line.split("ptxas info    :")[-1].strip())
    names = list(props)
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = names
    short = {}
    for mangled, plain in zip(names, out):
        plain = plain.replace("(anonymous namespace)::", "").removeprefix("void ")
        short[mangled] = plain.split("(")[0] if len(out) == len(names) else mangled
    return [f"{short[n]}: {'; '.join(props[n])}" for n in names]


def log_registers(library: str, kernels: tuple[str, ...]) -> None:
    """The ptxas lines (registers, spills) of ``library``'s kernels whose
    names start with one of ``kernels``, from phase 1's build log."""
    from transformer_recommenders_tpu_torch.ops import cuda_build

    for line in ptxas_report(cuda_build.BUILD_LOGS.get(library, "")):
        if line.startswith(kernels):
            log(f"  ptxas {library}: {line}")


def check_vpu_chain() -> tuple[dict, dict]:
    """Phase 10: the throughput probe (#13) against its plain version on
    the card at K = 64 for each mix, over the one-wave tile and the JAX
    package's (1024, 512) tile; then the calibration (its gate on every
    timed point, the calibration path's launches counted); returns the
    kernel's row and the path's launch counts."""
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.ops import vpu_calibration as vc
    from transformer_recommenders_tpu_torch.tools import calibrate_vpu

    gen = torch.Generator(device="cuda").manual_seed(12)
    for shape in (vc.wave_tile(torch.device("cuda")), (1024, 512)):
        x = torch.rand(shape, generator=gen, device="cuda") + 0.5
        for mix in vc.MIXES:
            got = vc.vpu_chain(x, iters=64, mix=mix)
            want = vc.reference_chain(x, iters=64, mix=mix)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float(((got - want).abs() / want.abs()).max())
            # fma, select: the same correctly rounded f32 operations, so
            # bit for bit; exp: the kernel's expf against torch's exp
            ok = bool(torch.isfinite(got).all()) and (rel <= 2e-5 if mix == "exp" else err == 0.0)
            log(f"  vpu_chain {mix} {tuple(shape)} K=64: max_abs_err={err:.3g} "
                f"max_rel_err={rel:.3g} "
                f"tol={'2e-5 relative' if mix == 'exp' else '0 (bit for bit)'} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"vpu_chain {mix} disagrees with its plain version")
    cuda_build.reset_launches()
    record = calibrate_vpu.calibrate(log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    # the row: the fma mix at K_LO over the one-wave tile; the plain
    # version is one eager call (K_LO x 3 elementwise launches)
    shape, k = tuple(record["shape"]), calibrate_vpu.K_LO
    x = torch.rand(shape, generator=gen, device="cuda") + 0.5
    vc.reference_chain(x, iters=64, mix="fma")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    vc.reference_chain(x, iters=k, mix="fma")
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    elems = shape[0] * shape[1]
    fma = record["results"]["fma"]
    # f32 operations at the data sheet's f32 rate (which counts an FMA as
    # two: the mix has none, so the kernel can reach at most half of it)
    bound_ms, bound_by = bound(elems * k * vc.OPS_PER_ITER["fma"], 8 * elems, H100_F32_FLOPS)
    log(f"  vpu_chain fma {shape} K={k}, device time: kernel {fma['t_lo_ms']:.4f} ms, plain "
        f"(one eager call) {plain_ms:.2f} ms, bound {bound_ms:.5f} ms ({bound_by}, 67 TFLOP/s "
        "f32)")
    row = {
        "name": "vpu_chain", "route": "cuda",
        "source": "transformer_recommenders_tpu_torch/csrc/vpu_calibration.cu",
        "replaces": "transformer_recommenders_tpu/ops/vpu_calibration.py:47",
        "shape": f"{shape} f32, fma, K={k}", "max_abs_err": 0.0, "ms": fma["t_lo_ms"],
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "by_mix": {m: {key: r.get(key) for key in ("t_lo_ms", "t_hi_ms", "elemops_per_ms",
                                                    "share_of_peak", "dispatch_share",
                                                    "clocks_sm_mhz_median", "power_draw_w_max")}
                   for m, r in record["results"].items()},
        "fp32_ops_per_s": record["fp32_ops_per_s"], "mufu_per_s": record["mufu_per_s"],
    }
    # the bounds by instruction issue, from the compiled loops: the mixes
    # fix their bits (``ops/vpu_calibration.py``), so the fma mix's three
    # operations are three single-rounding instructions (FADD, FMUL, FMUL)
    # that no FFMA can fuse, and each takes an FP32 lane a clock (128 an SM)
    # where the data sheet's 67 TFLOP/s counts an FFMA as two; every
    # instruction of the loop takes a dispatch slot (128 lanes an SM a
    # clock), and each MUFU one of 16 an SM a clock
    peak = record["peaks"]
    for mix, loop in (record.get("sass_loops") or {}).items():
        per_step = {op: c / calibrate_vpu.STEPS_PER_LOOP for op, c in loop["opcodes"].items()}
        steps = elems * k
        fp32 = sum(per_step.get(op, 0.0) for op in ("FADD", "FMUL", "FFMA"))
        bounds = {
            "fp32_pipe_bound_ms": fp32 * steps / peak["fp32_lane_ops_per_s"] * 1e3,
            "issue_bound_ms": loop["instructions"] / calibrate_vpu.STEPS_PER_LOOP * steps
            / peak["fp32_lane_ops_per_s"] * 1e3,
            "mufu_bound_ms": per_step.get("MUFU", 0.0) * steps / peak["mufu_per_s"] * 1e3,
        }
        t = record["results"][mix]["t_lo_ms"]
        row["by_mix"][mix] |= bounds | {"ffma_per_step": per_step.get("FFMA", 0.0)}
        log(f"  vpu_chain {mix} K={k}: {t:.4f} ms against bounds by instruction: FP32 pipe "
            f"({fp32:g} FADD/FMUL/FFMA a step, {per_step.get('FFMA', 0.0):g} of them FFMA) "
            f"{bounds['fp32_pipe_bound_ms']:.4f} ms ({bounds['fp32_pipe_bound_ms'] / t:.3f}), "
            f"issue ({loop['instructions'] / calibrate_vpu.STEPS_PER_LOOP:g} instructions a "
            f"step) {bounds['issue_bound_ms']:.4f} ms ({bounds['issue_bound_ms'] / t:.3f}), "
            f"MUFU {bounds['mufu_bound_ms']:.4f} ms")
    return row, launches


def check_sections() -> tuple[list[dict], dict]:
    """Phase 11: the section variants of the layer's kernels (#14, #15)
    against their plain versions at the flagship's width (B=256, the JAX
    script's), every stage, bf16 (the parameters rounded to bf16, as the
    profile takes them) and f32, dropout 0.1; the full variants bit for bit
    against the production kernels; then the section profile at
    ``flagship`` and ``train`` (the sections path's launches counted);
    returns the two kernels' rows and the path's launch counts."""
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.ops import fused_layer as fl
    from transformer_recommenders_tpu_torch.ops import fused_sections as fs
    from transformer_recommenders_tpu_torch.tools import profile_fused_sections as pfs

    b, s, d, h, f = 256, 32, 128, 8, 512
    gen = torch.Generator().manual_seed(13)
    seeds = [1, 2, 3]
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        dtype_name = str(dtype).removeprefix("torch.")
        x, params, mask, kwargs = layer_case(gen, b=b, s=s, d=d, h=h, f=f, dtype=dtype,
                                             dropout=0.1, seeds=seeds)
        if dtype == torch.bfloat16:
            params = {m: {n: t.to(dtype).float() for n, t in v.items()} for m, v in params.items()}
        kwargs.pop("ffn_dim")
        dy = torch.randn(x.shape, generator=gen).to("cuda", dtype)
        with torch.no_grad():
            for stage in fs.FWD_STAGES:
                got = fs.layer_stage_forward(x, params, mask, stage=stage, **kwargs)
                want = fs.layer_stage_forward_reference(x, params, mask, stage=stage, **kwargs)
                torch.cuda.synchronize()
                err = compare(f"fused_layer_stage_fwd {stage} B={b} {dtype_name} dropout 0.1",
                              got, want, dtype_name)
                if dtype == torch.bfloat16:
                    max_err["fwd"] = max(max_err["fwd"], err)
            for stage in fs.BWD_STAGES:
                got = fs.layer_stage_backward(x, params, mask, dy, stage=stage, **kwargs)
                want = fs.layer_stage_backward_reference(x, params, mask, dy, stage=stage, **kwargs)
                torch.cuda.synchronize()
                name = f"fused_layer_stage_bwd {stage} B={b} {dtype_name} dropout 0.1"
                if stage == "recompute":  # the layer's output: the forward's bounds
                    err = compare(name, got, want, dtype_name)
                else:
                    err, mean_err, rel = compare_grad(name, got, want, dtype_name)
                    log(f"  {name}: max_abs_err={err:.3g} mean_abs_err={mean_err:.3g} "
                        f"max_rel_err={rel:.3g} tol={GRAD_TOL[dtype_name]} (relative to max "
                        "abs) ok")
                if dtype == torch.bfloat16:
                    max_err["bwd"] = max(max_err["bwd"], err)
            y_stage = fs.layer_stage_forward(x, params, mask, stage="full", **kwargs)
            y_prod = fl.fused_layer(x, params, mask, ffn_dim=f, **kwargs)
            dx_stage = fs.layer_stage_backward(x, params, mask, dy, stage="full", **kwargs)
        xr = x.detach().clone().requires_grad_()
        fl.fused_layer(xr, params, mask, ffn_dim=f, **kwargs).backward(dy)
        torch.cuda.synchronize()
        same = torch.equal(y_stage, y_prod), torch.equal(dx_stage, xr.grad)
        log(f"  full stages {dtype_name} against the production kernels: forward "
            f"{'bit for bit' if same[0] else 'DIFFERENT'}, backward dx "
            f"{'bit for bit' if same[1] else 'DIFFERENT'}")
        if not all(same):
            raise AssertionError("a full section variant is not the production kernel")
    cuda_build.reset_launches()
    profiles = {}
    for name in ("flagship", "train"):
        profiles[name] = pfs.profile_sections(name, log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    # the rows: the full variants at the flagship shape, beside their
    # plain versions on the profile's inputs
    layer, x, dy, mask, opts = pfs.make_inputs(pfs.SHAPES["flagship"], torch.device("cuda"))
    with torch.no_grad():
        plain = {
            "fwd": time_ms(lambda: fs.layer_stage_forward_reference(x, layer, mask, stage="full",
                                                                    **opts)),
            "bwd": time_ms(lambda: fs.layer_stage_backward_reference(x, layer, mask, dy,
                                                                     stage="full", **opts)),
        }
    res = profiles["flagship"]["results"]
    fwd_bound = layer_bound_ms(b, s, d, h, f, 2)
    flops = 6 * b * s * (4 * d * d + 2 * d * f) + 12 * b * s * s * d
    nparams = 4 * d * d + 2 * d * f + 9 * d + f
    bwd_bound = bound(flops, 3 * b * s * d * 2 + 4 * b * s + 2 * 4 * nparams, H100_BF16_FLOPS)
    common = {"route": "cuda", "source": "transformer_recommenders_tpu_torch/csrc/fused_layer.cu",
              "shape": f"B={b} S={s} D={d} H={h} F={f} bf16 dropout 0.1, the full variant",
              "library_ms": None}
    rows = []
    for direction, replaces, bnd in (("fwd", "scripts/profile_fused_sections.py:68", fwd_bound),
                                     ("bwd", "scripts/profile_fused_sections.py:141", bwd_bound)):
        by_stage = {k.split("/")[1]: {m: v[m] for m in ("cumulative_ms", "delta_ms")}
                    for k, v in res.items() if k.startswith(direction)}
        rows.append({
            "name": f"fused_layer_stage_{direction}", **common, "replaces": replaces,
            "max_abs_err": max_err[direction], "ms": res[f"{direction}/full"]["cumulative_ms"],
            "plain_ms": plain[direction], "bound_ms": bnd[0], "bound_by": bnd[1],
            "by_stage": by_stage,
            "by_shape": {n: {k: v["cumulative_ms"] for k, v in p["results"].items()}
                         for n, p in profiles.items()},
        })
        log(f"  fused_layer_stage_{direction} full B={b}, device time: kernel "
            f"{rows[-1]['ms']:.4f} ms, plain {plain[direction]:.4f} ms, bound {bnd[0]:.5f} ms "
            f"({bnd[1]})")
    rows[1]["bwd_full_passes_ms"] = {n: p["bwd_full_passes_ms"] for n, p in profiles.items()}
    return rows, launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only-scale", action="store_true",
                        help="phases 1 and 17 alone (no kernels line)")
    parser.add_argument("--only-quality", action="store_true",
                        help="phases 1 and 18 alone (no kernels line)")
    parser.add_argument("--only-parity", action="store_true",
                        help="phases 1 and 19's parity part with the full protocol (every "
                             "config at 3 seeds, both shapes; no kernels line)")
    parser.add_argument("--only-serving", action="store_true",
                        help="phases 1 and 19's serving bench at each mode's defaults (no "
                             "kernels line)")
    parser.add_argument("--only-dense", action="store_true",
                        help="phases 1 and 20 alone (no kernels line)")
    parser.add_argument("--scale-uncut", action="store_true",
                        help="phase 17's fit over ML-25M's 25M events and the whole epoch, its "
                             "test and predict over every user (~9 minutes more)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from transformer_recommenders_tpu_torch.tools import card
    except ModuleNotFoundError as e:  # the script alone, without the port beside it
        print(f"chip_smoke: {e}: run it from a checkout of the repository", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # phase 17's and phase 19's data, generated beside the earlier phases
    scale_dir = tempfile.TemporaryDirectory()
    scale_data = pathlib.Path(scale_dir.name) / "data"
    parity_root = pathlib.Path(scale_dir.name) / "parity"
    events = ML25M_SCALE["synthetic_num_events"] if args.scale_uncut else SCALE_EVENTS
    only = (args.only_scale or args.only_quality or args.only_parity or args.only_serving
            or args.only_dense)
    data_job = (start_scale_data(scale_data, events) if args.only_scale or not only
                else None)
    parity_job = (start_parity_data(parity_root) if args.only_parity or not only else None)
    try:
        return run_phases(args, smi, data_job, scale_data, parity_root)
    finally:
        for job in (data_job, parity_job):
            if job is not None and job.poll() is None:
                job.kill()
                job.wait()
        scale_dir.cleanup()


def run_phases(args, smi: str, data_job, scale_data: pathlib.Path,
               parity_root: pathlib.Path) -> int:
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()

    def phase(title: str) -> None:
        log(f"[{time.perf_counter() - t_start:.0f} s] phase {title}")

    phase("1: build")
    t0 = time.perf_counter()
    cuda_build.build_all()
    for name, text in cuda_build.BUILD_LOGS.items():
        for line in ptxas_report(text):
            log(f"  {name}: {line}")
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    if args.only_scale:
        scale_phase(phase, data_job, scale_data, args)
        log(f"[{time.perf_counter() - t_start:.0f} s] done (phases 1 and 17 alone)")
        return 0
    if args.only_quality:
        phase("18: the quality protocols against the JAX package's records")
        quality_phase()
        log(f"[{time.perf_counter() - t_start:.0f} s] done (phases 1 and 18 alone)")
        return 0
    if args.only_parity:
        phase("19: the ML-1M parity protocol, every config at 3 seeds, both shapes")
        parity_phase(parity_root, full=True)
        log(f"[{time.perf_counter() - t_start:.0f} s] done (phases 1 and 19's parity part alone)")
        return 0
    if args.only_dense:
        phase("20: the layer stack's dense (#19) against the plain graph")
        check_dense()
        log(f"[{time.perf_counter() - t_start:.0f} s] done (phases 1 and 20 alone)")
        return 0
    if args.only_serving:
        phase("19 (e): the serving bench, each mode at its defaults")
        serving_bench_phase(smoke=False)
        log(f"[{time.perf_counter() - t_start:.0f} s] done (phases 1 and 19's serving bench "
            "alone)")
        return 0

    phase("2: the serving path's kernels against their plain versions")
    kernels = [check_fused_layer(), check_gather()]

    work = tempfile.TemporaryDirectory()  # phase 3's artifact, served again in phase 15
    artifact = pathlib.Path(work.name) / "artifact"
    phase("3: serving")
    serve_launches = serving_phase(artifact=artifact)
    log(" retrieval's top-k with ties in lax.top_k's order, two ways")
    check_topk_ties()

    # after the burst, so the training checks' load does not reach it
    phase("4: the training path's kernels against their plain versions")
    kernels += [check_fused_layer_bwd(), check_gather_bwd(), *check_table_infonce()]

    phase("5: training, the flagship's hot step")
    launches = {"serving": serve_launches, "training": training_phase()}

    phase("6: the pool InfoNCE kernels against their plain versions")
    kernels += check_pool_infonce()

    phase("7: training through the pool objective")
    log(" path A: the flagship's logging step (full_logs=True)")
    launches["logging_A"] = training_phase(full_logs=True, steps=0, timed_steps=10)
    log(" path B: the reference-equivalent hot step (configs/ml1m_reference.yaml)")
    launches["reference_B"] = training_phase(config=REFERENCE, batch_size=REFERENCE_BATCH)

    phase("8: the pairwise kernels against their plain versions")
    kernels += check_pairwise()

    phase("9: training through the pairwise objectives")
    log(" path C: ml100k_bpr's hot step (configs/ml100k_bpr.yaml)")
    launches["ml100k_C"] = training_phase(config=ML100K, num_items=ML100K_ITEMS)
    log(" path C's logging step (full_logs=True)")
    launches["ml100k_logging"] = training_phase(config=ML100K, num_items=ML100K_ITEMS,
                                                full_logs=True, steps=0, timed_steps=10)
    for name in ("ContrastiveLoss", "NCELoss", "AlignmentContrastiveLoss"):
        # margin 1: the cosines of a random-weight model are small, and
        # at ml25m_ccl.yaml's 0.5 almost no pool row would count.  Batch
        # 128, ml100k_bpr.yaml's: at 32 a few relu terms of the cosines
        # carry the gradient, and a bf16 rounding that flips one moves it
        # by more than the step check's bound
        log(f" {name} at ml100k_bpr's widths, margin 1, batch {TRAIN_BATCH}")
        training_phase(config={**ML100K, "train_loss": name, "margin": 1.0},
                       num_items=ML100K_ITEMS, steps=0, timed_steps=0)
    log(" gradient accumulation: the flagship's hot step, accumulate_grad_batches=2")
    accumulation_phase()

    phase("10: the throughput probe against its plain version, then the calibration")
    row, launches["calibration"] = check_vpu_chain()
    kernels.append(row)

    phase("11: the fused layer's section variants against their plain versions, then the "
          "section profile")
    rows, launches["sections"] = check_sections()
    kernels += rows

    phase("12: the multi-step driver, K steps as CUDA-graph replays")
    log(" the flagship's hot step (configs/ml1m_ssm.yaml, batch 128)")
    launches["scan_flagship"] = scan_phase()
    log(" path C's hot step (configs/ml100k_bpr.yaml, batch 128)")
    launches["scan_C"] = scan_phase(config=ML100K, num_items=ML100K_ITEMS)

    phase("13: the bench, one short window of each part")
    bench_phase()

    phase("14: the trainer, the flagship at MovieLens-1M scale")
    launches["fit_flagship"] = trainer_phase()

    phase("15: the serving worker pool, the unbatched search, the two-stage top-k")
    launches["serving_workers"] = workers_phase(artifact)
    check_two_stage_topk()
    work.cleanup()

    phase("16: the parallel layer on a 1x1 mesh over NCCL")
    launches |= parallel_phase()

    scale = scale_phase(phase, data_job, scale_data, args)
    launches |= scale["launches"]
    kernels += scale["stack"]

    phase("18: the quality protocols against the JAX package's records")
    quality = quality_phase()
    launches["quality"] = quality["launches"]

    phase("19: the ML-1M parity protocol and the serving bench")
    parity = parity_phase(parity_root)
    launches |= parity["launches"]
    log(" (e) the serving bench, one short run of each mode")
    serving_bench_phase()
    for k in kernels:  # the fits' and the parity steps' shapes beside each row's own
        k["by_shape"] = (k.get("by_shape", {}) | quality["by_shape"].get(k["name"], {})
                         | parity["by_shape"].get(k["name"], {}))
    for k in kernels:  # the D=256 and 62k-catalog shapes beside each row's own
        if k["name"].startswith("pairwise_"):
            k["by_shape"] |= {f"scale_{shape}": t[k["name"]]
                              for shape, t in scale["pairwise"]["times"].items()}
            k["scale_max_abs_err"] = scale["pairwise"]["max_err"]
        elif k["name"] in scale["gather"]:
            k["by_shape"] |= {f"scale_{shape}": t
                              for shape, t in scale["gather"][k["name"]].items()}

    for k in kernels:
        # each kernel's launches on the path it was ported for: the two
        # forward kernels on serving, the backward and table kernels on the
        # flagship's hot step, the pool kernels on its logging step, the
        # pairwise kernels on path C (every training path launches the
        # forward kernels too), the probe on the calibration, the section
        # variants on the section profile, the layer stack's (the dense's
        # too) on the scale configuration's hot step
        path = ("serving" if k["name"] in ("fused_layer", "gather_rows") else
                "logging_A" if k["name"].startswith("pool_") else
                "ml100k_C" if k["name"].startswith("pairwise_") else
                "calibration" if k["name"] == "vpu_chain" else
                "sections" if k["name"].startswith("fused_layer_stage_") else
                "scale_hot" if k["name"] in ("hash_dropout", "attn_core_fwd", "attn_core_bwd")
                or k["name"].startswith("dense_") else "training")
        k["launches"] = launches[path][k["name"]]
        k["launches_by_path"] = {p: counts[k["name"]] for p, counts in launches.items()}
        if k["name"] in FLAGSHIP_PATH and not launches["fit_flagship"][k["name"]]:
            msg = f"{k['name']} was not launched in the flagship's fit"
            raise AssertionError(msg)
        if k["name"] in SCALE_PATH and not launches["fit_scale"][k["name"]]:
            msg = f"{k['name']} was not launched in the scale configuration's fit"
            raise AssertionError(msg)
        if not k["launches"]:
            msg = f"{k['name']} was not launched on its path ({path})"
            raise AssertionError(msg)
    log(f"[{time.perf_counter() - t_start:.0f} s] done")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def scale_phase(phase, data_job, scale_data: pathlib.Path, args) -> dict:
    """Phase 17, the scale configuration (configs/ml25m_ccl.yaml) at full
    width: (a) the pairwise kernels at D=256, (b) the gather at the 62k
    catalog, (c) the layer stack's kernels (#16-#19), (d, e) the hot and
    logging steps, (f) the fit.  Returns the kernels' numbers and rows and
    the launch counts of one hot step and the fit."""
    from transformer_recommenders_tpu_torch.configs import TrainConfig

    phase("17: the scale configuration (configs/ml25m_ccl.yaml) at full width")
    phase("17 (a): the pairwise kernels at D=256, R = Rn = 8,192 and 32,768")
    pairwise = check_scale_pairwise(special_function_rate()[0])
    phase("17 (b): the gather at the 62k catalog's shapes")
    gather = check_scale_gather()
    phase("17 (c): the layer stack's kernels, the hash dropout (#16), the attention core "
          "(#17, #18) and the dense (#19)")
    stack = [check_hash_dropout(),
             *check_attn_core(TrainConfig.from_dict(scale_sections()[0]).is_decoder),
             *check_dense()]
    phase("17 (d, e): the hot and logging steps")
    hot = scale_steps_phase(scale_catalog(ML25M_SCALE["synthetic_num_items"]))
    phase("17 (f): a fit at ML-25M's synthetic scale")
    uncut = args.scale_uncut
    fit = scale_fit_phase(data_job, scale_data,
                          ML25M_SCALE["synthetic_num_events"] if uncut else SCALE_EVENTS,
                          cut=-1 if uncut else SCALE_FIT_BATCHES,
                          eval_cut=-1 if uncut else SCALE_EVAL_BATCHES)
    return {"pairwise": pairwise, "gather": gather, "stack": stack,
            "launches": {"scale_hot": hot, "fit_scale": fit}}


FLAGSHIP = dict(  # configs/ml1m_ssm.yaml, the flagship model
    input_dim=384, hidden_size=128, num_hidden_layers=4, num_attention_heads=8,
    intermediate_size=512, max_seq_length=32, compute_dtype="bfloat16", pooling_mode="mean",
)
GENRES = ("Action", "Adventure", "Animation", "Children's", "Comedy", "Crime", "Documentary",
          "Drama", "Fantasy", "Film-Noir", "Horror", "Musical", "Mystery", "Romance",
          "Sci-Fi", "Thriller", "War", "Western")


def synthetic_records(seed: int, num_items: int, num_users: int, dim: int, max_history: int):
    """MovieLens-1M-shaped records from ``seed``: items with a JSON text and
    a unit-norm ``dim``-d embedding, users with a JSON text, a history of
    up to ``max_history`` items and one target item."""
    import numpy as np

    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(num_items, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    items = []
    for i in range(num_items):
        genres = [GENRES[g] for g in rng.choice(len(GENRES), size=1 + i % 3, replace=False)]
        text = json.dumps({"title": f"Movie {i + 1} ({1919 + i % 81})", "genres": genres},
                          separators=(",", ":"))
        items.append({"item_id": str(i + 1), "item_text": text})
    users = []
    for u in range(num_users):
        n = int(rng.integers(1, max_history + 1))
        picks = rng.choice(num_items, size=n + 1, replace=False)
        text = json.dumps({"gender": "FM"[u % 2], "age": int(rng.choice([1, 18, 25, 35, 45, 50, 56])),
                           "occupation": int(rng.integers(0, 21)), "zipcode": f"{u:05d}"},
                          separators=(",", ":"))
        activity = [{"item_id": [items[i]["item_id"] for i in part],
                     "item_text": [items[i]["item_text"] for i in part]}
                    for part in (picks[:n], picks[n:])]
        users.append({"user_id": str(u + 1), "user_text": text,
                      "history": activity[0], "target": activity[1]})
    return items, users, emb


def build_artifact(path, *, device, seed: int = 0, num_items: int = 3706,
                   num_users: int = 6040, config: dict | None = None):
    """Write a serving artifact for a randomly initialized model (weights
    from ``torch.Generator().manual_seed(seed)``) over synthetic records."""
    import torch

    from transformer_recommenders_tpu_torch.configs import ModelConfig
    from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel
    from transformer_recommenders_tpu_torch.serving.deploy import save_artifact

    cfg = ModelConfig(**(config or FLAGSHIP))
    items, users, emb = synthetic_records(seed, num_items, num_users, cfg.resolved_input_dim,
                                          cfg.max_seq_length)
    model = RecommenderModel(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    model.configure_embeddings([r["item_id"] for r in items], emb)
    save_artifact(model, items, users, path)
    return model


def _timed(fn, times: list, sizes: list):
    """``fn`` that appends its wall time to ``times`` and its first
    argument's length to ``sizes``."""

    def wrapper(items, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(items, *args, **kwargs)
        times.append(time.perf_counter() - t0)
        sizes.append(len(items))
        return out

    return wrapper


async def concurrent_requests(service, user_ids: list[str]) -> tuple[list[float], float]:
    """Send ``recommend_with_user_id`` for every user at once; returns
    per-request latencies (s) and the wall time of the whole burst."""

    async def one(uid: str) -> float:
        t0 = time.perf_counter()
        recs = await service.recommend_with_user_id(uid)
        if len(recs) != 20:
            msg = f"user {uid}: {len(recs)} recs"
            raise AssertionError(msg)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    latencies = await asyncio.gather(*(one(u) for u in user_ids))
    return list(latencies), time.perf_counter() - t0


def serving_phase(*, device: str = "cuda", num_items: int = 3706, num_users: int = 6040,
                  requests: int = 256, config: dict | None = None, artifact=None) -> dict:
    """Build the artifact (at ``artifact``, kept, or in a temporary
    directory), serve all nine APIs and a burst of concurrent requests on
    ``device``, hold the card's embeddings against the plain path on the
    CPU; returns the launch counts of the serving run."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.serving.deploy import test_queries
    from transformer_recommenders_tpu_torch.serving.service import Query, Service

    with tempfile.TemporaryDirectory() as tmp:
        artifact = pathlib.Path(artifact or pathlib.Path(tmp) / "artifact")
        t0 = time.perf_counter()
        model = build_artifact(artifact, device=device, num_items=num_items,
                               num_users=num_users, config=config)
        layers = model.config.num_hidden_layers
        service = Service(artifact, device=device)
        log(f"  artifact ({num_items} items, {num_users} users) built and loaded in "
            f"{time.perf_counter() - t0:.1f} s")

        # count the encoder batches and time the two device stages (both
        # end in a copy to the host, so their wall time includes the device)
        batches, stage_s = [], {"encode": [], "search": []}
        service.model.embed = _timed(service.model.embed, stage_s["encode"], batches)
        index = service.item_index.index
        index.search_batch = _timed(index.search_batch, stage_s["search"], [])
        users = [str(r["user_id"]) for r in service.user_index.index.store.records]
        rng = np.random.default_rng(1)
        asyncio.run(concurrent_requests(service, list(rng.choice(users, requests))))  # warm-up
        if device == "cuda":
            torch.cuda.synchronize()

        # the main path, counted: nine APIs, a burst of requests, encode
        cuda_build.reset_launches()
        batches.clear()
        test_queries(service)
        for times in stage_s.values():
            times.clear()
        latencies, wall = asyncio.run(
            concurrent_requests(service, list(rng.choice(users, requests))))
        encode_s, search_s = sum(stage_s["encode"]), sum(stage_s["search"])
        log(f"  burst breakdown: encode {len(stage_s['encode'])} batches {encode_s * 1e3:.2f} ms, "
            f"search {len(stage_s['search'])} batches {search_s * 1e3:.2f} ms, other host work "
            f"{(wall - encode_s - search_s) * 1e3:.2f} ms of {wall * 1e3:.2f} ms wall")
        history = service.user_index.get_id(users[0]).history.item_id
        encoded = model.encode(history)
        histories = np.asarray(rng.integers(1, num_items + 1, size=(64, 32)))
        batch_out = model(histories)["sentence_embedding"]
        if device == "cuda":
            torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        encoder_batches = len(batches) + 2  # the embed batches + encode + the (64, 32) call
        log(f"  encoder batches {encoder_batches} (embed batch sizes {sorted(batches)}), "
            f"launches {launches}: {launches['fused_layer'] / encoder_batches:g} fused-layer "
            f"launches per encoder batch of a {layers}-layer model")
        if device == "cuda":
            if launches["fused_layer"] != layers * encoder_batches:
                msg = (f"fused_layer launched {launches['fused_layer']} times for "
                       f"{encoder_batches} encoder batches of {layers} layers")
                raise AssertionError(msg)
            if launches["gather_rows"] != 2:
                msg = f"gather_rows launched {launches['gather_rows']} times, expected 2"
                raise AssertionError(msg)
        lat = sorted(latencies)
        pct = {q: lat[min(len(lat) - 1, math.ceil(q / 100 * len(lat)) - 1)] for q in (50, 95, 99)}
        card = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
        log(f"  {requests} concurrent recommend_with_user_id (one burst, n={len(lat)}) on "
            f"{card}: " + ", ".join(f"p{q} {v * 1e3:.2f} ms" for q, v in pct.items())
            + f", {requests / wall:.1f} QPS ({wall:.3f} s wall)")
        if not (torch.isfinite(encoded).all() and torch.isfinite(batch_out).all()):
            raise AssertionError("non-finite encoder output")

        # the card's answers against the plain path on the CPU
        reference = Service(artifact, device="cpu")
        queries = [Query(item_ids=service.user_index.get_id(u).history.item_id)
                   for u in users[:8]]
        got_emb, want_emb = (asyncio.run(embed_queries(svc, queries)) for svc in (service, reference))
        err = float(np.abs(got_emb - want_emb).max())
        log(f"  query embeddings, {device} vs plain CPU path: max_abs_err={err:.3g} "
            f"tol={TOL['bfloat16']}")
        if not err <= TOL["bfloat16"]:
            raise AssertionError("the card's query embeddings disagree with the CPU path")
        for q, emb in zip(queries, got_emb):
            got = service.item_index.index.search(emb, q.item_ids)
            want = reference.item_index.index.search(emb, q.item_ids)
            diff = max(abs(a["score"] - b["score"]) for a, b in zip(got, want))
            if len(got) != len(want) or diff > 1e-4:
                raise AssertionError(f"retrieval scores differ by {diff}")
        log(f"  retrieval on {device} matches the CPU index (scores within 1e-4)")
        return launches


async def embed_queries(service, queries):
    """Query embeddings of copies of ``queries`` through the service's
    normalization chain and batched encoder."""
    import copy

    import numpy as np

    out = []
    for q in queries:
        q = await service.process_query(copy.deepcopy(q))
        out.append((await service.embed_query(q)).embedding)
    return np.asarray(out)


def check_topk_ties() -> dict:
    """Equal scores lower index first, as ``lax.top_k`` returns them: the
    two ways, timed at a serving batch (U=64 queries, k=100) over
    MovieLens-1M's catalog (3,706 items) and MovieLens-25M's (62,423),
    each item with copies so that scores tie: ``torch.topk`` over int64
    keys that order by score and then by column (``ops/topk.py``, what the
    port runs) and a stable descending sort cut to k.  They must return
    the same columns; ``torch.topk`` of the raw scores (no order among
    ties) is timed beside them.  Returns the times by catalog size."""
    import torch

    from transformer_recommenders_tpu_torch.ops import topk

    gen = torch.Generator(device="cuda").manual_seed(14)
    times = {}
    for n in (3706, 62423):
        base = torch.randn(n // 2, 128, generator=gen, device="cuda")
        items = base[torch.randint(0, n // 2, (n,), generator=gen, device="cuda")]
        scores = topk.score_items(torch.randn(64, 128, generator=gen, device="cuda"), items)

        def stable_sort():
            return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :100]

        keyed = topk.top_k_columns(scores, 100)
        same = torch.equal(keyed, stable_sort())
        ties = int((scores.gather(-1, keyed).diff(dim=-1) == 0).sum())
        t = {"keyed_topk_ms": time_ms(lambda: topk.top_k_columns(scores, 100)),
             "stable_sort_ms": time_ms(stable_sort),
             "topk_ms": time_ms(lambda: torch.topk(scores, 100, dim=-1))}
        times[n] = t
        log(f"  top-k ties, U=64 k=100 over {n} items ({ties} tied neighbours in the top 100): "
            f"keyed torch.topk {t['keyed_topk_ms']:.4f} ms, stable sort {t['stable_sort_ms']:.4f} "
            f"ms, torch.topk of the scores (ties unordered) {t['topk_ms']:.4f} ms; the two tie "
            f"orders {'agree' if same else 'DISAGREE'}")
        if not same:
            raise AssertionError("the keyed top-k and the stable sort order ties differently")
    return times


# -- phase 5: training ---------------------------------------------------------


TRAIN = dict(  # configs/ml1m_ssm.yaml (model section; data.batch_size 128)
    FLAGSHIP, train_loss="InfoNCELoss", learning_rate=0.001, max_epochs=16,
    hidden_dropout=0.1, attention_dropout=0.1,
)
TRAIN_BATCH = 128


def train_batch(rng, b: int, s: int, num_items: int) -> dict:
    """(b, s) int32 ``history/pos/neg_item_idx`` with trailing zero
    padding, as ``data/dataset.py`` writes them: a history of 1..s distinct
    items per row (a quarter of the rows full), the positive at a position
    the next history item (a random later item at the last position, none
    at one position in ten), a random negative per valid position."""
    import numpy as np

    hist, pos, neg = (np.zeros((b, s), np.int32) for _ in range(3))
    lengths = rng.integers(1, s + 1, size=b)
    lengths[: b // 4] = s
    for row, n in enumerate(lengths):
        items = rng.choice(num_items, size=n + 1, replace=False) + 1
        hist[row, :n] = items[:n]
        p = items[1:].copy()
        p[rng.random(n) < 0.1] = 0
        pos[row, :n] = p
        neg[row, :n] = rng.integers(1, num_items + 1, size=n)
    return {"history_item_idx": hist, "pos_item_idx": pos, "neg_item_idx": neg}


REFERENCE = dict(  # configs/ml1m_reference.yaml (model section; data.batch_size 32)
    hidden_size=384, num_hidden_layers=1, num_attention_heads=12, intermediate_size=48,
    max_seq_length=32, compute_dtype="bfloat16", pooling_mode="mean", train_loss="InfoNCELoss",
    learning_rate=0.001, max_epochs=16, hidden_dropout=0.1, attention_dropout=0.1,
)
REFERENCE_BATCH = 32
ML100K = dict(  # configs/ml100k_bpr.yaml (model section; data.batch_size 128,
    # embedding_dim 384): BPR, PairwiseLogisticLoss at margin 0
    input_dim=384, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=256, max_seq_length=32, compute_dtype="bfloat16", pooling_mode="mean",
    train_loss="PairwiseLogisticLoss", margin=0.0, learning_rate=0.001, max_epochs=16,
    hidden_dropout=0.1, attention_dropout=0.1,
)
ML100K_ITEMS = 1682  # MovieLens-100K's published catalog (943 users)


def expected_launches(cfg, table_rows: int, pool_rows: int, full_logs: bool) -> dict:
    """Launches of one train step on the card under InfoNCE or a pairwise
    head, by kernel: the fused layer's where its gate admits the model's
    width and sequence length (else the layer stack runs: PyTorch products,
    the hash dropout (#16) at its sites and the attention core (#17/#18)
    where its gate admits the split bf16 core), the table-scored InfoNCE
    where the hot step's gate
    admits it, else the pool objective's kernels of the configured loss
    (the pool InfoNCE or the pairwise ones), none of them where hard
    negatives turn the fused loss off; the gather's and the pool's
    backward only where the gathered rows take a gradient, i.e. when they
    are rows of the projected table (a catalog of at most 3 * B * S rows
    is projected before the gather; a frozen, unprojected table takes
    none)."""
    import torch

    from transformer_recommenders_tpu_torch.models.transformer import _fused_layer_mode
    from transformer_recommenders_tpu_torch.ops.attn_core import kernel_admits
    from transformer_recommenders_tpu_torch.training import train_state as ts

    table_path = not full_logs and ts._table_loss_enabled(cfg, table_rows, pool_rows)
    fused = ts._fused_loss_enabled(cfg)  # off under hard negatives: the plain objective
    proj = cfg.resolved_input_dim != cfg.hidden_size
    # the fused layer where its gate admits the shape, else the layer stack
    s = cfg.max_seq_length
    layers = cfg.num_hidden_layers if _fused_layer_mode(cfg, s) else 0
    stack = cfg.num_hidden_layers - layers
    pool = "pool_infonce" if cfg.train_loss == "InfoNCELoss" else "pairwise"
    # the stack's attention core: #17/#18 where the split bf16 core's gate
    # admits the shape; elsewhere one probs site of #16 (the plain bf16
    # core's backward drops y and its cotangent: two); a remat layer runs
    # its forward again in the backward
    impl = cfg.attention_impl if cfg.attention_impl != "auto" else (
        "masked" if s <= 64 else "split")
    split16 = impl == "split" and cfg.compute_dtype == "bfloat16"
    core = stack if split16 and kernel_admits(
        s, cfg.hidden_size // cfg.num_attention_heads, torch.bfloat16) else 0
    fwd = 2 if cfg.remat_layers else 1
    hid, att = int(cfg.hidden_dropout > 0), int(cfg.attention_dropout > 0)
    # #19 under bf16 (every width of the repo's configurations is a multiple
    # of 8): each stack layer's four denses, forward (again in a remat
    # layer's backward), dgrad and wgrad, and the input projection's one
    # call a step, whose frozen table rows take no dgrad
    bf16 = int(cfg.compute_dtype == "bfloat16")
    denses = 4 * stack
    counts = {
        "gather_rows": 1,
        "gather_rows_bwd": int(proj and (table_path or table_rows <= 3 * pool_rows)),
        "fused_layer": layers, "fused_layer_bwd": layers,
        "table_infonce_fwd": int(table_path), "table_infonce_bwd": int(table_path),
        # the measurement kernels: no train step runs them
        "vpu_chain": 0, "fused_layer_stage_fwd": 0, "fused_layer_stage_bwd": 0,
        # #16 forward and backward at the embedding site, at each stack
        # layer's two hidden sites and its probs where #17 does not run
        "hash_dropout": 2 * hid + stack * 2 * hid * (fwd + 1)
        + (stack - core) * att * (fwd + (2 if split16 else 1)),
        "attn_core_fwd": core * fwd, "attn_core_bwd": core,
        "dense_fwd": bf16 * (denses * fwd + int(proj)), "dense_dgrad": bf16 * denses,
        "dense_wgrad": bf16 * (denses + int(proj)), "dense_plain": 0,
    }
    for prefix in ("pool_infonce", "pairwise"):
        on = fused and not table_path and prefix == pool
        counts |= {f"{prefix}_fwd": int(on), f"{prefix}_dq": int(on),
                   f"{prefix}_dn": int(on and proj)}
    return counts


# the logging step's logs, card against the CPU: the loss heads and logit
# statistics of bf16 embeddings whose values differ by one-ulp flips of
# intermediate roundings (see the step check below).  A few times what the
# H100 runs read: 1.5e-4, the hinge head (a relu near zero)
LOG_TOL = 2.0**-10


def compare_logs(logs: dict, want: dict, device: str) -> None:
    """Every log of a logging step against the CPU's plain path: the same
    keys, the counts equal, each value within ``LOG_TOL`` of the CPU's
    relative to max(|value|, 1)."""
    if set(logs) != set(want):
        raise AssertionError(f"log keys differ: {sorted(set(logs) ^ set(want))}")
    errs = {}
    for k in sorted(want):
        got, ref = float(logs[k]), float(want[k])
        errs[k] = abs(got - ref) / max(abs(ref), 1.0)
        if k.startswith("batch/") and got != ref:
            raise AssertionError(f"{k}: {got} on {device}, {ref} on the CPU")
    worst = sorted(errs, key=lambda k: -errs[k])[:4]
    ok = all(math.isfinite(float(v)) for v in logs.values()) and errs[worst[0]] <= LOG_TOL
    log(f"  {len(logs)} logs ({', '.join(sorted({k.split('/')[0] for k in logs}))}), {device} vs "
        f"CPU: worst " + ", ".join(f"{k} {errs[k]:.3g} ({float(logs[k]):.6g} vs "
                                   f"{float(want[k]):.6g})" for k in worst)
        + f"; tol {LOG_TOL:.3g} of max(|value|, 1), the batch counts exact {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {device} logging step's logs disagree with the CPU's")


def check_step_against_cpu(cfg, params, table, batch, seeds, *, full_logs: bool,
                           device: str, loss_tol: float = 1e-4) -> None:
    """One step's loss, raw gradients and, with ``full_logs``, every log on
    ``device`` against the same step on the CPU's plain path (the limits
    below; ``loss_tol`` relative on the loss)."""
    import torch

    from transformer_recommenders_tpu_torch.models.transformer import tree_leaves, tree_unflatten
    from transformer_recommenders_tpu_torch.training import train_state as ts

    loss_and_grad = ts.make_loss_and_grad(cfg, full_logs=full_logs)
    loss, grads, logs = loss_and_grad(params, table, batch, seeds)
    cpu_params = tree_unflatten(params, [t.cpu() for t in tree_leaves(params)])
    t0 = time.perf_counter()
    cpu_loss, cpu_grads, cpu_logs = loss_and_grad(cpu_params, table.cpu(), batch, seeds)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(loss) - float(cpu_loss)) / (abs(float(cpu_loss)) or 1.0)
    errs = {}
    for i, (got, want) in enumerate(zip(tree_leaves(grads), tree_leaves(cpu_grads))):
        got = got.cpu()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"non-finite gradient in leaf {i}")
        scale = float(want.abs().max())
        errs[i] = (float((got - want).abs().max()) / max(scale, 1e-30),
                   float((got - want).norm() / max(float(want.norm()), 1e-30)), tuple(got.shape))
    worst = max(errs, key=lambda i: errs[i][0])
    worst_norm = max(e[1] for e in errs.values())
    # bf16 through the layers, the projection and the loss: one-ulp flips
    # of intermediate roundings.  The limits are a few times what the H100
    # runs read (the flagship's table step: loss 2.7e-6 relative, worst
    # leaf 0.0051 of its max abs, worst norm 0.0021): a backward kernel a
    # few percent off fails them
    ok = loss_rel <= loss_tol and errs[worst][0] <= 2.0**-5 and worst_norm <= 2.0**-7
    log(f"  one step, {device} vs CPU plain path ({cpu_s:.1f} s on the CPU): loss "
        f"{float(loss):.6f} vs {float(cpu_loss):.6f} (rel err {loss_rel:.3g}, tol "
        f"{loss_tol:.3g}); "
        f"raw gradients of {len(errs)} leaves: worst max abs err {errs[worst][0]:.3g} of the "
        f"leaf's max abs (leaf {worst} {errs[worst][2]}, tol 2**-5), worst relative norm "
        f"err {worst_norm:.3g} (tol 2**-7) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {device} train step disagrees with the CPU's plain path")
    if full_logs:
        compare_logs(logs, cpu_logs, device)


def training_phase(*, device: str = "cuda", config: dict | None = None, num_items: int = 3706,
                   batch_size: int = TRAIN_BATCH, steps: int = 30, timed_steps: int = 20,
                   full_logs: bool = False, batch: dict | None = None, emb=None) -> dict:
    """One train step variant on ``device`` (the flagship's hot step by
    default): one step's loss, raw gradients and, with ``full_logs``,
    every log against the CPU's plain path; the launch counts of one step;
    a fixed batch's loss over ``steps`` steps; the eager step time over
    ``timed_steps`` and the device time by kernel (where it is timed).
    ``batch`` and ``emb`` (the catalog's rows) replace the synthetic batch
    and catalog.  Under hard negatives the positions whose mask may differ
    between the card and the CPU are left out first
    (:func:`hard_negative_ties`).  Returns the launch counts of one step."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.configs import TrainConfig
    from transformer_recommenders_tpu_torch.models.recommender import build_item_table
    from transformer_recommenders_tpu_torch.models.transformer import init_transformer_params
    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.training import train_state as ts

    cfg = TrainConfig(**(config or TRAIN))
    cuda = device == "cuda"
    loss_key = f"loss/{cfg.train_loss}"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    if emb is None:
        _, _, emb = synthetic_records(0, num_items, 0, cfg.resolved_input_dim,
                                      cfg.max_seq_length)
    num_items = len(emb)
    table = build_item_table(emb, device=device)
    params = init_transformer_params(torch.Generator().manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(4)
    if batch is None:
        batch = train_batch(rng, batch_size, cfg.max_seq_length, num_items)
    seed_gen = torch.Generator().manual_seed(1)
    seeds = ts.draw_dropout_seeds(seed_gen, cfg)
    if cfg.num_hard_negatives:
        batch = hard_negative_ties(cfg, params, table, batch, seeds, device)
    pool = ts.table_pool_rows(cfg, batch)
    expected = expected_launches(cfg, table.shape[0], pool, full_logs)
    objective = "table-scored" if expected["table_infonce_fwd"] else "pool"
    layers_path = "the fused layer" if expected["fused_layer"] else "the layer stack"
    valid = int((batch["history_item_idx"] != 0).sum())
    log(f"  {cfg.num_hidden_layers} layers d={cfg.hidden_size} (inputs {cfg.resolved_input_dim}) "
        f"heads={cfg.num_attention_heads} FFN {cfg.intermediate_size} seq {cfg.max_seq_length} "
        f"{cfg.compute_dtype}, dropout {cfg.hidden_dropout}; batch {batch_size} "
        f"({valid} valid positions), catalog {table.shape[0]} rows (pool {pool}); "
        f"full_logs={full_logs}, {cfg.train_loss} (margin {cfg.margin}) through the {objective} "
        f"objective, the layers through {layers_path}")

    check_step_against_cpu(cfg, params, table, batch, seeds, full_logs=full_logs, device=device)

    # the main path, counted: one step of make_train_step
    step = ts.make_train_step(cfg, full_logs=full_logs)
    state = ts.init_train_state(cfg, params)
    sync()
    cuda_build.reset_launches()
    state, logs = step(state, table, batch, seeds)
    sync()
    launches = dict(cuda_build.LAUNCHES)
    if not cuda:  # the plain path launches no kernel
        expected = dict.fromkeys(expected, 0)
    log(f"  launches of one train step: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("the train step did not go through every kernel once per use")
    if not all(bool(torch.isfinite(v)) for v in logs.values()):
        raise AssertionError("non-finite train step logs")

    # a fixed batch, fresh dropout seeds each step: the loss must fall
    if steps:
        losses = [float(logs[loss_key])]
        for _ in range(steps - 1):
            state, logs = step(state, table, batch, ts.draw_dropout_seeds(seed_gen, cfg))
            losses.append(float(logs[loss_key]))
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log(f"  {steps} steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}, mean of "
            f"the first 5 {first:.4f}, of the last 5 {last:.4f}")
        if not (all(math.isfinite(v) for v in losses) and last < first):
            raise AssertionError("the fixed-batch loss did not fall")

    if not timed_steps:
        return launches
    # eager step time over fresh batches, after the warm-up above
    times = []
    for _ in range(timed_steps):
        b = train_batch(rng, batch_size, cfg.max_seq_length, num_items)
        seeds = ts.draw_dropout_seeds(seed_gen, cfg)
        sync()
        t0 = time.perf_counter()
        state, logs = step(state, table, b, seeds)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    card = torch.cuda.get_device_name(0) if cuda else "cpu"
    log(f"  train step (full_logs={full_logs}) on {card}, eager, median of {timed_steps}: "
        f"{ms:.3f} ms/step, {batch_size / ms * 1e3:.1f} examples/s (min {min(times):.3f} ms, "
        f"max {max(times):.3f} ms)")
    if cuda:
        profile_steps(step, state, table, batch, cfg, seed_gen)
    return launches


def accumulation_phase(*, device: str = "cuda", config: dict | None = None,
                       num_items: int = 3706, batch_size: int = TRAIN_BATCH) -> None:
    """Two hot steps with ``accumulate_grad_batches=2`` (the flagship's by
    default) on ``device``, held against the same device: after the first
    the parameters are bit for bit as they were; after the second they are
    the flat AdamW update of the mean of the two steps' gradients (from
    ``make_loss_and_grad``, the mean formed as ``optax.MultiSteps`` forms
    it).  Not against the CPU: step-1 AdamW turns last-ulp gradient
    differences into +-lr flips."""
    import dataclasses

    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.configs import TrainConfig
    from transformer_recommenders_tpu_torch.models.recommender import build_item_table
    from transformer_recommenders_tpu_torch.models.transformer import init_transformer_params
    from transformer_recommenders_tpu_torch.training import train_state as ts

    cfg = TrainConfig(**(config or TRAIN), accumulate_grad_batches=2)
    _, _, emb = synthetic_records(0, num_items, 0, cfg.resolved_input_dim, cfg.max_seq_length)
    table = build_item_table(emb, device=device)
    params = init_transformer_params(torch.Generator().manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(5)
    batches = [train_batch(rng, batch_size, cfg.max_seq_length, num_items) for _ in range(2)]
    seed_gen = torch.Generator().manual_seed(6)
    seeds = [ts.draw_dropout_seeds(seed_gen, cfg) for _ in batches]
    loss_and_grad = ts.make_loss_and_grad(cfg)
    g1, g2 = (ts.flatten(loss_and_grad(params, table, b, s)[1]) for b, s in zip(batches, seeds))
    step = ts.make_train_step(cfg, full_logs=False)
    state0 = ts.init_train_state(cfg, params)
    state1, logs1 = step(state0, table, batches[0], seeds[0])
    state2, _ = step(state1, table, batches[1], seeds[1])
    p0 = ts.flatten(params)
    unchanged = torch.equal(ts.flatten(state1.params), p0)
    mean = g1 + (g2 - g1) / torch.full((), 2.0, device=device)
    plain = ts.make_flat_update(dataclasses.replace(cfg, accumulate_grad_batches=1))
    want, _, _ = plain(p0, mean, state0.opt_state)
    p2 = ts.flatten(state2.params)
    diff = float((p2 - want).abs().max())
    moved = float((p2 - p0).abs().max())
    counts = (int(state1.opt_state.count), int(state2.opt_state.count))
    # the same gradients give the same update bit for bit; the limit is a
    # hundredth of lr, where a step-1 AdamW sign flip moves an element by
    # 2 lr and a last-ulp gradient difference near 0 by lr * dg / eps
    ok = (unchanged and diff <= cfg.learning_rate / 100 and moved > 0 and counts == (0, 1)
          and state2.opt_state.mini_step == 0 and not bool(state2.opt_state.acc.any()))
    log(f"  step 1: parameters {'bit for bit unchanged' if unchanged else 'CHANGED'}, count "
        f"{counts[0]}, grad/global_norm {float(logs1['grad/global_norm']):.6g}; step 2: count "
        f"{counts[1]}, parameters moved by up to {moved:.3g}, max abs diff from the flat update "
        f"of the mean gradient {diff:.3g} (tol lr/100 = {cfg.learning_rate / 100:.3g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the accumulating step does not apply the mean gradient once")


def scan_phase(*, config: dict | None = None, num_items: int = 3706,
               batch_size: int = TRAIN_BATCH, k: int = 8, calls: int = 5, emb=None) -> dict:
    """The multi-step driver (``training/scan_steps.py``) on the card: K
    hot steps as CUDA-graph replays against K eager ``make_train_step``
    steps with the same batches and seeds, bit for bit (parameters,
    moments, count, logs); then, counted, one more call of K replays,
    whose launches must be K times one eager step's; ms per step graphed
    and eager from this call; a graphed call under ``torch.profiler``.
    ``emb``: the catalog's embeddings (by default ``synthetic_records``'
    Gaussian ones over ``num_items``).  Returns the launch counts of that
    one graphed call."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.configs import TrainConfig
    from transformer_recommenders_tpu_torch.models.recommender import build_item_table
    from transformer_recommenders_tpu_torch.models.transformer import init_transformer_params
    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.training import train_state as ts
    from transformer_recommenders_tpu_torch.training.scan_steps import (
        make_scanned_train_steps, stack_batches)

    cfg = TrainConfig.from_dict(config or TRAIN)
    if emb is None:
        _, _, emb = synthetic_records(0, num_items, 0, cfg.resolved_input_dim,
                                      cfg.max_seq_length)
    num_items = len(emb)
    table = build_item_table(emb, device="cuda")
    state0 = ts.init_train_state(cfg, init_transformer_params(torch.Generator().manual_seed(0),
                                                              cfg, device="cuda"))
    rng = np.random.default_rng(7)
    batches = [train_batch(rng, batch_size, cfg.max_seq_length, num_items) for _ in range(k)]
    stacked = stack_batches(batches)
    gen = torch.Generator().manual_seed(8)
    seeds = [ts.draw_dropout_seeds(gen, cfg) for _ in range(k)]
    expected = expected_launches(cfg, table.shape[0], ts.table_pool_rows(cfg, batches[0]), False)
    step = ts.make_train_step(cfg, full_logs=False)
    loss_key = f"loss/{cfg.train_loss}"

    def eager(state):
        losses = []
        for batch, s in zip(batches, seeds):
            state, logs = step(state, table, batch, s)
            losses.append(logs[loss_key])
        return state, torch.stack(losses)

    steps = make_scanned_train_steps(cfg)
    t0 = time.perf_counter()
    got, logs = steps(state0, table, stacked, torch.tensor(seeds))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    want, want_losses = eager(state0)
    torch.cuda.synchronize()
    same = {"parameters": torch.equal(ts.flatten(got.params), ts.flatten(want.params)),
            "mu": torch.equal(got.opt_state.mu, want.opt_state.mu),
            "nu": torch.equal(got.opt_state.nu, want.opt_state.nu),
            "count": torch.equal(got.opt_state.count, want.opt_state.count),
            "losses": torch.equal(logs[loss_key], want_losses)}
    positives = [float((b["pos_item_idx"] != 0).sum()) for b in batches]
    same["positives"] = logs["batch/positive_non_zero"].tolist() == positives
    log(f"  {k} graphed steps (first call: warm-up, capture and replays {capture_s:.2f} s) vs "
        f"{k} eager steps, same batches and seeds: "
        + ", ".join(f"{n} {'bit for bit' if v else 'DIFFER'}" for n, v in same.items())
        + f"; losses {[round(float(v), 4) for v in logs[loss_key]]}")
    if not all(same.values()):
        raise AssertionError("the graphed window differs from the eager steps")

    # the main path, counted: one call of K replays
    cuda_build.reset_launches()
    steps(state0, table, stacked, torch.tensor(seeds))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    want_counts = {n: k * c for n, c in expected.items()}
    log(f"  launches of one call of {k} graphed steps: {launches} (expected {k} x one step's)")
    if launches != want_counts:
        raise AssertionError("the graphed steps' launch counts are not K times one step's")

    graphed_ms, eager_ms_ = [], []
    state = got
    for _ in range(calls):  # turns: graphed, eager
        t0 = time.perf_counter()
        state, _ = steps(state, table, stacked, torch.tensor(seeds))
        torch.cuda.synchronize()
        graphed_ms.append((time.perf_counter() - t0) * 1e3 / k)
        t0 = time.perf_counter()
        eager(state)
        torch.cuda.synchronize()
        eager_ms_.append((time.perf_counter() - t0) * 1e3 / k)
    g, e = statistics.median(graphed_ms), statistics.median(eager_ms_)
    log(f"  ms per step, median of {calls} calls of {k} steps, in turns: graphed {g:.3f} "
        f"({batch_size / g * 1e3:.1f} examples/s; min {min(graphed_ms):.3f}, max "
        f"{max(graphed_ms):.3f}), eager {e:.3f} ({batch_size / e * 1e3:.1f} examples/s; min "
        f"{min(eager_ms_):.3f}, max {max(eager_ms_):.3f}): {e / g:.2f}x")
    profile_call(lambda: steps(state, table, stacked, torch.tensor(seeds)), k)
    return launches


# -- phase 14: the trainer -----------------------------------------------------

ML1M_SCALE = dict(synthetic_num_users=6040, synthetic_num_items=3706,
                  synthetic_num_events=1_000_209)  # MovieLens-1M's published counts
# the kernels of the flagship's training path: the forward and backward
# kernels and the table InfoNCE on hot steps, the pool InfoNCE on logging
# steps (the gather and the layer forward also on validation), the hash
# dropout at the embedding site of every train step
FLAGSHIP_PATH = ("gather_rows", "gather_rows_bwd", "fused_layer", "fused_layer_bwd",
                 "table_infonce_fwd", "table_infonce_bwd", "pool_infonce_fwd",
                 "pool_infonce_dq", "pool_infonce_dn", "hash_dropout")
EVAL_USERS = 256


def eval_scores(evaluator, params, table, arrays):
    """(U, N) f32 scores of ``arrays``' users over the catalog, history
    masked, as the evaluator's step computes them before its top-k."""
    import torch

    from transformer_recommenders_tpu_torch.models.recommender import model_forward
    from transformer_recommenders_tpu_torch.ops.topk import mask_excluded, score_items

    with torch.no_grad():
        items = evaluator._prepare_items(params, table)
        window = torch.from_numpy(arrays.history_window).to(table.device, torch.int64)
        full = torch.from_numpy(arrays.history_full).to(table.device, torch.int64)
        q = model_forward(params, evaluator.config, table, window)["sentence_embedding"]
        scores = score_items(q, items, metric="cosine", items_prenormalized=True)
        return mask_excluded(scores, full).cpu()


def check_evaluator_against_cpu(trainer, arrays) -> None:
    """The card's ``Evaluator`` against the CPU's plain path on the same
    parameters and users.

    The bound: let c and s be a user's card and CPU scores and eps their
    largest difference over the catalog (measured here).  The p-th largest
    of c and of s differ by at most eps, so the item the card ranks p-th
    has a CPU score within 2 eps of the CPU's p-th largest: every rank of
    every user is held to that.  Where eps exceeds half a gap between
    neighbouring scores (the bf16 encoder moves scores by ulps, so near
    ties swap), the lists may differ; each per-user metric lies in [0, 1],
    so a metric's mean over the users with targets may move by at most the
    share of those users whose lists differ.  Scores are cosines: eps is
    also held below 2**-4, the serving phase's bound on bf16 embeddings."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.models.transformer import tree_leaves, tree_unflatten
    from transformer_recommenders_tpu_torch.ops.topk import top_k_columns
    from transformer_recommenders_tpu_torch.training.evaluator import Evaluator

    params, table = trainer.model.params, trainer.model.item_table
    cpu_params = tree_unflatten(params, [leaf.detach().cpu() for leaf in tree_leaves(params)])
    card_ev, cpu_ev = trainer._evaluator, Evaluator(trainer.config)
    k = trainer.config.top_k
    card = card_ev.run(params, table, arrays, stage="val")
    cpu = cpu_ev.run(cpu_params, table.cpu(), arrays, stage="val")
    card_idx, _ = card_ev.recommend_batch(params, table, arrays)
    cpu_idx, _ = cpu_ev.recommend_batch(cpu_params, table.cpu(), arrays)
    c = eval_scores(card_ev, params, table, arrays)
    s = eval_scores(cpu_ev, cpu_params, table.cpu(), arrays)
    if not np.array_equal(card_idx, (top_k_columns(c, k) + 1).numpy()):
        raise AssertionError("the card's recommendations are not the top-k of its own scores")
    finite = torch.isfinite(s)
    if not torch.equal(finite, torch.isfinite(c)):
        raise AssertionError("the card and the CPU mask different items")
    eps = torch.where(finite, (c - s).abs(), torch.zeros(())).amax(dim=1)
    s_sorted = torch.sort(s, dim=1, descending=True).values[:, :k]
    s_of_card = s.gather(1, torch.from_numpy(card_idx).long() - 1)
    slack = (s_of_card - s_sorted).abs().amax(dim=1)
    valid = arrays.n_targets > 0
    differ = (card_idx != cpu_idx).any(axis=1)
    share = float((differ & valid).sum()) / max(int(valid.sum()), 1)
    worst = max(abs(card[name] - cpu[name]) for name in card)
    log(f"  card vs CPU evaluator, first {len(arrays)} val users: max |score diff| "
        f"{float(eps.max()):.3g} (median {float(eps.median()):.3g}); top-{k} lists identical "
        f"for {int((~differ).sum())} of {len(arrays)} users; max |metric diff| {worst:.3g} "
        f"(bound: share of users with targets whose lists differ, {share:.3f})")
    log("    " + ", ".join(f"{n.split('/')[-1]} {card[n]:.4f}/{cpu[n]:.4f}" for n in sorted(card)))
    if not bool((slack <= 2 * eps + 1e-6).all()):
        raise AssertionError("a card rank is further from the CPU's than the score error allows")
    if not float(eps.max()) <= 2**-4:
        raise AssertionError("the card's scores differ from the CPU's beyond 2**-4")
    if not worst <= share + 1e-6:
        raise AssertionError("the card's metrics differ beyond the share of differing lists")


def trainer_phase() -> dict:
    """The port's trainer on the flagship at MovieLens-1M scale (see the
    module docstring, phase 14); returns the fit's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.configs import (
        parse_yaml,
        SeqDataModuleConfig,
        TrainConfig,
    )
    from transformer_recommenders_tpu_torch.data.module import SeqDataModule
    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.serving import deploy
    from transformer_recommenders_tpu_torch.training.trainer import Trainer

    yaml_cfg = parse_yaml((REPO / "configs" / "ml1m_ssm.yaml").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        dm = SeqDataModule(SeqDataModuleConfig(**{
            **yaml_cfg["data"], "data_dir": str(tmp / "data"), "dataset": "synthetic",
            "embedder": "hash", **ML1M_SCALE}))
        dm.prepare_data()
        t_prep = time.perf_counter() - t0
        dm.setup()
        sampler = "native" if dm.train_data._native is not None else "numpy"
        log(f"  data: {len(dm.items)} items, {len(dm.users)} users, "
            f"{len(dm.train_data)} train rows, {dm.config.batch_size}-row batches, "
            f"{sampler} sampler; generated and processed in {t_prep:.1f} s, set up in "
            f"{time.perf_counter() - t0 - t_prep:.1f} s")
        cfg = TrainConfig(**{**yaml_cfg["model"], "max_epochs": 2, "steps_per_dispatch": 8,
                             "log_every_n_steps": 50, "use_mlflow": False,
                             "ckpt_dir": str(tmp / "ckpt")})
        trainer = Trainer(cfg, dm, log_dir=str(tmp / "logs"))
        t0 = time.perf_counter()
        val0, test0 = trainer.validate(), trainer.test()
        log(f"  splits: {len(dm.eval_arrays('val'))} val users, "
            f"{len(dm.eval_arrays('test'))} test users")
        log(f"  untrained: val ndcg {val0['val/retrieval_normalized_dcg']:.5f}, hit rate "
            f"{val0['val/retrieval_hit_rate']:.5f}; test ndcg "
            f"{test0['test/retrieval_normalized_dcg']:.5f} ({time.perf_counter() - t0:.1f} s)")

        # the main path, counted: the fit
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        result = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        steps = trainer._host_step
        per_epoch = steps // cfg.max_epochs
        vals = [json.loads(line) for line in (tmp / "logs" / "metrics.jsonl").read_text()
                .splitlines()]
        val_rows = [r for r in vals if "val/retrieval_normalized_dcg" in r]
        train_rows = [r for r in vals if "loss/InfoNCELoss" in r]
        log(f"  fit: {cfg.max_epochs} epochs, {steps} steps, K={cfg.steps_per_dispatch}, "
            f"{fit_s:.1f} s; {result['train/examples_per_s']:.1f} examples/s over the fit "
            f"(validation included); epoch walls {trainer.epoch_walls} s "
            f"({[round(w * 1e3 / per_epoch, 3) for w in trainer.epoch_walls]} ms per step)")
        log("  phase_seconds: " + json.dumps({k: round(v, 3)
                                               for k, v in trainer.phase_seconds.items()}))
        log(f"  phase_counts: {trainer.phase_counts}; logged train rows at steps "
            f"{[r['step'] for r in train_rows]}, loss/InfoNCELoss "
            f"{[round(r['loss/InfoNCELoss'], 2) for r in train_rows]}")
        log("  val per epoch: " + ", ".join(
            f"step {r['step']}: ndcg {r['val/retrieval_normalized_dcg']:.5f} hit rate "
            f"{r['val/retrieval_hit_rate']:.5f}" for r in val_rows))
        log(f"  launches in the fit: {launches}")
        missing = [n for n in FLAGSHIP_PATH if not launches[n]]
        if missing:
            raise AssertionError(f"the fit launched no {missing}")

        best = tmp / "ckpt" / "best"
        best_meta = json.loads((best / "meta.json").read_text())
        best_val = best_meta["metrics"]
        test1 = trainer.test()
        log(f"  trained (best epoch {best_meta['epoch']}, step {best_meta['step']}): val ndcg "
            f"{best_val['val/retrieval_normalized_dcg']:.5f} (untrained "
            f"{val0['val/retrieval_normalized_dcg']:.5f}), test ndcg "
            f"{test1['test/retrieval_normalized_dcg']:.5f} (untrained "
            f"{test0['test/retrieval_normalized_dcg']:.5f})")
        if not best_val["val/retrieval_normalized_dcg"] > val0["val/retrieval_normalized_dcg"]:
            raise AssertionError("the fit did not raise val ndcg above the untrained model's")
        if trainer.validate() != best_val:
            raise AssertionError("the fit's restored best weights do not validate as they did")

        t0 = time.perf_counter()
        recs = trainer.predict()
        u = len(recs["user_ids"])
        if recs["item_idx"].shape != (u, cfg.top_k) or not np.isfinite(recs["scores"]).all():
            raise AssertionError("predict gave malformed recommendations")
        log(f"  predict: {u} users x top-{cfg.top_k} in {time.perf_counter() - t0:.2f} s")

        check_evaluator_against_cpu(trainer, dm.eval_arrays("val").head(EVAL_USERS))

        t0 = time.perf_counter()
        trainer.save(tmp / "artifact")
        deploy.main(artifact_dir=tmp / "artifact")
        log(f"  saved and served through the nine APIs in {time.perf_counter() - t0:.1f} s")

        fresh = Trainer(cfg, dm, log_dir=str(tmp / "logs_restored"))
        meta = fresh.restore(str(best))
        resumed = fresh.validate()
        same = resumed == best_val
        log(f"  a fresh trainer restored at step {meta['step']}: validation "
            f"{'bit for bit the fit best' if same else 'DIFFERS from the fit best'}")
        if not same:
            raise AssertionError(f"resumed validation {resumed} != the fit's best {best_val}")
        fresh.close()
        trainer.close()

        eager_cfg = dataclasses.replace(cfg, max_epochs=1, steps_per_dispatch=1,
                                        limit_train_batches=50, limit_val_batches=1,
                                        ckpt_dir=str(tmp / "ckpt_eager"))
        eager = Trainer(eager_cfg, dm, log_dir=str(tmp / "logs_eager"))
        eager.fit()
        wall, n = eager.epoch_walls[0], eager._host_step
        graphed_ms = [w * 1e3 / per_epoch for w in trainer.epoch_walls]
        log(f"  eager epoch of {n} batches: {wall:.3f} s, {wall * 1e3 / n:.3f} ms per step, "
            f"{n * dm.config.batch_size / wall:.1f} examples/s; graphed epochs "
            f"{[round(ms, 3) for ms in graphed_ms]} ms per step, "
            f"{[round(dm.config.batch_size / ms * 1e3, 1) for ms in graphed_ms]} examples/s")
        eager.close()
    return launches


def profile_call(fn, k: int) -> None:
    """Device busy and idle share of one call of ``k`` graphed steps under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / k
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / k / 1e3
    if busy_ms == 0.0:
        log("  profiled graphed call: the profiler recorded no device time (not measured)")
        return
    log(f"  profiled graphed call: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall per step "
        f"(idle share {1.0 - busy_ms / wall_ms:.3f}, profiler on)")


def bench_phase() -> None:
    """One short window of each part of the port's bench
    (``transformer_recommenders_tpu_torch/bench.py``): the flagship at
    B=256 graphed and eager, retrieval at batches 1, 32 and 256."""
    from transformer_recommenders_tpu_torch import bench

    graphed = bench.bench_train(graphed=True, windows=1, reps=3, burn=1)
    eager = bench.bench_train(graphed=False, windows=1, reps=1, burn=1)
    retrieval = bench.bench_retrieval(windows=1, reps=20)
    log(f"  bench, one window each: graphed {graphed[0]:.1f} examples/s, eager {eager[0]:.1f} "
        "examples/s; retrieval " + ", ".join(
            f"batch {q}: {retrieval[f'qps_batch{q}']} QPS, {retrieval[f'latency_ms_batch{q}']} ms"
            for q in bench.RETRIEVAL_BATCHES))
    if not (graphed[0] > 0 and eager[0] > 0):
        raise AssertionError("the bench measured no throughput")


def profile_steps(step, state, table, batch, cfg, seed_gen, n: int = 3, ops: int = 0) -> dict:
    """Where a train step's device time goes: ``n`` steps under
    ``torch.profiler``, the device time of each CUDA kernel per step, and
    the device's busy share of the steps' wall time (one stream, so the
    kernels do not overlap); with ``ops``, also the ``ops`` PyTorch ops of
    the most device time (the kernels each launched) and the port's
    kernels (pairwise, gather, hash dropout, attention core, dense)
    against everything else.  Returns busy and
    wall ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from transformer_recommenders_tpu_torch.training import train_state as ts

    seeds = [ts.draw_dropout_seeds(seed_gen, cfg) for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in seeds:
            state, _ = step(state, table, batch, s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
    if busy_ms == 0.0:
        log("  profiled steps: the profiler recorded no device time (not measured)")
        return {}
    log(f"  profiled {n} steps: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall per step "
        f"(idle share {1.0 - busy_ms / wall_ms:.3f}, profiler on); by kernel, per step "
        "(the twelve longest, then the rest of the port's own):")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    own = [e for e in ranked[12:]
           if ("(anonymous namespace)::" in e.key or "xrt::" in e.key)
           and "at::native" not in e.key]
    for e in ranked[:12] + own:
        log(f"    {e.self_device_time_total / n / 1e3:9.4f} ms  {e.count // n:4d} launches  "
            f"{e.key[:90]}")
    if ops:
        groups = {"pairwise (#10-#12)": 0.0, "gather (#1, #2)": 0.0,
                  "hash dropout (#16)": 0.0, "attention core (#17, #18)": 0.0,
                  "dense (#19)": 0.0}
        for e in kernels:
            key = ("pairwise (#10-#12)" if "pairwise" in e.key else
                   "gather (#1, #2)" if "gather_rows" in e.key or "segment_" in e.key else
                   "hash dropout (#16)" if "hash_dropout" in e.key else
                   "attention core (#17, #18)" if "attn_core" in e.key else
                   "dense (#19)" if "dense_gemm" in e.key or "dense_wgrad" in e.key else
                   None)
            if key:
                groups[key] += e.self_device_time_total / n / 1e3
        rest = "everything else (the stack's casts, normalization, GELU and residuals, AdamW)"
        groups[rest] = busy_ms - sum(groups.values())
        log("  by part, per step: " + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
        by_op = sorted((e for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CPU
                        and e.self_device_time_total > 0),
                       key=lambda e: -e.self_device_time_total)
        log(f"  by PyTorch op (the device time of the kernels each op launched), per step, the "
            f"{ops} longest:")
        for e in by_op[:ops]:
            log(f"    {e.self_device_time_total / n / 1e3:9.4f} ms  {e.count // n:5d} calls  "
                f"{e.key[:80]}")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms}



# -- phase 15: the serving worker pool, the unbatched search, the two-stage top-k -------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_pool(artifact, port: int, *, workers: int = 2, device: str = "cuda"):
    """``serve_workers(artifact, workers=...)`` in a process of its own;
    its workers' launch lines come back on its standard output."""
    code = ("import sys\nfrom transformer_recommenders_tpu_torch.serving.asgi import "
            "serve_workers\ntry:\n    serve_workers(sys.argv[1], '127.0.0.1', int(sys.argv[2]), "
            "workers=int(sys.argv[3]), device=sys.argv[4])\nexcept KeyboardInterrupt:\n    pass")
    return subprocess.Popen([sys.executable, "-c", code, str(artifact), str(port), str(workers),
                             device], cwd=REPO, stdout=subprocess.PIPE, text=True)


def same_answer(got, want, where: str = "") -> None:
    """Equal structure and strings (item ids in order); floats within 1e-5."""
    if isinstance(want, float) or isinstance(got, float):
        if not abs(got - want) <= 1e-5 * max(1.0, abs(want)):
            raise AssertionError(f"{where}: {got} vs {want}")
    elif isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{where}: keys {sorted(set(got) ^ set(want))}")
        for k in want:
            same_answer(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{where}: {len(got)} vs {len(want)} entries")
        for i, (g, w) in enumerate(zip(got, want)):
            same_answer(g, w, f"{where}[{i}]")
    elif got != want:
        raise AssertionError(f"{where}: {got!r} vs {want!r}")


# a burst's scores, pool against the in-process Service: a user's query,
# encoded in one of the pool's micro-batches rather than alone, differs by
# bf16 roundings (1.3e-4 in a score on the H100), because cuBLAS picks its
# f32 sgemm by the row count for the input projection (``_dense``, the
# first op whose output moves with the batch:
# ``tools/batch_invariance.py``), and a last-bit difference there can
# cross a bf16 rounding; the fused layer's bits do not depend on its
# cluster size.  A few times that
BURST_SCORE_TOL = 2.0**-10


def same_recommendations(got: list, want: list, where: str) -> bool:
    """Two top-k lists of one query encoded in batches of other sizes:
    scores within ``BURST_SCORE_TOL`` rank by rank, and the item ids equal
    but where two of the in-process scores lie within twice that of each
    other (a near tie that the encoder's rounding may swap).  True when the
    lists are identical."""
    tol = BURST_SCORE_TOL
    if len(got) != len(want):
        raise AssertionError(f"{where}: {len(got)} vs {len(want)} recommendations")
    scores = [w["score"] for w in want]
    for p, (g, w) in enumerate(zip(got, want)):
        if not abs(g["score"] - w["score"]) <= tol:
            raise AssertionError(f"{where}[{p}].score: {g['score']} vs {w['score']}")
        near_tie = any(abs(scores[q] - scores[p]) <= 2 * tol for q in range(len(scores)) if q != p)
        if g["item_id"] != w["item_id"] and not near_tie:
            raise AssertionError(f"{where}[{p}].item_id: {g['item_id']} vs {w['item_id']}")
    return [g["item_id"] for g in got] == [w["item_id"] for w in want]


def workers_phase(artifact, *, device: str = "cuda", workers: int = 2, requests: int = 64,
                  start_timeout: float = 240.0) -> dict:
    """``serve_workers`` over phase 3's artifact: the nine APIs and a burst of
    ``requests`` concurrent ``recommend_with_user_id`` over HTTP (after one
    burst to warm the workers up), every answer held against the in-process
    ``Service``: the nine APIs, sent one at a time as the in-process calls
    are, item ids equal and floats within 1e-5; the burst, whose queries the
    pool encodes in batches of other sizes, by ``same_recommendations``;
    QPS and latency percentiles; then the pool interrupted, every worker
    gone.  Returns the
    workers' launch counts, summed (each worker prints its own on the way
    out)."""
    import concurrent.futures
    import signal

    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.serving import asgi, deploy
    from transformer_recommenders_tpu_torch.serving.service import Service

    service = Service(artifact, device=device)
    users = [str(r["user_id"]) for r in service.user_index.index.store.records[:requests]]
    want_burst = {u: deploy.test_service(service, "recommend_with_user_id", {"user_id": u})
                  for u in users}
    port = free_port()
    t0 = time.perf_counter()
    pool = start_pool(artifact, port, workers=workers, device=device)
    pids: set[int] = set()
    try:
        # up when every worker has answered (fresh connections, which the
        # kernel spreads over the workers' sockets)
        while len(pids) < workers:
            if pool.poll() is not None:
                raise AssertionError(f"the pool exited with code {pool.returncode}")
            try:
                status, _, headers = asgi.http_post("127.0.0.1", port, "model_name", {},
                                                    timeout=5)
                if status == 200:
                    pids.add(int(headers["x-worker-pid"]))
                    continue
            except OSError:
                pass
            if time.perf_counter() - t0 > start_timeout:
                raise AssertionError(f"{len(pids)} of {workers} workers answered within "
                                     f"{start_timeout:.0f} s")
            time.sleep(0.2)
        log(f"  {workers} workers up in {time.perf_counter() - t0:.1f} s")
        for name, payload in deploy.api_requests(service):
            status, body, headers = asgi.http_post("127.0.0.1", port, name, payload)
            if status != 200:
                raise AssertionError(f"{name}: {status} {body}")
            same_answer(body, deploy.test_service(service, name, payload), name)
            pids.add(int(headers["x-worker-pid"]))
        log("  the nine APIs through the pool answer as the in-process Service")

        def one(user: str):
            t = time.perf_counter()
            status, body, headers = asgi.http_post("127.0.0.1", port, "recommend_with_user_id",
                                                   {"user_id": user})
            return user, status, body, int(headers["x-worker-pid"]), time.perf_counter() - t

        with concurrent.futures.ThreadPoolExecutor(requests) as ex:
            list(ex.map(one, users))  # warm-up: each worker's first batch shapes
            t_burst = time.perf_counter()
            results = list(ex.map(one, users))
            wall = time.perf_counter() - t_burst
        identical = 0
        for user, status, body, pid, _ in results:
            if status != 200:
                raise AssertionError(f"user {user}: {status} {body}")
            identical += same_recommendations(body, want_burst[user],
                                              f"recommend_with_user_id({user})")
            pids.add(pid)
        lat = sorted(r[-1] for r in results)
        pct = {q: lat[min(len(lat) - 1, math.ceil(q / 100 * len(lat)) - 1)] for q in (50, 95)}
        served = {pid: sum(r[3] == pid for r in results) for pid in pids}
        log(f"  {requests} concurrent recommend_with_user_id through {workers} workers on "
            f"{torch.cuda.get_device_name(0) if device == 'cuda' else 'cpu'}: "
            f"{requests / wall:.1f} QPS ({wall:.3f} s wall), p50 {pct[50] * 1e3:.2f} ms, "
            f"p95 {pct[95] * 1e3:.2f} ms; answers per worker {sorted(served.values())}; "
            f"{identical} of {requests} lists identical to the in-process Service's, scores "
            f"within {BURST_SCORE_TOL:.3g}, ids equal but at near ties")
    finally:
        pool.send_signal(signal.SIGINT)
        out, _ = pool.communicate(timeout=60)
    launches = {name: 0 for name in cuda_build.KERNELS}
    reported = set()
    for line in out.splitlines():
        if line.startswith("worker ") and " launches " in line:
            pid, counts = line.split(" launches ", 1)
            reported.add(int(pid.split()[1]))
            for name, n in json.loads(counts).items():
                launches[name] += n
    alive = []
    for pid in pids | reported:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    log(f"  pool stopped: {len(reported)} workers reported their launches {launches}; "
        f"{len(alive)} left running")
    if alive or len(reported) != workers:
        raise AssertionError(f"workers left running {alive}, {len(reported)} reported")
    if device == "cuda" and not launches["fused_layer"]:
        # the APIs encode stored embeddings: the layer kernel, not the gather
        raise AssertionError("the pool's requests did not go through the fused layer")
    check_unbatched_search(service)
    return launches


def check_unbatched_search(service, n: int = 8) -> None:
    """``ItemIndexService.search`` (one query, one device search) against
    the batched path on the same queries: equal candidates."""
    import numpy as np

    from transformer_recommenders_tpu_torch.serving.service import Query

    rng = np.random.default_rng(15)
    dim = service.item_index.index.embeddings.shape[1]
    ids = [str(r["item_id"]) for r in service.item_index.index.store.records]
    for i in range(n):
        q = dict(embedding=[float(x) for x in rng.normal(size=dim)],
                 exclude_item_ids=list(rng.choice(ids, size=i, replace=False)), top_k=20)
        got = [c.to_dict() for c in service.item_index.search(Query(**q))]
        want = [c.to_dict() for c in asyncio.run(service.item_index.search_batched(Query(**q)))]
        if got != want:
            raise AssertionError("the unbatched search differs from the batched one")
    log(f"  ItemIndexService.search equals search_batched on {n} queries")


def check_two_stage_topk(n: int = 62000, d: int = 384, k: int = 100) -> dict:
    """The batch-1 two-stage top-k (JAX's gate: ``ops/topk.use_two_stage``)
    against the direct top-k over a 62,000 x 384 catalog, bit for bit, on
    Gaussian scores and on scores with many ties and -0.0; then both timed,
    the top-k alone and the whole retrieval (score, top-k, gather)."""
    import torch

    from transformer_recommenders_tpu_torch.ops import topk

    if not topk.use_two_stage(1, n, k):
        raise AssertionError("the gate does not route batch 1 at this catalog to two stages")
    gen = torch.Generator(device="cuda").manual_seed(16)
    items = topk.normalize_rows(torch.randn(n, d, generator=gen, device="cuda"))
    query = torch.randn(1, d, generator=gen, device="cuda")
    scores = topk.score_items(query, items, items_prenormalized=True)
    ties = (torch.randint(-4, 5, (1, n), generator=gen, device="cuda") / 4.0).float()
    ties[torch.rand(1, n, generator=gen, device="cuda") < 0.2] = -0.0
    for name, s in (("gaussian", scores), ("ties and -0.0", ties)):
        if not torch.equal(topk._two_stage_topk(s, k), topk.top_k_columns(s, k)):
            raise AssertionError(f"the two-stage top-k differs from the direct one ({name})")

    def direct_retrieval():
        s = topk.score_items(query, items, items_prenormalized=True)
        cols = topk.top_k_columns(s, k)
        return s.gather(-1, cols), cols

    t = {"two_stage_topk_ms": time_ms(lambda: topk._two_stage_topk(scores, k)),
         "direct_topk_ms": time_ms(lambda: topk.top_k_columns(scores, k)),
         "two_stage_retrieval_ms": time_ms(
             lambda: topk.topk_items(query, items, k, items_prenormalized=True)),
         "direct_retrieval_ms": time_ms(direct_retrieval)}
    log(f"  batch-1 top-{k} over {n} x {d}, two stages vs direct, bit for bit on Gaussian and "
        f"tied scores: top-k alone {t['two_stage_topk_ms']:.4f} vs {t['direct_topk_ms']:.4f} "
        f"ms; the whole retrieval {t['two_stage_retrieval_ms']:.4f} vs "
        f"{t['direct_retrieval_ms']:.4f} ms")
    return t


# -- phase 16: the parallel layer on a 1x1 mesh over NCCL --------------------------------------


def eval_arrays(rng, users: int, num_items: int, s: int):
    """``EvalArrays`` of ``users`` synthetic users over the catalog."""
    import numpy as np

    from transformer_recommenders_tpu_torch.data.module import EvalArrays

    hists, targets = [], []
    for _ in range(users):
        hists.append(rng.choice(num_items, size=int(rng.integers(1, 3 * s)), replace=False) + 1)
        targets.append(rng.choice(num_items, size=int(rng.integers(0, 6)), replace=False) + 1)
    window = np.zeros((users, s), np.int32)
    for i, h in enumerate(hists):
        window[i, : len(h[-s:])] = h[-s:]
    return EvalArrays(user_ids=[f"u{i}" for i in range(users)],
                      histories=[h.astype(np.int32) for h in hists], history_window=window,
                      target_lists=[t.astype(np.int32) for t in targets],
                      n_targets=np.asarray([len(t) for t in targets], np.int32))


def parallel_phase(*, device: str = "cuda", config: dict | None = None, num_items: int = 3706,
                   batch_size: int = TRAIN_BATCH, k: int = 8, calls: int = 5,
                   users: int = 256) -> dict:
    """The parallel layer over a real NCCL group of one rank (a 1x1 mesh:
    every collective an NCCL call that leaves its values as they are),
    against the one-device path: the sharded lookup and top-k; the
    flagship's sharded hot step (the table branch) and logging step (the
    pool branch) at B=128, loss, gradients and logs bit for bit, launches
    as one-device steps'; a graphed sharded window of K steps bit for bit
    against K eager sharded steps, its launches K times one step's, ms per
    step beside the unsharded window's; ``ShardedEvaluator`` against
    ``Evaluator`` on ``users`` users.  Returns the launch counts by step.
    (``device="cpu"``: a gloo group, the eager window, nothing timed.)"""
    import numpy as np
    import torch
    import torch.distributed as dist

    from transformer_recommenders_tpu_torch.configs import MeshConfig, TrainConfig
    from transformer_recommenders_tpu_torch.models.recommender import build_item_table
    from transformer_recommenders_tpu_torch.models.transformer import init_transformer_params
    from transformer_recommenders_tpu_torch.ops import cuda_build, topk
    from transformer_recommenders_tpu_torch.ops.gather_matmul import gather_rows_reference
    from transformer_recommenders_tpu_torch.parallel.embedding import (
        place_table, sharded_table_lookup)
    from transformer_recommenders_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from transformer_recommenders_tpu_torch.parallel.topk_sharded import sharded_topk
    from transformer_recommenders_tpu_torch.parallel import train as ptrain
    from transformer_recommenders_tpu_torch.training import train_state as ts
    from transformer_recommenders_tpu_torch.training.evaluator import Evaluator, ShardedEvaluator
    from transformer_recommenders_tpu_torch.training.scan_steps import (
        make_scanned_train_steps, stack_batches)

    cuda = device == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    backend = "nccl" if cuda else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1,
                            **({"device_id": torch.device("cuda", 0)} if cuda else {}))
    try:
        mesh = create_mesh(MeshConfig(), device)
        log(f"  {backend} group of 1 rank, mesh {mesh.shape}, in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = TrainConfig(**(config or TRAIN))
        _, _, emb = synthetic_records(0, num_items, 0, cfg.resolved_input_dim,
                                      cfg.max_seq_length)
        table = build_item_table(emb, device=device)
        shard = place_table(table, mesh)
        rng = np.random.default_rng(17)

        idx = torch.from_numpy(rng.integers(-2, num_items + 3, size=(batch_size, 32))).to(device)
        rows = sharded_table_lookup(shard, idx, mesh)
        if not torch.equal(rows, gather_rows_reference(table, idx).view(*idx.shape, -1)):
            raise AssertionError("the sharded lookup differs from the dense rows")
        queries = torch.randn(64, table.shape[1], device=device)
        exclude = torch.from_numpy(rng.integers(0, num_items + 1, size=(64, 16))).to(device)
        items = place_table(table[1:], mesh)
        got = sharded_topk(queries, items, min(100, num_items), mesh, exclude_idx=exclude)
        want = topk.topk_items(queries, table[1:], min(100, num_items), exclude_idx=exclude)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("the sharded top-k differs from the dense one")
        log("  sharded lookup and top-k (64 queries, k=100) bit for bit against the dense ones")

        params = init_transformer_params(torch.Generator().manual_seed(0), cfg, device=device)
        batch = train_batch(rng, batch_size, cfg.max_seq_length, num_items)
        seeds = ts.draw_dropout_seeds(torch.Generator().manual_seed(18), cfg)
        launches = {}
        for name, full_logs in (("parallel_hot", False), ("parallel_logging", True)):
            one = ts.make_loss_and_grad(cfg, full_logs=full_logs)
            sharded = ptrain.make_sharded_loss_and_grad(cfg, mesh, full_logs=full_logs)
            loss, grads, logs = one(params, table, batch, seeds)
            sync()
            cuda_build.reset_launches()  # the main path, counted: one sharded step
            s_loss, s_grad, s_logs, _ = sharded(params, shard, shard_batch(batch, mesh), seeds)
            sync()
            launches[name] = dict(cuda_build.LAUNCHES)
            expected = expected_launches(cfg, table.shape[0],
                                         ts.table_pool_rows(cfg, batch), full_logs)
            flat = ts.flatten(grads)
            same = {"loss": torch.equal(s_loss, loss), "gradients": torch.equal(s_grad, flat),
                    "logs": set(s_logs) == set(logs)
                    and all(torch.equal(s_logs[key], logs[key]) for key in logs)}
            err = float((s_grad - flat).abs().max())
            log(f"  {'logging' if full_logs else 'hot'} step, sharded vs one device: "
                + ", ".join(f"{n} {'bit for bit' if v else 'DIFFER'}" for n, v in same.items())
                + f" ({len(logs)} logs; max |grad diff| {err:.3g}); launches {launches[name]}")
            if not all(same.values()):
                raise AssertionError("the sharded step differs from the one-device step")
            if cuda and launches[name] != expected:
                raise AssertionError(f"the sharded step's launches differ from {expected}")

        # the graphed sharded window against eager sharded steps
        batches = [train_batch(rng, batch_size, cfg.max_seq_length, num_items) for _ in range(k)]
        gen = torch.Generator().manual_seed(19)
        step_seeds = torch.tensor([ts.draw_dropout_seeds(gen, cfg) for _ in range(k)])
        local = [shard_batch(b, mesh) for b in batches]
        stacked = {key: torch.stack([b[key] for b in local]) for key in local[0]}
        state0 = ptrain.place_state(ts.init_train_state(cfg, params), mesh)
        steps = make_scanned_train_steps(cfg, mesh=mesh)
        got, got_logs = steps(state0, shard, stacked, step_seeds)
        step = ptrain.make_sharded_train_step(cfg, mesh, full_logs=False)
        eager, losses = state0, []
        for b, s in zip(local, step_seeds):
            eager, logs = step(eager, shard, b, s)
            losses.append(logs[f"loss/{cfg.train_loss}"])
        sync()
        same = {"parameters": torch.equal(ts.flatten(got.params), ts.flatten(eager.params)),
                "mu": torch.equal(got.opt_state.mu, eager.opt_state.mu),
                "nu": torch.equal(got.opt_state.nu, eager.opt_state.nu),
                "losses": torch.equal(got_logs[f"loss/{cfg.train_loss}"], torch.stack(losses))}
        log(f"  {k} graphed sharded steps vs {k} eager sharded steps: "
            + ", ".join(f"{n} {'bit for bit' if v else 'DIFFER'}" for n, v in same.items()))
        if not all(same.values()):
            raise AssertionError("the graphed sharded window differs from the eager steps")
        cuda_build.reset_launches()  # the main path, counted: one call of K replays
        steps(state0, shard, stacked, step_seeds)
        sync()
        launches["parallel_scan"] = dict(cuda_build.LAUNCHES)
        one_step = expected_launches(cfg, table.shape[0], ts.table_pool_rows(cfg, batches[0]),
                                     False)
        if cuda and launches["parallel_scan"] != {n: k * c for n, c in one_step.items()}:
            raise AssertionError("the graphed sharded window's launches are not K steps'")
        plain_steps = make_scanned_train_steps(cfg)
        host_stacked = stack_batches(batches)
        plain_steps(ts.init_train_state(cfg, params), table, host_stacked, step_seeds)
        sharded_ms, plain_ms = [], []
        for _ in range(calls):  # in turns
            for fn, out in ((lambda: steps(state0, shard, stacked, step_seeds), sharded_ms),
                            (lambda: plain_steps(state0, table, host_stacked, step_seeds),
                             plain_ms)):
                sync()
                t = time.perf_counter()
                fn()
                sync()
                out.append((time.perf_counter() - t) * 1e3 / k)
        sh, pl = statistics.median(sharded_ms), statistics.median(plain_ms)
        log(f"  ms per step, graphed windows of {k}, median of {calls} calls in turns: sharded "
            f"(1x1 mesh, {backend}) {sh:.3f}, unsharded {pl:.3f}: the collectives cost "
            f"{sh - pl:.3f} ms a step at world size 1")

        # the sharded evaluator against the one-device one
        arrays = eval_arrays(rng, users, num_items, cfg.max_seq_length)
        ev, sev = Evaluator(cfg), ShardedEvaluator(cfg, mesh, num_items)
        want = ev.run(params, table, arrays)
        got = sev.run(params, (shard, items), arrays)
        want_idx, want_scores = ev.recommend_batch(params, table, arrays)
        got_idx, got_scores = sev.recommend_batch(params, (shard, items), arrays)
        same = (got == want and np.array_equal(got_idx, want_idx)
                and np.array_equal(got_scores, want_scores))
        log(f"  ShardedEvaluator vs Evaluator, {users} users: metric means and top-"
            f"{cfg.top_k} lists {'bit for bit' if same else 'DIFFER'} ("
            + ", ".join(f"{n.split('/')[-1]} {v:.4f}" for n, v in sorted(got.items())) + ")")
        if not same:
            raise AssertionError("the sharded evaluator differs from the one-device one")
        return launches
    finally:
        dist.destroy_process_group()


# -- phase 17: the scale configuration (configs/ml25m_ccl.yaml) -------------------------------

SCALE_YAML = REPO / "configs" / "ml25m_ccl.yaml"
# scripts/quality_run_25m.py's data: synthetic at MovieLens-25M's counts
ML25M_SCALE = dict(synthetic_num_users=162_000, synthetic_num_items=62_000,
                   synthetic_num_events=25_000_000)
# the smoke's events, cut for its time (users, items and widths are not):
# at 25M the fit's set-up (~63-87 s), the artifact's save (~26-32 s) and
# the deploy smoke over its user store (~55-70 s) grow with the events
# every user's history holds, and the script took 644 s on the H100
SCALE_EVENTS = 10_000_000
SCALE_BATCH = 256  # the file's data.batch_size
SCALE_BENCH_BATCH = 64  # scripts/bench_config4.py's batch
SCALE_CPU_BATCH = 8  # the card against the CPU's plain path: a batch the CPU steps quickly
SCALE_PAIRWISE = {"B64": (8192, 8192, 256), "B256": (32768, 32768, 256)}  # R = Rn = B * S
# #1 (and #2) where the scale path launches them: name -> (R, N, D, table dtype, output
# dtype, parts of a (B, 128) batch)
SCALE_GATHER = {
    # B=256: 3 * B * S = 98,304 >= 62,001 rows, so the catalog is projected
    # first and the gather reads exact bf16 rows of the projected table
    "hot_B256": (98304, 62001, 256, "bfloat16", "bfloat16", 3),
    # B=64: 24,576 < 62,001, so the gather reads exact f32 rows (the catalog
    # is over ONEHOT_LOOKUP_MAX_ITEMS) and only they are projected
    "hot_B64": (24576, 62001, 384, "float32", "float32", 3),
    # the evaluator: 512 users' windows of f32 rows
    "eval": (65536, 62001, 384, "float32", "float32", 1),
}
# the fit's cut, for the smoke's time (``--scale-uncut`` lifts it): 96 of
# the epoch's 825 batches of 256 (12 graphed windows of 8; a hot step takes
# ~250 ms on the H100), and the test and predict passes cut to 8 batches of
# 512 users each; validation runs the full val set
SCALE_FIT_BATCHES = 96
SCALE_EVAL_BATCHES = 8


def scale_sections() -> tuple[dict, dict]:
    """configs/ml25m_ccl.yaml's model and data sections with the overrides
    of scripts/quality_run_25m.py: a 1x1 mesh (one card; the file's model
    axis of 2 is for more cards) and synthetic data at ML-25M's counts
    through the hash embedder.  Every model field as the file gives it."""
    from transformer_recommenders_tpu_torch.configs import parse_yaml

    sections = parse_yaml(SCALE_YAML.read_text())
    model = {**sections["model"], "mesh": {"data_axis_size": 1, "model_axis_size": 1}}
    data = {**sections["data"], "dataset": "synthetic", "embedder": "hash", **ML25M_SCALE}
    return model, data


def start_scale_data(data_dir: pathlib.Path, events: int) -> subprocess.Popen:
    """``SeqDataModule.prepare_data`` of the scale fit's data (phase 17) in
    a child process, started before phase 1 so that it runs beside the
    earlier phases; ``events`` events over ML-25M's users and items."""
    _, data = scale_sections()
    data |= {"data_dir": str(data_dir), "synthetic_num_events": events}
    code = ("import json, sys, time; sys.path.insert(0, sys.argv[1]); t0 = time.perf_counter()\n"
            "from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig\n"
            "from transformer_recommenders_tpu_torch.data.module import SeqDataModule\n"
            "SeqDataModule(SeqDataModuleConfig.from_dict(json.loads(sys.argv[2]))).prepare_data()\n"
            "print(f'  scale data: generated and processed in {time.perf_counter() - t0:.1f} s "
            "(a child process)', flush=True)")
    return subprocess.Popen([sys.executable, "-c", code, str(REPO), json.dumps(data)])


def scale_catalog(num_items: int):
    """The synthetic catalog's item texts (``data/synthetic.generate_raw``'s,
    which depend on the item's index alone) through the hash embedder at
    384-d, as the fit's ``SeqDataModule`` embeds them."""
    from transformer_recommenders_tpu_torch.data.embeddings import embed_item_texts
    from transformer_recommenders_tpu_torch.data.synthetic import generate_raw

    items, _, _ = generate_raw(num_users=1, num_items=num_items, num_events=5)
    return embed_item_texts(list(items["item_text"]), embedder="hash", dim=384)


def check_scale_pairwise(sfu_rate: float) -> dict:
    """Phase 17 (a): #10-#12 at D=256 over R = Rn = 8,192 and 32,768
    (B=64 and 256 at seq 128) against their plain versions, as phase 8
    holds them, for the configuration's head (ContrastiveLoss, margin
    0.5), mask on and off; copies dropped and two calls bit for bit; splits,
    registers, times, the composite and the bounds."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    gen = torch.Generator().manual_seed(17)
    head, margin = "ContrastiveLoss", 0.5
    max_err = {}
    for r, rn, d in SCALE_PAIRWISE.values():
        for inputs, case in (("gaussian", pool_case), ("exact", exact_pool_case)):
            for mask_fn in (True, False):
                for key, err in hold_pairwise(case(gen, r, rn, d), inputs, head, margin,
                                              mask_fn).items():
                    max_err[key] = max(max_err.get(key, 0.0), err)
        check_pairwise_copies(gen, r, rn, d, heads=(head,))
        torch.cuda.empty_cache()
    log(PAIRWISE_TOL_TEXT)
    log_registers("fused_pairwise", ("pairwise_fwd_kernel<24>", "pairwise_dq_kernel<24>",
                                     "pairwise_dn_kernel<3>"))
    times = {}
    for shape, (r, rn, d) in SCALE_PAIRWISE.items():
        splits = {k: fp._splits(0, r, rn, d, i) for i, k in enumerate(("fwd", "dn", "dq"))}
        log(f"  pairwise R={r} Rn={rn} D={d}: {splits['fwd']} forward and {splits['dq']} dq "
            f"splits of the pool, {splits['dn']} dn splits of the query rows")
        # the plain versions take most of a second a call at R = 32,768 (an
        # f32 chain over D of a 4.3 GB score matrix): timed at 8,192 alone
        t = time_pairwise(gen, r, rn, d, sfu_rate, (head,), margin=margin, yardstick=head,
                          plain=r * rn <= 2**26, iters=5, reps=2)
        times[shape] = {name: {**t[name][head], "splits": splits[name.removeprefix("pairwise_")]}
                        for name in t}
        torch.cuda.empty_cache()
    return {"max_err": max_err, "times": times}


def check_scale_gather() -> dict:
    """Phase 17 (b): #1 at the scale path's shapes against its plain
    version (a copy: bit for bit) and timed as in phase 2; #2 at B=256's
    3 * B * S rows into the projected 62,001 x 256 bf16 catalog, bit for
    bit and twice, timed as in phase 4."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.ops import gather_matmul as gm

    gen = torch.Generator().manual_seed(18)
    times = {}
    for name, (r, n, d, tdt, odt, parts) in SCALE_GATHER.items():
        table = torch.randn(n, d, generator=gen).to("cuda", getattr(torch, tdt))
        batch = train_batch(np.random.default_rng(r), r // 128 // parts, 128, n - 1)
        keys = ("history_item_idx", "pos_item_idx", "neg_item_idx")[:parts]
        idx = torch.from_numpy(np.concatenate([batch[k].reshape(-1) for k in keys])).cuda()
        got = gm.gather_rows(table, idx, getattr(torch, odt))
        want = gm.gather_rows_reference(table, idx, getattr(torch, odt))
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        log(f"  gather_rows {name}: R={r} of {n}x{d} {tdt}->{odt}: "
            f"{'bit for bit' if ok else 'DIFFERS from'} its plain version (a copy)")
        if not ok:
            raise AssertionError("gather_rows disagrees with its plain version at scale")
        times[name] = time_gather(gen, r, n, d, tdt, odt, parts, seq=128)
    r, n, d = SCALE_GATHER["hot_B256"][:3]
    batch = train_batch(np.random.default_rng(0), SCALE_BATCH, 128, n - 1)
    idx = torch.from_numpy(np.concatenate([batch[k].reshape(-1) for k in (
        "history_item_idx", "pos_item_idx", "neg_item_idx")])).long().cuda()
    g = torch.randn(r, d, generator=gen).to("cuda", torch.bfloat16)
    table = torch.zeros(n, d, dtype=torch.bfloat16, device="cuda", requires_grad=True)
    gm.gather_rows(table, idx, torch.bfloat16).backward(g)
    again = gm._gather_bwd_cuda(g, idx, n, torch.bfloat16)
    want = gm.gather_rows_backward_reference(g, idx, n, torch.bfloat16)
    torch.cuda.synchronize()
    ok = torch.equal(table.grad, want) and torch.equal(table.grad, again)
    log(f"  gather_rows_bwd hot_B256 R={r} N={n} D={d} bf16: "
        f"{'bit for bit' if ok else 'DIFFERS from'} its plain version (which sums in the "
        f"kernel's order), two calls "
        f"{'bit for bit' if torch.equal(table.grad, again) else 'DIFFER'}")
    if not ok:
        raise AssertionError("gather_rows_bwd disagrees with its plain version at scale")
    t = time_gather_bwd("hot_B256", idx, g, n, plain=False)
    return {"gather_rows": times, "gather_rows_bwd": {"hot_B256": t}}


# #16 where the paths launch it: name -> (shape, dtype, permutation of a
# contiguous tensor or None); the first is the row's own (the scale step's
# embedding and hidden sites, 13 a forward)
STACK_DROPOUT = {
    "scale_hidden": ((SCALE_BATCH, 128, 256), "bfloat16", None),
    # the probs, where the plain core runs (outside #17's gate), bf16 and f32
    "scale_probs": ((SCALE_BATCH, 8, 128, 128), "bfloat16", None),
    "scale_probs_f32": ((SCALE_BATCH, 8, 128, 128), "float32", None),
    # a permuted einsum output (the plain core's dp), read by its strides
    "scale_dp_view": ((SCALE_BATCH, 128, 8, 128), "float32", (0, 2, 1, 3)),
    "C_probs": ((TRAIN_BATCH, 4, 32, 32), "float32", None),  # path C's masked f32 probs
    "flagship_embed": ((TRAIN_BATCH, 32, 128), "bfloat16", None),  # the fused path's one site
}
STACK_RATE = 0.1  # configs/ml25m_ccl.yaml's dropout (the model default)
# #17/#18 against their plain versions (the bounds of
# tests/test_torch_cuda.py): the kernels sum on the tensor cores, the plain
# version in f32 torch.matmul over the same bf16 values, so a score's last
# bit may move y across a bf16 rounding: one ulp (at most 2**-8 at y <= 1)
# in at most 1% of the probs, and ctx, dq, dk, dv within 1e-2 of their max
# abs values
ATTN_Y_TOL, ATTN_Y_FLIPS, ATTN_TOL = 2.0**-8, 0.01, 1e-2


def bits(t):
    """``t``'s bits as integers of its width (equal bits, not values)."""
    import torch

    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_hash_dropout() -> dict:
    """#16 at every site of STACK_DROPOUT: forward (two calls) and backward
    bit for bit against the plain int64 chain, with the site's seed term
    read on the card; device times of the kernel and the plain chain
    against the bound (x read and y written once)."""
    import torch

    from transformer_recommenders_tpu_torch.ops import hash_dropout as hd

    gen = torch.Generator().manual_seed(19)
    term = hd.seed_terms(torch.full((1,), 0xDEADBEEF, dtype=torch.int64, device="cuda"))[0]
    times = {}
    for name, (shape, dt, perm) in STACK_DROPOUT.items():
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=gen).to("cuda", dtype)
        g = torch.randn(shape, generator=gen).to("cuda", dtype)
        if perm is not None:
            x, g = x.permute(perm), g.permute(perm)
        xr = x.detach().requires_grad_(True)
        got = hd.hash_dropout(xr, STACK_RATE, term)
        got.backward(g)
        again = hd._hash_dropout_cuda(x, STACK_RATE, term)
        want = hd.hash_dropout_reference(x, STACK_RATE, term)
        want_g = hd.hash_dropout_reference(g, STACK_RATE, term)
        torch.cuda.synchronize()
        same = {"forward": torch.equal(bits(got), bits(want)),
                "backward": torch.equal(bits(xr.grad), bits(want_g)),
                "two calls": torch.equal(bits(got), bits(again))}
        big = x.numel() > 2**24  # the plain chain takes tens of ms a call there
        t = {"ms": time_ms(lambda: hd._hash_dropout_cuda(x, STACK_RATE, term)),
             "plain_ms": time_ms(lambda: hd.hash_dropout_reference(x, STACK_RATE, term),
                                 iters=5 if big else 20, reps=2 if big else 20),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(0, 2 * x.numel() * x.element_size(),
                                             H100_BF16_FLOPS)
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        times[name] = t
        log(f"  hash_dropout {name} {tuple(x.shape)} {dt}"
            f"{' (a strided view)' if perm else ''}: "
            + ", ".join(f"{k} {'bit for bit' if v else 'DIFFERS'}" for k, v in same.items())
            + f" (tol 0); device time: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.5f} ms (bytes): {t['share_of_bound']:.2f} of the bound")
        if not all(same.values()):
            raise AssertionError(f"hash_dropout disagrees with its plain version at {name}")
        del x, g, xr, got, again, want, want_g
        torch.cuda.empty_cache()
    return {
        "name": "hash_dropout", "route": "cuda",
        "source": "transformer_recommenders_tpu_torch/csrc/hash_dropout.cu",
        "replaces": "transformer_recommenders_tpu/models/transformer.py:184 (_dropout_from_seed, "
                    "an XLA fusion: no Pallas kernel)",
        "shape": "(256, 128, 256) bf16, rate 0.1",
        "max_abs_err": 0.0, **{k: times["scale_hidden"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "by_shape": times,
    }


def attn_inputs(gen, b: int, s: int, h: int, dh: int):
    """q, k, v as the layer stack gives them (views of one (B, S, 3 H dh)
    bf16 qkv tensor) on the card, a (B, S) key mask of a train batch's
    lengths, an f32 ctx cotangent."""
    import numpy as np
    import torch

    d = h * dh
    qkv = torch.randn(b, s, 3 * d, generator=gen).to("cuda", torch.bfloat16)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, s, h, dh) for i in range(3))
    batch = train_batch(np.random.default_rng(b), b, s, 1000)
    mask = torch.from_numpy(batch["history_item_idx"] != 0).cuda()
    g = torch.randn(b, s, h, dh, generator=gen).cuda()
    return q, k, v, mask, g


def attn_core_peaks(ac, q, k, v, mask, g, causal: bool) -> tuple[int, int]:
    """The bytes the core allocates above what was allocated before, at
    the peak of its forward (ctx, m, l) and of its backward (dq, dk, dv),
    through autograd as the layer stack calls it."""
    import torch

    leaves = [t.detach().contiguous().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ac.attn_core_bf16(*leaves, mask, 11, STACK_RATE, causal)
    torch.cuda.synchronize()
    fwd = torch.cuda.max_memory_allocated() - base
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out.backward(g)
    torch.cuda.synchronize()
    return fwd, torch.cuda.max_memory_allocated() - base


def check_attn_core(causal: bool) -> list[dict]:
    """#17 and #18 at the scale step's (B, 128, 8, 32), B = 256 and 64,
    dropout 0.1, against the plain core (ATTN_TOL; #18 from #17's m and
    l), two calls bit for bit, #18's y (read back through dv) bit for bit
    #17's, no (B, H, S, S) tensor allocated on the main path; device
    times of each kernel, the plain version and
    ``scaled_dot_product_attention`` without dropout (forward; forward and
    backward by autograd for #18), which computes another function (no
    hash dropout, no bf16 probs) and is never called by the port, against
    the bound (the function's bytes: q, k, v, the mask and the f32 ctx
    forward; q, k, v, the f32 g and the bf16 dq, dk, dv backward); the
    CTAs an SM holds."""
    import torch
    import torch.nn.functional as F

    from transformer_recommenders_tpu_torch.ops import attn_core as ac
    from transformer_recommenders_tpu_torch.ops.hash_dropout import seed_terms

    gen = torch.Generator().manual_seed(20)
    term = seed_terms(torch.full((1,), 12345, dtype=torch.int64, device="cuda"))[0]
    rows = {"attn_core_fwd": {}, "attn_core_bwd": {}}
    err = {"attn_core_fwd": 0.0, "attn_core_bwd": 0.0}
    for b in (SCALE_BATCH, SCALE_BENCH_BATCH):
        s, h, dh = 128, 8, 32
        q, k, v, mask, g = attn_inputs(gen, b, s, h, dh)
        ctx, m, l, y, _ = ac._fwd_cuda(q, k, v, mask, term, STACK_RATE, causal, with_y=True)
        ctx2, m2, l2, _, _ = ac._fwd_cuda(q, k, v, mask, term, STACK_RATE, causal)
        want_ctx, _, _, want_y = ac.attn_core_reference(q, k, v, mask, term, STACK_RATE, causal,
                                                        with_y=True)
        grads = ac._bwd_cuda(q, k, v, mask, m, l, g, term, STACK_RATE, causal)
        again = ac._bwd_cuda(q, k, v, mask, m, l, g, term, STACK_RATE, causal)
        want = ac.attn_core_backward_reference(q, k, v, mask, m, l, g, term, STACK_RATE, causal)
        rebuilt = ac.probs_through_dv(q, k, v, mask, m, l, causal)
        torch.cuda.synchronize()
        dy = (y.float() - want_y.float()).abs()
        flips = float((dy > 0).float().mean())
        rel = {n: float((a.float() - w.float()).abs().max() / w.float().abs().max())
               for n, a, w in zip(("ctx", "dq", "dk", "dv"), (ctx, *grads), (want_ctx, *want))}
        same = all(torch.equal(bits(a), bits(a2))
                   for a, a2 in zip((ctx, m, l, *grads), (ctx2, m2, l2, *again)))
        same_y = torch.equal(bits(rebuilt), bits(y))
        probs_bytes = b * h * s * s * 2
        peaks = attn_core_peaks(ac, q, k, v, mask, g, causal)
        # above its outputs (ctx, m, l; dq, dk, dv), at most 1 MiB: a bf16
        # (B, H, S, S) tensor would add probs_bytes
        lean = (peaks[0] <= ctx.nbytes + m.nbytes + l.nbytes + (1 << 20)
                and peaks[1] <= 3 * q.numel() * 2 + (1 << 20))
        ok = (same and same_y and lean and float(dy.max()) <= ATTN_Y_TOL
              and flips <= ATTN_Y_FLIPS and all(r <= ATTN_TOL for r in rel.values())
              and all(bool(torch.isfinite(t).all()) for t in (ctx, *grads)))
        err["attn_core_fwd"] = max(err["attn_core_fwd"],
                                   float((ctx - want_ctx).abs().max()))
        err["attn_core_bwd"] = max(err["attn_core_bwd"], *(
            float((a.float() - w.float()).abs().max()) for a, w in zip(grads, want)))
        log(f"  attn_core B={b} S={s} H={h} dh={dh} bf16, causal={causal}, dropout "
            f"{STACK_RATE}: y max abs err {float(dy.max()):.3g} in {flips:.2e} of the probs (tol "
            f"{ATTN_Y_TOL:.3g} in {ATTN_Y_FLIPS}), relative to max abs: "
            + ", ".join(f"{n} {r:.3g}" for n, r in rel.items())
            + f" (tol {ATTN_TOL}); two calls {'bit for bit' if same else 'DIFFER'}; #18's y "
            f"{'bit for bit' if same_y else 'DIFFERS from'} #17's; peak above the inputs: "
            f"forward {peaks[0]} B, backward {peaks[1]} B (a (B, H, S, S) bf16 tensor: "
            f"{probs_bytes} B) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the attention core's kernels disagree at B={b}")
        del y, want_y, rebuilt, ctx2, m2, l2, again
        torch.cuda.empty_cache()

        # SDPA on the same q, k, v (as (B, H, S, dh) views) and mask, no dropout
        keep = mask[:, None, None, :]
        if causal:
            keep = keep & torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
        qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
        gt = g.to(torch.bfloat16).permute(0, 2, 1, 3)

        def sdpa_grad():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
            return torch.autograd.grad(out, leaves, gt)

        qkv_bytes = 3 * q.numel() * 2
        flops = 2 * b * h * s * s * dh
        fwd = {"ms": time_ms(lambda: ac._fwd_cuda(q, k, v, mask, term, STACK_RATE, causal)),
               "plain_ms": time_ms(lambda: ac.attn_core_reference(q, k, v, mask, term,
                                                                  STACK_RATE, causal),
                                   iters=5, reps=2),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=keep)),
               "ctas_per_sm": ac.ctas_per_sm(False, s, dh)}
        fwd["bound_ms"], fwd["bound_by"] = bound(2 * flops, qkv_bytes + mask.numel()
                                                 + ctx.numel() * 4, H100_BF16_FLOPS)
        bwd = {"ms": time_ms(lambda: ac._bwd_cuda(q, k, v, mask, m, l, g, term, STACK_RATE,
                                                  causal)),
               "plain_ms": time_ms(lambda: ac.attn_core_backward_reference(
                   q, k, v, mask, m, l, g, term, STACK_RATE, causal), iters=5, reps=2),
               "library_ms": time_ms(sdpa_grad),
               "ctas_per_sm": ac.ctas_per_sm(True, s, dh)}
        bwd["bound_ms"], bwd["bound_by"] = bound(4 * flops, qkv_bytes + g.numel() * 4
                                                 + qkv_bytes, H100_BF16_FLOPS)
        for name, t in (("attn_core_fwd", fwd), ("attn_core_bwd", bwd)):
            t["share_of_bound"] = t["bound_ms"] / t["ms"]
            rows[name][f"B{b}"] = t
            log(f"  {name} B={b}: device time: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
                f"({'forward' if name.endswith('fwd') else 'forward and backward'}, no dropout, "
                f"another function) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
                f"({t['bound_by']}): {t['share_of_bound']:.3f} of the bound; "
                f"{t['ctas_per_sm']} CTAs an SM")
        del q, k, v, g, ctx, m, l, want_ctx, grads, want, leaves
        torch.cuda.empty_cache()
    log_registers("attn_core", ("attn_core_fwd_kernel", "attn_core_bwd_kernel"))
    replaces = {"attn_core_fwd": "transformer_recommenders_tpu/models/transformer.py:253 "
                                 "(_attn_core_bf16_fwd, XLA fusions: no Pallas kernel)",
                "attn_core_bwd": "transformer_recommenders_tpu/models/transformer.py:266 "
                                 "(_attn_core_bf16_bwd, XLA fusions: no Pallas kernel)"}
    return [{
        "name": name, "route": "cuda",
        "source": "transformer_recommenders_tpu_torch/csrc/attn_core.cu",
        "replaces": replaces[name], "shape": "(256, 128, 8, 32) bf16, dropout 0.1",
        "max_abs_err": err[name], **{k: rows[name][f"B{SCALE_BATCH}"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "by_shape": rows[name],
    } for name in ("attn_core_fwd", "attn_core_bwd")]


def count_zero_rows(cfg, params, table, batch, seeds) -> dict:
    """The rows of one hot step's queries, positives and pool that reach
    the cosine head's L2 normalization with norm 0 (JAX's gradient there
    is NaN; the port's is 0), and whether the step's gradient is finite."""
    import torch

    from transformer_recommenders_tpu_torch.models.recommender import compute_embeds
    from transformer_recommenders_tpu_torch.training import train_state as ts

    dev = ts._batch_on(batch, table.device)
    with torch.no_grad():
        embeds = compute_embeds(params, cfg, table, *(dev[k] for k in ts._BATCH_KEYS),
                                dropout_seeds=seeds)
    zeros = {k: int((torch.linalg.vector_norm(embeds[k].float(), dim=-1) == 0).sum())
             for k in ("query", "pos_embed", "neg_pool")}
    _, grads, _ = ts.make_loss_and_grad(cfg)(params, table, batch, seeds)
    return zeros | {"finite": bool(torch.isfinite(ts.flatten(grads)).all())}


def scale_steps_phase(emb) -> dict:
    """Phase 17 (d) and (e): the hot and logging steps of the scale
    configuration at full width on the card (see the module docstring);
    returns the launch counts of one hot step at B=256."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.configs import TrainConfig
    from transformer_recommenders_tpu_torch.models.recommender import build_item_table
    from transformer_recommenders_tpu_torch.models.transformer import init_transformer_params
    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.training import train_state as ts

    model, _ = scale_sections()
    cfg = TrainConfig.from_dict(model)
    table = build_item_table(emb, device="cuda")
    n = table.shape[0] - 1
    params = init_transformer_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    rng = np.random.default_rng(17)
    seed_gen = torch.Generator().manual_seed(17)
    seeds = ts.draw_dropout_seeds(seed_gen, cfg)
    log(f"  {cfg.num_hidden_layers} layers d={cfg.hidden_size} (inputs {cfg.resolved_input_dim}) "
        f"heads={cfg.num_attention_heads} FFN {cfg.intermediate_size} seq {cfg.max_seq_length} "
        f"{cfg.compute_dtype}, dropout {cfg.hidden_dropout}, {cfg.train_loss} at margin "
        f"{cfg.margin}; the hash-embedded synthetic catalog of {n} items")

    def branch(b: int) -> str:
        return ("3 * B * S >= N: the catalog projected first" if 3 * b * cfg.max_seq_length
                >= table.shape[0] else "3 * B * S < N: the rows gathered before the projection")

    log(f" the card against the CPU's plain path at B={SCALE_CPU_BATCH} "
        f"({branch(SCALE_CPU_BATCH)})")
    small = train_batch(rng, SCALE_CPU_BATCH, cfg.max_seq_length, n)
    for full_logs in (False, True):
        # the loss at margin 0.5 is a sum over rows of relu(l - 0.5) over
        # the few pool rows a random model's cosines put above the margin
        # (terms of ~1e-2), so the bf16 noise of the cosines (one-ulp
        # flips in the layer stack, ~1e-3 at l ~ 0.5; the H100 read 1.8e-3
        # relative) moves it by far more than a sum over all rows moves:
        # held to 2**-7 relative, the gradients' norm bound
        check_step_against_cpu(cfg, params, table, small, seeds, full_logs=full_logs,
                               device="cuda", loss_tol=2.0**-7)

    log(f" the hot step at B={SCALE_BATCH} ({branch(SCALE_BATCH)})")
    batch = train_batch(rng, SCALE_BATCH, cfg.max_seq_length, n)
    zeros = count_zero_rows(cfg, params, table, batch, seeds)
    log(f"  zero rows at the cosine head's L2 normalization in one step: {zeros['pos_embed']} "
        f"positives and {zeros['neg_pool']} pool rows (the padded positions' index 0), "
        f"{zeros['query']} queries; the gradient is "
        f"{'finite' if zeros['finite'] else 'NOT FINITE'} (the norm's subgradient 0)")
    if not zeros["finite"]:
        raise AssertionError("a zero row at the cosine normalization made the gradient NaN")
    step = ts.make_train_step(cfg, full_logs=False)
    state = ts.init_train_state(cfg, params)
    expected = expected_launches(cfg, table.shape[0], ts.table_pool_rows(cfg, batch), False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    state, logs = step(state, table, batch, seeds)  # the main path, counted
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    hot_peak = torch.cuda.max_memory_allocated()
    log(f"  launches of one hot step: {launches} (expected {expected}); peak memory "
        f"{hot_peak / 2**30:.2f} GiB")
    if launches != expected or launches["fused_layer"] or not all(
            launches[k] for k in SCALE_PATH):
        raise AssertionError("the scale hot step did not launch #1, #2, #10-#12 and #16-#19 "
                             "alone")
    losses = [float(logs["loss/ContrastiveLoss"])]
    for _ in range(29):
        state, logs = step(state, table, batch, ts.draw_dropout_seeds(seed_gen, cfg))
        losses.append(float(logs["loss/ContrastiveLoss"]))
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"  30 steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}")
    if not (all(math.isfinite(v) for v in losses) and last < first):
        raise AssertionError("the scale step's fixed-batch loss did not fall")
    profile = profile_steps(step, state, table, batch, cfg, seed_gen, ops=12)
    # what the hash dropout costs: eager steps with and without dropout
    # seeds (no seeds: no dropout site runs), in turns
    with_ms, without_ms = [], []
    for _ in range(4):
        for seeds_, out in ((ts.draw_dropout_seeds(seed_gen, cfg), with_ms), (None, without_ms)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, table, batch, seeds_)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    w, wo = statistics.median(with_ms), statistics.median(without_ms)
    log(f"  eager hot step, median of 4 in turns: with dropout {w:.2f} ms, without {wo:.2f} ms: "
        f"the hash dropout's sites cost {w - wo:.2f} ms a step")

    log(f" the logging step at B={SCALE_BATCH} (full_logs=True)")
    log_step = ts.make_train_step(cfg)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):
        s = ts.draw_dropout_seeds(seed_gen, cfg)
        t0 = time.perf_counter()
        state, logs = log_step(state, table, batch, s)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log_peak = torch.cuda.max_memory_allocated()
    if not all(bool(torch.isfinite(v)) for v in logs.values()):
        raise AssertionError("non-finite logging step logs at scale")
    log(f"  logging step, eager: {statistics.median(times[1:]):.2f} ms (calls "
        f"{[round(t, 2) for t in times]}); {len(logs)} logs; peak memory "
        f"{log_peak / 2**30:.2f} GiB")

    log(f" the multi-step driver at B={SCALE_BENCH_BATCH} (scripts/bench_config4.py's batch)")
    scan_phase(config=model, batch_size=SCALE_BENCH_BATCH, emb=emb, calls=3)
    log(f" the multi-step driver at B={SCALE_BATCH}")
    scan_phase(config=model, batch_size=SCALE_BATCH, emb=emb, calls=3)
    log(f"  scale steps: hot-step peak {hot_peak / 2**30:.2f} GiB, logging-step peak "
        f"{log_peak / 2**30:.2f} GiB, profiled hot step busy {profile.get('busy_ms', 0):.3f} of "
        f"{profile.get('wall_ms', 0):.3f} ms wall")
    return launches


# the kernels of the scale configuration's training path: #1 and #2 (B=256
# projects the catalog first, so the gathered rows take a gradient), the
# pairwise kernels, and the layer stack's at seq 128 (no fused layer): the
# hash dropout, the attention core and the dense
SCALE_PATH = ("gather_rows", "gather_rows_bwd", "pairwise_fwd", "pairwise_dq", "pairwise_dn",
              "hash_dropout", "attn_core_fwd", "attn_core_bwd", "dense_fwd", "dense_dgrad",
              "dense_wgrad")


def scale_fit_phase(data_job: subprocess.Popen, data_dir: pathlib.Path, events: int, *,
                    cut: int, eval_cut: int) -> dict:
    """Phase 17 (f): the scale configuration fitted for one epoch at
    ML-25M's synthetic scale through ``SeqDataModule`` and ``Trainer``, as
    scripts/quality_run_25m.py drives it, the epoch cut to ``cut`` batches
    and the test and predict passes to ``eval_cut`` (-1: uncut); returns
    the fit's launches."""
    import dataclasses

    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig, TrainConfig
    from transformer_recommenders_tpu_torch.data.module import SeqDataModule
    from transformer_recommenders_tpu_torch.models.transformer import tree_leaves
    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.serving import deploy
    from transformer_recommenders_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    if data_job.wait() != 0:
        raise AssertionError(f"the scale data's child process exited with {data_job.returncode}")
    waited = time.perf_counter() - t0
    model, data = scale_sections()
    tmp = data_dir.parent
    t0 = time.perf_counter()
    dm = SeqDataModule(SeqDataModuleConfig.from_dict(
        {**data, "data_dir": str(data_dir), "synthetic_num_events": events}))
    dm.prepare_data()  # written by the child
    dm.setup()
    sampler = "native" if dm.train_data._native is not None else "numpy"
    val_users = len(dm.eval_arrays("val"))
    log(f"  data: {len(dm.items)} items, {len(dm.users)} users, {events} events, "
        f"{len(dm.train_data)} train rows, {dm.config.batch_size}-row batches, {sampler} "
        f"sampler, {val_users} val users; waited {waited:.1f} s for the child, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = TrainConfig.from_dict({
        **model, "max_epochs": 1, "early_stopping_patience": 0, "steps_per_dispatch": 8,
        "checkpoint_every_epoch": False, "use_mlflow": False,
        "limit_train_batches": cut, "limit_test_batches": eval_cut,
        "limit_predict_batches": eval_cut, "ckpt_dir": str(tmp / "ckpt")})
    batches = list(itertools.islice(dm.train_batches(0), cut) if cut >= 0
                   else dm.train_batches(0))
    pos = np.concatenate([b["pos_item_idx"].reshape(-1) for b in batches])
    neg = np.concatenate([b["neg_item_idx"].reshape(-1) for b in batches])
    log(f"  the fit's batches: {len(batches)} of the epoch's "
        f"{dm.train_data.num_batches(SCALE_BATCH)} batches of {SCALE_BATCH}; zero rows the "
        f"cosine head normalizes: {int((pos == 0).sum())} of {pos.size} positives and "
        f"{int((neg == 0).sum())} of {neg.size} pool rows (index 0)")
    trainer = Trainer(cfg, dm, log_dir=str(tmp / "logs"))
    val0 = trainer.validate()
    log(f"  untrained: val ndcg {val0['val/retrieval_normalized_dcg']:.5f}, hit rate "
        f"{val0['val/retrieval_hit_rate']:.5f}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    result = trainer.fit()  # the main path, counted
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    fit_peak = torch.cuda.max_memory_allocated()
    steps = trainer._host_step
    wall = trainer.epoch_walls[0]
    log(f"  fit: 1 epoch, {steps} steps, K={cfg.steps_per_dispatch}, {fit_s:.1f} s; "
        f"{result['train/examples_per_s']:.1f} examples/s over the fit (validation included); "
        f"epoch wall {wall} s ({wall * 1e3 / steps:.3f} ms a step, "
        f"{steps * SCALE_BATCH / wall:.1f} examples/s); peak memory {fit_peak / 2**30:.2f} GiB")
    log("  phase_seconds: " + json.dumps({k: round(v, 3)
                                           for k, v in trainer.phase_seconds.items()}))
    log(f"  phase_counts: {trainer.phase_counts}")
    log(f"  launches in the fit: {launches}")
    if launches["fused_layer"] or not all(launches[k] for k in SCALE_PATH):
        raise AssertionError("the scale fit did not go through #1, #2, #10-#12 and #16-#19 "
                             "alone")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(trainer.model.params)):
        raise AssertionError("non-finite parameters after the scale fit")

    best = tmp / "ckpt" / "best"
    best_val = json.loads((best / "meta.json").read_text())["metrics"]
    t0 = time.perf_counter()
    again = trainer.validate()
    val_s = time.perf_counter() - t0
    log("  trained: " + ", ".join(f"{k.split('/')[-1]} {v:.5f}"
                                  for k, v in sorted(best_val.items()))
        + f" (untrained ndcg {val0['val/retrieval_normalized_dcg']:.5f}); validation of "
        f"{val_users} users x {len(dm.items)} items in {val_s:.2f} s "
        f"({val_users / val_s:.1f} users/s)")
    if again != best_val:
        raise AssertionError("the fit's weights do not validate as the fit did")
    t0 = time.perf_counter()
    test = trainer.test()
    users = "every test user" if eval_cut < 0 else f"the first {eval_cut * cfg.eval_batch_size}"
    log(f"  test ({users}): ndcg {test['test/retrieval_normalized_dcg']:.5f} "
        f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    recs = trainer.predict()
    u = len(recs["user_ids"])
    if recs["item_idx"].shape != (u, cfg.top_k) or not np.isfinite(recs["scores"]).all():
        raise AssertionError("predict gave malformed recommendations at scale")
    log(f"  predict: {u} users x top-{cfg.top_k} in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    trainer.save(tmp / "artifact")
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    deploy.main(artifact_dir=tmp / "artifact")
    log(f"  saved in {save_s:.1f} s; served through the nine APIs (seq 128 over the "
        f"{len(dm.items)}-item catalog) in {time.perf_counter() - t0:.1f} s")

    fresh = Trainer(cfg, dm, log_dir=str(tmp / "logs_restored"))
    meta = fresh.restore(str(best))
    resumed = fresh.validate()
    same = resumed == best_val
    log(f"  a fresh trainer restored at step {meta['step']}: validation "
        f"{'bit for bit the fit' if same else 'DIFFERS from the fit'}")
    if not same:
        raise AssertionError(f"resumed validation {resumed} != the fit's {best_val}")
    fresh.close()
    trainer.close()
    return launches


# -- phase 18: the quality protocols ------------------------------------------------------------

# the fits' catalog: 3,706 items and the pad row, 384-d f32 rows that no
# projection maps (hidden 384 = embedding 384), so no gradient reaches it
QUALITY_TABLE = (3707, 384)
# the seed-spread fit's layer: the reference topology at batch 32, f32, dropout 0
SEED_SPREAD_LAYER = (32, 32, 384, 12, 48)
# where the two fits launch each kernel (the shapes and dtypes its wrapper
# takes in a hot step, a logging step and a validation batch).  The seed
# spread (B=32, f32, dropout 0, no logging step) runs the pool objective
# over its B*S = 1,024 rows (the catalog is more than twice the pool) on
# the 3 * 1,024 history, positive and negative rows it gathers; the quality
# run (B=256, bf16, dropout 0.1) the table objective over its 8,192 rows on
# hot steps and the pool over 8,192 on logging steps (3 * 8,192 rows
# gathered), with #16 at the embedding site; both validate 256 users a
# batch (8,192 history rows, the layer without dropout)
QUALITY_GATHERS = ((3072, "float32"), (8192, "float32"), (8192, "bfloat16"),
                   (24576, "bfloat16"))  # (R, output dtype) from the f32 catalog
QUALITY_LAYERS = {  # name: (B, dtype, dropout, backward)
    "B_f32": (32, "float32", 0.0, True),  # the seed spread's train step
    "eval_f32": (256, "float32", 0.0, False),  # its validation batch
    "quality": (256, "bfloat16", 0.1, True),  # the quality run's train step
    "eval_bf16": (256, "bfloat16", 0.0, False),  # its validation batch
}
QUALITY_POOLS = {"seed_spread": (1024, 1024, 384), "quality_log": (8192, 8192, 384)}  # (R, Rn, D)
QUALITY_TABLE_ROWS = 8192  # the quality run's hot step: B*S queries over the catalog
QUALITY_DROPOUT = (256, 32, 384)  # #16 at the quality run's embedding site, bf16
# the kernels every fit of phase 18 launches: the gather, the layer forward
# and backward, and the pool InfoNCE's forward and dq (the seed spread's every
# step over 1,024 pool rows, the quality run's logging steps); the frozen
# table takes no gradient, so neither #2 nor #9 runs in the seed spread
QUALITY_PATH = ("gather_rows", "fused_layer", "fused_layer_bwd", "pool_infonce_fwd",
                "pool_infonce_dq")


def hold_layer(gen, b: int, dtype_name: str, dropout: float, backward: bool) -> float:
    """#3 (and #4 where ``backward``) at (B, 32, 384, 12, 48), ``dtype_name``,
    both dropouts ``dropout``, against their plain versions (TOL and
    TOL_MEAN, GRAD_TOL); returns the worst max abs error."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_layer as fl

    _, s, d, h, f = SEED_SPREAD_LAYER
    dtype = getattr(torch, dtype_name)
    seeds = [0x0BADF00D, 0x600DCAFE, 2000000000] if dropout else None
    x, params, mask, kwargs = layer_case(gen, b=b, s=s, d=d, h=h, f=f, dtype=dtype,
                                         dropout=dropout, seeds=seeds)
    name = f"fused_layer B={b} S={s} D={d} H={h} F={f} {dtype_name} dropout {dropout}"
    if not backward:
        with torch.no_grad():
            got = fl.fused_layer(x, params, mask, **kwargs)
            want = fl.fused_layer_reference(x, params, mask, **kwargs)
        torch.cuda.synchronize()
        return compare(name, got, want, dtype_name)
    leaves = [params[m][n].requires_grad_() for m, n in fl._PARAM_ORDER]
    x.requires_grad_()
    dy = torch.randn(x.shape, generator=gen).to("cuda", dtype)
    y = fl.fused_layer(x, params, mask, **kwargs)
    y.backward(dy)
    with torch.no_grad():
        want = fl.fused_layer_reference(x.detach(), params, mask, **kwargs)
        dx_want, grads = fl.fused_layer_backward_reference(x.detach(), params, mask, dy,
                                                           **kwargs)
    torch.cuda.synchronize()
    fwd_err = compare(name, y.detach(), want, dtype_name)
    errs = [compare_grad(f"{name} dx", x.grad, dx_want, dtype_name)]
    errs += [compare_grad(f"{name} {m}/{n}", t.grad, grads[m][n], dtype_name)
             for (m, n), t in zip(fl._PARAM_ORDER, leaves)]
    log(f"  {name} backward: worst of dx and 12 parameter gradients max_rel_err="
        f"{max(e[2] for e in errs):.3g}; tol={GRAD_TOL[dtype_name]} (relative to max abs) ok")
    return max(fwd_err, *(e[0] for e in errs))


def check_f32_clusters(gen) -> dict:
    """The seed spread's f32 layer (#3, #4) at (32, 32, 384, 12, 48) with
    its sequences split over clusters of 1, 2, 3 and 4 CTAs: y, dx and the
    12 parameter gradients bit for bit the same at every size, dropout 0
    and 0.1; the planned size (3 or 4) the largest whose 32 clusters the
    card holds at once.  Returns the times at each size."""
    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.ops import fused_layer as fl

    b, s, d, h, f = SEED_SPREAD_LAYER
    device = torch.device("cuda")
    planned = {bwd: fl._f32_cluster(b, s, d, h, f, device, bwd) for bwd in (False, True)}
    limit = cuda_build.max_shared_memory(device)
    active = {c: (fl._max_clusters(0, fl.F32_FWD, s, d, h, f,
                                   fl.heads_per_stage(s, d, f, h, 4, limit, c), c),
                  fl._max_clusters(0, fl.F32_BWD, s, d, h, f,
                                   fl.bwd_heads_per_stage(s, d, h, limit, c), c))
              for c in (2, 3, 4)}
    log(f"  f32 clusters the card holds at once, forward and backward, by size: {active}; "
        f"planned at B={b}: forward {planned[False]}, backward {planned[True]}")
    if any(c < 3 or b > active[c][bwd] for bwd, c in planned.items()):
        raise AssertionError("the f32 planner does not take the largest cluster in one wave")
    planner = fl.cluster_size
    for dropout in (0.0, 0.1):
        x, params, mask, kwargs = layer_case(gen, b=b, s=s, d=d, h=h, f=f, dtype=torch.float32,
                                             dropout=dropout,
                                             seeds=[7, 8, 9] if dropout else None)
        dy = torch.randn(x.shape, generator=gen).cuda()
        outs = {}
        try:
            for c in fl.F32_CLUSTER_SIZES:
                fl.cluster_size = lambda *_, c=c: c
                xr = x.clone().requires_grad_()
                leaves = [params[m][n].detach().clone().requires_grad_()
                          for m, n in fl._PARAM_ORDER]
                y = fl.fused_layer(xr, fl._unflatten(leaves), mask, **kwargs)
                y.backward(dy)
                outs[c] = [y.detach(), xr.grad, *(t.grad for t in leaves)]
        finally:
            fl.cluster_size = planner
        torch.cuda.synchronize()
        same = {c: all(torch.equal(a, w) for a, w in zip(o, outs[1])) for c, o in outs.items()}
        log(f"  fused_layer f32 B={b} D={d} dropout {dropout}, clusters of 4, 3, 2, 1: y, dx "
            "and 12 gradients against 1's "
            + ", ".join(f"{c}: {'bit for bit' if v else 'DIFFER'}" for c, v in same.items()))
        if not all(same.values()):
            raise AssertionError("the f32 layer's bits depend on its cluster size")
    return time_by_cluster(gen, b, s, d, h, f, "float32", fl.F32_CLUSTER_SIZES)


def check_quality_kernels() -> dict:
    """Phase 18 (a): every kernel of the two fits at the shapes and dtypes
    the fits give it (see QUALITY_GATHERS above), against its plain version
    with the tolerances of the earlier phases (#1 and #16 bit for bit), and
    timed at the train steps' shapes.  Returns ``{kernel: {shape: times and
    max_abs_err}}``, the kernels line's ``by_shape`` entries."""
    import torch

    from transformer_recommenders_tpu_torch.ops import gather_matmul as gm
    from transformer_recommenders_tpu_torch.ops import hash_dropout as hd
    from transformer_recommenders_tpu_torch.tools import profile_fused_sections as pfs

    gen = torch.Generator().manual_seed(18)
    out: dict = {}

    def add(kernel: str, shape: str, row: dict) -> None:
        out.setdefault(kernel, {})[shape] = row

    n, d = QUALITY_TABLE
    table = (0.3 * torch.randn(n, d, generator=gen)).cuda()
    for r, out_dtype in QUALITY_GATHERS:
        idx = torch.randint(0, n, (r,), generator=gen).cuda()
        got = gm.gather_rows(table, idx, getattr(torch, out_dtype))
        want = gm.gather_rows_reference(table, idx, getattr(torch, out_dtype))
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        log(f"  gather_rows N={n} D={d} R={r} float32->{out_dtype}: "
            f"{'bit for bit' if ok else 'DIFFERS'} (tol 0, a copy)")
        if not ok:
            raise AssertionError("gather_rows disagrees with its plain version")
    add("gather_rows", "B_f32", time_gather(gen, 3072, n, d, "float32", "float32", 3)
        | {"max_abs_err": 0.0})
    add("gather_rows", "quality", time_gather(gen, 8192, n, d, "float32", "bfloat16", 1)
        | {"max_abs_err": 0.0})

    errs = {name: hold_layer(gen, *case) for name, case in QUALITY_LAYERS.items()}
    by_cluster = check_f32_clusters(gen)
    for name in ("B_f32", "quality"):  # the train steps' shapes
        b, dtype_name, dropout, _ = QUALITY_LAYERS[name]
        _, s, _, h, f = SEED_SPREAD_LAYER
        add("fused_layer", name, time_fused_layer(gen, b, s, d, h, f, dtype_name)
            | {"max_abs_err": errs[name]})
        seeds = [0x0BADF00D, 0x600DCAFE, 2000000000] if dropout else None
        add("fused_layer_bwd", name, time_layer_bwd(gen, seeds, b=b, s=s, d=d, h=h, f=f,
                                                    dtype_name=dtype_name, dropout=dropout)
            | {"max_abs_err": errs[name]})
    # the seed spread's layer by section (the f32 variants #14, #15)
    sections = pfs.profile_sections("seed_spread", dtype="float32", dropout=0.0,
                                    log=lambda m: log(f"  {m}"))
    for kernel, direction in (("fused_layer", "fwd"), ("fused_layer_bwd", "bwd")):
        out[kernel]["B_f32"]["sections_ms"] = {
            k.split("/")[1]: v["delta_ms"] for k, v in sections["results"].items()
            if k.startswith(direction)}
        out[kernel]["B_f32"]["by_cluster_ms"] = {c: t[direction] for c, t in by_cluster.items()}

    r = QUALITY_TABLE_ROWS
    table_errs: dict = {}
    for inputs in ("gaussian", "exact"):
        for k, v in hold_table_infonce(gen, r, n, d, inputs, True, 1.0).items():
            table_errs[k] = max(table_errs.get(k, 0.0), v)
    q, tbl, pos, counts, row_valid = hold_table_twice(gen, r, n, d)
    times = time_table_infonce(q, tbl, pos, counts, row_valid.float())
    add("table_infonce_fwd", "quality", times["table_infonce_fwd"]
        | {"max_abs_err": table_errs["ce"]})
    add("table_infonce_bwd", "quality", times["table_infonce_bwd"]
        | {"max_abs_err": max(table_errs["dq"], table_errs["dtable"])})

    for shape, (r, rn, dp) in QUALITY_POOLS.items():
        pool_errs: dict = {}
        for inputs in ("gaussian", "exact"):
            for k, v in hold_pool_infonce(gen, r, rn, dp, inputs, True, 1.0).items():
                pool_errs[k] = max(pool_errs.get(k, 0.0), v)
        check_pool_copies(gen, r, rn, dp)
        times = time_pool_infonce(gen, r, rn, dp)
        for name, keys in (("pool_infonce_fwd", ("ce",)), ("pool_infonce_dq", ("dq", "dp"))):
            add(name, shape, times[name] | {"max_abs_err": max(pool_errs[k] for k in keys)})

    # #16 at the embedding site: forward, backward and a second call bit
    # for bit against the plain int64 chain
    rate = 0.1
    term = hd.seed_terms(torch.full((1,), 0x5EED, dtype=torch.int64, device="cuda"))[0]
    x = torch.randn(QUALITY_DROPOUT, generator=gen).to("cuda", torch.bfloat16)
    g = torch.randn(QUALITY_DROPOUT, generator=gen).to("cuda", torch.bfloat16)
    xr = x.detach().requires_grad_(True)
    got = hd.hash_dropout(xr, rate, term)
    got.backward(g)
    again = hd._hash_dropout_cuda(x, rate, term)
    torch.cuda.synchronize()
    same = {"forward": torch.equal(bits(got), bits(hd.hash_dropout_reference(x, rate, term))),
            "backward": torch.equal(bits(xr.grad), bits(hd.hash_dropout_reference(g, rate, term))),
            "two calls": torch.equal(bits(got), bits(again))}
    t = {"ms": time_ms(lambda: hd._hash_dropout_cuda(x, rate, term)),
         "plain_ms": time_ms(lambda: hd.hash_dropout_reference(x, rate, term)),
         "library_ms": None, "max_abs_err": 0.0}
    t["bound_ms"], t["bound_by"] = bound(0, 2 * x.numel() * x.element_size(), H100_BF16_FLOPS)
    log(f"  hash_dropout {QUALITY_DROPOUT} bfloat16 rate {rate}: "
        + ", ".join(f"{k} {'bit for bit' if v else 'DIFFERS'}" for k, v in same.items())
        + f" (tol 0); device time: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.5f} ms (bytes)")
    if not all(same.values()):
        raise AssertionError("hash_dropout disagrees with its plain version at the embedding site")
    add("hash_dropout", "quality_embedding", t)
    return out


# -- phase 20: the layer stack's dense (#19) -----------------------------------------------------

# (M, K, N) by the cells that give them: the scale recommend call's (B=512
# x S=128) and step's (B=256) four denses a layer, the scale catalog's
# projection (62,424 rows, the step's), the flagship's catalog (3,706) and
# its recommend call's window rows (2,048 users x 32); and K and N that the
# gate admits but no 64-wide k-block or 64-column store box divides
DENSE_CASES = {
    "recommend qkv": (65536, 256, 768), "recommend out": (65536, 256, 256),
    "recommend ffn_in": (65536, 256, 1024), "recommend ffn_out": (65536, 1024, 256),
    "recommend proj": (65536, 384, 256),
    "step qkv": (32768, 256, 768), "step out": (32768, 256, 256),
    "step ffn_in": (32768, 256, 1024), "step ffn_out": (32768, 1024, 256),
    "step catalog": (62424, 384, 256),
    "flagship catalog": (3706, 384, 128), "flagship window": (65536, 384, 128),
    "ragged k-block": (1000, 72, 200), "ragged column tile": (3706, 392, 136),
}


def dense_error(got, want, scale) -> tuple[float, float]:
    """(the worst |got - want| over one bf16 ulp of |want| plus 2**-16 of
    ``scale``, the sum of the terms' magnitudes; the share of outputs that
    differ): at most 1 where the two differ by the f32 sum order alone."""
    got, want = got.float(), want.float()
    slack = want.abs() * 2.0**-7 + 2.0**-133 + 2.0**-16 * scale
    return float(((got - want).abs() / slack).max()), float((got != want).float().mean())


def check_dense() -> list[dict]:
    """Phase 20 (see the module docstring); returns the kernels' rows,
    one a kernel, timed at the scale recommend call's qkv and at every
    shape under ``by_shape``."""
    import torch

    from transformer_recommenders_tpu_torch.ops import dense as D

    bf16 = torch.bfloat16
    times = {d: {} for d in ("fwd", "dgrad", "wgrad")}
    max_err = dict.fromkeys(times, 0.0)
    for name, (m, k, n) in DENSE_CASES.items():
        gen = torch.Generator().manual_seed(m + k + n)
        x = torch.randn(m, k, generator=gen).to("cuda", bf16)
        w = (torch.randn(k, n, generator=gen) / math.sqrt(k)).cuda()
        b = (0.1 * torch.randn(n, generator=gen)).cuda()
        g = torch.randn(m, n, generator=gen).to("cuda", bf16)
        w16 = w.to(bf16)
        xa, wa, ga = x.float().abs(), w16.float().abs(), g.float().abs()
        y = D._fwd_cuda(x, w16, b)
        dx = D._dgrad_cuda(g, w16)
        dw, db = D._wgrad_cuda(x, g)
        dw2, db2 = D._wgrad_cuda(x, g)
        plain = {
            "fwd": lambda: D.dense_reference(x, w, b, bf16),
            "dgrad": lambda: (g.float() @ w16.float().t()).to(bf16),
            "wgrad": lambda: ((x.float().t() @ g.float()).to(bf16).float(), g.float().sum(0)),
        }
        f32 = torch.float32  # cuBLAS's bf16 GEMM with f32 output
        library = {
            "fwd": lambda: (torch.mm(x, w16, out_dtype=f32) + b).to(bf16),
            "dgrad": lambda: torch.mm(g, w16.t(), out_dtype=f32).to(bf16),
            "wgrad": lambda: (torch.mm(x.t(), g, out_dtype=f32).to(bf16).float(),
                              g.float().sum(0)),
        }
        kernel = {"fwd": lambda: D._fwd_cuda(x, w16, b), "dgrad": lambda: D._dgrad_cuda(g, w16),
                  "wgrad": lambda: D._wgrad_cuda(x, g)}
        want_dw, want_db = plain["wgrad"]()
        want = {"fwd": plain["fwd"](), "dgrad": plain["dgrad"](), "wgrad": want_dw}
        errs = {
            "fwd": dense_error(y, want["fwd"], xa @ wa + b.abs()),
            "dgrad": dense_error(dx, want["dgrad"], ga @ wa.t()),
            "wgrad": dense_error(dw, want["wgrad"], xa.t() @ ga),
        }
        for d, got in (("fwd", y), ("dgrad", dx), ("wgrad", dw)):
            max_err[d] = max(max_err[d], float((got.float() - want[d].float()).abs().max()))
        db_err = float(((db - want_db).abs() / (2.0**-16 * ga.sum(0))).max())
        with torch.no_grad():
            invariant = all(torch.equal(D._fwd_cuda(x[lo:lo + 64].clone(), w16, b),
                                        y[lo:lo + 64]) for lo in (0, m // 2, m - 64))
        repeat = torch.equal(dw, dw2) and torch.equal(db, db2)
        ok = (all(e <= 1.0 and share <= 0.01 for e, share in errs.values()) and db_err <= 1.0
              and invariant and repeat)
        log(f"  {name} M={m} K={k} N={n}: " + ", ".join(
            f"{d} {e:.3g} of its slack, {share:.2e} differ" for d, (e, share) in errs.items())
            + f"; db {db_err:.3g} of its slack; rows at M=64 bit for bit: {invariant}; wgrad "
            f"twice bit for bit: {repeat} ({D.wgrad_splits(m, k, n, 'cuda')} splits) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"#19 disagrees with the plain graph at {name}")
        flops = 2.0 * m * k * n
        nbytes = {"fwd": 2 * (m * k + k * n + m * n) + 4 * n,
                  "dgrad": 2 * (m * n + k * n + m * k),
                  "wgrad": 2 * (m * k + m * n) + 4 * (k * n + n)}
        for d in ("fwd", "dgrad", "wgrad"):
            t = {"ms": time_ms(kernel[d]), "plain_ms": time_ms(plain[d]),
                 "library_ms": time_ms(library[d])}
            t["bound_ms"], t["bound_by"] = bound(flops, nbytes[d], H100_BF16_FLOPS)
            t["share_of_bound"] = t["bound_ms"] / t["ms"]
            log(f"    {d}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}): "
                f"{t['share_of_bound']:.3f} of it")
            times[d][name] = t
        del x, g, y, dx, dw, db
        torch.cuda.empty_cache()
    what = {"fwd": "forward: bf16(x w + b)", "dgrad": "autograd of it in x",
            "wgrad": "autograd of it in w and b"}
    head = "recommend qkv"
    return [{
        "name": f"dense_{d}", "route": "cuda",
        "source": "transformer_recommenders_tpu_torch/csrc/dense.cu",
        "replaces": "transformer_recommenders_tpu/models/transformer.py:135 (_dense, "
                    f"{what[d]}; one jnp.dot that XLA runs: no Pallas kernel)",
        "shape": f"{head} {DENSE_CASES[head]} bf16", "max_abs_err": max_err[d],
        **{k: times[d][head][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
        "by_shape": times[d],
    } for d in ("fwd", "dgrad", "wgrad")]


def expected_eval_launches(cfg, users: int) -> dict:
    """Launches of one validation pass over ``users``: per batch of
    ``eval_batch_size`` users the gather and each fused layer's forward (no
    dropout at evaluation), or, where the gate sends the model to the layer
    stack, the gather and under bf16 the stack's denses (#19).  For an unprojected catalog, which passes
    through no kernel, and a stack whose attention core runs no kernel
    (f32, or the masked core)."""
    from transformer_recommenders_tpu_torch.models.transformer import _fused_layer_mode
    from transformer_recommenders_tpu_torch.ops import cuda_build

    s = cfg.max_seq_length
    fused = _fused_layer_mode(cfg, s)
    impl = cfg.attention_impl if cfg.attention_impl != "auto" else (
        "masked" if s <= 64 else "split")
    if cfg.resolved_input_dim != cfg.hidden_size or not (
            fused or cfg.compute_dtype == "float32" or impl == "masked"):
        raise ValueError("counted only for an unprojected catalog, and the fused layer or a "
                         "stack without the attention core's kernels")
    batches = -(-users // cfg.eval_batch_size)
    stack = cfg.num_hidden_layers * int(not fused)
    return dict.fromkeys(cuda_build.KERNELS, 0) | {
        "gather_rows": batches, "fused_layer": batches * cfg.num_hidden_layers * int(bool(fused)),
        # #19: the stack's four denses a layer under bf16
        "dense_fwd": batches * 4 * stack * int(cfg.compute_dtype == "bfloat16")}


def check_fit_launches(summary: dict) -> None:
    """Each fit's launches of a protocol's summary (``tools/quality_run.py``)
    exactly what its steps and validations add up to: each hot step and
    graph warm-up step one hot step's (``expected_launches``), each logging
    step one logging step's, each validation one validation's (the
    untrained model's pass counted alone, itself held to
    :func:`expected_eval_launches`)."""
    from transformer_recommenders_tpu_torch.configs import TrainConfig

    rows = summary["data"]["items"] + 1  # the catalog and its pad row
    users = summary["data"]["val_users"]
    for run in summary["runs"]:
        cfg = TrainConfig(**{**summary["train_config"], "seed": run["seed"]})
        pool = summary["data_config"]["batch_size"] * cfg.max_seq_length
        hot = expected_launches(cfg, rows, pool, False)
        logging = expected_launches(cfg, rows, pool, True)
        val = expected_eval_launches(cfg, users)
        got_val = {k: run["validate_launches"].get(k, 0) for k in val}
        n_hot = run["steps"] - run["log_steps"] + run["warmup_steps"]
        want = {k: n_hot * hot[k] + run["log_steps"] * logging[k] + run["validations"] * val[k]
                for k in hot}
        got = {k: run["launches"].get(k, 0) for k in want}
        ok = got == want and got_val == val
        log(f"  seed {run['seed']}: {run['steps']} steps ({run['log_steps']} logging, "
            f"{run['warmup_steps']} graph warm-ups), {run['validations']} validations of "
            f"{users} users; launches {({k: v for k, v in got.items() if v})} (expected "
            f"{({k: v for k, v in want.items() if v})}), one validation "
            f"{({k: v for k, v in got_val.items() if v})} {'ok' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError("a fit's launches are not its steps' and validations'")


def quality_phase() -> dict:
    """Phase 18: (a) every kernel of the two fits at the shapes they give
    it, against its plain version, timed; (b) one hot step of each fit's
    model at its batch on the card against the CPU's plain path, with its
    launches; (c) the seed-spread
    protocol in full (``tools/quality_run.py``: 5 seeds of 2 epochs on
    synthetic data of ML-1M's shape), whose mean val NDCG@10 must lie in
    the JAX seeds' range; (d) the quality protocol at seed 0, whose val
    NDCG@20 must be finite and above the untrained model's; each fit's
    launches exactly its steps' and validations'.  Returns the kernels'
    rows at (a) and the fits' launch counts."""
    import dataclasses

    import torch

    from transformer_recommenders_tpu_torch.ops import cuda_build
    from transformer_recommenders_tpu_torch.tools import quality_run as Q

    t_start = time.perf_counter()
    log(" (a) the fits' kernels at their shapes against their plain versions")
    by_shape = check_quality_kernels()
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for name, configs in (("seed_spread", Q.seed_spread_configs),
                              ("quality", Q.quality_configs)):
            # the hot step alone: the quality run's logging step (17 a fit)
            # differs from it by the pool kernels, held at its 8,192 rows in
            # (a), whose plain versions make its CPU path the slowest here
            train, data = configs(0, str(tmp / "steps"))
            log(f" (b) the {name} fit's hot step, batch {data.batch_size}, against the CPU")
            training_phase(config=dataclasses.asdict(train), batch_size=data.batch_size,
                           steps=0, timed_steps=0)
        log(" (c) the seed spread (scripts/parity_seed_spread.py's protocol), 5 seeds")
        spread = Q.seed_spread(5, device=device, root=str(tmp / "spread"),
                               log=lambda m: log(f"  {m}"))
        check_fit_launches(spread)
        if not spread["passed"]:
            lo, hi = spread["gate"]
            msg = (f"the seed spread's mean val ndcg@10 {spread['mean_ndcg']:.5f} lies outside "
                   f"[{lo:.5f}, {hi:.5f}]")
            raise AssertionError(msg)
        log(" (d) the quality run (scripts/quality_run.py's protocol), seed 0")
        (tmp / "quality").mkdir()
        (tmp / "quality" / "data").symlink_to(tmp / "spread" / "data")  # the same data
        quality = Q.quality(1, device=device, root=str(tmp / "quality"),
                            log=lambda m: log(f"  {m}"))
        check_fit_launches(quality)
    (run,) = quality["runs"]
    ndcg, before = run["ndcg"], run["untrained"][Q.NDCG]
    log(f"  val ndcg@20 {ndcg:.5f} after {run['epochs_ran']} epochs (untrained {before:.5f}); "
        f"JAX's {quality['jax']['val_ndcg']}; time to it {run['time_to_target_s']} s")
    if not (math.isfinite(ndcg) and ndcg > before):
        raise AssertionError("the quality run did not raise val ndcg@20 above the untrained "
                             "model's")
    runs = spread["runs"] + quality["runs"]
    launches = {k: sum(r["launches"].get(k, 0) for r in runs) for k in cuda_build.KERNELS}
    log(f"  launches in the fits: {launches}")
    missing = [k for k in QUALITY_PATH if not all(r["launches"].get(k) for r in runs)]
    if missing:
        raise AssertionError(f"a fit launched no {missing}")
    log(f"  phase 18 took {time.perf_counter() - t_start:.1f} s")
    return {"by_shape": by_shape, "launches": launches}


# -- phase 19: the ML-1M parity protocol and the serving bench --------------------


# the parity models' loss kernels at the shapes their hot steps give them:
# #7-#9 at d=64 over the B*S = 64*16 = 1,024 pool rows of the InfoNCE
# configs (the 3,707-row catalog is over twice the pool: no table
# kernels), #10-#12 there and at the reference shape's 32*32 rows of 384
PARITY_POOL = (1024, 1024, 64)  # (R, Rn, D)
ML1M_ITEMS = 3706  # the parity data's catalog
PARITY_PAIRWISE = {"ml1m": (1024, 1024, 64), "refshape": (1024, 1024, 384)}
PARITY_HEADS = {"BPR": ("PairwiseLogisticLoss", 0.0), "CCL": ("ContrastiveLoss", 0.5)}
# the fits of the default run, seed 0: plain InfoNCE and the two paths no
# card run had taken before, the mined hard negatives and the windowed
# positive (--only-parity runs every config at 3 seeds, both shapes)
PARITY_FITS = ("InfoNCE", "InfoNCE+hard32", "InfoNCE+lookahead8")
# the fused loss kernels (#5-#12), which hard negatives turn off
FUSED_LOSS_KERNELS = ("table_infonce_fwd", "table_infonce_bwd", "pool_infonce_fwd",
                      "pool_infonce_dq", "pool_infonce_dn", "pairwise_fwd", "pairwise_dq",
                      "pairwise_dn")
# a near tie of the hard-negative mask, card against CPU: two f32 logits
# of the plain heads (cuBLAS against the CPU's product: sums in other
# orders, ~1e-6 relative) within this share of the row's largest |logit|
HARD_TIE = 2.0**-16
# the default run's short window of each bench mode
SERVING_SMOKE = dict(clients=4, requests=64, workers=2)
# the keys of the JAX scripts' outputs (scripts/bench_serving*.py)
SERVING_KEYS = {
    "http": {"clients", "requests_ok", "errors", "qps", "p50_ms", "p95_ms"},
    "device": {"mode", "backend", "clients", "sweep", "best", "sequential_1_client"},
    "workers": {"backend", "host_cpus", "clients", "n_workers", "best_config", "speedup"},
}


def start_parity_data(root: pathlib.Path) -> subprocess.Popen:
    """``SeqDataModule.prepare_data`` of the d=64 parity configs' two data
    directories (``data_la0``, ``data_la8``) in a child process, started
    before phase 1 so that it runs beside the earlier phases."""
    from transformer_recommenders_tpu_torch.tools import quality_run as Q

    dirs = [Q.parity_configs(spec, 0, str(root))[1] for spec in Q.PARITY_CONFIGS
            if spec["name"] in ("InfoNCE", "InfoNCE+lookahead8")]
    import dataclasses

    code = ("import json, sys, time; sys.path.insert(0, sys.argv[1]); t0 = time.perf_counter()\n"
            "from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig\n"
            "from transformer_recommenders_tpu_torch.data.module import SeqDataModule\n"
            "for d in json.loads(sys.argv[2]):\n"
            "    SeqDataModule(SeqDataModuleConfig.from_dict(d)).prepare_data()\n"
            "print(f'  parity data: generated and processed in {time.perf_counter() - t0:.1f} s "
            "(a child process)', flush=True)")
    return subprocess.Popen([sys.executable, "-c", code, str(REPO),
                             json.dumps([dataclasses.asdict(d) for d in dirs])])


def check_parity_kernels() -> dict:
    """Phase 19 (a): #7-#9 at (1,024, 1,024, 64) and #10-#12 at 1,024 rows
    of 64 and of 384 for BPR (the logistic head at margin 0) and CCL (the
    contrastive head at margin 0.5), against their plain versions as
    phases 6 and 8 hold them (Gaussian inputs without the near-tie rows,
    exact-sum inputs on every row, copies of a shared positive dropped bit
    for bit, two calls bit for bit), timed beside the plain version, the
    composite of stock calls and the bound.  Returns ``{kernel: {shape:
    times and max_abs_err}}``, the kernels line's ``by_shape`` entries."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    gen = torch.Generator().manual_seed(19)
    out: dict = {}
    r, rn, d = PARITY_POOL
    errs: dict = {}
    for inputs in ("gaussian", "exact"):
        for k, v in hold_pool_infonce(gen, r, rn, d, inputs, True, 1.0).items():
            errs[k] = max(errs.get(k, 0.0), v)
    check_pool_copies(gen, r, rn, d)
    times = time_pool_infonce(gen, r, rn, d)
    for name, keys in (("pool_infonce_fwd", ("ce",)), ("pool_infonce_dq", ("dq", "dp")),
                       ("pool_infonce_dn", ("dn",))):
        out.setdefault(name, {})["parity_ml1m"] = times[name] | {
            "max_abs_err": max(errs[k] for k in keys)}
    sfu_rate = special_function_rate()[0]
    for shape, (r, rn, d) in PARITY_PAIRWISE.items():
        for label, (head, margin) in PARITY_HEADS.items():
            errs = {}
            for inputs, case in (("gaussian", pool_case), ("exact", exact_pool_case)):
                for k, v in hold_pairwise(case(gen, r, rn, d), inputs, head, margin,
                                          True).items():
                    errs[k] = max(errs.get(k, 0.0), v)
            t = time_pairwise(gen, r, rn, d, sfu_rate, (head,), margin=margin, yardstick=head)
            for i, (name, keys) in enumerate((("pairwise_fwd", ("out",)),
                                              ("pairwise_dn", ("dn",)),
                                              ("pairwise_dq", ("dq", "dp")))):
                out.setdefault(name, {})[f"parity_{shape}_{label}"] = t[name][head] | {
                    "max_abs_err": max(errs[k] for k in keys), "splits": fp._splits(0, r, rn, d, i),
                    "margin": margin, "head": head}
        check_pairwise_copies(gen, r, rn, d, heads=[h for h, _ in PARITY_HEADS.values()])
    log(PAIRWISE_TOL_TEXT)
    return out


def hard_negative_ties(cfg, params, table, batch: dict, seeds, device: str) -> dict:
    """``batch`` with the positions whose hard-negative mask may differ
    between ``device`` and the CPU left out (their positive set to 0, so
    they count no term): where the two masks differ, and where, in the
    CPU's f32 logits of the plain head, the k-th and (k+1)-th masked logits
    or a counted logit and the positive (the false-negative filter) lie
    within ``HARD_TIE`` of the row's largest |logit| and are not equal (equal
    logits are copies of one item, ranked by index on both; where a copy's
    bits differ between the two, so do the masks).  Prints the counts,
    and the exact zeros among the masked logits (``lax.top_k`` ranks -0.0
    below +0.0; the port's mask does too)."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.models.recommender import compute_embeds
    from transformer_recommenders_tpu_torch.models.transformer import tree_leaves, tree_unflatten
    from transformer_recommenders_tpu_torch.ops import losses as L
    from transformer_recommenders_tpu_torch.training import train_state as ts

    k = cfg.num_hard_negatives
    sim = L.LOSS_FNS[cfg.train_loss][1]
    got = {}
    for dev in (device, "cpu"):
        p = params if dev == device else tree_unflatten(params, [t.cpu() for t in
                                                                 tree_leaves(params)])
        tbl = table.to(dev)
        b = ts._batch_on(batch, tbl.device)
        with torch.no_grad():
            e = compute_embeds(p, cfg, tbl, b["history_item_idx"], b["pos_item_idx"],
                               b["neg_item_idx"], dropout_seeds=seeds)
            pos, neg = L.compute_pair_logits(e["query"], e["pos_embed"], e["neg_pool"],
                                             similarity=sim)
            mask = L.negative_mask(cfg, pos, neg, e["neg_valid"])
        got[dev] = (pos.cpu(), neg.cpu(), mask.cpu(), e["row_valid"].cpu().bool(),
                    e["neg_valid"].cpu().bool())
    pos, neg, mask, row_valid, neg_valid = got["cpu"]
    differ = (got[device][2] != mask).any(dim=1)
    counted = neg_valid[None, :].expand_as(neg)
    if cfg.mask_false_negatives:
        counted = counted & (neg < pos[:, None])
    masked = torch.where(counted, neg, float("-inf"))
    scale = torch.maximum(neg.abs().amax(dim=1), pos.abs()) * HARD_TIE
    def near(gap):  # within the rounding margin, not equal: copies of one row tie exactly
        return (gap != 0) & (gap.abs() <= scale.reshape(-1, *[1] * (gap.dim() - 1)))

    kth = exact = torch.zeros_like(differ)
    if k < neg.shape[1]:
        top = masked.sort(dim=1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).where(torch.isfinite(top[:, k]), torch.inf)
        kth, exact = near(gap), gap == 0
    near_pos = torch.zeros_like(differ)
    if cfg.mask_false_negatives:
        near_pos = (near(neg - pos[:, None]) & neg_valid[None, :]).any(dim=1)
    drop = (differ | kth | near_pos) & row_valid
    zeros = int(((masked == 0) & counted).sum())
    log(f"  hard negatives (k={k}): {int(drop.sum())} of {int(row_valid.sum())} valid positions "
        f"left out (masks differ {int((differ & row_valid).sum())}; within {HARD_TIE:.3g} of the "
        f"row's max |logit| but not equal: the k-th and (k+1)-th counted logits "
        f"{int((kth & row_valid).sum())}, a pool logit and the positive "
        f"{int((near_pos & row_valid).sum())}); kept with exact ties at the k-th place (copies "
        f"of one item, ranked by index on both) {int((exact & row_valid & ~drop).sum())}; exact "
        f"zeros among the counted logits: {zeros}")
    if int(drop.sum()) * 2 > int(row_valid.sum()):
        raise AssertionError("the hard-negative step check would leave out most positions")
    out = {key: np.array(v, copy=True) for key, v in batch.items()}
    out["pos_item_idx"].reshape(-1)[drop.numpy()] = 0
    return out


def beyond_window(datamodule, lookahead: int) -> tuple[int, int, str]:
    """The first train batch of epoch 0 as the fit reads it (the native
    sampler where it built): of its valid positives, how many lie more than
    ``lookahead`` events after every occurrence of their query item in the
    user's history (none may, under a windowed positive).  Returns (that
    count, the positives, the sampler)."""
    import numpy as np

    data = datamodule.train_data
    batch = next(iter(datamodule.train_batches(0)))
    n = len(data.rows)
    if data._native is not None:
        order, sampler = data._native.shuffled_order(n, data.seed, 0), "native"
    else:
        order = np.random.default_rng(np.random.SeedSequence([data.seed, 0, n])).permutation(n)
        sampler = "numpy"
    far = total = 0
    for b, row in enumerate(order[: len(batch["history_item_idx"])]):
        idx, labels = data.rows[int(row)]
        positives = np.flatnonzero(labels)
        for q, p in zip(batch["history_item_idx"][b], batch["pos_item_idx"][b]):
            if q == 0 or p == 0:
                continue
            total += 1
            near = False
            for at in np.flatnonzero(idx == q):
                window = positives[(positives > at) & (positives <= at + lookahead)]
                near |= bool((idx[window] == p).any())
            far += not near
    return far, total, sampler


def check_windowed_positive(datamodules: dict, configs: dict) -> None:
    """The lookahead-8 fit reads the data keyed by its lookahead, and its
    sampler's positives lie within 8 events of their query; the unbounded
    sampler's do not (the check can fail)."""
    from transformer_recommenders_tpu_torch.tools import quality_run as Q

    counts = {}
    for name in ("InfoNCE", "InfoNCE+lookahead8"):
        data_cfg = configs[name][1]
        dm = Q.load_data(data_cfg, datamodules, log=lambda m: log(f"  {m}"))
        counts[name] = beyond_window(dm, 8) + (data_cfg.data_dir, dm.config.pos_lookahead)
    (far0, n0, sampler0, dir0, la0), (far8, n8, sampler8, dir8, la8) = counts.values()
    ok = (far8 == 0 and far0 > 0 and la8 == 8 and la0 == 0 and dir8.endswith("data_la8")
          and dir0.endswith("data_la0"))
    log(f"  the windowed positive: {dir8} (pos_lookahead {la8}, the {sampler8} sampler): "
        f"{far8} of {n8} positives more than 8 events after their query; {dir0} (pos_lookahead "
        f"{la0}, the {sampler0} sampler): {far0} of {n0} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the lookahead-8 fit does not read windowed positives")


def parity_steps(datamodules: dict, configs: dict, root: pathlib.Path) -> dict:
    """Phase 19 (b): one hot step of each parity model against the CPU's
    plain path at its batch (the d=64 configs on their data's first batch
    and catalog, the reference shape's three on phase 5's synthetic batch
    over the fit's catalog, the hash embedder's 384-d rows, whose cosines
    reach CCL's margin where unit Gaussian rows' do not), each step's
    launches; hard32's none of #5-#12.  Returns the launches by config."""
    import dataclasses

    from transformer_recommenders_tpu_torch.tools import quality_run as Q

    launches = {}
    for reference_shape in (False, True):
        for spec in Q.parity_specs(reference_shape):
            train, data = configs[spec["name"]] if not reference_shape else Q.parity_configs(
                spec, 0, str(root), reference_shape=True)
            label = f"{spec['name']}{' (reference shape)' if reference_shape else ''}"
            log(f" (b) {label}'s hot step, batch {data.batch_size}, against the CPU")
            if not reference_shape:
                dm = Q.load_data(data, datamodules, log=lambda m: log(f"  {m}"))
                kw = dict(batch=next(iter(dm.train_batches(0))), emb=dm.item_embeddings)
            else:  # the fit's catalog: the hash embedder at 384-d
                kw = dict(emb=scale_catalog(ML1M_ITEMS))
            launches[label] = training_phase(config=dataclasses.asdict(train),
                                             batch_size=data.batch_size, steps=0,
                                             timed_steps=0, **kw)
    hard = launches["InfoNCE+hard32"]
    if any(hard[k] for k in FUSED_LOSS_KERNELS) or not hard["gather_rows"]:
        raise AssertionError(f"the hard-negative step launched a fused loss kernel: {hard}")
    log("  hard negatives: the step launched none of #5-#12 (the plain objective) ok")
    return launches


def check_parity_fits(summary: dict) -> dict:
    """Each config's fit launches exactly its steps' and validations'
    (:func:`check_fit_launches`); the hard negatives' none of #5-#12, the
    InfoNCE configs' the pool kernels.  Returns the launches summed over
    the fits."""
    from transformer_recommenders_tpu_torch.ops import cuda_build

    for name, config in summary["configs"].items():
        log(f"  {name}: launches against the steps and validations")
        check_fit_launches(config)
        fused = {k: sum(r["launches"].get(k, 0) for r in config["runs"])
                 for k in FUSED_LOSS_KERNELS}
        if "hard32" in name and any(fused.values()):
            raise AssertionError(f"the hard-negative fit launched fused loss kernels: {fused}")
        if name.startswith("InfoNCE") and "hard32" not in name and not fused["pool_infonce_fwd"]:
            raise AssertionError(f"{name}'s fit launched no pool InfoNCE kernel")
    runs = [r for c in summary["configs"].values() for r in c["runs"]]
    return {k: sum(r["launches"].get(k, 0) for r in runs) for k in cuda_build.KERNELS}


def parity_table(summary: dict) -> None:
    """One line a config: the seeds' mean val NDCG@10 beside JAX's and the
    torch reference's, the range and the untrained model's."""
    for name, c in summary["configs"].items():
        jax = c["jax"]
        log(f"  | {name} | {c['mean_ndcg']:.5f} | {[round(x, 5) for x in c['ndcgs']]} | "
            f"{jax['ndcg_ours']:.5f} | {jax['ndcg_torch']:.5f} | [{c['gate'][0]:.5f}, "
            f"{c['gate'][1]:.5f}] | {c['verdict']} | untrained "
            f"{[round(x, 5) for x in c['untrained_ndcg']]} | "
            f"{statistics.fmean(r['ms_per_step'] for r in c['runs']):.3f} ms a step |")


def parity_phase(parity_root: pathlib.Path, *, full: bool = False) -> dict:
    """Phase 19, the ML-1M parity protocol (``tools/quality_run.py
    parity-ml1m``): (a) the loss kernels at the parity shapes, (b) one hot
    step of each config against the CPU, hard32's without #5-#12, (c) the
    windowed positive, (d) the fits: seed 0 of InfoNCE, hard32 and
    lookahead8 (``full``: every config at 3 seeds, both shapes), each
    config's mean at or above its range's lower edge and hard32 above
    InfoNCE, each fit's launches exactly its steps' and validations'.
    Returns the kernels' ``by_shape`` rows and the launches."""
    import torch

    from transformer_recommenders_tpu_torch.tools import quality_run as Q

    t_start = time.perf_counter()
    log(" (a) the loss kernels at the parity shapes against their plain versions")
    by_shape = check_parity_kernels()
    device = torch.device("cuda")
    datamodules: dict = {}
    configs = {spec["name"]: Q.parity_configs(spec, 0, str(parity_root))
               for spec in Q.PARITY_CONFIGS}
    launches = {f"parity {k}": v for k, v in
                parity_steps(datamodules, configs, parity_root).items()}
    log(" (c) the windowed positive through the fit's sampler")
    check_windowed_positive(datamodules, configs)
    summaries = []
    for reference_shape in ((False, True) if full else (False,)):
        seeds = 3 if full else 1
        names = None if full else PARITY_FITS
        log(f" (d) the parity fits{' at the reference shape' if reference_shape else ''}: "
            f"{names or 'every config'}, {seeds} seed(s)")
        summary = Q.parity_ml1m(
            seeds, device=device,
            root=str(parity_root / "refshape" if reference_shape else parity_root),
            reference_shape=reference_shape, names=names, log=lambda m: log(f"  {m}"),
            datamodules=None if reference_shape else datamodules)
        launches[f"parity fits{' refshape' if reference_shape else ''}"] = check_parity_fits(
            summary)
        log("  | config | port mean | seeds | JAX | torch reference | range | verdict | "
            "untrained | eager step |")
        parity_table(summary)
        if not summary["passed"]:
            raise AssertionError("the parity gate failed: " + "; ".join(summary["failures"]))
        summaries.append(summary)
    log(f"  phase 19's parity part took {time.perf_counter() - t_start:.1f} s")
    return {"by_shape": by_shape, "launches": launches, "summaries": summaries}


def serving_bench_phase(*, smoke: bool = True, device: str = "cuda") -> dict:
    """Phase 19 (e): each mode of ``tools/bench_serving.py`` on the card
    over one artifact (``smoke``: 4 clients, 64 requests, 2 workers; else
    each mode's defaults): every request answered 200, the JAX scripts'
    keys in each record.  Returns the records by mode."""
    import torch

    from transformer_recommenders_tpu_torch.tools import bench_serving as B

    device = torch.device(device)
    kw = SERVING_SMOKE if smoke else {}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        artifact = B.make_artifact(tmp, device)
        for mode in ("http", "device", "workers"):
            t0 = time.perf_counter()
            record = B.run(mode, device=device, artifact=artifact, log=lambda m: None,
                           **{k: v for k, v in kw.items() if k != "workers" or mode == "workers"})
            requests = record["requests_sent"]  # clients * (requests // clients)
            if mode == "http":
                points = {"http": record}
            elif mode == "device":
                points = {f"window {p['window_ms']} ms, max_batch {p['max_batch']}": p
                          for p in record["sweep"]}
            else:
                points = {k: v for k, v in record.items() if k.startswith("workers=")}
            missing = SERVING_KEYS[mode] - set(record)
            bad = {k: (p["requests_ok"], p["errors"]) for k, p in points.items()
                   if p["errors"] or p["requests_ok"] != requests}
            if mode == "device":
                seq = record["sequential_1_client"]
                if seq["errors"] or seq["requests_ok"] != 96:
                    bad["sequential"] = (seq["requests_ok"], seq["errors"])
            for k, p in points.items():
                log(f"  {mode} {k}: {p['requests_ok']} of {requests} answered 200, "
                    f"{p['qps']:.1f} QPS, p50 {p['p50_ms']:.2f} ms, p95 {p['p95_ms']:.2f} ms, "
                    f"p99 {p['p99_ms']:.2f} ms" + (f", mean batch {p['batch'].get('mean_batch')}"
                                                   if "batch" in p else "")
                    + f", launches {p['launches']}")
            if mode == "device":
                seq = record["sequential_1_client"]
                log(f"  device sequential, one client, window 0: {seq['qps']:.1f} QPS, p50 "
                    f"{seq['p50_ms']:.2f} ms, p95 {seq['p95_ms']:.2f} ms, p99 {seq['p99_ms']:.2f} ms")
            if mode == "workers":
                log(f"  workers: best {record['best_config']}, speedup {record['speedup']:.3f} "
                    f"over workers=1 ({record['host_cpus']} host cores)")
            log(f"  {mode}: {time.perf_counter() - t0:.1f} s; the JAX script's keys "
                f"{'present' if not missing else f'MISSING {sorted(missing)}'}")
            if missing or bad:
                raise AssertionError(f"the {mode} bench: missing keys {sorted(missing)}, requests "
                                     f"not answered 200: {bad}")
            out[mode] = record
    return out


if __name__ == "__main__":
    sys.exit(main())
