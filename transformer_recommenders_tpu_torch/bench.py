"""The port's benchmark on one CUDA card:

    python -m transformer_recommenders_tpu_torch.bench [--out PATH]

Counterpart of the repository's root ``bench.py`` (the JAX package on its
TPU), with the same three parts:

- flagship training examples/s (``configs.flagship_config``: B=256, S=32,
  a 4,096-item 384-d table plus the padding row, random batches from
  ``np.random.default_rng(i)``): K=16 hot steps a call, 3 calls burnt, then
  3 windows of 20 calls, their median and spread; once through the
  CUDA-graph driver (``training/scan_steps.py``) and once with the eager
  step in a Python loop over the same batches;
- retrieval QPS: exact top-100 (``ops/topk.py``) over a pre-normalized
  62,000 x 384 catalog at query batches 1, 32 and 256, 5 windows of 50
  calls, distinct queries each call;
- the reference's compute path (an HF ``BertModel`` step on the host's
  CPU, as the root bench runs it), only where ``transformers`` is
  importable; otherwise it is logged as skipped and reported as null.

Progress goes to stderr.  Stdout carries one JSON line with the root
bench's ``details`` keys, the eager examples/s and the card's name and
power limit; the same object goes to ``--out`` (by default under
``build/``, which git ignores), never to the root's ``BENCH_DETAILS.json``.
Without a CUDA card it exits 2 and writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

import numpy as np

B = 256
S = 32
N_ITEMS = 4096
EMB_DIM = 384
K_STEPS = 16
BURN_CALLS = 3
TRAIN_WINDOWS = 3
TRAIN_REPS = 20
RETRIEVAL_ITEMS = 62_000
RETRIEVAL_K = 100
RETRIEVAL_BATCHES = (1, 32, 256)
RETRIEVAL_WINDOWS = 5
RETRIEVAL_REPS = 50
TORCH_STEPS = 20
TORCH_WARMUP = 2
DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "bench" / "bench_details.json"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def spread_pct(values: list[float]) -> float:
    """(max - min) / median as a percentage: the root bench's spread."""
    med = float(np.median(values))
    return round((max(values) - min(values)) / med * 100, 1) if med else 0.0


def make_table(n_items: int = N_ITEMS, dim: int = EMB_DIM) -> np.ndarray:
    """(n_items + 1, dim) f32: the padding row, then Gaussian rows
    (``default_rng(0)``), as the root bench builds it."""
    rng = np.random.default_rng(0)
    return np.concatenate([np.zeros((1, dim), np.float32),
                           rng.normal(size=(n_items, dim)).astype(np.float32)])


def make_batch(seed: int, b: int = B, s: int = S, n_items: int = N_ITEMS) -> dict:
    """One (b, s) int32 batch of uniform item indices from ``default_rng(seed)``:
    the root bench's batches (no padding)."""
    r = np.random.default_rng(seed)
    return {k: r.integers(1, n_items + 1, size=(b, s)).astype(np.int32)
            for k in ("history_item_idx", "pos_item_idx", "neg_item_idx")}


def details(graphed: list[float], eager: list[float], retrieval: dict, reference, smi: str,
            kind: str) -> dict:
    """The output record: the root bench's ``details`` keys (train windows
    of the graphed driver, the reference's step times, retrieval), the
    eager windows, and the card.  ``reference`` is (examples/s, step
    times in s) or None where it did not run."""
    ref_eps, ref_steps = reference if reference is not None else (None, [])
    return {
        "train_examples_per_s": round(float(np.median(graphed)), 1),
        "train_window_examples_per_s": [round(w, 1) for w in graphed],
        "train_window_spread_pct": spread_pct(graphed),
        "eager_train_examples_per_s": round(float(np.median(eager)), 1),
        "eager_train_window_examples_per_s": [round(w, 1) for w in eager],
        "eager_train_window_spread_pct": spread_pct(eager),
        "torch_reference_examples_per_s": None if ref_eps is None else round(ref_eps, 1),
        "torch_step_ms": [round(t * 1e3, 1) for t in ref_steps],
        "torch_step_spread_pct": spread_pct(ref_steps) if ref_steps else None,
        "retrieval": retrieval,
        "device": {"kind": kind, "nvidia_smi": smi},
    }


def _stacked(k: int, b: int, n_items: int, device) -> dict:
    import torch

    from transformer_recommenders_tpu_torch.training.scan_steps import stack_batches

    stacked = stack_batches([make_batch(i, b, S, n_items) for i in range(k)])
    return {key: torch.from_numpy(v).to(device) for key, v in stacked.items()}


def bench_train(*, graphed: bool, k: int = K_STEPS, windows: int = TRAIN_WINDOWS,
                reps: int = TRAIN_REPS, burn: int = BURN_CALLS, b: int = B,
                n_items: int = N_ITEMS) -> list[float]:
    """Examples/s of each window of ``reps`` calls of ``k`` flagship hot
    steps, after ``burn`` calls: through the CUDA-graph driver, or (not
    ``graphed``) the eager step in a Python loop over the same batches.
    Each step draws fresh dropout seeds; each window ends in a
    synchronize."""
    import torch

    from transformer_recommenders_tpu_torch.configs import flagship_config
    from transformer_recommenders_tpu_torch.models.recommender import build_item_table
    from transformer_recommenders_tpu_torch.models.transformer import init_transformer_params
    from transformer_recommenders_tpu_torch.training import train_state as ts
    from transformer_recommenders_tpu_torch.training.scan_steps import make_scanned_train_steps

    cfg = flagship_config()
    device = torch.device("cuda")
    table = build_item_table(make_table(n_items)[1:], device=device)
    state = ts.init_train_state(cfg, init_transformer_params(torch.Generator().manual_seed(0),
                                                             cfg, device=device))
    batches = _stacked(k, b, n_items, device)
    gen = torch.Generator().manual_seed(0)
    n_seeds = 1 + 3 * cfg.num_hidden_layers
    if graphed:
        steps = make_scanned_train_steps(cfg)

        def call(state):
            seeds = torch.randint(0, 2**32, (k, n_seeds), generator=gen, dtype=torch.int64)
            return steps(state, table, batches, seeds)[0]
    else:
        step = ts.make_train_step(cfg, full_logs=False)
        rows = [{key: v[i] for key, v in batches.items()} for i in range(k)]

        def call(state):
            for batch in rows:
                state = step(state, table, batch, ts.draw_dropout_seeds(gen, cfg))[0]
            return state

    t0 = time.perf_counter()
    for _ in range(burn):
        state = call(state)
    torch.cuda.synchronize()
    log(f"{'graphed' if graphed else 'eager'}: {burn} burn calls of {k} steps (capture and "
        f"warm-up included) {time.perf_counter() - t0:.1f} s")
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            state = call(state)
        torch.cuda.synchronize()
        out.append(b * k * reps / (time.perf_counter() - t0))
        time.sleep(0.25)
    if not all(bool(torch.isfinite(leaf).all()) for leaf in ts.tree_leaves(state.params)):
        raise RuntimeError("non-finite parameters after the timed windows")
    log(f"{'graphed' if graphed else 'eager'}: {windows} windows x {k * reps} steps -> median "
        f"{np.median(out):.1f} examples/s (spread {spread_pct(out)}%: "
        f"{[round(w, 1) for w in out]})")
    return out


def bench_retrieval(*, batches=RETRIEVAL_BATCHES, windows: int = RETRIEVAL_WINDOWS,
                    reps: int = RETRIEVAL_REPS, n_items: int = RETRIEVAL_ITEMS,
                    d: int = EMB_DIM, k: int = RETRIEVAL_K) -> dict:
    """Exact top-``k`` QPS and latency over a pre-normalized (n_items, d)
    catalog at each query batch: ``windows`` windows of ``reps`` calls,
    each call on distinct queries, each window ending in a synchronize."""
    import torch

    from transformer_recommenders_tpu_torch.ops.topk import normalize_rows, topk_items

    rng = np.random.default_rng(0)
    items = normalize_rows(torch.from_numpy(rng.normal(size=(n_items, d)).astype(np.float32))
                           .cuda())
    out = {}
    for qbatch in batches:
        qs = torch.from_numpy(rng.normal(size=(windows * reps, qbatch, d)).astype(np.float32))
        qs = qs.cuda()
        topk_items(qs[0], items, k, items_prenormalized=True)
        torch.cuda.synchronize()
        lat_ms = []
        for w in range(windows):
            t0 = time.perf_counter()
            for i in range(w * reps, (w + 1) * reps):
                topk_items(qs[i], items, k, items_prenormalized=True)
            torch.cuda.synchronize()
            lat_ms.append((time.perf_counter() - t0) / reps * 1e3)
            time.sleep(0.25)
        med = float(np.median(lat_ms))
        out[f"qps_batch{qbatch}"] = round(qbatch / med * 1e3, 1)
        out[f"latency_ms_batch{qbatch}"] = round(med, 4)
        out[f"latency_ms_batch{qbatch}_windows"] = [round(t, 4) for t in lat_ms]
        out[f"latency_ms_batch{qbatch}_spread_pct"] = spread_pct(lat_ms)
    log(f"retrieval top-{k} over {n_items}x{d}: {out}")
    return out


def bench_reference() -> tuple[float, list[float]] | None:
    """The root bench's reference step (an HF ``BertModel`` with the same
    shapes, candidate scoring and AdamW, on the host's CPU), or None where
    ``transformers`` is not importable: nothing is fetched."""
    try:
        from transformers.models.bert import BertConfig, BertModel
    except ImportError:
        log("reference baseline skipped: transformers is not importable here")
        return None
    import torch

    torch.manual_seed(0)
    torch.set_num_threads(os.cpu_count() or 8)
    model = BertModel(BertConfig(vocab_size=1, hidden_size=128, num_hidden_layers=4,
                                 num_attention_heads=8, intermediate_size=512,
                                 max_position_embeddings=S, is_decoder=True))
    proj = torch.nn.Linear(EMB_DIM, 128)
    table = torch.randn(N_ITEMS + 1, EMB_DIM)
    table[0] = 0
    opt = torch.optim.AdamW(list(model.parameters()) + list(proj.parameters()), lr=1e-3,
                            weight_decay=0.01)
    rng = np.random.default_rng(0)

    def run_step():
        hist, pos, neg = (torch.as_tensor(rng.integers(1, N_ITEMS + 1, size=(B, S)))
                          for _ in range(3))
        inputs = proj(table[hist])
        out = model(inputs_embeds=inputs, attention_mask=(inputs != 0).any(-1).long())
        q = out.last_hidden_state.reshape(B * S, -1)
        pos_e, neg_e = (proj(table[i]).reshape(B * S, -1) for i in (pos, neg))
        pos_logit = (q * pos_e).sum(-1)
        neg_logits = q @ neg_e.T
        logits = torch.cat([pos_logit[:, None],
                            neg_logits.masked_fill(~(neg_logits < pos_logit[:, None]),
                                                   -torch.inf)], dim=1)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.zeros(B * S, dtype=torch.long), reduction="sum")
        opt.zero_grad()
        loss.backward()
        opt.step()

    for _ in range(TORCH_WARMUP):
        run_step()
    times = []
    for _ in range(TORCH_STEPS):
        t0 = time.perf_counter()
        run_step()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"reference: {TORCH_STEPS} steps, median {med * 1e3:.0f} ms -> {B / med:.1f} examples/s")
    return B / med, times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    import torch

    from transformer_recommenders_tpu_torch.tools import card, require_cuda

    if not require_cuda("bench"):
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    log(f"device: {smi}")
    graphed = bench_train(graphed=True)
    eager = bench_train(graphed=False)
    retrieval = bench_retrieval()
    record = details(graphed, eager, retrieval, bench_reference(), smi,
                     torch.cuda.get_device_name(0))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=2))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
