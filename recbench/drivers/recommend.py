"""Recommendation cells: the program's evaluator step
(``training/evaluator.make_eval_step``): the catalog projected and
normalised once (set-up), then one call a batch of users: encode each
user's last window, score the whole catalog, exclude the user's whole
history, take the top k, and copy the items and their scores to the host.

Calls cycle through the pool, one at a time (closed loop: a call is issued
when the previous call's results are on the host), each timed from its
issue to the host's receipt.  Set-up runs the first pool call of each
shape once (a call's shapes differ only in the width of its users'
histories, a power of two), so every shape the window uses is warm.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from recbench import check, roofline, traffic, weights
from recbench.reference import model as ref
from recbench.reference.numerics import Precision, no_tf32
from recbench.runtime import sync
from recbench.trace import spans

TRACE_S = 1.0  # the traced window: about a second of calls, at least four


@dataclasses.dataclass
class Inputs:
    model: dict
    params: dict
    table: torch.Tensor
    pool: list  # the calls' batches (traffic.recommend_pool)
    counts: list  # per call: the work its inputs need


def users_per_call(ctx) -> int:
    n = ctx.traffic["users_per_call"]
    return ctx.config["model"]["eval_batch_size"] if n == "eval_batch_size" else int(n)


def make_inputs(ctx) -> Inputs:
    model = ctx.config["model"]
    dev = ctx.device
    t = time.perf_counter()
    pool = traffic.recommend_pool(ctx.config["dataset"], users_per_call(ctx),
                                  model["max_seq_length"], ctx.traffic, ctx.seeds["traffic"], dev)
    counts = []
    for call in pool:
        w = call["history_window"]
        c = roofline.sequence_counts(w)
        c["distinct"] = float(torch.unique(w[w != 0]).numel())
        c["users"] = float(call["n_real"])
        c["catalog"] = float(ctx.config["dataset"]["items"])
        counts.append(c)
    t = ctx.phase("traffic", t)
    gen = torch.Generator(device=dev).manual_seed(ctx.seeds["weights"])
    table = weights.make_item_table(ctx.config["dataset"]["items"], model["input_dim"],
                                    ctx.config["item_table"], gen, dev)
    params = weights.make_params(model, gen, dev)
    ctx.phase("weights", t)
    return Inputs(model, params, table, pool, counts)


class Session:
    kind = "recommend"

    def __init__(self, ctx, inputs: Inputs | None = None) -> None:
        from transformer_recommenders_tpu_torch.configs import TrainConfig
        from transformer_recommenders_tpu_torch.training import evaluator

        self.ctx = ctx
        self.evaluator = evaluator
        self.inputs = inputs = inputs or make_inputs(ctx)
        self.cfg = TrainConfig.from_dict(inputs.model)
        t = time.perf_counter()
        prepare, self.eval_step = evaluator.make_eval_step(self.cfg)
        self.items = prepare(inputs.params, inputs.table)
        self.answers = {}  # pool call -> (items, scores) on the host, as last received
        firsts = {}
        for i, b in enumerate(inputs.pool):
            firsts.setdefault(tuple(tuple(v.shape) for v in b.values()
                                    if isinstance(v, torch.Tensor)), i)
        for i in firsts.values():
            self.next_call = i
            self._call()
        sync(ctx.device)
        self.next_call = 0
        t0 = time.perf_counter()
        self._call()
        self.call_s = time.perf_counter() - t0
        self.answers.clear()
        ctx.phase("warm_up", t)

    def _call(self) -> tuple[float, int]:
        i = self.next_call % len(self.inputs.pool)
        b = self.inputs.pool[i]
        t0 = time.perf_counter()
        _, top_idx, top_scores = self.eval_step(
            self.inputs.params, self.inputs.table, self.items, b["history_window"],
            b["history_full"], b["targets"], b["n_targets"], return_recs=True)
        answer = (top_idx.cpu(), top_scores.cpu())
        latency = time.perf_counter() - t0
        self.answers[i] = answer
        self.next_call += 1
        return latency, b["n_real"]

    def window(self, seconds: float) -> dict:
        sync(self.ctx.device)
        latencies, users = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            latency, n = self._call()
            latencies.append(latency)
            users += n
        wall = time.perf_counter() - t0
        ms = np.asarray(latencies) * 1e3
        self.ctx.log(f"window: {len(ms)} calls, {users} users in {wall:.6f} s; latency ms "
                     f"median {np.median(ms):.4f} p95 {np.percentile(ms, 95):.4f} "
                     f"max {ms.max():.4f}")
        return {"attempted": len(ms), "failed": 0,
                "values": {"recommend_users_per_s": users / wall,
                           "recommend_p95_ms": float(np.percentile(ms, 95))}}

    def traced(self) -> tuple[callable, callable]:
        calls = max(4, min(256, round(TRACE_S / max(self.call_s, 1e-6))))
        first = self.next_call

        def run():
            with spans(self.evaluator, ("score_items", "mask_excluded", "top_k_columns"),
                       "recbench.topk"):
                for _ in range(calls):
                    self._call()
            sync(self.ctx.device)
            return calls

        def least() -> dict:
            model = self.inputs.model
            out = {"fused_layer": 0.0, "attn_core": 0.0, "model": 0.0}
            for call in range(first, first + calls):
                c = self.inputs.counts[call % len(self.inputs.pool)]
                out["fused_layer"] += roofline.fused_layer_seconds(model, c, False)
                out["attn_core"] += roofline.attn_core_seconds(model, c, False)
                out["model"] += roofline.recommend_call_seconds(model, c, c["distinct"],
                                                                c["users"], c["catalog"])
            return out

        return run, least

    def free(self) -> None:
        self.items = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def sample_users(ctx, inputs: Inputs, answered) -> list[tuple[int, int]]:
    """(call, row) of ``check_users`` real users drawn from the seed among
    the calls answered."""
    rows = [(i, r) for i in sorted(answered) for r in range(inputs.pool[i]["n_real"])]
    rng = np.random.default_rng(ctx.seeds["sample"])
    pick = rng.choice(len(rows), size=min(ctx.traffic["check_users"], len(rows)), replace=False)
    return [rows[j] for j in sorted(pick)]


def _gather(inputs: Inputs, users, key: str) -> torch.Tensor:
    parts = [inputs.pool[i][key][r] for i, r in users]
    width = max(p.shape[0] for p in parts)
    return torch.stack([torch.nn.functional.pad(p, (0, width - p.shape[0])) for p in parts]).long()


def reference_scores(ctx, inputs: Inputs, users, precision: str = "f32") -> torch.Tensor:
    cfg = {k: inputs.model[k] for k in ("num_attention_heads", "num_hidden_layers",
                                         "layer_norm_eps", "hidden_dropout", "attention_dropout",
                                         "is_decoder")}
    with no_tf32():
        return ref.recommend_scores(inputs.params, cfg, inputs.table,
                                    _gather(inputs, users, "history_window"),
                                    _gather(inputs, users, "history_full"), Precision(precision))


def reference_answer(ctx, inputs: Inputs, users, precision: str, fault: str | None = None):
    """The reference put in the program's place: its top k of its own
    scores; with ``fault``, a fault planted in it (``half``: the second
    half of the users answered with the first half's; ``altered``: every
    user's first item moved to the next item of the catalog)."""
    scores = reference_scores(ctx, inputs, users, precision)
    if fault == "half":
        half = scores.shape[0] // 2
        scores = torch.cat([scores[:half], scores[:scores.shape[0] - half]])
    items, top = ref.top_k(scores, inputs.model["top_k"])
    if fault == "altered":
        n = scores.shape[1]
        items[:, 0] = items[:, 0] % n + 1
    return items, top


def numbers(ctx, inputs: Inputs, users, items: torch.Tensor, scores: torch.Tensor) -> dict:
    return check.recommend_numbers(items, scores, reference_scores(ctx, inputs, users))


def program_answer(session: Session, users):
    items = torch.stack([session.answers[i][0][r] for i, r in users])
    scores = torch.stack([session.answers[i][1][r] for i, r in users])
    return items, scores
