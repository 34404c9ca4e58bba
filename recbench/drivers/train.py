"""Training cells: the program's scanned driver
(``training/scan_steps.make_scanned_train_steps``), ``steps_per_call`` hot
steps a call as CUDA-graph replays, fed from a pool of batches.

Set-up builds one ``steps`` and one train state from the seed's weights
and makes the first K-step call, which captures the graph the window
replays and runs the K steps the check reads (each step's objective, and
AdamW's first moment and the parameters after the K-th), then one more
call, and hands the same state to the window.  Every call, the first too,
draws fresh dropout seeds from the run's seed and takes the pool's next K
batches; the window's calls are queued one behind the one running, and it
ends on a synchronize.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

from recbench import check, roofline, traffic, weights
from recbench.runtime import Queue, sync
from recbench.reference import model as ref
from recbench.reference.numerics import Precision, no_tf32

ADAM = {"adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8}
TRACE_S = 1.0  # the traced window: about a second of calls, at least two


@dataclasses.dataclass
class Inputs:
    model: dict
    params: dict  # the seed's weights (the reference's copy)
    table: torch.Tensor
    pool: dict  # (P, B, S) int64 batches
    first_seeds: torch.Tensor  # (K, sites): the first call's, the steps checked
    drop_gen: torch.Generator
    counts: list  # per pool batch: the work its inputs need


def reference_config(model: dict) -> dict:
    keys = ("num_attention_heads", "num_hidden_layers", "layer_norm_eps", "hidden_dropout",
            "attention_dropout", "is_decoder", "train_loss", "margin", "learning_rate",
            "weight_decay")
    return {**{k: model[k] for k in keys}, **ADAM}


def _batch_counts(dataset: dict, batch: dict) -> dict:
    hist, pos, neg = (batch[k] for k in ("history_item_idx", "pos_item_idx", "neg_item_idx"))
    c = roofline.sequence_counts(hist)
    valid = hist != 0
    rows = valid & (pos != 0)
    c["loss_rows"] = float(rows.sum())
    c["pool_rows"] = float(valid.sum())
    c["distinct"] = float(torch.unique(torch.cat([hist[valid], pos[rows], neg[valid]])).numel())
    c["columns"] = float(torch.unique(torch.cat([pos[rows], neg[valid]])).numel())
    c["catalog"] = float(dataset["items"] + 1)
    return c


def make_inputs(ctx) -> Inputs:
    model, data, mix = ctx.config["model"], ctx.config["data"], ctx.traffic
    dev = ctx.device
    t = time.perf_counter()
    pool = traffic.train_pool(ctx.config["dataset"], data["batch_size"], model["max_seq_length"],
                              mix, ctx.seeds["traffic"], dev)
    counts = [_batch_counts(ctx.config["dataset"], {k: v[i] for k, v in pool.items()})
              for i in range(next(iter(pool.values())).shape[0])]
    t = ctx.phase("traffic", t)
    gen = torch.Generator(device=dev).manual_seed(ctx.seeds["weights"])
    table = weights.make_item_table(ctx.config["dataset"]["items"], model["input_dim"],
                                    ctx.config["item_table"], gen, dev)
    params = weights.make_params(model, gen, dev)
    drop = torch.Generator(device=dev).manual_seed(ctx.seeds["dropout"])
    first = _draw_seeds(drop, mix["steps_per_call"], model, dev)
    ctx.phase("weights", t)
    return Inputs(model, params, table, pool, first, drop, counts)


def _draw_seeds(gen: torch.Generator, k: int, model: dict, device) -> torch.Tensor:
    """A call's dropout site seeds: (K, 1 + 3 * layers)."""
    sites = 1 + 3 * model["num_hidden_layers"]
    return torch.randint(0, 2**32, (k, sites), generator=gen, device=device)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


class Session:
    """The program's training object for one run: set up, its first call
    (the capture and the checked steps), then driven by :meth:`window` or
    :meth:`traced`."""

    kind = "train"

    def __init__(self, ctx, inputs: Inputs | None = None) -> None:
        from transformer_recommenders_tpu_torch.configs import TrainConfig
        from transformer_recommenders_tpu_torch.training import train_state as ts
        from transformer_recommenders_tpu_torch.training.scan_steps import (
            make_scanned_train_steps)

        self.ctx = ctx
        self.inputs = inputs = inputs or make_inputs(ctx)
        mix = ctx.traffic
        self.cfg = TrainConfig.from_dict(inputs.model)
        self.k = mix["steps_per_call"]
        self.batch = ctx.config["data"]["batch_size"]
        self.pool_calls = mix["pool_calls"]
        t = time.perf_counter()
        self.steps = make_scanned_train_steps(self.cfg, with_logs=False)
        self.state = ts.init_train_state(self.cfg, _clone(inputs.params))
        self.next_call = 0
        logs = self._call(inputs.first_seeds)
        named = ref.leaves(inputs.params)
        sizes = [v.numel() for v in named.values()]
        self.program_out = {
            "losses": [float(v) for v in logs[f"loss/{self.cfg.train_loss}"]],
            "moment": {k: m.view(v.shape) for (k, v), m in
                       zip(named.items(), torch.split(self.state.opt_state.mu, sizes))},
            "params": {k: v.detach().clone() for k, v in ref.leaves(self.state.params).items()},
        }
        sync(ctx.device)
        t0 = time.perf_counter()
        self._call()
        sync(ctx.device)
        self.call_s = time.perf_counter() - t0
        ctx.phase("capture", t)

    def _batches(self, call: int) -> dict:
        i = call % self.pool_calls
        return {k: v[i * self.k:(i + 1) * self.k] for k, v in self.inputs.pool.items()}

    def _call(self, seeds: torch.Tensor | None = None) -> dict:
        if seeds is None:
            seeds = _draw_seeds(self.inputs.drop_gen, self.k, self.inputs.model, self.ctx.device)
        self.state, logs = self.steps(self.state, self.inputs.table,
                                      self._batches(self.next_call), seeds)
        self.next_call += 1
        return logs

    def _drive(self, seconds: float | None = None, calls: int | None = None) -> int:
        """Calls until ``seconds`` have passed or ``calls`` were made, one
        queued behind the one running; ends on a synchronize."""
        queue = Queue(self.ctx.device)
        made, t0 = 0, time.perf_counter()
        while (seconds is None or time.perf_counter() - t0 < seconds) and (
                calls is None or made < calls):
            self._call()
            queue.push()
            made += 1
        sync(self.ctx.device)
        return made

    def window(self, seconds: float) -> dict:
        sync(self.ctx.device)
        t0 = time.perf_counter()
        calls = self._drive(seconds=seconds)
        wall = time.perf_counter() - t0
        steps = calls * self.k
        self.ctx.log(f"window: {calls} calls, {steps} steps of {self.batch} rows in {wall:.6f} s")
        return {"attempted": steps, "failed": 0,
                "values": {"train_examples_per_s": steps * self.batch / wall}}

    def traced(self) -> tuple[callable, callable]:
        """(the traced window's function, the least work of what it ran)."""
        calls = max(2, min(64, round(TRACE_S / max(self.call_s, 1e-6))))
        first = self.next_call

        def run():
            return self._drive(calls=calls) * self.k

        def least() -> dict:
            model = self.inputs.model
            d = model["hidden_size"]
            out = collections.Counter()
            for call in range(first, first + calls):
                i = call % self.pool_calls
                for c in self.inputs.counts[i * self.k:(i + 1) * self.k]:
                    out["fused_layer"] += roofline.fused_layer_seconds(model, c, True)
                    out["attn_core"] += roofline.attn_core_seconds(model, c, True)
                    if model["train_loss"] == "InfoNCELoss":
                        out["table_infonce"] += roofline.table_infonce_seconds(
                            d, c["loss_rows"], c["columns"], c["catalog"])
                        columns = c["columns"]
                    else:
                        out["pairwise"] += roofline.pairwise_seconds(d, c["loss_rows"],
                                                                     c["pool_rows"])
                        columns = c["pool_rows"]
                    out["model"] += roofline.train_step_flops(
                        model, c, c["distinct"], c["loss_rows"], columns) / roofline.BF16_FLOPS
            return dict(out)

        return run, least

    def free(self) -> None:
        """Drop the program's state and its graphs before the reference runs."""
        self.steps = self.state = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_out(ctx, inputs: Inputs, precision: str = "f32", fault: str | None = None) -> dict:
    """The reference's run of the first call's K steps; with ``fault``, a
    fault planted in it (``half``: the loss over the first half of each
    batch's rows, doubled; ``altered``: each step's objective doubled where
    it is produced; ``unchanged``: every step returns its state unchanged)."""
    cfg = reference_config(inputs.model)
    batches = []
    for i in range(inputs.first_seeds.shape[0]):
        batch = {k: v[i] for k, v in inputs.pool.items()}
        if fault == "half":
            half = batch["history_item_idx"].shape[0] // 2
            batch = {k: torch.cat([v[:half], v[:half]]) for k, v in batch.items()}
        batches.append(batch)
    seeds = inputs.first_seeds.tolist()
    with no_tf32():
        out = ref.train_steps(inputs.params, cfg, inputs.table, batches, seeds,
                              Precision(precision))
    if fault == "altered":
        out["losses"] = [2.0 * v for v in out["losses"]]
        out["moment"] = {k: 2.0 * v for k, v in out["moment"].items()}
    if fault == "unchanged":
        out["params"] = {k: v.clone() for k, v in ref.leaves(inputs.params).items()}
        out["moment"] = {k: torch.zeros_like(v) for k, v in out["moment"].items()}
    return out


def numbers(ctx, inputs: Inputs, program_out: dict) -> dict:
    return check.train_numbers(program_out, reference_out(ctx, inputs),
                               ref.leaves(inputs.params))
