"""The numbers that decide ``correct``, each against its limit.

Training (the K steps of a run's first call, the call that captures the
graph the window replays, followed by the reference): ``loss_gap``, the
largest gap of a step's objective, over the larger of the reference's
objective at that step and at the first (ContrastiveLoss falls to a few
pairs, or to exactly 0, within the K steps, and a gap relative to that
alone is the ratio of two roundings of nothing); ``moment_gap``, the worst
leaf's gap between the norms of AdamW's first moment after the K-th step
(a decaying sum of the K gradients as the optimizer got them), over the
larger of the reference's norm of that leaf and of the median leaf;
``change_gap``, the same of the parameters' change over the K steps, among
the leaves whose reference moment is at least a thousandth of the median
leaf's (a leaf that only round-off moves, as a key's bias under softmax,
is left out); ``moment_angle``, over those leaves, the worst ``1 -
cosine`` between the program's and the reference's moment.  A norm
averages rounding away, so the norms' gaps of gradients computed on fp8
operands read as low as bf16's; their direction does not.  Leaves are
:func:`split_leaves`'.

Recommendation (a sample of the users answered in the window): for each
user and rank, ``rank_gap`` is how far the reference's score of the item
returned there lies below the reference's score at that rank, and
``score_gap`` how far the returned score lies from the reference's score
of that item.  An item out of the catalog, returned twice or in the
user's history reads an infinite gap.
"""

from __future__ import annotations

import math
import statistics

import torch


def _norms(tree: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def split_leaves(named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The leaves the comparison takes: each layer's slice of a stacked
    ``layers.*`` leaf, and the fused qkv projection's columns as its q, k
    and v parts (a key's bias, whose gradient is nought under softmax, is
    then a leaf of its own)."""
    out = {}
    for name, t in named.items():
        if not name.startswith("layers."):
            out[name] = t
            continue
        rest = name[len("layers."):]
        for i in range(t.shape[0]):
            parts = {rest: t[i]}
            if rest.startswith("qkv."):
                kind = rest.split(".", 1)[1]
                parts = {f"{p}.{kind}": c for p, c in zip("qkv", torch.chunk(t[i], 3, dim=-1))}
            out.update({f"layers.{i}.{k}": v for k, v in parts.items()})
    return out


def train_numbers(program: dict, reference: dict, params0: dict[str, torch.Tensor]) -> dict:
    """``program`` and ``reference``: ``losses`` (a float a step),
    ``moment`` and ``params`` (leaves by name after the last step)."""
    program, reference = ({**out, "moment": split_leaves(out["moment"]),
                           "params": split_leaves(out["params"])} for out in (program, reference))
    params0 = split_leaves(params0)
    first = abs(reference["losses"][0])
    loss_gap = max(abs(p - r) / max(abs(r), first, 1e-30)
                   for p, r in zip(program["losses"], reference["losses"], strict=True))
    mr, mp = _norms(reference["moment"]), _norms(program["moment"])
    med = statistics.median(mr.values())
    moment_gap = max(abs(mp[k] - mr[k]) / max(mr[k], med, 1e-30) for k in mr)
    moved = [k for k in mr if mr[k] >= 1e-3 * med]
    moment_angle = max(_angle(program["moment"][k], reference["moment"][k]) for k in moved)
    dr = _norms({k: reference["params"][k] - params0[k] for k in moved})
    dp = _norms({k: program["params"][k] - params0[k] for k in moved})
    med_c = statistics.median(dr.values())
    change_gap = max(abs(dp[k] - dr[k]) / max(dr[k], med_c, 1e-30) for k in moved)
    return {"loss_gap": loss_gap, "moment_gap": moment_gap, "moment_angle": moment_angle,
            "change_gap": change_gap}


def _angle(a: torch.Tensor, b: torch.Tensor) -> float:
    """1 - the cosine of two tensors' directions."""
    a, b = a.double().flatten(), b.double().flatten()
    return float(1.0 - a @ b / (a.norm() * b.norm()).clamp(min=1e-300))


def recommend_numbers(top_items: torch.Tensor, top_scores: torch.Tensor,
                      reference_scores: torch.Tensor) -> dict:
    """``top_items`` (U, k) 1-based and ``top_scores`` (U, k) as returned;
    ``reference_scores`` (U, N), -inf where excluded."""
    u, k = top_items.shape
    n = reference_scores.shape[1]
    items = top_items.long().to(reference_scores.device)
    inside = (items >= 1) & (items <= n)
    ref_at = reference_scores.gather(1, (items - 1).clamp(0, n - 1))
    # an item returned twice counts as excluded at its second place
    by_item, order = torch.sort(items, dim=1, stable=True)
    again = torch.zeros_like(inside)
    again[:, 1:] = by_item[:, 1:] == by_item[:, :-1]
    again = torch.zeros_like(inside).scatter_(1, order, again)
    ref_at = torch.where(inside & ~again, ref_at, float("-inf"))
    best = torch.topk(reference_scores, k, dim=1).values
    if not bool(torch.isfinite(ref_at).all()):
        return {"rank_gap": math.inf, "score_gap": math.inf}
    rank_gap = float((best - ref_at).max())
    score_gap = float((top_scores.float().to(ref_at.device) - ref_at).abs().max())
    return {"rank_gap": rank_gap, "score_gap": score_gap}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
