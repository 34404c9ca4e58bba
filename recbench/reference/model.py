"""The recommender in plain float32: the causal post-LN encoder over
projected item embeddings, its two training objectives, AdamW, and the
retrieval scores.

Parameters are the nested dict the benchmark makes (``recbench.weights``):
``pos_embed`` (S, D), ``embed_ln``, ``input_proj`` (384 -> D) and
``layers`` with a leading (layers, ...) axis.  Departures from the
program's numerics are deliberate: every product and sum is f32 (the
program rounds operands and activations to bf16), dropout divides by
``1 - rate`` exactly, GELU uses ``erf``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from recbench.reference.numerics import Precision, dropout

NEG_BIAS = -1e9  # additive mask bias, as the model defines it
ROW_BLOCK = 2048  # rows of a (rows, pool) score block: 256 MB at a 32,768-row pool
USER_BLOCK = 1024  # users encoded and scored at once


def leaves(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tree's leaves by dotted name, in sorted-key, depth-first order
    (the order the program flattens them in)."""
    out = {}
    for key in sorted(tree):
        name = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            out.update(leaves(tree[key], name + "."))
        else:
            out[name] = tree[key]
    return out


def unflatten(template: dict, named: dict[str, torch.Tensor], prefix: str = "") -> dict:
    return {k: unflatten(v, named, f"{prefix}{k}.") if isinstance(v, dict) else named[prefix + k]
            for k, v in template.items()}


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def dense(x: torch.Tensor, p: dict, prec: Precision) -> torch.Tensor:
    return prec.act(prec.mm(x, p["w"]) + p["b"])


def project_table(params: dict, table: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The whole item table in the query space, its padding row 0 zero."""
    t = dense(table, params["input_proj"], prec)
    return torch.cat([torch.zeros_like(t[:1]), t[1:]])


def encode(params: dict, cfg: dict, x: torch.Tensor, mask: torch.Tensor, seeds, prec: Precision
           ) -> torch.Tensor:
    """Token embeddings (B, S, D) of projected inputs ``x`` with key mask
    ``mask`` (B, S).  ``seeds``: the ``1 + 3 * layers`` dropout site seeds
    (embedding, then each layer's attention probs, attention output, FFN
    output), or None for no dropout."""
    b, s, d = x.shape
    h = cfg["num_attention_heads"]
    dh = d // h
    eps = cfg["layer_norm_eps"]
    rate_h, rate_a = cfg["hidden_dropout"], cfg["attention_dropout"]
    seeds = list(seeds) if seeds is not None else None

    def seed(i):
        return None if seeds is None else seeds[i]

    bias = torch.where(mask[:, None, None, :], 0.0, NEG_BIAS)
    if cfg["is_decoder"]:
        tri = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        bias = bias + torch.where(tri, 0.0, NEG_BIAS)
    x = prec.act(layer_norm(prec.act(x + params["pos_embed"][:s]), params["embed_ln"], eps))
    x = dropout(x, rate_h, seed(0))
    layers = params["layers"]
    for i in range(cfg["num_hidden_layers"]):
        lp = {k: {n: t[i] for n, t in v.items()} for k, v in layers.items()}
        qkv = dense(x, lp["qkv"], prec)
        q, k, v = (qkv[..., j * d:(j + 1) * d].reshape(b, s, h, dh).transpose(1, 2)
                   for j in range(3))
        scores = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias
        probs = dropout(torch.softmax(scores, dim=-1), rate_a, seed(1 + 3 * i))
        ctx = prec.act(prec.mm(probs, v)).transpose(1, 2).reshape(b, s, d)
        a = dropout(dense(ctx, lp["out"], prec), rate_h, seed(2 + 3 * i))
        x = prec.act(layer_norm(prec.act(x + a), lp["ln1"], eps))
        u = dense(x, lp["ffn_in"], prec)
        f = dense(prec.act(0.5 * u * (1.0 + torch.erf(u / math.sqrt(2.0)))), lp["ffn_out"], prec)
        x = prec.act(layer_norm(prec.act(x + dropout(f, rate_h, seed(3 + 3 * i))), lp["ln2"], eps))
    return x


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


class _BlockedSum(torch.autograd.Function):
    """The sum over blocks of rows of ``fn(q_block, pos_block, n) * weight``
    without keeping any block's (rows, pool) intermediates: the backward
    recomputes each block and differentiates it alone (q and n only)."""

    @staticmethod
    def forward(ctx, q, pos_logit, n, weight, fn, block):
        ctx.save_for_backward(q, pos_logit, n, weight)
        ctx.fn, ctx.block = fn, block
        return sum((fn(q[lo:lo + block], pos_logit[lo:lo + block], n)
                    * weight[lo:lo + block]).sum() for lo in range(0, q.shape[0], block))

    @staticmethod
    def backward(ctx, g):
        q, pos_logit, n, weight = ctx.saved_tensors
        dq, dn = torch.zeros_like(q), torch.zeros_like(n)
        for lo in range(0, q.shape[0], ctx.block):
            with torch.enable_grad():
                qb = q[lo:lo + ctx.block].detach().requires_grad_()
                nb = n.detach().requires_grad_()
                part = (ctx.fn(qb, pos_logit[lo:lo + ctx.block], nb)
                        * weight[lo:lo + ctx.block]).sum()
                gq, gn = torch.autograd.grad(part, (qb, nb))
            dq[lo:lo + ctx.block] = gq * g
            dn += gn * g
        return dq, None, dn, None, None, None


def _contrastive_rows(q, pos_logit, n, neg_valid, margin, prec):
    """Per-row ContrastiveLoss of a block of rows: the mean of
    ``relu(cos - 1 + margin)`` over the pool rows that are valid and score
    below the row's positive."""
    x = prec.mm(q, n.T)
    counted = neg_valid[None, :] & (x < pos_logit[:, None]).detach()
    f = torch.where(counted, F.relu(x - 1.0 + margin), 0.0)
    return f.sum(dim=1) / (counted.float().sum(dim=1) + 1e-9)


def objective(params: dict, cfg: dict, table: torch.Tensor, batch: dict, seeds,
              prec: Precision) -> torch.Tensor:
    """The training objective of one step, a sum over the positions that
    have a positive: the catalog-scored InfoNCE (every catalog row weighted
    by its count among the batch's negatives; a row scoring at or above the
    positive does not count) or the cosine ContrastiveLoss over the batch's
    pool of negatives.  ``batch`` holds (B, S) ``history_item_idx``,
    ``pos_item_idx``, ``neg_item_idx`` (0 = padding)."""
    hist, pos, neg = (batch[k] for k in ("history_item_idx", "pos_item_idx", "neg_item_idx"))
    b, s = hist.shape
    mask = hist != 0
    pos_f, neg_f = pos.reshape(-1), neg.reshape(-1)
    neg_valid = mask.reshape(-1)
    row_valid = ((pos_f != 0) & neg_valid).float()
    t = project_table(params, table, prec)
    q = encode(params, cfg, t[hist], mask, seeds, prec).reshape(b * s, -1)
    loss = cfg["train_loss"]
    if loss == "InfoNCELoss":
        logits = prec.mm(q, t.T)
        pos_logit = logits.gather(1, pos_f[:, None])[:, 0]
        counts = torch.zeros(t.shape[0], device=t.device).index_add_(
            0, neg_f, neg_valid.float())
        counts[0] = 0.0
        w = torch.where(logits.detach() < pos_logit.detach()[:, None], counts[None, :], 0.0)
        masked = torch.where(w > 0, logits, float("-inf"))
        m = torch.maximum(pos_logit, masked.amax(dim=1)).detach()
        lse = m + torch.log(torch.exp(pos_logit - m)
                            + (w * torch.exp(masked - m[:, None])).sum(dim=1))
        return ((lse - pos_logit) * row_valid).sum()
    if loss == "ContrastiveLoss":
        qn, pn, nn_ = (_normalize(x, 1e-8) for x in (q, t[pos_f], t[neg_f]))
        pos_logit = (qn * pn).sum(dim=-1).detach()  # only compared: no gradient flows

        def rows(qb, pb, n):
            return _contrastive_rows(qb, pb, n, neg_valid, cfg["margin"], prec)

        return _BlockedSum.apply(qn, pos_logit, nn_, row_valid, rows, ROW_BLOCK)
    msg = f"the reference has no objective {loss!r}"
    raise ValueError(msg)


def adamw(p, g, mu, nu, count: int, cfg: dict):
    """One AdamW update as optax computes it (bias correction, ``eps``
    outside the square root, decoupled weight decay inside the step)."""
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * g * g
    mu_hat = mu / (1.0 - b1 ** count)
    nu_hat = nu / (1.0 - b2 ** count)
    p = p - cfg["learning_rate"] * (mu_hat / (torch.sqrt(nu_hat) + eps) + cfg["weight_decay"] * p)
    return p, mu, nu


def train_steps(params0: dict, cfg: dict, table: torch.Tensor, batches: list, seeds: list,
                prec: Precision) -> dict:
    """``len(batches)`` training steps from ``params0``: each step's
    objective, and after the last step AdamW's first moment and the
    parameters, by leaf."""
    named = {k: v.detach().clone().float() for k, v in leaves(params0).items()}
    mu = {k: torch.zeros_like(v) for k, v in named.items()}
    nu = {k: torch.zeros_like(v) for k, v in named.items()}
    losses = []
    for step, (batch, step_seeds) in enumerate(zip(batches, seeds), 1):
        live = {k: v.clone().requires_grad_() for k, v in named.items()}
        loss = objective(unflatten(params0, live), cfg, table, batch, step_seeds, prec)
        grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(live.items(), grads)}
        losses.append(float(loss.detach()))
        for k in named:
            named[k], mu[k], nu[k] = adamw(named[k], grads[k], mu[k], nu[k], step, cfg)
    return {"losses": losses, "moment": mu, "params": named}


@torch.no_grad()
def recommend_scores(params: dict, cfg: dict, table: torch.Tensor, windows: torch.Tensor,
                     history: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(U, N) cosine scores of each user's window-encoded query against
    every catalog item (column j is item j + 1), items in the user's whole
    ``history`` (1-based, 0 padding) set to -inf."""
    items = _normalize(dense(table[1:], params["input_proj"], prec), 1e-12)
    n = items.shape[0]
    out = []
    for lo in range(0, windows.shape[0], USER_BLOCK):
        w = windows[lo:lo + USER_BLOCK]
        mask = w != 0
        tokens = encode(params, cfg, dense(table[w], params["input_proj"], prec), mask, None, prec)
        m = mask.float()[..., None]
        query = (tokens * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
        scores = prec.mm(_normalize(query, 1e-12), items.T)
        h = history[lo:lo + USER_BLOCK].long()
        cols = torch.where((h > 0) & (h <= n), h - 1, n)
        scores = torch.cat([scores, scores.new_zeros(scores.shape[0], 1)], dim=1)
        out.append(scores.scatter_(1, cols, float("-inf"))[:, :n])
    return torch.cat(out)


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(1-based items, scores) of each row's k best, lower item first
    among equal scores."""
    order = torch.argsort(scores, dim=1, descending=True, stable=True)[:, :k]
    return order + 1, scores.gather(1, order)
