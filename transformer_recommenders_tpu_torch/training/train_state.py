"""Train state and train steps (JAX ``training/train_state.py``).

``make_train_step(config, full_logs=...)`` gives the JAX step's two
variants.  The hot step (``full_logs=False``) differentiates only the
training objective: the count-weighted catalog InfoNCE
(``ops/fused_table_infonce.py``) over :func:`compute_query_embeds` when
the table-scored gate is on, else the pool objective over
:func:`compute_embeds` (the gathered positives and negatives): the pool
InfoNCE kernels (``ops/fused_infonce.py``) for InfoNCE, the pairwise pool
kernels (``ops/fused_pairwise.py``) for ContrastiveLoss, the hinge and
logistic pairwise losses, NCELoss and AlignmentContrastiveLoss, the plain
cosine sum for AlignmentLoss, and the plain loss heads (``ops/losses.py``)
when the fused loss is off (``use_fused_loss=False`` or hard negatives).
The logging step (``full_logs=True``, the default, as in JAX) takes the
pool objective whatever the gate and adds every loss head, the logits
statistics and the batch statistics to its logs, computed on detached
embeddings.  AdamW runs over one flat f32 buffer; with
``accumulate_grad_batches = k > 1`` it runs every k-th step on the mean
of the last k gradients, as ``optax.MultiSteps`` does.  On the card every
kernel of the path runs as CUDA, forward and backward; on the CPU their
plain versions run.  The frozen item table is a step argument, never part
of the state.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from transformer_recommenders_tpu_torch import tracing
from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.models.recommender import (
    compute_embeds,
    compute_query_embeds,
)
from transformer_recommenders_tpu_torch.models.transformer import tree_leaves, tree_unflatten
from transformer_recommenders_tpu_torch.ops import losses as loss_lib
from transformer_recommenders_tpu_torch.ops.fused_infonce import fused_infonce_loss
from transformer_recommenders_tpu_torch.ops.fused_pairwise import fused_pairwise_loss
from transformer_recommenders_tpu_torch.ops.fused_table_infonce import fused_table_infonce_loss

_BATCH_KEYS = ("history_item_idx", "pos_item_idx", "neg_item_idx")
_COSINE_LOSSES = ("ContrastiveLoss", "AlignmentLoss", "AlignmentContrastiveLoss")


class FlatAdamWState(NamedTuple):
    """Optimizer state over ONE flat f32 buffer (first/second moments).
    With gradient accumulation, ``acc`` is the running mean of this
    window's micro-batch gradients and ``mini_step`` how many it holds
    (``optax.MultiSteps``' ``acc_grads`` and ``mini_step``)."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    acc: torch.Tensor | None = None
    mini_step: int = 0


class TrainState(NamedTuple):
    params: Any
    opt_state: FlatAdamWState
    step: int


def flatten(tree) -> torch.Tensor:
    """The leaves of ``tree`` in ``tree_leaves`` order as one flat f32 vector."""
    return torch.cat([leaf.reshape(-1).float() for leaf in tree_leaves(tree)])


def unflatten(template, flat: torch.Tensor):
    """Views of ``flat`` shaped as the leaves of ``template``."""
    leaves, start = [], 0
    for leaf in tree_leaves(template):
        leaves.append(flat[start:start + leaf.numel()].view(leaf.shape))
        start += leaf.numel()
    return tree_unflatten(template, leaves)


def make_flat_update(config: TrainConfig):
    """``(p_flat, g_flat, opt_state) -> (new_p_flat, new_opt_state, gnorm)``:
    AdamW with the JAX flat update's arithmetic (optax's): global-norm
    clipping when ``gradient_clip_val`` is set (``gnorm`` is the norm
    before it), bias correction by ``1 - b**count``, ``eps`` outside the
    square root, the decoupled ``weight_decay * p`` inside the ``lr``
    product.  Not ``torch.optim.AdamW``.  Out of place: new buffers each
    step, the inputs untouched.

    With ``accumulate_grad_batches = k > 1``, ``optax.MultiSteps`` around
    that update: each step folds its gradient into the running mean
    ``acc += (g - acc) / (mini_step + 1)``; the k-th runs the update,
    clipping included, on ``acc`` and clears it; the others leave the
    parameters, the count and the moments as they are.  ``gnorm`` is then
    the micro-batch gradient's own norm."""
    lr = config.learning_rate
    wd = config.weight_decay
    clip = config.gradient_clip_val
    k = config.accumulate_grad_batches
    b1, b2, eps = 0.9, 0.999, 1e-8

    def update(p: torch.Tensor, g: torch.Tensor, opt_state: FlatAdamWState):
        gnorm = torch.sqrt(torch.sum(g * g))
        if clip:
            g = g * torch.where(gnorm < clip, 1.0, clip / gnorm)
        count = opt_state.count + 1
        mu = b1 * opt_state.mu + (1.0 - b1) * g
        nu = b2 * opt_state.nu + (1.0 - b2) * (g * g)
        cf = count.to(mu.dtype)
        mu_hat = mu / (1.0 - torch.pow(b1, cf))
        nu_hat = nu / (1.0 - torch.pow(b2, cf))
        new_p = p - lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + wd * p)
        return new_p, opt_state._replace(count=count, mu=mu, nu=nu), gnorm

    def traced(step):
        def flat_update(p: torch.Tensor, g: torch.Tensor, opt_state: FlatAdamWState):
            with tracing.span("optimizer", request=False):
                return step(p, g, opt_state)

        return flat_update

    if k <= 1:
        return traced(update)

    def accumulate(p: torch.Tensor, g: torch.Tensor, opt_state: FlatAdamWState):
        gnorm = torch.sqrt(torch.sum(g * g))
        # a device tensor, not a host scalar: CUDA would multiply by its
        # reciprocal, where optax divides
        n = torch.full((), opt_state.mini_step + 1, dtype=g.dtype, device=g.device)
        acc = opt_state.acc + (g - opt_state.acc) / n
        if opt_state.mini_step < k - 1:
            return p, opt_state._replace(acc=acc, mini_step=opt_state.mini_step + 1), gnorm
        new_p, opt_state, _ = update(p, acc, opt_state)
        return new_p, opt_state._replace(acc=torch.zeros_like(acc), mini_step=0), gnorm

    return traced(accumulate)


def init_train_state(config: TrainConfig, params) -> TrainState:
    """Zero moments and count over the flat parameters, and a zero
    accumulator where ``accumulate_grad_batches > 1``."""
    flat = flatten(params)
    zeros = torch.zeros_like(flat)
    count = torch.zeros((), dtype=torch.int32, device=flat.device)
    acc = zeros.clone() if config.accumulate_grad_batches > 1 else None
    return TrainState(params=params, opt_state=FlatAdamWState(count, zeros, zeros.clone(), acc),
                      step=0)


def table_pool_rows(config: TrainConfig, batch: dict) -> int:
    """Rows of the negative pool a batch gives after the history is cut to
    ``max_seq_length``."""
    b, h = batch["history_item_idx"].shape
    return b * min(h, config.max_seq_length)


def _fused_loss_enabled(config: TrainConfig) -> bool:
    """The JAX gate of the fused losses, restated for the card: the fused
    loss is configured and no hard negatives are mined (the kernels do not
    mine them).  The JAX package also turns it off on its CPU backend,
    where Pallas would run interpreted; here the CPU and the card take one
    path, the CPU through the kernels' plain versions."""
    return config.use_fused_loss and config.num_hard_negatives == 0


def _table_loss_enabled(config: TrainConfig, n_table_rows: int, pool_rows: int) -> bool:
    """The JAX gate of the table-scored InfoNCE, restated for the card: the
    fused loss is on, the configured objective is InfoNCE through the
    table-scored loss, and the catalog is at most twice the pool.  The
    TPU's 13 MB VMEM test does not apply."""
    return (
        _fused_loss_enabled(config)
        and config.use_table_scored_loss
        and config.train_loss == "InfoNCELoss"
        and n_table_rows <= 2 * pool_rows
    )


def _fused_objective(config: TrainConfig, embeds: dict) -> torch.Tensor | None:
    """The fused objective of the configured train loss over
    :func:`compute_embeds` output, or None where the fused loss is off."""
    if not _fused_loss_enabled(config):
        return None
    name = config.train_loss
    q, p, n = embeds["query"], embeds["pos_embed"], embeds["neg_pool"]
    if name == "InfoNCELoss":
        return fused_infonce_loss(q, p, n, embeds["row_valid"], embeds["neg_valid"],
                                  scale=config.scale,
                                  mask_false_negatives=config.mask_false_negatives)
    rv = embeds["row_valid"].float()
    if name in _COSINE_LOSSES:
        q, p, n = (loss_lib._l2_normalize(x) for x in (q, p, n))

    def pos_logit() -> torch.Tensor:  # f32, of the normalized rows where cosine
        return (q.float() * p.float()).sum(dim=-1)

    if name == "AlignmentLoss":  # no pool term: the cosine of each valid row's pair
        return ((1.0 - pos_logit()) * rv).sum()
    pool_term = fused_pairwise_loss(
        q, p, n, embeds["row_valid"], embeds["neg_valid"],
        head="ContrastiveLoss" if name == "AlignmentContrastiveLoss" else name,
        margin=config.margin, mask_false_negatives=config.mask_false_negatives,
    )
    if name == "AlignmentContrastiveLoss":
        return ((1.0 - pos_logit()) * rv).sum() + pool_term
    if name == "NCELoss":  # the positive's BCE term, labelled 1
        return (loss_lib._softplus(-pos_logit()) * rv).sum() + pool_term
    return pool_term


def _loss_args(embeds: dict) -> tuple:
    return tuple(embeds[k] for k in ("query", "pos_embed", "neg_pool", "row_valid", "neg_valid"))


def _full_logs(config: TrainConfig, embeds: dict, reduce=None,
               data_ranks: int = 1) -> dict[str, torch.Tensor]:
    """Every loss head (``loss/{name}`` and ``loss/{name}Mean``, the sum
    over the positive count), the logits statistics and the batch
    statistics, with the JAX step's keys.  The parallel layer passes
    ``reduce(kind, x)``, which combines a rank's partial result over the
    data axis (``kind`` ``"sum"``, ``"min"`` or ``"max"``), and the data
    axis's size, by which the batch's shape counts grow; on one device both
    leave the values as they are."""
    if reduce is None:
        def reduce(kind: str, x: torch.Tensor) -> torch.Tensor:
            return x

    all_losses = {k: reduce("sum", v)
                  for k, v in loss_lib.compute_losses(config, *_loss_args(embeds)).items()}
    attn = embeds["attention_mask"]
    numel = attn.numel() * data_ranks
    attn_nz = reduce("sum", attn.float().sum())
    pos_nz = reduce("sum", embeds["positive_mask"].float().sum())
    moments = loss_lib.logits_statistics_moments(config, *_loss_args(embeds))
    moments = {k: reduce(k.rsplit("_", 1)[-1] if k.endswith(("_min", "_max")) else "sum", v)
               for k, v in moments.items()}

    def full(v: float) -> torch.Tensor:
        return torch.full((), float(v), dtype=torch.float32, device=attn.device)

    logs = {f"loss/{k}": v for k, v in all_losses.items()}
    logs |= {f"loss/{k}Mean": v / (pos_nz + 1e-9) for k, v in all_losses.items()}
    logs |= loss_lib.finish_logits_statistics(moments)
    logs |= {
        "batch/size": full(attn.shape[0] * data_ranks),
        "batch/seq_len": full(attn.shape[1]),
        "batch/numel": full(numel),
        "batch/attention_non_zero": attn_nz,
        "batch/attention_density": attn_nz / full(numel + 1e-9),
        "batch/positive_non_zero": pos_nz,
        "batch/positive_density": pos_nz / (attn_nz + 1e-9),
    }
    return logs


def draw_dropout_seeds(generator: torch.Generator, config: TrainConfig) -> list[int]:
    """The ``1 + 3 * num_hidden_layers`` uint32 dropout site seeds of one
    step (embedding site, then each layer's three), drawn from
    ``generator``."""
    n = 1 + 3 * config.num_hidden_layers
    return torch.randint(0, 2**32, (n,), generator=generator, dtype=torch.int64).tolist()


def _batch_on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(batch[k]).to(device=device, dtype=torch.int64) for k in _BATCH_KEYS}


def _objective_and_logs(config: TrainConfig, full_logs: bool, params, item_table, batch,
                        dropout_seeds):
    """The JAX step's ``loss_fn``: the objective to differentiate, the
    step's loss logs (detached) and the (R,) ``row_valid`` mask (the
    positions with a positive; JAX's ``positive_mask``)."""
    name = config.train_loss
    if not full_logs and _table_loss_enabled(config, item_table.shape[0],
                                             table_pool_rows(config, batch)):
        qe = compute_query_embeds(
            params, config, item_table, batch["history_item_idx"], batch["pos_item_idx"],
            batch["neg_item_idx"], dropout_seeds=dropout_seeds,
        )
        with tracing.span("loss", request=False):
            objective = fused_table_infonce_loss(
                qe["query"], qe["table"], qe["pos_idx"], qe["neg_idx"], qe["row_valid"],
                qe["neg_valid"], scale=config.scale,
                mask_false_negatives=config.mask_false_negatives,
            )
        objective = tracing.mark_backward(objective, "loss")
        return objective, {f"loss/{name}": objective.detach()}, qe["row_valid"]
    embeds = compute_embeds(
        params, config, item_table, batch["history_item_idx"], batch["pos_item_idx"],
        batch["neg_item_idx"], dropout_seeds=dropout_seeds,
    )
    with tracing.span("loss", request=False):
        objective = _fused_objective(config, embeds)
        if objective is None:
            objective = loss_lib.compute_losses(config, *_loss_args(embeds),
                                                loss_names=(name,))[name]
    objective = tracing.mark_backward(objective, "loss")
    if not full_logs:
        return objective, {f"loss/{name}": objective.detach()}, embeds["row_valid"]
    # the logs are the JAX step's aux: computed alongside, never differentiated
    with torch.no_grad(), tracing.span("loss", request=False):
        logs = _full_logs(config, {k: v.detach() for k, v in embeds.items()})
    return objective, logs, embeds["row_valid"]


def loss_grads_and_positives(config: TrainConfig, full_logs: bool, params, item_table, batch,
                             dropout_seeds=None):
    """``(loss, grads, logs, row_valid)``: :func:`make_loss_and_grad`'s
    three, and the positions with a positive (the scanned driver logs
    their count)."""
    batch = _batch_on(batch, item_table.device)
    leaves = [leaf.detach().requires_grad_() for leaf in tree_leaves(params)]
    objective, logs, row_valid = _objective_and_logs(
        config, full_logs, tree_unflatten(params, leaves), item_table, batch, dropout_seeds)
    grads = torch.autograd.grad(objective, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g for leaf, g in zip(leaves, grads)]
    return objective.detach(), tree_unflatten(params, grads), logs, row_valid


def make_loss_and_grad(config: TrainConfig, *, full_logs: bool = False):
    """``fn(params, item_table, batch, dropout_seeds) -> (loss, grads,
    logs)``: the step's objective (a sum over valid rows), its gradient (a
    tree shaped as ``params``) and the step's loss logs, without the
    update.  ``full_logs`` picks the step variant as
    :func:`make_train_step` does.  Under a pool kernel's objective (InfoNCE
    or a pairwise head) the logging step logs ``loss/{train_loss}`` from
    the plain f32 loss head and trains on the kernel's objective, which
    scores bf16-rounded operands, as the JAX step does."""

    def loss_and_grad(params, item_table: torch.Tensor, batch: dict, dropout_seeds=None):
        loss, grads, logs, _ = loss_grads_and_positives(config, full_logs, params, item_table,
                                                        batch, dropout_seeds)
        return loss, grads, logs

    return loss_and_grad


def make_train_step(config: TrainConfig, *, full_logs: bool = True):
    """``step(state, item_table, batch, dropout_seeds) -> (state, logs)``.

    ``batch`` holds (B, S) integer ``history_item_idx``, ``pos_item_idx``
    and ``neg_item_idx`` (numpy or tensors); ``dropout_seeds`` the
    ``1 + 3 * num_hidden_layers`` seeds of :func:`draw_dropout_seeds`, or
    ``None`` for no dropout.  ``full_logs=False`` is the hot step, whose
    logs hold ``loss/{train_loss}``; the default logging step logs every
    loss head (``loss/{name}``, ``loss/{name}Mean``), the 9 ``logits/...``
    and the 7 ``batch/...`` statistics.  Both add ``grad/global_norm``
    (this step's gradient, before clipping).  The logs are 0-dim tensors
    on the table's device."""
    loss_and_grad = make_loss_and_grad(config, full_logs=full_logs)
    update = make_flat_update(config)

    def train_step(state: TrainState, item_table: torch.Tensor, batch: dict, dropout_seeds=None):
        _, grads, logs = loss_and_grad(state.params, item_table, batch, dropout_seeds)
        new_p, opt_state, gnorm = update(flatten(state.params), flatten(grads), state.opt_state)
        logs["grad/global_norm"] = gnorm
        return TrainState(unflatten(state.params, new_p), opt_state, state.step + 1), logs

    return train_step
