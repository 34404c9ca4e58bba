"""Train state and the hot train step (JAX ``training/train_state.py``).

The ported step is the JAX ``make_train_step(config, full_logs=False)`` on
its table-scored path: the encoder over the history rows of a projected
catalog, then the count-weighted catalog InfoNCE
(``ops/fused_table_infonce.py``), then AdamW over one flat f32 buffer.  On
the card it runs through the CUDA kernels of the gather, the fused layer
and the table InfoNCE, forward and backward; on the CPU through their
plain versions.  The frozen item table is a step argument, never part of
the state.

Not ported yet, and refused with ``NotImplementedError``: ``full_logs=True``
(every loss head and the batch statistics: ``ops/losses.py`` and the pool
kernels), the pool objective taken when the table-scored gate is off
(large catalogs, other losses, hard negatives), and gradient accumulation
(``accumulate_grad_batches > 1``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.models.recommender import compute_query_embeds
from transformer_recommenders_tpu_torch.models.transformer import tree_leaves, tree_unflatten
from transformer_recommenders_tpu_torch.ops.fused_table_infonce import fused_table_infonce_loss

_BATCH_KEYS = ("history_item_idx", "pos_item_idx", "neg_item_idx")


class FlatAdamWState(NamedTuple):
    """Optimizer state over ONE flat f32 buffer (first/second moments)."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


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
    step, the inputs untouched."""
    lr = config.learning_rate
    wd = config.weight_decay
    clip = config.gradient_clip_val
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
        return new_p, FlatAdamWState(count, mu, nu), gnorm

    return update


def init_train_state(config: TrainConfig, params) -> TrainState:
    del config  # the optimizer state depends only on the parameters' shapes
    flat = flatten(params)
    zeros = torch.zeros_like(flat)
    count = torch.zeros((), dtype=torch.int32, device=flat.device)
    return TrainState(params=params, opt_state=FlatAdamWState(count, zeros, zeros.clone()), step=0)


def table_pool_rows(config: TrainConfig, batch: dict) -> int:
    """Rows of the negative pool a batch gives after the history is cut to
    ``max_seq_length``."""
    b, h = batch["history_item_idx"].shape
    return b * min(h, config.max_seq_length)


def _table_loss_enabled(config: TrainConfig, n_table_rows: int, pool_rows: int) -> bool:
    """The JAX gate of the table-scored InfoNCE, restated for the card: the
    configured objective is InfoNCE through the fused, table-scored loss
    without hard negatives, and the catalog is at most twice the pool.  The
    TPU's 13 MB VMEM test does not apply.  The same gate holds on the CPU,
    so both devices take one path."""
    return (
        config.use_fused_loss
        and config.use_table_scored_loss
        and config.train_loss == "InfoNCELoss"
        and config.num_hard_negatives == 0
        and n_table_rows <= 2 * pool_rows
    )


def draw_dropout_seeds(generator: torch.Generator, config: TrainConfig) -> list[int]:
    """The ``1 + 3 * num_hidden_layers`` uint32 dropout site seeds of one
    step (embedding site, then each layer's three), drawn from
    ``generator``."""
    n = 1 + 3 * config.num_hidden_layers
    return torch.randint(0, 2**32, (n,), generator=generator, dtype=torch.int64).tolist()


def _batch_on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(batch[k]).to(device=device, dtype=torch.int64) for k in _BATCH_KEYS}


def make_loss_and_grad(config: TrainConfig):
    """``fn(params, item_table, batch, dropout_seeds) -> (loss, grads)``:
    the step's objective (the InfoNCE sum over valid rows) and its
    gradient, a tree shaped as ``params``.  Raises ``NotImplementedError``
    where the table-scored gate is off: the pool objective is not ported."""

    def loss_and_grad(params, item_table: torch.Tensor, batch: dict, dropout_seeds=None):
        batch = _batch_on(batch, item_table.device)
        if not _table_loss_enabled(config, item_table.shape[0], table_pool_rows(config, batch)):
            msg = (
                "the pool objective (ops/losses.py and the pool InfoNCE/pairwise kernels "
                "of the JAX package) is not ported yet: this configuration and batch fail the "
                f"table-scored gate (train_loss={config.train_loss!r}, "
                f"use_fused_loss={config.use_fused_loss}, use_table_scored_loss="
                f"{config.use_table_scored_loss}, num_hard_negatives="
                f"{config.num_hard_negatives}, {item_table.shape[0]} table rows against a "
                f"pool of {table_pool_rows(config, batch)})"
            )
            raise NotImplementedError(msg)
        leaves = [leaf.detach().requires_grad_() for leaf in tree_leaves(params)]
        qe = compute_query_embeds(
            tree_unflatten(params, leaves), config, item_table, batch["history_item_idx"],
            batch["pos_item_idx"], batch["neg_item_idx"], dropout_seeds=dropout_seeds,
        )
        loss = fused_table_infonce_loss(
            qe["query"], qe["table"], qe["pos_idx"], qe["neg_idx"], qe["row_valid"],
            qe["neg_valid"], scale=config.scale,
            mask_false_negatives=config.mask_false_negatives,
        )
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g for leaf, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    return loss_and_grad


def make_train_step(config: TrainConfig, *, full_logs: bool = False):
    """``step(state, item_table, batch, dropout_seeds) -> (state, logs)``.

    ``batch`` holds (B, S) integer ``history_item_idx``, ``pos_item_idx``
    and ``neg_item_idx`` (numpy or tensors); ``dropout_seeds`` the
    ``1 + 3 * num_hidden_layers`` seeds of :func:`draw_dropout_seeds`, or
    ``None`` for no dropout.  ``logs`` holds ``loss/{train_loss}`` and
    ``grad/global_norm`` (before clipping), as 0-dim tensors on the
    table's device."""
    if full_logs:
        msg = ("full_logs=True (every loss head and the batch statistics: ops/losses.py and "
               "the pool kernels) is not ported yet; use full_logs=False")
        raise NotImplementedError(msg)
    if config.accumulate_grad_batches > 1:
        msg = ("accumulate_grad_batches > 1 (the JAX package's optax.MultiSteps) is not "
               "ported yet")
        raise NotImplementedError(msg)
    loss_and_grad = make_loss_and_grad(config)
    update = make_flat_update(config)

    def train_step(state: TrainState, item_table: torch.Tensor, batch: dict, dropout_seeds=None):
        loss, grads = loss_and_grad(state.params, item_table, batch, dropout_seeds)
        new_p, opt_state, gnorm = update(flatten(state.params), flatten(grads), state.opt_state)
        logs = {f"loss/{config.train_loss}": loss, "grad/global_norm": gnorm}
        return TrainState(unflatten(state.params, new_p), opt_state, state.step + 1), logs

    return train_step
