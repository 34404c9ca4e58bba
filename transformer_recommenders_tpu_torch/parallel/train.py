"""Train steps over the (data, model) mesh (JAX ``parallel/train.py``).

- The encoder's parameters are replicated; the batch is split over
  ``data`` (each rank holds its rows, ``parallel.mesh.shard_batch``); the
  frozen item table is row-sharded over ``model``
  (``parallel.embedding.place_table``).
- The loss is the one-device loss of the global batch.  The in-batch
  objectives share their negative pool over the WHOLE batch, so each rank
  scores its rows against the pool all-gathered over ``data`` (the pool
  branch), or against the catalog weighted by the pool's counts summed
  over ``data`` (the table branch of the hot step).
- The gradient: every rank differentiates the replicated loss with a
  cotangent of ``1 / ranks`` through the collectives' transposes
  (``parallel/collectives.py``: a psum's backward is a psum, an
  all-gather's a reduce-scatter), and the flat gradient is summed over
  every rank.  That is the gradient of the one-device loss; JAX gets the
  same from ``shard_map``'s transposes.  At one rank every collective and
  scale is the identity, and the step is the one-device step's arithmetic.
- Dropout: each data rank draws its own stream, as JAX folds the data
  coordinate into its key: the step's seeds at data coordinate 0, mixed
  with the coordinate elsewhere (:func:`data_rank_seeds`).  The ranks of
  one model group share their stream, since they compute the same rows.
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.models.recommender import (
    _projected_table,
    compute_embeds,
    compute_query_embeds,
)
from transformer_recommenders_tpu_torch.models.transformer import (
    _dense,
    compute_dtype,
    tree_leaves,
    tree_unflatten,
)
from transformer_recommenders_tpu_torch.ops import losses as loss_lib
from transformer_recommenders_tpu_torch.ops.fused_table_infonce import (
    fused_table_infonce_loss,
    neg_pool_counts,
)
from transformer_recommenders_tpu_torch.parallel.collectives import (
    all_gather,
    gather,
    psum,
    reduce,
)
from transformer_recommenders_tpu_torch.parallel.embedding import sharded_table_lookup
from transformer_recommenders_tpu_torch.parallel.mesh import Mesh
from transformer_recommenders_tpu_torch.params import DATA_AXIS, MODEL_AXIS
from transformer_recommenders_tpu_torch.training import train_state as ts

_SEED_STRIDE = 0x9E3779B9  # odd: distinct data coordinates give distinct seeds


def data_rank_seeds(dropout_seeds, mesh: Mesh):
    """This rank's dropout site seeds: the step's at data coordinate 0, each
    plus ``coordinate * 0x9E3779B9`` (mod 2**32) elsewhere.  A tensor stays
    a tensor (a CUDA graph reads each replay's seeds), a list a list."""
    d = mesh.coordinate(DATA_AXIS)
    if dropout_seeds is None or d == 0:
        return dropout_seeds
    if isinstance(dropout_seeds, torch.Tensor):
        return (dropout_seeds.to(torch.int64) + d * _SEED_STRIDE) & 0xFFFFFFFF
    return [(int(v) + d * _SEED_STRIDE) & 0xFFFFFFFF for v in dropout_seeds]


def _project_shard(params, config: TrainConfig, table_shard: torch.Tensor,
                   mesh: Mesh) -> torch.Tensor:
    """The row shard through the input projection; the global padding row,
    row 0 of shard 0, zeroed there as the one-device table's is."""
    if mesh.coordinate(MODEL_AXIS) == 0:
        return _projected_table(params, config, table_shard)
    return _dense(table_shard, params["input_proj"], compute_dtype(config))


def make_sharded_loss(config: TrainConfig, mesh: Mesh, *, full_logs: bool = True):
    """``loss(params, table_shard, batch, dropout_seeds) -> (objective,
    logs, positives)`` on each rank of ``mesh``: the global batch's
    objective (replicated, differentiable in ``params``), the step's logs
    (every rank the same values) and the global count of positions with a
    positive.  ``batch`` holds this rank's (B / data, S) rows.

    ``full_logs=False`` is the hot step: the table branch where the
    table-scored gate admits the global catalog and pool (each rank
    projects its shard, the shards are all-gathered over ``model``, the
    pool's counts summed over ``data``), else the pool branch.
    ``full_logs=True`` is the logging step: the pool branch, with every
    loss head, the logits statistics (their moments summed, their extrema
    reduced by all-gather) and the batch statistics over the global batch,
    the 30 keys of a one-device logging step."""
    name = config.train_loss
    n_data, n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    data_group = mesh.group(DATA_AXIS)

    def reduce_data(kind: str, x: torch.Tensor) -> torch.Tensor:
        if kind == "sum":
            return reduce(x, data_group)
        parts = gather(x.reshape(1), data_group)
        return parts.amin() if kind == "min" else parts.amax()

    def table_branch(params, table_shard, hist, pos, neg, seeds, projected: bool):
        n_global = table_shard.shape[0] * n_model
        full_table = all_gather(table_shard, mesh, MODEL_AXIS)
        qe = compute_query_embeds(params, config, full_table, hist, pos, neg,
                                  dropout_seeds=seeds, table_projected=projected)
        counts = reduce(neg_pool_counts(qe["neg_idx"], qe["neg_valid"], n_global), data_group)
        local = fused_table_infonce_loss(
            qe["query"], qe["table"], qe["pos_idx"], qe["neg_idx"], qe["row_valid"],
            qe["neg_valid"], scale=config.scale,
            mask_false_negatives=config.mask_false_negatives, counts=counts,
        )
        return local, qe["row_valid"]

    def loss(params, table_shard: torch.Tensor, batch: dict, dropout_seeds=None):
        batch = ts._batch_on(batch, table_shard.device)
        seeds = data_rank_seeds(dropout_seeds, mesh)
        projected = "input_proj" in params
        if projected:
            table_shard = _project_shard(params, config, table_shard, mesh)
        hist, pos, neg = (batch[k] for k in ts._BATCH_KEYS)
        if not full_logs and ts._table_loss_enabled(
                config, table_shard.shape[0] * n_model, ts.table_pool_rows(config, batch) * n_data):
            local, row_valid = table_branch(params, table_shard, hist, pos, neg, seeds, projected)
            objective = psum(local, mesh, DATA_AXIS)
            positives = reduce(row_valid.float().sum(), data_group)
            return objective, {f"loss/{name}": objective.detach()}, positives

        embeds = compute_embeds(
            params, config, None, hist, pos, neg, dropout_seeds=seeds,
            table_lookup=lambda idx: sharded_table_lookup(table_shard, idx, mesh),
            lookup_projected=projected,
        )
        # the global negative pool: every data rank's rows, in rank order
        embeds["neg_pool"] = all_gather(embeds["neg_pool"], mesh, DATA_AXIS)
        embeds["neg_valid"] = gather(embeds["neg_valid"], data_group)
        local = ts._fused_objective(config, embeds)
        if local is None:
            local = loss_lib.compute_losses(config, *ts._loss_args(embeds),
                                            loss_names=(name,))[name]
        objective = psum(local, mesh, DATA_AXIS)
        positives = reduce(embeds["row_valid"].float().sum(), data_group)
        if not full_logs:
            return objective, {f"loss/{name}": objective.detach()}, positives
        with torch.no_grad():
            logs = ts._full_logs(config, {k: v.detach() for k, v in embeds.items()},
                                 reduce=reduce_data, data_ranks=n_data)
        return objective, logs, positives

    return loss


def make_sharded_loss_and_grad(config: TrainConfig, mesh: Mesh, *, full_logs: bool = False):
    """``fn(params, table_shard, batch, dropout_seeds) -> (loss, flat_grad,
    logs, positives)``: :func:`make_sharded_loss`'s objective, its gradient
    as one flat f32 vector (``train_state.flatten``'s order), summed over
    every rank, so each rank holds the one-device gradient of the global
    batch, the logs and the positives' count."""
    loss_fn = make_sharded_loss(config, mesh, full_logs=full_logs)

    def loss_and_grad(params, table_shard: torch.Tensor, batch: dict, dropout_seeds=None):
        leaves = [leaf.detach().requires_grad_() for leaf in tree_leaves(params)]
        objective, logs, positives = loss_fn(tree_unflatten(params, leaves), table_shard, batch,
                                             dropout_seeds)
        # the loss is replicated on every rank: each takes 1 / ranks of its cotangent
        share = torch.full((), 1.0 / mesh.size, dtype=objective.dtype, device=objective.device)
        grads = torch.autograd.grad(objective, leaves, grad_outputs=share, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(leaf) if g is None else g).reshape(-1).float()
                          for leaf, g in zip(leaves, grads)])
        return objective.detach(), reduce(flat, None), logs, positives

    return loss_and_grad


def make_sharded_train_step(config: TrainConfig, mesh: Mesh, *, full_logs: bool = True):
    """``step(state, table_shard, batch, dropout_seeds) -> (state, logs)``
    over the mesh: :func:`make_sharded_loss_and_grad`, then the flat AdamW
    update of ``train_state.make_flat_update``, the same on every rank, so
    the state stays replicated.  The logs add ``grad/global_norm``."""
    loss_and_grad = make_sharded_loss_and_grad(config, mesh, full_logs=full_logs)
    update = ts.make_flat_update(config)

    def train_step(state: ts.TrainState, table_shard: torch.Tensor, batch: dict,
                   dropout_seeds=None):
        _, flat_grad, logs, _ = loss_and_grad(state.params, table_shard, batch, dropout_seeds)
        new_p, opt_state, gnorm = update(ts.flatten(state.params), flat_grad, state.opt_state)
        logs["grad/global_norm"] = gnorm
        return ts.TrainState(ts.unflatten(state.params, new_p), opt_state, state.step + 1), logs

    return train_step


def place_state(state: ts.TrainState, mesh: Mesh) -> ts.TrainState:
    """The train state on the mesh's device, replicated: every tensor
    broadcast from rank 0."""
    import torch.distributed as dist

    def put(x):
        if x is None:
            return None
        x = x.detach().to(mesh.device).clone()
        dist.broadcast(x, src=0)
        return x

    opt = state.opt_state
    params = tree_unflatten(state.params, [put(leaf) for leaf in tree_leaves(state.params)])
    return ts.TrainState(params, opt._replace(count=put(opt.count), mu=put(opt.mu),
                                              nu=put(opt.nu), acc=put(opt.acc)), state.step)
