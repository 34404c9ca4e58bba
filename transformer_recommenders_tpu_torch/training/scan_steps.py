"""Multi-step training: K train steps per host call (JAX
``training/scan_steps.py``).

JAX runs K steps as one program (``lax.scan`` over stacked batches) so that
no Python runs between them.  On the card the counterpart is a CUDA graph:
the hot step (``make_train_step(config, full_logs=False)``'s arithmetic, its
kernels and the flat AdamW update) is captured once per position in the
gradient-accumulation window, and a call of K steps is K graph replays.
Every replay reads its batch and its dropout seeds from a row of static
device buffers, picked by a step counter on the device that the replay
itself advances, and writes the step's loss and positive count into the
logs at that row; the parameters (one flat f32 vector, the leaves views
of it), the AdamW moments, the count and the accumulator are static
buffers that each replay updates in place with the step's results.  So a
window of K graphed steps does the arithmetic of K eager steps, and gives
the same bits.

Before the first capture one eager step of each position runs on a side
stream (kernel builds, shared-memory opt-ins, split plans and allocations
happen there, never inside a capture); the buffers are then loaded again
from the caller's state.  Nothing falls back: where capture fails, the call
raises.  The kernels' launch counts (``cuda_build.LAUNCHES``) are taken on
the host when a wrapper is called, so a capture would count each kernel
once whatever the replays: the driver takes back the capture's counts and
adds a graph's counts at each replay.

On the CPU (the tests) the same step runs eagerly, K times.

A call is the span ``xrt.steps`` (``tracing.py``); the copies into and out
of the static buffers, per call and per replay, are ``xrt.state``.  With
tracing enabled each capture labels its nodes by the spans that captured
them (``tracing.capture``), so a replayed kernel has its layer.

With a mesh (``mesh=``) each step is the sharded hot step of
``parallel/train.py``, its collectives inside the graph.  NCCL creates a
communicator at a group's first collective, which a capture cannot do:
the eager warm-up step on the side stream makes every collective of the
step first.  Under gloo (the CPU) the window is the eager loop.
"""

from __future__ import annotations

import numpy as np
import torch

from transformer_recommenders_tpu_torch import tracing
from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.models.transformer import tree_leaves
from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.parallel.train import make_sharded_loss_and_grad
from transformer_recommenders_tpu_torch.training import train_state as ts


def stack_batches(batches: list[dict]) -> dict:
    """Stack K host batches into (K, B, S) arrays for one call."""
    return {key: np.stack([b[key] for b in batches]) for key in batches[0]}


def _logs(config: TrainConfig, with_logs: bool, losses, positives) -> dict:
    logs = {f"loss/{config.train_loss}": losses}
    if with_logs:
        logs["batch/positive_non_zero"] = positives
    return logs


class _GraphedWindow:
    """The static buffers of one (table, K, B, S, parameter layout) and one
    captured graph per position in the accumulation window."""

    def __init__(self, step, state: ts.TrainState, item_table, batches, seeds, positions: int):
        device = item_table.device
        self.template = state.params
        self.flat = ts.flatten(state.params).clone()
        opt = state.opt_state
        self.count, self.mu, self.nu = opt.count.clone(), opt.mu.clone(), opt.nu.clone()
        self.acc = None if opt.acc is None else opt.acc.clone()
        self.batches = {k: v.to(device=device, dtype=torch.int64).clone()
                        for k, v in batches.items()}
        self.seeds = seeds.to(device=device, dtype=torch.int64).clone()
        k = self.seeds.shape[0]
        self.row = torch.zeros(1, dtype=torch.int64, device=device)
        self.loss = torch.zeros(k, dtype=torch.float32, device=device)
        self.positives = torch.zeros(k, dtype=torch.float32, device=device)
        self.step, self.table = step, item_table

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # every lazy set-up, outside the capture
            for j in range(positions):
                self.row.zero_()
                self._body(j)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graphs, self.counts = [], []
        for j in range(positions):
            before = dict(cuda_build.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph), tracing.capture():
                self._body(j)
            # the capture launched nothing: its counts go to the replays
            counts = {n: cuda_build.LAUNCHES[n] - before[n] for n in before}
            cuda_build.LAUNCHES.update(before)
            self.graphs.append(graph)
            self.counts.append(counts)

    def _body(self, position: int) -> None:
        """One step at window position ``position``, the batch and seeds of
        row ``self.row``; its results written into the static buffers."""
        with tracing.span("state", request=False):
            batch = {k: v.index_select(0, self.row)[0] for k, v in self.batches.items()}
            seeds = self.seeds.index_select(0, self.row)[0]
            opt = ts.FlatAdamWState(self.count, self.mu, self.nu, self.acc, position)
        new_p, opt, loss, positives = self.step(self.flat, self.template, opt, self.table, batch,
                                                seeds)
        with tracing.span("state", request=False):
            for dst, src in ((self.flat, new_p), (self.count, opt.count), (self.mu, opt.mu),
                             (self.nu, opt.nu), (self.acc, opt.acc)):
                if dst is not None and src is not dst:
                    dst.copy_(src)
            self.loss.index_copy_(0, self.row, loss.reshape(1))
            self.positives.index_copy_(0, self.row, positives.reshape(1))
            self.row += 1

    def load(self, state: ts.TrainState, batches: dict, seeds: torch.Tensor) -> None:
        self.flat.copy_(ts.flatten(state.params))
        opt = state.opt_state
        for dst, src in ((self.count, opt.count), (self.mu, opt.mu), (self.nu, opt.nu),
                         (self.acc, opt.acc)):
            if dst is not None:
                dst.copy_(src)
        for k, buf in self.batches.items():
            buf.copy_(batches[k])
        self.seeds.copy_(seeds)
        self.row.zero_()

    def run(self, first_position: int, k: int) -> None:
        positions = len(self.graphs)
        for t in range(k):
            j = (first_position + t) % positions
            self.graphs[j].replay()
            for name, n in self.counts[j].items():
                cuda_build.LAUNCHES[name] += n


def make_scanned_train_steps(config: TrainConfig, *, with_logs: bool = True, mesh=None):
    """``steps(state, item_table, batches, dropout_seeds) -> (state,
    logs)``: K hot train steps per call.

    ``batches`` holds (K, B, S) integer ``history_item_idx``,
    ``pos_item_idx`` and ``neg_item_idx`` (numpy or tensors, e.g. from
    :func:`stack_batches`); ``dropout_seeds`` is a (K, 1 + 3 * layers)
    integer tensor or array, one row of the step's site seeds per step
    (``train_state.draw_dropout_seeds``).  ``logs`` holds
    ``loss/{train_loss}`` (K,) and, with ``with_logs``,
    ``batch/positive_non_zero`` (K,): the step's objective and its count
    of positions with a positive, as JAX's flat-carry scan logs them.

    On a CUDA table the K steps are CUDA-graph replays (see the module
    docstring); the graphs are captured at the first call for a table, K,
    batch shape and parameter layout, and kept for later calls, in
    ``steps.windows`` by key.  Before its capture each window runs one
    eager warm-up step per accumulation position, whose kernel launches
    count as a step's.  On the CPU they run eagerly.

    With ``mesh`` (``parallel.mesh.create_mesh``) each step is the sharded
    hot step: ``item_table`` is this rank's row shard
    (``parallel.embedding.place_table``), ``batches`` this rank's (K, B /
    data, S) rows, and the positives' count is the global batch's."""
    update = ts.make_flat_update(config)
    positions = max(1, config.accumulate_grad_batches)
    windows: dict[tuple, _GraphedWindow] = {}

    if mesh is None:
        def loss_and_grad(params, item_table, batch, seeds):
            loss, grads, _, row_valid = ts.loss_grads_and_positives(config, False, params,
                                                                    item_table, batch, seeds)
            with tracing.span("optimizer", request=False):
                flat_grad = ts.flatten(grads)
            return loss, flat_grad, row_valid.float().sum()
    else:
        sharded = make_sharded_loss_and_grad(config, mesh, full_logs=False)

        def loss_and_grad(params, item_table, batch, seeds):
            loss, flat_grad, _, positives = sharded(params, item_table, batch, seeds)
            return loss, flat_grad, positives

    def one_step(flat, template, opt_state, item_table, batch, seeds):
        loss, flat_grad, positives = loss_and_grad(ts.unflatten(template, flat), item_table,
                                                   batch, seeds)
        new_p, opt_state, _ = update(flat, flat_grad, opt_state)
        return new_p, opt_state, loss, positives

    def steps(state: ts.TrainState, item_table: torch.Tensor, batches: dict, dropout_seeds):
        with tracing.span("steps", request=False):
            batches = {k: torch.as_tensor(batches[k]) for k in ts._BATCH_KEYS}
            seeds = torch.as_tensor(dropout_seeds)
            k = seeds.shape[0]
            if seeds.dim() != 2 or any(v.shape[0] != k for v in batches.values()):
                msg = (f"steps: dropout_seeds {tuple(seeds.shape)} and batches "
                       f"{ {n: tuple(v.shape) for n, v in batches.items()} } need one row per step")
                raise ValueError(msg)
            mini_step = state.opt_state.mini_step
            if item_table.device.type == "cpu":
                with tracing.span("state", request=False):
                    flat, opt = ts.flatten(state.params), state.opt_state
                losses, positives = [], []
                for i in range(k):
                    batch = {n: v[i] for n, v in batches.items()}
                    flat, opt, loss, pos = one_step(flat, state.params, opt, item_table, batch,
                                                    seeds[i])
                    losses.append(loss)
                    positives.append(pos)
                with tracing.span("state", request=False):
                    new_state = ts.TrainState(ts.unflatten(state.params, flat), opt, state.step + k)
                    logs = _logs(config, with_logs, torch.stack(losses), torch.stack(positives))
                return new_state, logs

            key = (item_table.data_ptr(), tuple(item_table.shape), item_table.dtype, k,
                   tuple(next(iter(batches.values())).shape), state.opt_state.acc is None,
                   tuple(tuple(leaf.shape) for leaf in tree_leaves(state.params)))
            window = windows.get(key)
            if window is None:
                window = windows[key] = _GraphedWindow(one_step, state, item_table, batches, seeds,
                                                       positions)
            with tracing.span("state", request=False):
                window.load(state, batches, seeds)
            window.run(mini_step, k)
            with tracing.span("state", request=False):
                opt = ts.FlatAdamWState(
                    window.count.clone(), window.mu.clone(), window.nu.clone(),
                    None if window.acc is None else window.acc.clone(), (mini_step + k) % positions)
                new_state = ts.TrainState(ts.unflatten(state.params, window.flat.clone()), opt,
                                          state.step + k)
                logs = _logs(config, with_logs, window.loss.clone(), window.positives.clone())
            return new_state, logs

    steps.windows = windows
    return steps
