"""Checkpoint/resume of the train state (JAX ``training/checkpoint.py``).

The ``npz`` format is the JAX package's, so either package loads the
other's checkpoints: ``state.npz`` holds ``leaf0..leafN``, the leaves of
``jax.tree.leaves(TrainState)``, and ``meta.json`` the epoch, step and
metrics.  The leaves are ``[*params, *opt, step]``:

- params in the JAX tree order (``tree_leaves``: dict keys sorted, depth
  first), f32;
- the opt leaves of the flat AdamW (``accumulate_grad_batches <= 1``):
  ``[count, mu_flat, nu_flat]``, the count int32 and the moments one f32
  vector each in ``jax.flatten_util.ravel_pytree``'s order (the port's
  ``flatten``);
- with ``accumulate_grad_batches > 1`` JAX's optimizer is
  ``optax.MultiSteps`` over a per-leaf AdamW, whose leaves are
  ``[mini_step, gradient_step, count, *mu, *nu, *acc]`` (int32 counters,
  then per-leaf f32 trees); the port writes and reads that layout, its
  ``gradient_step`` being the update count;
- the step, int32.

A stored per-leaf AdamW layout (``[count, *mu, *nu]``) converts to the
flat one, as JAX's ``_convert_opt_leaves`` does; any other mismatch
raises.  The frozen item table is not part of the state.  The sharded
``orbax`` backend is the JAX package's alone: asking for it raises.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np
import torch

from transformer_recommenders_tpu_torch.models.transformer import tree_leaves, tree_unflatten
from transformer_recommenders_tpu_torch.training.train_state import (
    FlatAdamWState,
    TrainState,
    flatten,
)


def _orbax_error() -> ValueError:
    return ValueError("checkpoint_backend='orbax' (sharded multi-host checkpoints) is not "
                      "available in the PyTorch port; use 'npz'")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _split(flat: torch.Tensor, params) -> list[np.ndarray]:
    """A flat vector as per-leaf arrays shaped as ``params``' leaves."""
    out, start = [], 0
    for leaf in tree_leaves(params):
        out.append(_np(flat[start:start + leaf.numel()].reshape(leaf.shape)))
        start += leaf.numel()
    return out


def state_leaves(state: TrainState) -> list[np.ndarray]:
    """The state's leaves in the JAX package's order and dtypes."""
    params = [_np(leaf).astype(np.float32) for leaf in tree_leaves(state.params)]
    opt = state.opt_state
    count = np.asarray(_np(opt.count), np.int32)
    if opt.acc is None:
        opt_leaves = [count, _np(opt.mu), _np(opt.nu)]
    else:
        opt_leaves = [np.asarray(opt.mini_step, np.int32), count, count,
                      *_split(opt.mu, state.params), *_split(opt.nu, state.params),
                      *_split(opt.acc, state.params)]
    return [*params, *opt_leaves, np.asarray(state.step, np.int32)]


def save_checkpoint(
    path: str | pathlib.Path,
    state: TrainState,
    *,
    epoch: int,
    metrics: dict[str, float] | None = None,
    backend: str = "npz",
) -> None:
    if backend != "npz":
        raise _orbax_error()
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "state.npz",
             **{f"leaf{i}": x for i, x in enumerate(state_leaves(state))})
    meta = {"epoch": epoch, "step": int(state.step), "metrics": metrics or {}}
    (path / "meta.json").write_text(json.dumps(meta, indent=2))


def load_checkpoint(
    path: str | pathlib.Path, template: TrainState
) -> tuple[TrainState, dict[str, Any]]:
    """Restore onto ``template``'s structure and device (a state built from
    the same config)."""
    path = pathlib.Path(path)
    if (path / "orbax").exists():
        raise _orbax_error()
    with np.load(path / "state.npz") as data:
        leaves = [data[f"leaf{i}"] for i in range(len(data.files))]
    device = template.opt_state.mu.device
    n_p = len(tree_leaves(template.params))

    def put(a, dtype=torch.float32) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    def cat(arrays) -> torch.Tensor:
        return put(np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in arrays]))

    params = tree_unflatten(template.params, [put(a) for a in leaves[:n_p]])
    stored = leaves[n_p:-1]
    accumulate = template.opt_state.acc is not None
    if not accumulate and len(stored) == 3:
        count, mu, nu = stored
        opt = FlatAdamWState(put(count, torch.int32), put(mu), put(nu))
    elif not accumulate and len(stored) == 2 * n_p + 1:
        # per-leaf AdamW -> flat: ravel the stored moment trees
        opt = FlatAdamWState(put(stored[0], torch.int32), cat(stored[1:1 + n_p]),
                             cat(stored[1 + n_p:]))
    elif accumulate and len(stored) == 3 + 3 * n_p:
        mini_step, _, count = stored[:3]
        mu, nu, acc = (cat(stored[3 + i * n_p:3 + (i + 1) * n_p]) for i in range(3))
        opt = FlatAdamWState(put(count, torch.int32), mu, nu, acc, int(mini_step))
    else:
        expect = 3 + 3 * n_p if accumulate else 3
        msg = (
            "checkpoint opt-state layout does not match the current config's: "
            f"stored {len(stored)} opt leaves, the template expects {expect} "
            f"({'optax.MultiSteps' if accumulate else 'flat fused AdamW'}). No conversion "
            "exists between these layouts. Likely cause: accumulate_grad_batches changed "
            "across the resume."
        )
        raise ValueError(msg)
    if opt.mu.numel() != flatten(params).numel():
        msg = "checkpoint moments do not match the parameters' size"
        raise ValueError(msg)
    state = TrainState(params, opt, int(leaves[-1]))
    meta = json.loads((path / "meta.json").read_text())
    return state, meta


def latest_checkpoint(ckpt_dir: str | pathlib.Path) -> pathlib.Path | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    candidates = sorted(
        (p for p in ckpt_dir.iterdir() if (p / "state.npz").exists() or (p / "orbax").exists()),
        key=lambda p: p.stat().st_mtime,
    )
    return candidates[-1] if candidates else None
