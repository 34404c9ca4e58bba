"""Checkpoints across the packages, on the CPU: a JAX checkpoint loads into
the port, and a port checkpoint loads into JAX's ``load_checkpoint``,
each giving the same parameters, moments, count and step bit for bit.

- the flat AdamW layout (``[*params, count, mu_flat, nu_flat, step]``),
  after a few JAX steps so the moments are not zero;
- ``accumulate_grad_batches = 2``: JAX's ``optax.MultiSteps`` layout
  (``[mini_step, gradient_step, count, *mu, *nu, *acc]``), mid-window
  (``mini_step`` 1, a non-zero accumulator);
- a stored per-leaf AdamW layout converts to the flat one, as JAX's
  ``_convert_opt_leaves`` converts it; layouts without a conversion raise,
  and so does the ``orbax`` backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from transformer_recommenders_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu.training import checkpoint as JC
from transformer_recommenders_tpu.training import train_state as JTS
from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.training import checkpoint as TC
from transformer_recommenders_tpu_torch.training import train_state as TTS

SETTINGS = dict(input_dim=24, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32, max_seq_length=4, compute_dtype="float32",
                hidden_dropout=0.0, attention_dropout=0.0)


def jax_state(accumulate: int, steps: int):
    """A JAX train state after ``steps`` updates with random gradients."""
    jcfg = JaxTrainConfig(accumulate_grad_batches=accumulate, **SETTINGS)
    params = JT.init_transformer_params(jax.random.key(0), jcfg)
    state = JTS.init_train_state(jcfg, params)
    update = jax.jit(JTS.make_update_fn(jcfg))
    rng = np.random.default_rng(1)
    for i in range(steps):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), params)
        new_params, opt_state, _ = update(grads, state.opt_state, state.params)
        state = JTS.TrainState(new_params, opt_state, state.step + 1)
    return jcfg, state


def port_template(accumulate: int):
    cfg = TrainConfig(accumulate_grad_batches=accumulate, **SETTINGS)
    params = TT.init_transformer_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    return TTS.init_train_state(cfg, params)


def jax_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(i))


@pytest.mark.parametrize("accumulate,steps", [(1, 3), (2, 3)])
def test_jax_checkpoint_loads_into_the_port(tmp_path, accumulate, steps):
    _, state = jax_state(accumulate, steps)
    JC.save_checkpoint(tmp_path / "c", state, epoch=4, metrics={"val/x": 0.5})
    restored, meta = TC.load_checkpoint(tmp_path / "c", port_template(accumulate))
    assert meta == {"epoch": 4, "step": steps, "metrics": {"val/x": 0.5}}
    assert restored.step == steps and isinstance(restored.step, int)
    assert_leaves_equal(TC.state_leaves(restored), jax_leaves(state))
    opt = restored.opt_state
    assert opt.count.dtype == torch.int32 and int(opt.count) == steps // accumulate
    if accumulate > 1:
        assert opt.mini_step == steps % accumulate and bool(opt.acc.abs().sum() > 0)
        flat_mu, _ = ravel_pytree(state.opt_state.inner_opt_state[0].mu)
    else:
        flat_mu = state.opt_state.mu
    np.testing.assert_array_equal(opt.mu.numpy(), np.asarray(flat_mu))


@pytest.mark.parametrize("accumulate,steps", [(1, 3), (2, 3)])
def test_port_checkpoint_loads_into_jax(tmp_path, accumulate, steps):
    jcfg, state = jax_state(accumulate, steps)
    JC.save_checkpoint(tmp_path / "j", state, epoch=1)
    port_state, _ = TC.load_checkpoint(tmp_path / "j", port_template(accumulate))
    TC.save_checkpoint(tmp_path / "p", port_state, epoch=2, metrics={"m": 1.5})
    template = JTS.init_train_state(jcfg, JT.init_transformer_params(jax.random.key(9), jcfg))
    restored, meta = JC.load_checkpoint(tmp_path / "p", template)
    assert meta == {"epoch": 2, "step": steps, "metrics": {"m": 1.5}}
    assert jax.tree.structure(restored) == jax.tree.structure(state)
    assert_leaves_equal(jax_leaves(restored), jax_leaves(state))


def test_port_roundtrip_and_latest(tmp_path):
    state = port_template(1)
    state = state._replace(step=7, opt_state=state.opt_state._replace(
        count=torch.tensor(7, dtype=torch.int32), mu=torch.randn_like(state.opt_state.mu)))
    TC.save_checkpoint(tmp_path / "a", state, epoch=0)
    TC.save_checkpoint(tmp_path / "b", state, epoch=1)
    restored, meta = TC.load_checkpoint(tmp_path / "b", port_template(1))
    assert_leaves_equal(TC.state_leaves(restored), TC.state_leaves(state))
    assert meta["epoch"] == 1 and meta["step"] == 7
    assert TC.latest_checkpoint(tmp_path) == tmp_path / "b"
    assert TC.latest_checkpoint(tmp_path / "missing") is None


def test_per_leaf_adamw_converts_to_flat(tmp_path):
    jcfg = JaxTrainConfig(**SETTINGS)
    params = JT.init_transformer_params(jax.random.key(0), jcfg)
    opt = JTS.make_optimizer(jcfg)  # optax.adamw: per-leaf moments
    opt_state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.3, p.dtype), params)
    _, opt_state = opt.update(grads, opt_state, params)
    JC.save_checkpoint(tmp_path / "c", JTS.TrainState(params, opt_state, jnp.int32(1)), epoch=0)
    restored, _ = TC.load_checkpoint(tmp_path / "c", port_template(1))
    np.testing.assert_array_equal(restored.opt_state.mu.numpy(),
                                  np.asarray(ravel_pytree(opt_state[0].mu)[0]))
    np.testing.assert_array_equal(restored.opt_state.nu.numpy(),
                                  np.asarray(ravel_pytree(opt_state[0].nu)[0]))
    assert int(restored.opt_state.count) == 1


def test_unconvertible_layouts_and_orbax_raise(tmp_path):
    _, flat = jax_state(1, 1)
    JC.save_checkpoint(tmp_path / "flat", flat, epoch=0)
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        TC.load_checkpoint(tmp_path / "flat", port_template(2))
    _, multi = jax_state(2, 1)
    JC.save_checkpoint(tmp_path / "multi", multi, epoch=0)
    with pytest.raises(ValueError, match="No conversion"):
        TC.load_checkpoint(tmp_path / "multi", port_template(1))
    with pytest.raises(ValueError, match="orbax"):
        TC.save_checkpoint(tmp_path / "o", port_template(1), epoch=0, backend="orbax")
