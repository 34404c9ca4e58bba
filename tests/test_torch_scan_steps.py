"""The port's multi-step driver (``training/scan_steps.py``) on the CPU,
and the device-read dropout seeds it relies on, at a small size: 2
layers, d=128, 4 heads, FFN 128, S=8, B=4 (the fused layer's gate admits
it: its plain version runs on the CPU, JAX's kernel in interpret mode),
and the ml100k_bpr shape at d=64 (the layer stack, the pairwise kernels'
plain versions).

- The scanned driver against K eager ``make_train_step(full_logs=False)``
  steps given the same batches and seeds: the parameters, moments, count,
  accumulator and logs bit for bit (the same arithmetic, op for op), K=3,
  and K=4 with ``accumulate_grad_batches=2``.
- Against JAX's ``make_scanned_train_steps`` (the flat-carry scan; with
  accumulation, its optax path), run on the CPU with the TPU kernels in
  interpret mode, the rng folded per step and the port given
  ``jax_dropout_seeds`` of each folded key.  Both sides'
  ``make_flat_update`` (and JAX's optax optimizer) are replaced by plain
  SGD (``p - lr * g``; of the MultiSteps mean under accumulation), so the
  parameters move linearly in the gradients and the step parity tests'
  bounds apply to the displacement: step-1 AdamW turns
  last-ulp gradient differences into +-lr sign flips (the AdamW
  arithmetic is held to JAX's in ``test_torch_train_state.py``).  f32
  with the mask on: each loss log rtol 1e-5, the positive counts exactly,
  each leaf's displacement within 1e-3 of its max abs value (the bounds
  of ``test_step_gradients_match_jax_kernel_path``).
- ``keep_mask`` given a 0-dim tensor seed equals the int form over the
  whole uint32 range of seeds; ``seed_tensor`` gives a strided view's
  values contiguous; the fused layer's plain versions given a tensor of
  seeds equal the list form, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train_state import force_jax_kernels, jax_dropout_seeds, make_batch
from transformer_recommenders_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu.training import scan_steps as JSS
from transformer_recommenders_tpu.training import train_state as JTS
from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.ops import fused_layer as fl
from transformer_recommenders_tpu_torch.ops.hash_dropout import keep_mask, seed_tensor, seed_terms
from transformer_recommenders_tpu_torch.training import scan_steps as TSS
from transformer_recommenders_tpu_torch.training import train_state as TTS

SMALL = dict(input_dim=48, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_seq_length=8, learning_rate=1e-3)
BPR = dict(SMALL, hidden_size=64, intermediate_size=256, train_loss="PairwiseLogisticLoss",
           margin=0.0)
N_ITEMS = 40


def case(overrides: dict, k: int, seed: int = 0):
    """Config pair, JAX params, the table (padding row first) and K
    (B=4, S=8) batches with pos and neg from disjoint ranges."""
    jcfg, tcfg = JaxTrainConfig(**overrides), TrainConfig(**overrides)
    jparams = JT.init_transformer_params(jax.random.key(seed), jcfg)
    emb = np.random.default_rng(seed + 1).normal(size=(N_ITEMS, jcfg.input_dim))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    table = np.concatenate([np.zeros((1, jcfg.input_dim), np.float32), emb])
    batches = [make_batch(seed + 2 + i, N_ITEMS, disjoint=True) for i in range(k)]
    return jcfg, tcfg, jparams, table, batches


def port_state(tcfg, jparams):
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return TTS.init_train_state(tcfg, params)


@pytest.mark.parametrize(("config", "k", "accumulate"), [
    (SMALL, 3, 1), (SMALL, 4, 2), (BPR, 3, 1),
], ids=["flagship-like", "flagship-like-accumulate2", "ml100k-bpr-like"])
def test_scanned_steps_equal_eager_steps_bit_for_bit(config, k, accumulate):
    _, tcfg, jparams, table, batches = case({**config, "accumulate_grad_batches": accumulate},
                                            k, seed=3)
    gen = torch.Generator().manual_seed(4)
    seeds = [TTS.draw_dropout_seeds(gen, tcfg) for _ in range(k)]
    tab = torch.from_numpy(table)
    state0 = port_state(tcfg, jparams)
    step = TTS.make_train_step(tcfg, full_logs=False)
    eager, losses, positives = state0, [], []
    for batch, s in zip(batches, seeds):
        eager, logs = step(eager, tab, batch, s)
        losses.append(logs[f"loss/{tcfg.train_loss}"])
        positives.append(float((batch["pos_item_idx"] != 0).sum()))
    steps = TSS.make_scanned_train_steps(tcfg)
    got, got_logs = steps(state0, tab, TSS.stack_batches(batches), torch.tensor(seeds))
    assert got.step == eager.step == k
    assert torch.equal(TTS.flatten(got.params), TTS.flatten(eager.params))
    for name in ("count", "mu", "nu", "acc"):
        a, b = getattr(got.opt_state, name), getattr(eager.opt_state, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    assert got.opt_state.mini_step == eager.opt_state.mini_step == k % accumulate
    assert set(got_logs) == {f"loss/{tcfg.train_loss}", "batch/positive_non_zero"}
    assert torch.equal(got_logs[f"loss/{tcfg.train_loss}"], torch.stack(losses))
    assert got_logs["batch/positive_non_zero"].tolist() == positives
    # the input state is left as it was
    torch.testing.assert_close(TTS.flatten(state0.params),
                               TTS.flatten(port_state(tcfg, jparams).params), rtol=0, atol=0)
    # without with_logs, only the loss
    _, only_loss = TSS.make_scanned_train_steps(tcfg, with_logs=False)(
        state0, tab, TSS.stack_batches(batches), torch.tensor(seeds))
    assert set(only_loss) == {f"loss/{tcfg.train_loss}"}


def patch_sgd(monkeypatch, lr: float):
    """Both packages' updates become ``p - lr * g``; under accumulation, of
    the MultiSteps mean (optax's on the JAX side; on the port's, the
    running mean ``acc += (g - acc) / (mini_step + 1)`` that its own
    ``make_flat_update`` forms)."""
    monkeypatch.setattr(JTS, "make_flat_update",
                        lambda config: lambda p, g, s: (p - lr * g, s, jnp.float32(0.0)))
    monkeypatch.setattr(JTS, "make_optimizer", lambda config: optax.MultiSteps(
        optax.sgd(lr), every_k_schedule=config.accumulate_grad_batches))

    def sgd(config):
        k = config.accumulate_grad_batches

        def update(p, g, s):
            gnorm = torch.sqrt(torch.sum(g * g))
            if k <= 1:
                return p - lr * g, s._replace(count=s.count + 1), gnorm
            acc = s.acc + (g - s.acc) / torch.full((), s.mini_step + 1, dtype=g.dtype)
            if s.mini_step < k - 1:
                return p, s._replace(acc=acc, mini_step=s.mini_step + 1), gnorm
            return p - lr * acc, s._replace(count=s.count + 1, acc=torch.zeros_like(acc),
                                            mini_step=0), gnorm

        return update

    monkeypatch.setattr(TTS, "make_flat_update", sgd)


@pytest.mark.parametrize(("k", "accumulate"), [(3, 1), (4, 2)], ids=["k3", "k4-accumulate2"])
def test_scanned_steps_match_jax(monkeypatch, k, accumulate):
    jcfg, tcfg, jparams, table, batches = case(
        {**SMALL, "compute_dtype": "float32", "accumulate_grad_batches": accumulate}, k, seed=5)
    patch_sgd(monkeypatch, SMALL["learning_rate"])
    force_jax_kernels(monkeypatch)
    assert TT._fused_layer_mode(tcfg, SMALL["max_seq_length"])
    assert TTS._table_loss_enabled(tcfg, table.shape[0], TTS.table_pool_rows(tcfg, batches[0]))
    key = jax.random.key(6)
    jsteps = JSS.make_scanned_train_steps(jcfg)
    jstate, jlogs = jsteps(JTS.init_train_state(jcfg, jparams), jnp.asarray(table),
                           {n: jnp.asarray(v) for n, v in JSS.stack_batches(batches).items()},
                           key)
    seeds = torch.tensor([jax_dropout_seeds(jax.random.fold_in(key, i)) for i in range(k)])
    state0 = port_state(tcfg, jparams)
    got, logs = TSS.make_scanned_train_steps(tcfg)(state0, torch.from_numpy(table),
                                                   TSS.stack_batches(batches), seeds)
    name = f"loss/{tcfg.train_loss}"
    np.testing.assert_allclose(logs[name].numpy(), np.asarray(jlogs[name]), rtol=1e-5)
    np.testing.assert_array_equal(logs["batch/positive_non_zero"].numpy(),
                                  np.asarray(jlogs["batch/positive_non_zero"]))
    errs = []
    for p0, p, w, w0 in zip(TT.tree_leaves(state0.params), TT.tree_leaves(got.params),
                            jax.tree.leaves(jstate.params), jax.tree.leaves(jparams)):
        moved, want = (p - p0).numpy(), np.asarray(w) - np.asarray(w0)
        assert np.abs(want).max() > 0  # every leaf moves
        errs.append(float(np.abs(moved - want).max() / np.abs(want).max()))
    assert max(errs) <= 1e-3, errs
    assert got.step == int(jstate.step) == k


def test_scanned_steps_reject_ragged_windows():
    _, tcfg, jparams, table, batches = case(SMALL, 2)
    steps = TSS.make_scanned_train_steps(tcfg)
    with pytest.raises(ValueError, match="one row per step"):
        steps(port_state(tcfg, jparams), torch.from_numpy(table), TSS.stack_batches(batches),
              torch.zeros((3, 1 + 3 * 2), dtype=torch.int64))


def test_stack_batches_matches_jax():
    batches = [make_batch(i, N_ITEMS) for i in range(3)]
    got, want = TSS.stack_batches(batches), JSS.stack_batches(batches)
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == (3, 4, 8)
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_tensor_seed_equals_int_seed(rate):
    """Over the whole uint32 range: 0, 1, the top and random seeds, and
    seeds past 2**32 and below 0 (both forms take them mod 2**32)."""
    rng = np.random.default_rng(0)
    seeds = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, -7,
             *rng.integers(0, 2**32, size=24, dtype=np.uint64).tolist()]
    idx = torch.arange(4096, dtype=torch.int64) * 7919 + 3
    for s in seeds:
        want = keep_mask(idx, int(s), rate)
        got = keep_mask(idx, torch.tensor(int(s), dtype=torch.int64), rate)
        assert torch.equal(got, want), s
    assert torch.equal(seed_tensor([2**32 + 5, -7], "cpu"), torch.tensor([5, 2**32 - 7]))


def test_seed_tensor_is_contiguous_for_strided_views():
    """A kernel reads the seeds by address: a strided view (every other
    seed, a column of a (K, n) table) comes back as a contiguous copy of
    its values; a contiguous int64 tensor comes back as it is."""
    table = torch.arange(24, dtype=torch.int64).view(4, 6)
    for view in (table.reshape(-1)[::2], table[:, 1], table[1:, ::2]):
        got = seed_tensor(view, "cpu")
        assert got.is_contiguous() and got.dim() == 1
        assert torch.equal(got, view.reshape(-1))
    row = table[2]
    assert seed_tensor(row, "cpu").data_ptr() == row.data_ptr()
    # the terms of a list and of a tensor of the same seeds agree
    seeds = [0, 1, 2**32 - 1, 2**32 + 5, -7, 0x9E3779B1]
    assert seed_terms(torch.tensor(seeds)).tolist() == seed_terms(seeds)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_plain_versions_take_a_seed_tensor(dtype):
    gen = torch.Generator().manual_seed(0)
    b, s, d, h, f = 3, 8, 128, 4, 128
    x = torch.randn(b, s, d, generator=gen).to(dtype)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[-1, 5:] = False

    def dense(i, o):
        return {"w": torch.randn(i, o, generator=gen) / i**0.5, "b": 0.1 * torch.randn(o)}

    params = {"qkv": dense(d, 3 * d), "out": dense(d, d), "ffn_in": dense(d, f),
              "ffn_out": dense(f, d),
              "ln1": {"scale": torch.ones(d), "bias": torch.zeros(d)},
              "ln2": {"scale": torch.ones(d), "bias": torch.zeros(d)}}
    seeds = [0x12345678, 4000000000, 7]
    kw = dict(num_heads=h, causal=True, attn_dropout=0.1, hidden_dropout=0.1, ffn_dim=f)
    dy = torch.randn(b, s, d, generator=gen).to(dtype)
    for as_tensor in (torch.tensor(seeds), torch.tensor([99, *seeds, 5])[1:4]):
        want = fl.fused_layer_reference(x, params, mask, dropout_seeds=seeds, **kw)
        got = fl.fused_layer_reference(x, params, mask, dropout_seeds=as_tensor, **kw)
        assert torch.equal(got, want)
        want_dx, want_g = fl.fused_layer_backward_reference(x, params, mask, dy,
                                                            dropout_seeds=seeds, **kw)
        got_dx, got_g = fl.fused_layer_backward_reference(x, params, mask, dy,
                                                          dropout_seeds=as_tensor, **kw)
        assert torch.equal(got_dx, want_dx)
        for m in want_g:
            for n in want_g[m]:
                assert torch.equal(got_g[m][n], want_g[m][n]), (m, n)
    # the encoder takes its 1 + 3 * layers seeds as a list or a tensor alike
    cfg = dataclasses.replace(TrainConfig(**SMALL), compute_dtype=str(dtype).split(".")[1])
    tparams = TT.init_transformer_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    inputs = torch.randn(b, s, SMALL["input_dim"], generator=gen)
    listed = [int(v) for v in torch.randint(0, 2**32, (7,), generator=gen)]
    a = TT.transformer_encode(tparams, cfg, inputs, dropout_seeds=listed)["token_embeddings"]
    t = TT.transformer_encode(tparams, cfg, inputs,
                              dropout_seeds=torch.tensor(listed))["token_embeddings"]
    assert torch.equal(a, t)
