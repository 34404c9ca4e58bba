"""The port's train state and hot train step against the JAX package on
the CPU, from the same numpy weights (``params_from_jax``, at the model's
own init scale), catalog, batches and dropout seeds (derived from the JAX
key as ``transformer_encode`` splits it).

- Flat AdamW: ``make_flat_update`` against the JAX one over 3 steps, with
  and without clipping; f32 elementwise arithmetic, rtol 1e-6.
- The tiny-config step: the port's loss and raw gradients on the CPU
  against JAX's ``make_train_step(full_logs=False)`` with the table path,
  the fused layer and the one-hot gather forced in interpret mode (the
  TPU's kernels) and the update patched to pass the gradients through
  (step-1 AdamW turns every element into +-lr and would amplify last-ulp
  differences into sign flips).
  - f32, the false-negative mask on: loss rtol 1e-5, gradients 1e-3 of
    each leaf's max abs value (measured 4.8e-5; <= 1e-6 in most cases).
    The loss rounds q to bf16 in both packages, and where the two
    packages' f32 queries (~1e-7 apart) straddle a bf16 rounding boundary,
    that query's bf16 value moves by one ulp (2**-8 relative).
  - bf16, the mask off: loss rtol 2**-10, gradients 2**-6 of each leaf's
    max abs value (measured <= 1e-2 over four seeds and dropout on and
    off).  Every encoder product rounds to bf16, and Pallas interpret mode
    rounds its bf16 products unlike the port (see
    test_torch_fused_layer_grad.py).  The mask is off because it compares
    two logits for ``<``: where a negative's logit lies within that bf16
    noise of the positive's, the two packages can decide it differently,
    and a whole pool term (up to log 2 of that row's loss) flips with it.
- The unpatched CPU step: the same gradients against JAX's CPU step as it
  runs untouched (the XLA layer stack, ``jnp.take`` and the pool
  objective over gathered rows, scored in f32 without the bf16 rounding of
  the table kernel), the mask off for the same reason, pos and neg from
  disjoint index ranges.  Loss rtol 2**-10; gradients 2**-7 of each
  leaf's max abs value in f32 (measured <= 4.7e-3) and 2**-5 in bf16
  (measured <= 1.4e-2).
- The pool objective (a catalog of more than twice the pool's rows, or
  the logging step): against JAX with its pool kernel in interpret mode
  patched in beside the other kernels, the same bounds as the table path
  (both score bf16-rounded operands with f32 sums in other orders).  With
  the mask on, pos and neg come from disjoint index ranges: the JAX kernel
  sums a positive's logit in another order than its pool logits, so a
  copy of the positive in the pool can tie by one ulp there, where the
  port drops every copy.
- The plain objectives (hard negatives, ``use_fused_loss=False``): against
  JAX's unpatched CPU step, which computes the same loss heads in f32;
  loss rtol 1e-5, gradients 1e-3 of each leaf's max abs value (the XLA
  layer stack against the fused layer's plain version, f32 sums in other
  orders).
- The logging step's logs: key for key against JAX's
  ``make_train_step(full_logs=True)``; every loss head, statistic and
  count in f32, rtol 1e-4 (atol 1e-5), a few times the encoder's f32
  noise carried through the loss heads.
- The pairwise objectives (the pairwise pool kernels, JAX's in interpret
  mode): the pool objective's bounds, f32 with the mask on and disjoint
  ranges, bf16 with the mask off.
- Gradient accumulation: the flat update against ``optax.MultiSteps``
  (the JAX package's optimizer for ``accumulate_grad_batches > 1``) fed
  the same gradients, rtol 1e-6; the port's step against its own flat
  update of the mean gradient, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transformer_recommenders_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_recommenders_tpu.models import recommender as JR
from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu.ops import fused_infonce as JFI
from transformer_recommenders_tpu.ops import fused_pairwise as JFP
from transformer_recommenders_tpu.ops import fused_table_infonce as JFT
from transformer_recommenders_tpu.ops.gather_matmul import gather_rows as jax_gather_rows
from transformer_recommenders_tpu.training import train_state as JTS
from transformer_recommenders_tpu_torch.configs import TrainConfig
from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.training import train_state as TTS

LAYERS = 2
SETTINGS = dict(input_dim=48, hidden_size=32, num_hidden_layers=LAYERS, num_attention_heads=4,
                intermediate_size=48, max_seq_length=8, hidden_dropout=0.1,
                attention_dropout=0.1, learning_rate=1e-3)


def configs(**overrides):
    kw = {**SETTINGS, **overrides}
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def make_batch(seed, n_items, b=4, s=8, disjoint=False, full=False):
    """(B, S) int32 batches with trailing zero padding, as
    ``data/dataset.py`` writes them; some positions have no positive.
    ``full``: every position valid, with a positive."""
    rng = np.random.default_rng(seed)
    half = n_items // 2
    hist, pos, neg = (np.zeros((b, s), np.int32) for _ in range(3))
    lengths = rng.integers(2, s + 1, size=b)
    lengths[0] = s  # one full row
    if full:
        lengths[:] = s
    for row, length in enumerate(lengths):
        hist[row, :length] = rng.integers(1, n_items + 1, size=length)
        pos[row, :length] = rng.integers(1, half + 1 if disjoint else n_items + 1, size=length)
        pos[row, :length] *= (rng.random(length) > 0.2) | full
        neg[row, :length] = rng.integers(half + 1 if disjoint else 1, n_items + 1, size=length)
    return {"history_item_idx": hist, "pos_item_idx": pos, "neg_item_idx": neg}


def make_case(jcfg, n_items=40, seed=0, disjoint=False, full=False):
    jparams = JT.init_transformer_params(jax.random.key(seed), jcfg)
    emb = np.random.default_rng(seed + 1).normal(size=(n_items, jcfg.input_dim))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    table = np.concatenate([np.zeros((1, jcfg.input_dim), np.float32), emb])
    return jparams, table, make_batch(seed + 2, n_items, disjoint=disjoint, full=full)


def jax_dropout_seeds(key):
    """The 1 + 3 * layers uint32 site seeds JAX's ``transformer_encode``
    derives from ``key``."""
    rngs = jax.random.split(key, 2)
    layer_keys = jax.random.split(rngs[1], 3 * LAYERS).reshape(LAYERS, 3)
    return [int(JT._dropout_seed(rngs[0]))] + [
        int(v) for i in range(LAYERS) for v in np.asarray(JT._dropout_site_seeds(layer_keys[i]))
    ]


def patch_grad_passthrough(monkeypatch):
    """JAX's updated params become its raw gradients."""
    monkeypatch.setattr(JTS, "make_flat_update",
                        lambda config: lambda p, g, opt_state: (g, opt_state, jnp.float32(0.0)))


def jax_layer_gate(cfg, s):
    """JAX's fused-layer gate as on a TPU, the kernel in interpret mode:
    the fused layer where the shape admits it (the port's gate, which
    ``test_torch_layer_stack.py`` holds to JAX's), else the XLA stack."""
    return "interpret" if TT._fused_layer_mode(cfg, s) else None


def force_jax_kernels(monkeypatch):
    """JAX's TPU path on the CPU: the table-scored loss, the fused layer
    where its shape gate admits it and the one-hot gather, each kernel in
    interpret mode."""
    monkeypatch.setattr(JTS, "_fused_loss_enabled", lambda config: True)
    monkeypatch.setattr(JT, "_fused_layer_mode", jax_layer_gate)
    table_loss = JFT.fused_table_infonce_loss
    monkeypatch.setattr(JFT, "fused_table_infonce_loss",
                        lambda *a, **kw: table_loss(*a, **{**kw, "interpret": True,
                                                           "tile_rows": 16}))

    def lookup(table, idx, *, compute_dtype):
        if jnp.dtype(compute_dtype) != jnp.bfloat16:
            return jnp.take(table, idx, axis=0)
        rows = jax_gather_rows(table, idx.reshape(-1), out_dtype=jnp.bfloat16, interpret=True)
        return rows.reshape(*idx.shape, table.shape[1])

    monkeypatch.setattr(JR, "fast_table_lookup", lookup)
    pool_loss = JFI.fused_infonce_loss
    monkeypatch.setattr(JFI, "fused_infonce_loss",
                        lambda *a, **kw: pool_loss(*a, **{**kw, "interpret": True}))
    pairwise_loss = JFP.fused_pairwise_loss
    monkeypatch.setattr(JFP, "fused_pairwise_loss",
                        lambda *a, **kw: pairwise_loss(*a, **{**kw, "interpret": True,
                                                              "tile_rows": 16,
                                                              "tile_cols": 128}))


def jax_step(jcfg, jparams, table, batch, key, full_logs=False):
    """JAX's logs and raw gradients (under ``patch_grad_passthrough``)."""
    step = JTS.make_train_step(jcfg, full_logs=full_logs)
    state, logs = step(JTS.init_train_state(jcfg, jparams), jnp.asarray(table),
                       {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return logs, [np.asarray(a) for a in jax.tree.leaves(state.params)]


def jax_loss_and_grads(jcfg, jparams, table, batch, key):
    logs, grads = jax_step(jcfg, jparams, table, batch, key)
    return float(logs[f"loss/{jcfg.train_loss}"]), grads


def port_loss_and_grads(tcfg, jparams, table, batch, seeds, full_logs=False):
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    loss, grads, logs = TTS.make_loss_and_grad(tcfg, full_logs=full_logs)(
        params, torch.from_numpy(table), batch, seeds)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(logs[f"loss/{tcfg.train_loss}"]) == float(loss) or full_logs
    return float(loss), [g.numpy() for g in TT.tree_leaves(grads)]


def assert_grads_close(got, want, rel):
    assert len(got) == len(want)
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32, i
        scale = np.abs(w).max()
        assert scale > 0, i  # every leaf gets a gradient
        errs.append(float(np.abs(g - w).max() / scale))
    assert max(errs) <= rel, errs


@pytest.mark.parametrize("clip", [None, 0.5, 1e3], ids=["noclip", "clipped", "clip-inactive"])
def test_flat_adamw_matches_jax(clip):
    n = 1000
    rng = np.random.default_rng(0)
    kw = dict(learning_rate=3e-3, weight_decay=0.05, gradient_clip_val=clip)
    jcfg, tcfg = configs(**kw)
    jupdate, tupdate = JTS.make_flat_update(jcfg), TTS.make_flat_update(tcfg)
    p = rng.normal(size=n).astype(np.float32)
    jp, tp = jnp.asarray(p), torch.from_numpy(p.copy())
    jstate = JTS.FlatAdamWState(jnp.zeros((), jnp.int32), jnp.zeros(n), jnp.zeros(n))
    tstate = TTS.init_train_state(tcfg, {"w": tp}).opt_state
    for _ in range(3):
        g = (2.0 * rng.normal(size=n)).astype(np.float32)
        jp, jstate, jnorm = jupdate(jp, jnp.asarray(g), jstate)
        tp, tstate, tnorm = tupdate(tp, torch.from_numpy(g), tstate)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        for got, want in ((tp, jp), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
        assert int(tstate.count) == int(jstate.count)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_gradients_match_jax_kernel_path(monkeypatch, dtype):
    f32 = dtype == "float32"
    jcfg, tcfg = configs(compute_dtype=dtype, mask_false_negatives=f32)
    jparams, table, batch = make_case(jcfg)
    key = jax.random.key(7)
    patch_grad_passthrough(monkeypatch)
    force_jax_kernels(monkeypatch)
    assert TTS._table_loss_enabled(tcfg, table.shape[0], TTS.table_pool_rows(tcfg, batch))
    want_loss, want = jax_loss_and_grads(jcfg, jparams, table, batch, key)
    got_loss, got = port_loss_and_grads(tcfg, jparams, table, batch, jax_dropout_seeds(key))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5 if f32 else 2.0**-10)
    assert_grads_close(got, want, 1e-3 if f32 else 2.0**-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_gradients_match_jax_unpatched_cpu_step(monkeypatch, dtype):
    jcfg, tcfg = configs(compute_dtype=dtype, mask_false_negatives=False)
    jparams, table, batch = make_case(jcfg, seed=4, disjoint=True)
    key = jax.random.key(8)
    patch_grad_passthrough(monkeypatch)
    assert not JTS._fused_loss_enabled(jcfg)  # the XLA pool objective on the CPU
    want_loss, want = jax_loss_and_grads(jcfg, jparams, table, batch, key)
    got_loss, got = port_loss_and_grads(tcfg, jparams, table, batch, jax_dropout_seeds(key))
    np.testing.assert_allclose(got_loss, want_loss, rtol=2.0**-10)
    assert_grads_close(got, want, 2.0**-7 if dtype == "float32" else 2.0**-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ml100k_bpr_step_matches_jax_without_forcing_the_layer(monkeypatch, dtype):
    """configs/ml100k_bpr.yaml's step (d=64, 4 heads, FFN 256, BPR:
    PairwiseLogisticLoss at margin 0): the fused-layer gate sends d=64 to
    the layer stack in both packages, so only the loss kernel and the
    gather are JAX's interpret-mode kernels.  The pairwise objective's
    bounds (f32 with the mask on and disjoint ranges, bf16 with it off)."""
    f32 = dtype == "float32"
    jcfg, tcfg = configs(compute_dtype=dtype, mask_false_negatives=f32, hidden_size=64,
                         num_attention_heads=4, intermediate_size=256,
                         train_loss="PairwiseLogisticLoss", margin=0.0)
    jparams, table, batch = make_case(jcfg, n_items=80, seed=15, disjoint=True, full=not f32)
    key = jax.random.key(16)
    patch_grad_passthrough(monkeypatch)
    force_jax_kernels(monkeypatch)
    assert jax_layer_gate(jcfg, SETTINGS["max_seq_length"]) is None
    want_loss, want = jax_loss_and_grads(jcfg, jparams, table, batch, key)
    got_loss, got = port_loss_and_grads(tcfg, jparams, table, batch, jax_dropout_seeds(key))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5 if f32 else 2.0**-10)
    assert_grads_close(got, want, 1e-3 if f32 else 2.0**-6)


def test_train_step_applies_flat_adamw_to_the_gradients():
    jcfg, tcfg = configs(gradient_clip_val=0.1)
    jparams, table, batch = make_case(jcfg, seed=5)
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    seeds = TTS.draw_dropout_seeds(torch.Generator().manual_seed(0), tcfg)
    state = TTS.init_train_state(tcfg, params)
    new_state, logs = TTS.make_train_step(tcfg, full_logs=False)(state, torch.from_numpy(table),
                                                                  batch, seeds)
    loss, grads, _ = TTS.make_loss_and_grad(tcfg)(params, torch.from_numpy(table), batch, seeds)
    want_p, want_opt, want_norm = TTS.make_flat_update(tcfg)(
        TTS.flatten(params), TTS.flatten(grads), state.opt_state)
    assert set(logs) == {"loss/InfoNCELoss", "grad/global_norm"}
    assert float(logs["loss/InfoNCELoss"]) == float(loss)
    assert float(logs["grad/global_norm"]) == float(want_norm) > 0.1  # clipping was active
    torch.testing.assert_close(TTS.flatten(new_state.params), want_p, rtol=0, atol=0)
    torch.testing.assert_close(new_state.opt_state.mu, want_opt.mu, rtol=0, atol=0)
    assert new_state.step == 1 and int(new_state.opt_state.count) == 1
    for a, b in zip(TT.tree_leaves(new_state.params), TT.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the input state is left as it was
    torch.testing.assert_close(TTS.flatten(state.params), TTS.flatten(params), rtol=0, atol=0)


@pytest.mark.parametrize(("n_rows", "pool_rows", "overrides"), [
    (41, 32, {}),
    (65, 32, {}),  # the catalog is more than twice the pool
    (64, 32, {}),
    (41, 32, {"train_loss": "PairwiseLogisticLoss"}),
    (41, 32, {"use_table_scored_loss": False}),
    (41, 32, {"use_fused_loss": False}),
    (41, 32, {"num_hard_negatives": 2}),
])
def test_table_gate_matches_jax_off_the_tpu_vmem_test(monkeypatch, n_rows, pool_rows, overrides):
    jcfg, tcfg = configs(**overrides)
    monkeypatch.setattr(JTS, "_fused_loss_enabled",
                        lambda c: c.use_fused_loss and c.num_hard_negatives == 0)
    assert TTS._table_loss_enabled(tcfg, n_rows, pool_rows) == \
        JTS._table_loss_enabled(jcfg, n_rows, pool_rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_items", [80, 120], ids=["project-then-gather", "gather-then-project"])
def test_pool_objective_matches_jax_kernel_path(monkeypatch, dtype, n_items):
    """A catalog of more than twice the pool's 32 rows takes the pool
    objective: the pool InfoNCE over compute_embeds' gathered rows, whose
    catalog of 81 rows is projected whole (at most 3 * B * S = 96 rows) or
    121 rows gathered first."""
    f32 = dtype == "float32"
    jcfg, tcfg = configs(compute_dtype=dtype, mask_false_negatives=f32)
    jparams, table, batch = make_case(jcfg, n_items=n_items, seed=6, disjoint=True)
    key = jax.random.key(9)
    patch_grad_passthrough(monkeypatch)
    force_jax_kernels(monkeypatch)
    assert not TTS._table_loss_enabled(tcfg, table.shape[0], TTS.table_pool_rows(tcfg, batch))
    want_loss, want = jax_loss_and_grads(jcfg, jparams, table, batch, key)
    got_loss, got = port_loss_and_grads(tcfg, jparams, table, batch, jax_dropout_seeds(key))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5 if f32 else 2.0**-10)
    assert_grads_close(got, want, 1e-3 if f32 else 2.0**-6)


@pytest.mark.parametrize("n_items", [80, 120], ids=["project-then-gather", "gather-then-project"])
def test_compute_embeds_matches_jax(monkeypatch, n_items):
    """Both branches of compute_embeds, f32, dropout on: the gathered rows
    within 1e-6 (one product each), the queries within 2e-5 (the fused
    layer's f32 bound), the masks exactly."""
    jcfg, tcfg = configs(compute_dtype="float32")
    jparams, table, batch = make_case(jcfg, n_items=n_items, seed=7)
    key = jax.random.key(3)
    monkeypatch.setattr(JT, "_fused_layer_mode", jax_layer_gate)
    want = JR.compute_embeds(jparams, jcfg, jnp.asarray(table),
                             *(jnp.asarray(batch[k]) for k in TTS._BATCH_KEYS), dropout_rng=key)
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    got = RecommenderModel(tcfg, params=params, device="cpu")
    got.configure_embeddings([str(i) for i in range(n_items)], table[1:])
    got = got.compute_embeds(*(batch[k] for k in TTS._BATCH_KEYS),
                             dropout_seeds=jax_dropout_seeds(key))
    assert set(got) == set(want)
    for k in ("row_valid", "neg_valid", "attention_mask", "positive_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k, tol in (("pos_embed", 1e-6), ("neg_pool", 1e-6), ("query", 2e-5)):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("overrides", [
    {"num_hard_negatives": 3},
    {"num_hard_negatives": 2, "train_loss": "NCELoss"},
    {"use_fused_loss": False},
    {"use_fused_loss": False, "train_loss": "PairwiseLogisticLoss"},
    {"use_fused_loss": False, "train_loss": "AlignmentContrastiveLoss"},
], ids=["hard-infonce", "hard-nce", "plain-infonce", "plain-logistic", "plain-aligncontrastive"])
def test_plain_objectives_match_jax(monkeypatch, overrides):
    """Where the fused loss is off the objective is the plain loss head
    over compute_embeds' rows, as JAX's XLA pipeline computes it."""
    jcfg, tcfg = configs(compute_dtype="float32", **overrides)
    jparams, table, batch = make_case(jcfg, seed=8, disjoint=True)
    key = jax.random.key(10)
    patch_grad_passthrough(monkeypatch)
    assert TTS._fused_objective(tcfg, {}) is None
    want_loss, want = jax_loss_and_grads(jcfg, jparams, table, batch, key)
    got_loss, got = port_loss_and_grads(tcfg, jparams, table, batch, jax_dropout_seeds(key))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert_grads_close(got, want, 1e-3)


def test_alignment_fused_objective_matches_jax(monkeypatch):
    """AlignmentLoss through the fused loss has no pool term: the plain
    cosine sum over valid rows, as the JAX ``_fused_objective`` has it."""
    jcfg, tcfg = configs(compute_dtype="float32", train_loss="AlignmentLoss")
    jparams, table, batch = make_case(jcfg, seed=9)
    key = jax.random.key(11)
    patch_grad_passthrough(monkeypatch)
    force_jax_kernels(monkeypatch)
    want_loss, want = jax_loss_and_grads(jcfg, jparams, table, batch, key)
    got_loss, got = port_loss_and_grads(tcfg, jparams, table, batch, jax_dropout_seeds(key))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert_grads_close(got, want, 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_logs_step_matches_jax(monkeypatch, dtype):
    """The logging step on a catalog the table gate admits: both take the
    pool objective, log every head, the logits and the batch statistics
    under the same keys, and train on the kernel's objective while logging
    the plain loss head."""
    f32 = dtype == "float32"
    jcfg, tcfg = configs(compute_dtype=dtype, mask_false_negatives=f32)
    jparams, table, batch = make_case(jcfg, seed=10, disjoint=True)
    key = jax.random.key(12)
    patch_grad_passthrough(monkeypatch)
    force_jax_kernels(monkeypatch)
    want_logs, want = jax_step(jcfg, jparams, table, batch, key, full_logs=True)
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    seeds = jax_dropout_seeds(key)
    loss, grads, logs = TTS.make_loss_and_grad(tcfg, full_logs=True)(
        params, torch.from_numpy(table), batch, seeds)
    assert set(logs) | {"grad/global_norm"} == set(want_logs)
    assert len(want_logs) == 7 + 7 + 9 + 7 + 1
    rtol, atol = (1e-4, 1e-5) if f32 else (2.0**-6, 2.0**-8)
    for k, v in logs.items():
        assert v.dim() == 0 and v.dtype == torch.float32 and not v.requires_grad, k
        np.testing.assert_allclose(float(v), float(want_logs[k]), rtol=rtol, atol=atol, err_msg=k)
    assert_grads_close([g.numpy() for g in TT.tree_leaves(grads)], want, 1e-3 if f32 else 2.0**-6)
    # the objective is the kernel's, which rounds the queries to bf16
    # (2**-9 relative; exact under bf16 compute), the log the plain f32
    # head's
    np.testing.assert_allclose(float(loss), float(logs["loss/InfoNCELoss"]), rtol=2.0**-8)
    # the step takes the logging variant by default, as in JAX
    state = TTS.init_train_state(tcfg, params)
    _, step_logs = TTS.make_train_step(tcfg)(state, torch.from_numpy(table), batch, seeds)
    assert set(step_logs) == set(want_logs)


@pytest.mark.parametrize("train_loss", ["ContrastiveLoss", "PairwiseHingeLoss",
                                        "PairwiseLogisticLoss", "NCELoss",
                                        "AlignmentContrastiveLoss"])
@pytest.mark.parametrize(("full_logs", "dtype"), [(False, "float32"), (True, "float32"),
                                                  (False, "bfloat16")],
                         ids=["hot-f32", "logging-f32", "hot-bf16"])
def test_pairwise_fused_objectives_match_jax_kernel_path(monkeypatch, train_loss, full_logs,
                                                         dtype):
    """The pairwise objectives through the fused loss: the pairwise pool
    kernels over compute_embeds' rows (L2-normalized first for the cosine
    heads), plus NCELoss's positive term and AlignmentContrastiveLoss's
    alignment term, against JAX with its pairwise kernel in interpret
    mode.  f32 with the mask on (pos and neg from disjoint ranges, as for
    the pool InfoNCE) at the table path's bounds.  bf16 with the mask off
    at the file's bf16 bounds: loss 2**-10 (measured <= 3.5e-4),
    gradients 2**-6 (measured <= 9.9e-3).  Margin 0.8 for the heads
    with the positive in their score: at margin 0 the hinge head with the
    mask on is zero (every counted score is below its positive).  Margin 1
    for the cosine heads, which count the cosines above 1 - margin: at 0.8
    ContrastiveLoss's loss is a sum of a few relu terms of bf16 cosines,
    1.0e-3 from JAX's.  The logging step logs the plain f32 head
    (``loss/{name}``) and trains on the kernel's objective over
    bf16-rounded rows: the two differ, in both packages.

    The bf16 batch has every position valid.  A masked position's
    positive or pool row is a zero row; JAX's gradient of its L2
    normalization is NaN there (0 * inf in the norm's VJP), and under bf16
    JAX's one-hot gather backward spreads it into the input projection's
    gradient.  Torch's norm takes the subgradient 0, so the port's
    gradients stay finite."""
    f32 = dtype == "float32"
    margin = 1.0 if train_loss in ("ContrastiveLoss", "AlignmentContrastiveLoss") else 0.8
    jcfg, tcfg = configs(compute_dtype=dtype, mask_false_negatives=f32, train_loss=train_loss,
                         margin=margin)
    jparams, table, batch = make_case(jcfg, n_items=80, seed=12, disjoint=True, full=not f32)
    key = jax.random.key(13)
    patch_grad_passthrough(monkeypatch)
    force_jax_kernels(monkeypatch)
    want_logs, want = jax_step(jcfg, jparams, table, batch, key, full_logs=full_logs)
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    loss, grads, logs = TTS.make_loss_and_grad(tcfg, full_logs=full_logs)(
        params, torch.from_numpy(table), batch, jax_dropout_seeds(key))
    name = f"loss/{train_loss}"
    if full_logs:  # the plain f32 head, logged beside the kernel's objective
        np.testing.assert_allclose(float(logs[name]), float(want_logs[name]), rtol=1e-4,
                                   atol=1e-5)
    else:  # the hot step logs its objective
        assert float(logs[name]) == float(loss)
        np.testing.assert_allclose(float(loss), float(want_logs[name]),
                                   rtol=1e-5 if f32 else 2.0**-10)
    assert_grads_close([g.numpy() for g in TT.tree_leaves(grads)], want,
                       1e-3 if f32 else 2.0**-6)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clipped"])
def test_accumulation_matches_optax_multisteps(k, clip):
    """The accumulating flat update against the JAX package's optimizer for
    ``accumulate_grad_batches = k``: ``optax.MultiSteps`` around clipping
    and ``optax.adamw``, fed the same k + 1 gradients.  The parameters
    after each step within rtol 1e-6 (f32 elementwise arithmetic), left
    bit for bit as they were on the steps that only accumulate."""
    n = 1000
    rng = np.random.default_rng(k)
    jcfg, tcfg = configs(learning_rate=3e-3, weight_decay=0.05, gradient_clip_val=clip,
                         accumulate_grad_batches=k)
    opt = JTS.make_optimizer(jcfg)
    p = rng.normal(size=n).astype(np.float32)
    jp, tp = jnp.asarray(p), torch.from_numpy(p.copy())
    jstate = opt.init(jp)
    tstate = TTS.init_train_state(tcfg, {"w": tp}).opt_state
    tupdate = TTS.make_flat_update(tcfg)
    for i in range(k + 1):
        g = (2.0 * rng.normal(size=n)).astype(np.float32)
        updates, jstate = opt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        before = tp
        tp, tstate, tnorm = tupdate(tp, torch.from_numpy(g), tstate)
        np.testing.assert_allclose(float(tnorm), float(np.linalg.norm(g)), rtol=1e-6)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tstate.acc.numpy(), np.asarray(jstate.acc_grads), rtol=1e-6,
                                   atol=1e-9)
        assert tstate.mini_step == int(jstate.mini_step) == (i + 1) % k
        assert int(tstate.count) == int(optax.tree_utils.tree_get(jstate.inner_opt_state,
                                                                  "count"))
        if i != k - 1:
            assert torch.equal(tp, before)


def test_accumulating_step_applies_the_mean_gradient():
    """The port's CPU step with ``accumulate_grad_batches=2``: the first
    step leaves the parameters bit for bit as they were and logs its own
    gradient's norm; the second applies the flat update to the mean of the
    two steps' gradients from ``make_loss_and_grad``, formed as
    ``optax.MultiSteps`` forms it (``g1 + (g2 - g1) / 2``)."""
    jcfg, tcfg = configs(accumulate_grad_batches=2, gradient_clip_val=1.0)
    jparams, table, _ = make_case(jcfg, seed=14)
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batches = [make_batch(s, 40) for s in (15, 16)]
    gen = torch.Generator().manual_seed(2)
    seeds = [TTS.draw_dropout_seeds(gen, tcfg) for _ in batches]
    tab = torch.from_numpy(table)
    grads = [TTS.flatten(TTS.make_loss_and_grad(tcfg)(params, tab, b, s)[1])
             for b, s in zip(batches, seeds)]
    step = TTS.make_train_step(tcfg, full_logs=False)
    state0 = TTS.init_train_state(tcfg, params)
    state1, logs1 = step(state0, tab, batches[0], seeds[0])
    torch.testing.assert_close(TTS.flatten(state1.params), TTS.flatten(params), rtol=0, atol=0)
    assert float(logs1["grad/global_norm"]) == float(torch.sqrt(torch.sum(grads[0] * grads[0])))
    assert int(state1.opt_state.count) == 0 and state1.opt_state.mini_step == 1
    state2, logs2 = step(state1, tab, batches[1], seeds[1])
    mean = grads[0] + (grads[1] - grads[0]) / torch.full((), 2.0)
    plain = TTS.make_flat_update(dataclasses.replace(tcfg, accumulate_grad_batches=1))
    want_p, want_opt, _ = plain(TTS.flatten(params), mean, state0.opt_state)
    torch.testing.assert_close(TTS.flatten(state2.params), want_p, rtol=0, atol=0)
    torch.testing.assert_close(state2.opt_state.mu, want_opt.mu, rtol=0, atol=0)
    assert int(state2.opt_state.count) == 1 and state2.opt_state.mini_step == 0
    assert not state2.opt_state.acc.any() and state2.step == 2
    assert float(logs2["grad/global_norm"]) == float(torch.sqrt(torch.sum(grads[1] * grads[1])))


def test_dropout_seeds_from_a_generator():
    _, tcfg = configs()
    a = TTS.draw_dropout_seeds(torch.Generator().manual_seed(3), tcfg)
    b = TTS.draw_dropout_seeds(torch.Generator().manual_seed(3), tcfg)
    assert a == b and len(a) == 1 + 3 * LAYERS and len(set(a)) == len(a)
    assert all(0 <= v < 2**32 for v in a)


def test_train_config_matches_jax_fields_and_loads_its_json():
    jcfg = JaxTrainConfig(input_dim=384, hidden_size=128, num_hidden_layers=4,
                          num_attention_heads=8, intermediate_size=512, max_seq_length=32,
                          learning_rate=1e-3, max_epochs=16, gradient_clip_val=1.0)
    tcfg = TrainConfig.from_json(jcfg.model_dump_json())
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    assert names == set(JaxTrainConfig.model_fields)

    def plain(value):  # the nested index configs as dicts
        if dataclasses.is_dataclass(value):
            return dataclasses.asdict(value)
        return value.model_dump() if hasattr(value, "model_dump") else value

    for name in names:
        assert plain(getattr(tcfg, name)) == plain(getattr(jcfg, name)), name
        assert plain(getattr(TrainConfig(), name)) == plain(getattr(JaxTrainConfig(), name)), name
    with pytest.raises(ValueError, match="train_loss"):
        TrainConfig(train_loss="BPR")
