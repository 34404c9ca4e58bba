"""The scale configuration, ``configs/ml25m_ccl.yaml`` (6 layers, d=256,
FFN 1024, 8 heads, seq 128, ContrastiveLoss at margin 0.5, a 62k-item
catalog behind a learned 384 -> 256 projection), through the port on the
CPU, against the JAX package.

- The port's YAML reader (``training/cli.py``, ``--print_config``) gives
  JAX's ``TrainConfig`` and ``SeqDataModuleConfig`` field for field, the
  nested ``mesh:`` included, as the file stands and with the overrides of
  ``scripts/quality_run_25m.py`` (a 1x1 mesh; synthetic data at ML-25M's
  counts, the hash embedder).
- Train steps at this configuration's loss, margin, sequence length and
  attention (split at s > 64, the one-sweep LayerNorm variance), cut to
  narrow widths (d=32, 2 layers, 4 heads), over a catalog of more than
  ``ONEHOT_LOOKUP_MAX_ITEMS`` rows, so both packages look rows up exactly
  (JAX's ``jnp.take``, the port's f32-row gather):
  - the hot step's loss and raw gradients against JAX's with its pairwise
    kernel in interpret mode (the TPU's objective), the catalog gathered
    before its projection (3 * B * S < N, ``bench_config4.py``'s branch).
    f32 with the mask on, pos and neg from disjoint ranges: loss rtol
    1e-5, gradients 1e-3 of each leaf's max abs value (the bounds of
    ``test_torch_train_state.py``).  bf16 with the mask off, JAX run op by
    op as in ``test_torch_layer_stack.py``: loss 2**-10, gradients 2**-6
    (measured 2.9e-4 and 6.0e-3).  Every position is valid: in this branch JAX's
    gradient of the cosine normalization is NaN at a masked position's
    zero row, and its re-zeroing multiply carries the NaN into the input
    projection's gradient (``test_cosine_zero_rows_...`` below);
  - the projected-catalog branch (N <= 3 * B * S, the branch of the
    configuration's B=256) with padded positions, against JAX's CPU step
    as it runs (the plain loss heads in f32; the port with
    ``use_fused_loss=False`` computes the same heads): loss rtol 1e-5,
    gradients 1e-3 in f32;
  - three steps along JAX's trajectory (AdamW), each step's loss and raw
    gradients from JAX's parameters held to JAX's, f32, the mask off:
    loss rtol 1e-5, gradients 1e-3;
  - at padded positions, the port's gradients are finite in both branches
    (it takes the norm's subgradient 0 at a zero row), where JAX's are NaN
    in the gather-first branch and finite in the projected one.
- The plain pairwise functions at D=256 (the configuration's width)
  against JAX's kernels in interpret mode, on a small R (the bounds of
  ``test_torch_fused_pairwise.py``: rows 1e-5, gradients 2**-7).
"""

import contextlib
import dataclasses
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_fused_pairwise import assert_grad_close, bf16_exact
from test_torch_train_state import (
    assert_grads_close,
    jax_dropout_seeds,
    make_batch,
    patch_grad_passthrough,
)
from transformer_recommenders_tpu.configs import SeqDataModuleConfig as JaxDataConfig
from transformer_recommenders_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_recommenders_tpu.models import recommender as JR
from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu.ops import fused_pairwise as JFP
from transformer_recommenders_tpu.training import train_state as JTS
from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig, TrainConfig
from transformer_recommenders_tpu_torch.models import recommender as TR
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.ops import fused_pairwise as TFP
from transformer_recommenders_tpu_torch.training import cli
from transformer_recommenders_tpu_torch.training import train_state as TTS

REPO = pathlib.Path(__file__).resolve().parents[1]
SCALE_YAML = REPO / "configs" / "ml25m_ccl.yaml"
# scripts/quality_run_25m.py's overrides of the file (its defaults: 2
# epochs, its own directories)
QUALITY_RUN_MODEL = dict(max_epochs=2, early_stopping_patience=0, log_every_n_steps=100,
                         steps_per_dispatch=8, checkpoint_every_epoch=False,
                         ckpt_dir="/tmp/xrt_25m_ckpt",
                         mesh={"data_axis_size": 1, "model_axis_size": 1})
QUALITY_RUN_DATA = dict(dataset="synthetic", embedder="hash", data_dir="/tmp/xrt_25m_data",
                        synthetic_num_users=162_000, synthetic_num_items=62_000,
                        synthetic_num_events=25_000_000)


def plain(value):
    """A config field as plain data: nested configs as dicts."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    return value.model_dump() if hasattr(value, "model_dump") else value


def port_configs(argv):
    """The port CLI's ``--print_config`` output for ``argv``, as configs."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as done:
        cli.main(["fit", "--config", str(SCALE_YAML), "--print_config", *argv])
    assert done.value.code == 0
    printed = json.loads(out.getvalue())
    return TrainConfig.from_dict(printed["model"]), SeqDataModuleConfig.from_dict(printed["data"])


def overrides_argv(section, values):
    """``--section.key value`` pairs, a nested mapping as dotted keys."""
    argv = []
    for key, value in values.items():
        if isinstance(value, dict):
            argv += overrides_argv(f"{section}.{key}", value)
        else:
            argv += [f"--{section}.{key}", str(value)]
    return argv


@pytest.mark.parametrize("overridden", [False, True], ids=["as-is", "quality-run"])
def test_scale_yaml_reads_as_jax_train_config(overridden):
    payload = yaml.safe_load(SCALE_YAML.read_text())
    argv = []
    if overridden:  # as scripts/quality_run_25m.py updates the file's payload
        payload["model"].update(QUALITY_RUN_MODEL)
        payload["data"].update(QUALITY_RUN_DATA)
        argv = overrides_argv("model", QUALITY_RUN_MODEL) + overrides_argv("data",
                                                                           QUALITY_RUN_DATA)
    want = JaxTrainConfig.model_validate(payload["model"])
    want_data = JaxDataConfig.model_validate(payload["data"])
    got, got_data = port_configs(argv)
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    assert names == set(JaxTrainConfig.model_fields)
    for name in names:
        assert plain(getattr(got, name)) == plain(getattr(want, name)), name
    for name in (f.name for f in dataclasses.fields(SeqDataModuleConfig)):
        assert plain(getattr(got_data, name)) == plain(getattr(want_data, name)), name
    mesh = (1, 1) if overridden else (-1, 2)
    assert (got.mesh.data_axis_size, got.mesh.model_axis_size) == mesh
    # the model section as the file gives it, whatever the overrides
    assert (got.hidden_size, got.num_hidden_layers, got.intermediate_size,
            got.max_seq_length, got.train_loss, got.margin) == (256, 6, 1024, 128,
                                                                 "ContrastiveLoss", 0.5)


LAYERS = 2  # as test_torch_train_state.LAYERS, whose dropout seeds are JAX's
NARROW = dict(input_dim=48, hidden_size=32, num_hidden_layers=LAYERS, num_attention_heads=4,
              intermediate_size=64)
CATALOG = 16_500  # more than ONEHOT_LOOKUP_MAX_ITEMS = 16,384


def scale_configs(**overrides):
    """The model section of ml25m_ccl.yaml at narrow widths."""
    model = {**yaml.safe_load(SCALE_YAML.read_text())["model"], **NARROW, **overrides}
    model.pop("mesh")
    return JaxTrainConfig(**model), TrainConfig(**model)


def scale_case(jcfg, *, b, seed, disjoint, full):
    jparams = JT.init_transformer_params(jax.random.key(seed), jcfg)
    emb = np.random.default_rng(seed + 1).normal(size=(CATALOG, jcfg.input_dim))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    table = np.concatenate([np.zeros((1, jcfg.input_dim), np.float32), emb])
    batch = make_batch(seed + 2, CATALOG, b=b, s=jcfg.max_seq_length, disjoint=disjoint,
                       full=full)
    return jparams, table, batch


def force_jax_pairwise(monkeypatch):
    """JAX's TPU objective on the CPU: the fused loss with its pairwise
    kernel in interpret mode.  The lookup stays ``jnp.take`` (the TPU's
    too above ONEHOT_LOOKUP_MAX_ITEMS) and d=32 runs the XLA stack."""
    monkeypatch.setattr(JTS, "_fused_loss_enabled", lambda config: True)
    pairwise_loss = JFP.fused_pairwise_loss
    monkeypatch.setattr(JFP, "fused_pairwise_loss",
                        lambda *a, **kw: pairwise_loss(*a, **{**kw, "interpret": True,
                                                              "tile_rows": 64,
                                                              "tile_cols": 128}))


def jax_grads(jcfg, jparams, table, batch, key):
    """JAX's hot-step loss and raw gradients (under patch_grad_passthrough)."""
    step = JTS.make_train_step(jcfg, full_logs=False)
    state, logs = step(JTS.init_train_state(jcfg, jparams), jnp.asarray(table),
                       {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return (float(logs[f"loss/{jcfg.train_loss}"]),
            [np.asarray(a) for a in jax.tree.leaves(state.params)])


def port_grads(tcfg, jparams, table, batch, seeds):
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    loss, grads, _ = TTS.make_loss_and_grad(tcfg)(params, torch.from_numpy(table), batch, seeds)
    return float(loss), [g.numpy() for g in TT.tree_leaves(grads)]


def test_scale_path_takes_the_stack_split_attention_and_exact_rows():
    _, wide = scale_configs(hidden_size=256, num_attention_heads=8)
    s = wide.max_seq_length
    assert s == 128 and wide.attention_impl == "auto"  # split at s > 64
    assert not TT._fused_layer_mode(wide, s)  # d=256 at seq 128: the layer stack
    assert CATALOG + 1 > TR.ONEHOT_LOOKUP_MAX_ITEMS == JR.ONEHOT_LOOKUP_MAX_ITEMS
    table = torch.randn(CATALOG + 1, 8, dtype=torch.float32)
    idx = torch.tensor([0, 5, CATALOG])
    rows = TR.fast_table_lookup(table, idx, compute_dtype="bfloat16")
    assert rows.dtype == torch.float32 and torch.equal(rows, table[idx])  # exact f32 rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_hot_step_matches_jax_pairwise_kernel(monkeypatch, dtype):
    """Gather-first branch (3 * B * S = 768 < 16,501 catalog rows)."""
    f32 = dtype == "float32"
    jcfg, tcfg = scale_configs(compute_dtype=dtype, mask_false_negatives=f32)
    jparams, table, batch = scale_case(jcfg, b=2, seed=20, disjoint=True, full=True)
    assert table.shape[0] > 3 * batch["history_item_idx"].size
    key = jax.random.key(21)
    patch_grad_passthrough(monkeypatch)
    force_jax_pairwise(monkeypatch)
    # bf16: JAX op by op, rounding every bf16 op's result as the port's
    # stack does (under jax.jit XLA keeps some of the stack's bf16
    # intermediates in f32; at seq 128 that moves these gradients by up to
    # 0.27 of a leaf's max abs, where op by op reads 6.0e-3)
    with contextlib.nullcontext() if f32 else jax.disable_jit():
        want_loss, want = jax_grads(jcfg, jparams, table, batch, key)
    got_loss, got = port_grads(tcfg, jparams, table, batch, jax_dropout_seeds(key))
    assert got_loss > 0.0
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5 if f32 else 2.0**-10)
    assert_grads_close(got, want, 1e-3 if f32 else 2.0**-6)


def test_scale_projected_branch_matches_jax_cpu_step(monkeypatch):
    """The projected-catalog branch (16,501 rows <= 3 * B * S = 16,896 at
    B=44), padded positions included, f32: the plain loss heads in both."""
    jcfg, tcfg = scale_configs(compute_dtype="float32", use_fused_loss=False)
    jparams, table, batch = scale_case(jcfg, b=44, seed=22, disjoint=True, full=False)
    assert table.shape[0] <= 3 * batch["history_item_idx"].size
    assert (batch["pos_item_idx"] == 0).any()  # zero rows reach the normalization
    key = jax.random.key(23)
    patch_grad_passthrough(monkeypatch)
    want_loss, want = jax_grads(jcfg, jparams, table, batch, key)
    got_loss, got = port_grads(tcfg, jparams, table, batch, jax_dropout_seeds(key))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert_grads_close(got, want, 1e-3)


def test_scale_train_steps_match_jax(monkeypatch):
    """Three steps along JAX's own trajectory (its ``make_train_step``,
    AdamW at the configuration's rate, three batches): at each step the
    port's loss and raw gradients from JAX's current parameters, against
    JAX's (its step with the update patched to pass the gradients
    through), f32 with the mask off (a random model's cosines rarely
    reach a positive above the margin, so with the mask on such a batch
    counts almost no term): loss rtol 1e-5, gradients 1e-3 of each leaf's
    max abs value.  Each step starts from the same parameters in both
    packages: along two trajectories, f32 noise at a relu's kink would
    compound."""
    jcfg, tcfg = scale_configs(compute_dtype="float32", mask_false_negatives=False)
    jparams, table, _ = scale_case(jcfg, b=2, seed=28, disjoint=True, full=True)
    batches = [make_batch(29 + i, CATALOG, b=2, s=jcfg.max_seq_length, disjoint=True,
                          full=True) for i in range(3)]
    keys = [jax.random.key(32 + i) for i in range(3)]
    force_jax_pairwise(monkeypatch)
    jstep = JTS.make_train_step(jcfg, full_logs=False)  # with AdamW
    patch_grad_passthrough(monkeypatch)
    jstate = JTS.init_train_state(jcfg, jparams)
    losses = []
    for batch, key in zip(batches, keys):
        want_loss, want = jax_grads(jcfg, jstate.params, table, batch, key)
        got_loss, got = port_grads(tcfg, jstate.params, table, batch, jax_dropout_seeds(key))
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
        assert_grads_close(got, want, 1e-3)
        losses.append(got_loss)
        jstate, _ = jstep(jstate, jnp.asarray(table),
                          {k: jnp.asarray(v) for k, v in batch.items()}, key)
    assert min(losses) > 0.0, losses


@pytest.mark.parametrize(("b", "projected"), [(2, False), (44, True)],
                         ids=["gather-first", "projected"])
def test_cosine_zero_rows_get_a_zero_gradient(monkeypatch, b, projected):
    """A masked position's positive (index 0) is a zero row, normalized
    by the cosine head.  The port's gradients stay finite in both
    branches.  JAX's are NaN where the gathered rows are re-zeroed by a
    multiply after the projection (0 times the norm's NaN), and finite
    where the pad row of the projected catalog is zeroed by
    ``.at[0].set(0)``, whose transpose drops its cotangent."""
    jcfg, tcfg = scale_configs(compute_dtype="float32", mask_false_negatives=False, learning_rate=0.02)
    jparams, table, batch = scale_case(jcfg, b=b, seed=26, disjoint=True, full=False)
    assert (table.shape[0] <= 3 * batch["history_item_idx"].size) == projected
    key = jax.random.key(27)
    patch_grad_passthrough(monkeypatch)
    force_jax_pairwise(monkeypatch)
    _, want = jax_grads(jcfg, jparams, table, batch, key)
    _, got = port_grads(tcfg, jparams, table, batch, jax_dropout_seeds(key))
    assert all(np.isfinite(g).all() for g in got)
    assert all(np.isfinite(w).all() for w in want) == projected
    if projected:
        assert_grads_close(got, want, 1e-3)


def pairwise_case(seed, r=48, rn=40, d=256):
    rng = np.random.default_rng(seed)
    q = bf16_exact(rng.normal(size=(r, d)) / 8)
    p = bf16_exact(rng.normal(size=(r, d)) / 8)
    n = bf16_exact(rng.normal(size=(rn, d)) / 8)
    p[0] = -4.0 * q[0]
    row_valid = rng.random(r) > 0.2
    row_valid[0] = True
    neg_valid = rng.random(rn) > 0.2
    return q, p, n, row_valid, neg_valid


@pytest.mark.parametrize(("head", "margin"), [("ContrastiveLoss", 0.5),
                                              ("PairwiseHingeLoss", 0.3),
                                              ("PairwiseLogisticLoss", 0.0),
                                              ("NCELoss", 0.5)])
@pytest.mark.parametrize("mask_fn", [True, False], ids=["fnmask", "nofnmask"])
def test_pairwise_plain_versions_match_jax_at_d256(head, margin, mask_fn):
    q, p, n, row_valid, neg_valid = pairwise_case(TFP.HEADS.index(head) + 5 * mask_fn)

    def jax_loss(q_, p_, n_):
        return JFP.fused_pairwise_loss(q_, p_, n_, jnp.asarray(row_valid), jnp.asarray(neg_valid),
                                       head=head, margin=margin, mask_false_negatives=mask_fn,
                                       tile_rows=16, tile_cols=128, interpret=True)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(n))
    tq, tp, tn = (torch.from_numpy(a).requires_grad_() for a in (q, p, n))
    got = TFP.fused_pairwise_loss(tq, tp, tn, torch.from_numpy(row_valid),
                                  torch.from_numpy(neg_valid), head=head, margin=margin,
                                  mask_false_negatives=mask_fn)
    got.backward()
    assert got.item() > 0.0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for name, g, w in zip("qpn", (tq.grad, tp.grad, tn.grad), want_grads):
        assert_grad_close(name, g, w)
