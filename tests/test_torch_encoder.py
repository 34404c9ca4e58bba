"""The port's encoder and recommender model against the JAX package on
the CPU: the same weights (``params_from_jax``, or a JAX-saved
``params.npz``), the same inputs.

The JAX encoder on the CPU runs its XLA layer stack; the port runs its
plain fused layer.  Tolerances:
- f32: 5e-5 abs/rel over an embedding LayerNorm and two layers (the JAX
  package's fused-vs-XLA bound is 2e-5 per layer).
- bf16: outputs after a LayerNorm (|y| < 8) may be one ulp apart per
  layer wherever an intermediate bf16 rounding flips: at most 2**-4 per
  layer, a mean abs error of at most 2**-8.  That holds at the model's
  own init scale (initializer_range 0.02, used here); with weights five
  times larger the mean error passes 2**-8, because the XLA stack computes
  its GELU in bf16 where the fused layer (the JAX kernel's too) uses f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.configs import ModelConfig as JaxModelConfig
from transformer_recommenders_tpu.models import recommender as JR
from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu_torch.configs import ModelConfig
from transformer_recommenders_tpu_torch.models import recommender as TR
from transformer_recommenders_tpu_torch.models import transformer as TT

LAYERS = 2
SETTINGS = dict(input_dim=48, hidden_size=128, num_hidden_layers=LAYERS,
                num_attention_heads=8, intermediate_size=256, max_seq_length=16,
                initializer_range=0.02)


def configs(**overrides):
    kw = {**SETTINGS, **overrides}
    return JaxModelConfig(**kw), ModelConfig(**kw)


def inputs(seed=0, b=3, s=16, d=48):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    x[0, 11:] = 0.0  # padded tails: the mask comes from "any nonzero component"
    x[2, 4:] = 0.0
    return x


def assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
        return
    err = np.abs(got - want)
    assert err.max() <= LAYERS * 2.0**-4, err.max()
    assert err.mean() <= 2.0**-8, err.mean()


@pytest.mark.parametrize("pooling", ["mean", "max", "cls", "lasttoken"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(pooling, dtype):
    jcfg, tcfg = configs(pooling_mode=pooling, compute_dtype=dtype,
                         is_normalized=pooling == "mean")
    jparams = JT.init_transformer_params(jax.random.key(3), jcfg)
    tparams = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = inputs()
    want = JT.transformer_encode(jparams, jcfg, jnp.asarray(x))
    got = TT.transformer_encode(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(got["attention_mask"].numpy(),
                                  np.asarray(want["attention_mask"]))
    assert got["token_embeddings"].dtype == got["sentence_embedding"].dtype == torch.float32
    assert_close(got["token_embeddings"], want["token_embeddings"], dtype)
    assert_close(got["sentence_embedding"], want["sentence_embedding"], dtype)


def test_encoder_with_dropout_matches_jax():
    """Training-mode dropout: the port takes the uint32 site seeds the JAX
    encoder derives from its key (embedding site, then 3 per layer)."""
    jcfg, tcfg = configs(compute_dtype="float32", hidden_dropout=0.2, attention_dropout=0.2)
    jparams = JT.init_transformer_params(jax.random.key(4), jcfg)
    tparams = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = inputs(1)
    key = jax.random.key(11)
    want = JT.transformer_encode(jparams, jcfg, jnp.asarray(x), dropout_rng=key)
    rngs = jax.random.split(key, 2)
    layer_keys = jax.random.split(rngs[1], 3 * LAYERS).reshape(LAYERS, 3)
    seeds = [int(JT._dropout_seed(rngs[0]))] + [
        int(s) for i in range(LAYERS) for s in np.asarray(JT._dropout_site_seeds(layer_keys[i]))
    ]
    got = TT.transformer_encode(tparams, tcfg, torch.from_numpy(x), dropout_seeds=seeds)
    no_drop = TT.transformer_encode(tparams, tcfg, torch.from_numpy(x))
    assert_close(got["token_embeddings"], want["token_embeddings"], "float32")
    assert (got["token_embeddings"] - no_drop["token_embeddings"]).abs().max() > 0.1


def test_long_sequences_are_not_ported_yet():
    """Sequences longer than 64 (configs/ml25m_ccl.yaml's 128) no longer
    raise: the fused-layer gate sends them to the layer stack, which
    matches JAX's (f32, dropout on; ``test_torch_layer_stack.py`` has the
    bf16 and gradient cases)."""
    jcfg, tcfg = configs(max_seq_length=128, input_dim=None, hidden_size=16,
                         num_attention_heads=2, intermediate_size=16, compute_dtype="float32",
                         hidden_dropout=0.1, attention_dropout=0.1)
    jparams = JT.init_transformer_params(jax.random.key(8), jcfg)
    params = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = np.random.default_rng(4).normal(size=(2, 128, 16)).astype(np.float32)
    x[1, 70:] = 0.0
    key = jax.random.key(9)
    rngs = jax.random.split(key, 2)
    layer_keys = jax.random.split(rngs[1], 3 * LAYERS).reshape(LAYERS, 3)
    seeds = [int(JT._dropout_seed(rngs[0]))] + [
        int(s) for i in range(LAYERS) for s in np.asarray(JT._dropout_site_seeds(layer_keys[i]))
    ]
    want = JT.transformer_encode(jparams, jcfg, jnp.asarray(x), dropout_rng=key)
    got = TT.transformer_encode(params, tcfg, torch.from_numpy(x), dropout_seeds=seeds)
    assert got["token_embeddings"].shape == (2, 128, 16)
    assert_close(got["token_embeddings"], want["token_embeddings"], "float32")


def test_param_tree_order_matches_jax_leaves():
    jcfg, tcfg = configs()
    jparams = JT.init_transformer_params(jax.random.key(0), jcfg)
    tparams = TT.init_transformer_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jleaves = jax.tree.leaves(jparams)
    tleaves = TT.tree_leaves(tparams)
    assert [tuple(a.shape) for a in jleaves] == [tuple(t.shape) for t in tleaves]
    rebuilt = TT.tree_unflatten(tparams, [torch.from_numpy(np.array(a)) for a in jleaves])
    for a, t in zip(jleaves, TT.tree_leaves(rebuilt)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recommender_model_loads_jax_artifact(tmp_path, dtype):
    """A JAX-saved model (config.json + params.npz) loads in the port and
    gives the same encodings through the item-index entry points; the
    port's save loads back in the JAX package."""
    jcfg, _ = configs(compute_dtype=dtype)
    jmodel = JR.RecommenderModel(jcfg, rng=jax.random.key(5))
    rng = np.random.default_rng(2)
    item_ids = [f"i{k}" for k in range(40)]
    emb = rng.normal(size=(40, 48)).astype(np.float32)
    jmodel.configure_embeddings(item_ids, emb)
    jmodel.save(tmp_path / "jax")

    tmodel = TR.RecommenderModel.load(tmp_path / "jax", device="cpu")
    tmodel.configure_embeddings(item_ids, emb)
    for a, t in zip(jax.tree.leaves(jmodel.params), TT.tree_leaves(tmodel.params)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())

    idx = rng.integers(0, 41, size=(4, 20))  # longer than max_seq: last window kept
    idx[1, 15:] = 0
    want = jmodel(idx)
    got = tmodel(idx)
    assert_close(got["sentence_embedding"], want["sentence_embedding"], dtype)
    history = ["i3", "missing", "i7", "i1"]
    assert_close(tmodel.encode(history), jmodel.encode(history), dtype)

    tmodel.save(tmp_path / "torch")
    back = JR.RecommenderModel.load(tmp_path / "torch")
    for a, t in zip(jax.tree.leaves(back.params), TT.tree_leaves(tmodel.params)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())


def test_retrieval_item_embeddings_match_jax():
    jcfg, tcfg = configs(compute_dtype="bfloat16")
    jparams = JT.init_transformer_params(jax.random.key(6), jcfg)
    tparams = TT.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    emb = np.random.default_rng(3).normal(size=(30, 48)).astype(np.float32)
    want = JR.retrieval_item_embeddings(jparams, jcfg, JR.build_item_table(emb))
    got = TR.retrieval_item_embeddings(tparams, tcfg, TR.build_item_table(emb, device="cpu"))
    assert got.shape == (30, 128)
    # one bf16 dense: products exact in f32, sums in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2**-7, atol=2**-9)
