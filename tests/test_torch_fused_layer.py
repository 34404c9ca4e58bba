"""The port's plain fused layer (``fused_layer_reference``, what the CUDA
kernel computes and what the wrapper runs on CPU tensors) against the JAX
Pallas kernel in interpret mode and against the JAX XLA layer stack, from
the same numpy weights, inputs and dropout seeds.

Tolerances:
- f32: 2e-5 abs and rel, the JAX package's own fused-vs-XLA bound
  (tests/test_fused_layer.py); the port measures ~1e-6.
- bf16: every dense, the probs, the residual adds and both LayerNorms
  round to bf16, so an intermediate rounding that flips by one ulp moves
  outputs (|y| < 8 after LayerNorm) by about one ulp: at most 2**-4 (two
  ulps at |y| in [4, 8)), and a mean abs error of at most 2**-8 (half an
  ulp at |y| ~ 1).  Pallas interpret mode on the CPU rounds its bf16 dots
  differently from both the XLA stack and its own code run outside Pallas
  (measured: 45% of outputs one ulp apart); the same bounds hold there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.configs import ModelConfig
from transformer_recommenders_tpu.models import transformer as T
from transformer_recommenders_tpu.ops.fused_layer import fused_layer as jax_fused_layer
from transformer_recommenders_tpu_torch.ops import fused_layer as tfl

F32_TOL = 2e-5
BF16_MAX = 2.0**-4
BF16_MEAN = 2.0**-8


def layer_weights(rng, d, f):
    """One layer's weights with O(1) activations (std 1/sqrt(fan_in))."""
    def dense(i, o):
        return {"w": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                "b": (0.1 * rng.normal(size=(o,))).astype(np.float32)}

    def ln(n):
        return {"scale": (1 + 0.1 * rng.normal(size=(n,))).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(n,))).astype(np.float32)}

    return {"qkv": dense(d, 3 * d), "out": dense(d, d), "ffn_in": dense(d, f),
            "ffn_out": dense(f, d), "ln1": ln(d), "ln2": ln(d)}


def make_case(seed, b, s, d, f):
    rng = np.random.default_rng(seed)
    weights = layer_weights(rng, d, f)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[-1, s // 2:] = False  # a padded tail
    mask[0, s - 3:] = False
    return weights, x, mask


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def port(weights, x, mask, dtype, *, h, causal, rate, seeds, f):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    y = tfl.fused_layer(
        torch.from_numpy(x).to(tdt), to_torch(weights), torch.from_numpy(mask),
        num_heads=h, causal=causal, attn_dropout=rate, hidden_dropout=rate,
        dropout_seeds=None if seeds is None else [int(v) for v in seeds], ffn_dim=f,
    )
    assert y.dtype == tdt
    return y.float().numpy()


def assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        return
    err = np.abs(got - want)
    assert err.max() <= BF16_MAX, err.max()
    assert err.mean() <= BF16_MEAN, err.mean()


CASES = [
    # (b, s, d, h, f, dtype, causal, dropout)
    (4, 32, 128, 8, 512, "float32", True, 0.0),
    (4, 32, 128, 8, 512, "float32", True, 0.1),
    (4, 32, 128, 8, 512, "float32", False, 0.0),
    (4, 32, 128, 8, 512, "bfloat16", True, 0.0),
    (4, 32, 128, 8, 512, "bfloat16", True, 0.1),
    (4, 8, 128, 8, 48, "float32", True, 0.1),
    (4, 8, 128, 8, 48, "bfloat16", False, 0.1),
    (2, 48, 128, 8, 512, "float32", True, 0.1),
]
SEEDS = np.asarray([0x12345678, 0x9ABCDEF0, 4000000000], np.uint32)


@pytest.mark.parametrize(("b", "s", "d", "h", "f", "dtype", "causal", "rate"), CASES)
def test_reference_matches_jax_kernel_interpret(b, s, d, h, f, dtype, causal, rate):
    weights, x, mask = make_case(0, b, s, d, f)
    seeds = SEEDS if rate > 0 else None
    want = jax_fused_layer(
        jnp.asarray(x).astype(dtype), to_jax(weights), jnp.asarray(mask), num_heads=h,
        causal=causal, attn_dropout=rate, hidden_dropout=rate,
        dropout_seeds=None if seeds is None else jnp.asarray(seeds), ffn_dim=f, interpret=True,
    )
    got = port(weights, x, mask, dtype, h=h, causal=causal, rate=rate, seeds=seeds, f=f)
    assert_close(got, np.asarray(want.astype(jnp.float32)), dtype)


def _xla_layer(cfg, x, layer, mask, keys):
    """The JAX package's unfused layer (models/transformer.py layer_fn)."""
    dtype = jnp.dtype(cfg.compute_dtype)
    r1, r2, r3 = keys if keys is not None else (None, None, None)
    attn = T._dropout(T._attention(x, layer, cfg, mask, r1), cfg.hidden_dropout, r2)
    hid = T._layer_norm(x + attn, layer["ln1"], cfg.layer_norm_eps, dtype)
    ffn = T._dropout(T._ffn(hid, layer, cfg), cfg.hidden_dropout, r3)
    return T._layer_norm(hid + ffn, layer["ln2"], cfg.layer_norm_eps, dtype)


@pytest.mark.parametrize(("b", "s", "d", "h", "f", "dtype", "causal", "rate"), CASES)
def test_reference_matches_jax_xla_layer(b, s, d, h, f, dtype, causal, rate):
    weights, x, mask = make_case(1, b, s, d, f)
    cfg = ModelConfig(hidden_size=d, num_attention_heads=h, intermediate_size=f,
                      max_seq_length=s, is_decoder=causal, compute_dtype=dtype,
                      hidden_dropout=rate, attention_dropout=rate)
    keys = jax.random.split(jax.random.key(7), 3) if rate > 0 else None
    want = _xla_layer(cfg, jnp.asarray(x).astype(dtype), to_jax(weights), jnp.asarray(mask),
                      keys)
    seeds = np.asarray(T._dropout_site_seeds(keys)) if rate > 0 else None
    got = port(weights, x, mask, dtype, h=h, causal=causal, rate=rate, seeds=seeds, f=f)
    assert_close(got, np.asarray(want.astype(jnp.float32)), dtype)


def test_erf_matches_jax_polynomial():
    from transformer_recommenders_tpu.ops.fused_layer import _erf

    x = np.linspace(-5, 5, 20001).astype(np.float32)
    np.testing.assert_allclose(tfl._erf(torch.from_numpy(x)).numpy(), np.asarray(_erf(x)),
                               atol=2e-7, rtol=0)


def test_dropout_changes_output_and_is_deterministic():
    weights, x, mask = make_case(2, 2, 8, 128, 48)
    kw = dict(h=8, causal=True, f=48)
    off = port(weights, x, mask, "float32", rate=0.0, seeds=None, **kw)
    on1 = port(weights, x, mask, "float32", rate=0.3, seeds=SEEDS, **kw)
    on2 = port(weights, x, mask, "float32", rate=0.3, seeds=SEEDS, **kw)
    other = port(weights, x, mask, "float32", rate=0.3, seeds=SEEDS + 1, **kw)
    np.testing.assert_array_equal(on1, on2)
    assert np.abs(on1 - off).max() > 0.1 and np.abs(on1 - other).max() > 0.1


def test_shared_memory_plan():
    """The wrapper's shared-memory layout decides the heads per stage: all
    heads at the flagship shape, fewer at d=384 in f32, and an error for a
    shape no stage size fits."""
    limit = 232448  # an H100 block's opt-in maximum
    assert tfl.heads_per_stage(32, 128, 512, 8, 2, limit) == 8
    assert tfl.heads_per_stage(32, 384, 48, 12, 4, limit) == 6
    assert tfl.smem_bytes(32, 384, 48, 6, 4, 12) <= limit < tfl.smem_bytes(32, 384, 48, 12, 4, 12)
    with pytest.raises(ValueError, match="shared memory"):
        tfl.heads_per_stage(64, 384, 1536, 12, 4, limit)


def test_tensor_core_shared_memory_plan():
    """The bf16 forward's layout (``TcLayout`` in csrc/fused_layer.cu):
    the activations at whole m-tiles of 16 rows and the mask, 59,520 bytes
    at the flagship shape and 149,632 at path B's D=384; its scores stay
    in registers, so every head of a CTA's share runs at once."""
    limit = 232448  # an H100 block's opt-in maximum
    assert tfl.smem_bytes(32, 128, 512, 8, 2) == 3 * 32 * 136 * 2 + 32 * 520 * 2 + 32 * 4 == 59520
    assert tfl.smem_bytes(32, 384, 48, 12, 2) == 149632
    assert tfl.smem_bytes(8, 128, 48, 8, 2) == 3 * 16 * 136 * 2 + 16 * 392 * 2 + 8 * 4
    assert tfl.heads_per_stage(32, 128, 512, 8, 2, limit) == 8
    assert tfl.heads_per_stage(32, 128, 512, 8, 2, limit, cluster=2) == 4
    assert tfl.heads_per_stage(32, 384, 48, 12, 2, limit, cluster=4) == 3
    assert tfl.heads_per_stage(64, 128, 512, 8, 2, limit) == 8
    with pytest.raises(ValueError, match="shared memory"):
        tfl.heads_per_stage(64, 1024, 4096, 8, 2, limit)


H100_ACTIVE = {4: 30, 3: 39, 2: 66}  # the clusters an H100 holds at once (whole in a GPC)
H100_TC_ACTIVE = {4: 30, 2: 66}  # the bf16 forward's sizes, at one CTA an SM


@pytest.mark.parametrize(("b", "d", "h", "active", "want"), [
    (64, 128, 8, None, 2),    # serving's batch: 128 CTAs on 132 SMs
    (128, 128, 8, None, 1),   # training's batch already fills the card
    (32, 384, 12, None, 4),   # path B, were 33 clusters of 4 to fit
    (33, 128, 8, None, 4),    # 132 CTAs exactly
    (34, 128, 8, None, 2),
    (8, 96, 6, None, 2),      # 6 heads do not split in 4
    (8, 48, 4, None, 2),      # 12 q columns a CTA would cut an 8-column block
    (1, 40, 5, None, 1),
    # with the card's count (bf16 forward, one CTA an SM): path B's 32
    # clusters of 4 would run in two waves, so it takes 2 (64 CTAs, one)
    (32, 384, 12, H100_TC_ACTIVE, 2), (30, 384, 12, H100_TC_ACTIVE, 4),
    (31, 384, 12, H100_TC_ACTIVE, 2), (64, 128, 8, H100_TC_ACTIVE, 2),
    (66, 128, 8, H100_TC_ACTIVE, 2), (67, 128, 8, H100_TC_ACTIVE, 1),
])
def test_cluster_plan(b, d, h, active, want):
    got = tfl.cluster_size(b, d, h, 132, max_active=active)
    assert got == want
    assert b <= (active or {}).get(got, 132 // got) or got == 1


@pytest.mark.parametrize(("b", "d", "h", "active", "want"), [
    (32, 384, 12, None, 4),   # the seed spread's batch, one CTA an SM: 128 CTAs on 132 SMs
    (64, 384, 12, None, 2),
    (128, 384, 12, None, 1),  # a batch that fills the card alone
    (256, 384, 12, None, 1),  # the seed spread's validation batch
    (8, 48, 4, None, 4),      # 12 q columns a CTA: whole 4-column blocks in f32 (bf16 takes 2)
    (8, 72, 6, None, 3),      # 6 heads split in 3, not in 4
    (8, 80, 10, None, 2),
    (8, 40, 5, None, 1),
    (40, 384, 12, None, 3),   # 160 CTAs of 4 would not fit
    # with the H100's counts the seed spread's B=32 takes clusters of 3
    # (96 CTAs in one wave), not of 4 (128 CTAs in two)
    (30, 384, 12, H100_ACTIVE, 4), (31, 384, 12, H100_ACTIVE, 3), (32, 384, 12, H100_ACTIVE, 3),
    (39, 384, 12, H100_ACTIVE, 3), (40, 384, 12, H100_ACTIVE, 2), (66, 384, 12, H100_ACTIVE, 2),
    (67, 384, 12, H100_ACTIVE, 1),
])
def test_f32_cluster_plan(b, d, h, active, want):
    got = tfl.cluster_size(b, d, h, 132, elem=4, max_active=active)
    assert got == want
    assert b <= (active or {}).get(got, 132 // got) or got == 1
    assert h % got == 0 and d % (4 * got) == 0


@pytest.mark.parametrize(("shape", "active", "want"), [
    # the quality run's batch: two sequences a CTA, 128 CTAs in one wave on
    # 132 SMs, 64 rows a weight fragment; all 12 heads a stage
    ((256, 32, 384, 12, 48), H100_ACTIVE, (2, 1, 12, 128)),
    ((300, 32, 384, 12, 48), None, (2, 1, 12, 150)),  # past 264 a second wave: rows stay <= 64
    # path B: one sequence on a cluster of 3 (39 fit at once, 30 of 4)
    ((32, 32, 384, 12, 48), H100_ACTIVE, (1, 3, 4, 96)),
    ((32, 32, 384, 12, 48), None, (1, 4, 3, 128)),
    ((30, 32, 384, 12, 48), H100_ACTIVE, (1, 4, 3, 120)),
    # the flagship's and path C's training batches fill the card alone
    ((128, 32, 128, 8, 512), H100_ACTIVE, (1, 1, 8, 128)),
    ((128, 32, 64, 4, 256), H100_ACTIVE, (1, 1, 4, 128)),
    ((64, 32, 128, 8, 512), H100_ACTIVE, (1, 2, 4, 128)),
    # S=64 (one sequence a CTA at most), S=8 and S=16
    ((3, 64, 128, 8, 512), H100_ACTIVE, (1, 4, 2, 12)),
    ((4, 8, 128, 8, 48), H100_ACTIVE, (1, 4, 2, 16)),
    ((600, 16, 64, 4, 256), None, (4, 1, 4, 150)),
    # head widths off the k-steps of 16 (staged padded to 16): 16 heads of
    # 8 at the flagship's width, of 24 at D=384, of 4 at path C's
    ((128, 32, 128, 16, 512), H100_ACTIVE, (1, 1, 16, 128)),
    ((256, 32, 384, 16, 48), H100_ACTIVE, (2, 1, 16, 128)),
    ((32, 32, 384, 16, 48), H100_ACTIVE, (1, 2, 8, 64)),  # 16 heads: no 3
    ((128, 32, 64, 16, 256), None, (1, 1, 16, 128)),
])
def test_bf16_backward_plan(shape, active, want):
    """Pass 1 of the bf16 backward: sequences a CTA for one wave (at most
    64 rows), else the largest cluster whose B clusters fit at once, the
    most heads a stage that fit, and each plan inside the H100's 232,448
    bytes of shared memory a CTA."""
    b, s, d, h, f = shape
    limit = 232448
    plan = tfl.bwd_tc_plan(b, s, d, h, f, 132, limit, active)
    assert (plan["seqs"], plan["cluster"], plan["heads_per_stage"], plan["ctas"]) == want
    assert plan["seqs"] * s <= tfl.BWD_ROWS and (plan["seqs"] == 1 or plan["cluster"] == 1)
    assert plan["smem"] == tfl.bwd_tc_smem_bytes(s, d, h, f, plan["seqs"], plan["cluster"],
                                                 plan["heads_per_stage"]) <= limit
    hpc = h // plan["cluster"]
    assert hpc % plan["heads_per_stage"] == 0 and d % (8 * plan["cluster"]) == 0
    bigger = [hg for hg in range(plan["heads_per_stage"] + 1, hpc + 1) if hpc % hg == 0]
    assert all(tfl.bwd_tc_smem_bytes(s, d, h, f, plan["seqs"], plan["cluster"], hg) > limit
               for hg in bigger)


def test_bf16_backward_shared_memory_plan():
    """``BwdTcLayout``: the mask, then the largest of a product's operand
    (the CTA's rows in whole m-tiles, max(3D, F) + 8 bf16 wide: dx's
    product over dqm), the row steps' column sums (3 D f32 for each of 16
    warps) and one sequence's attention (its rows of the CTA's heads'
    q|k|v and gw in whole 16-row blocks, then per head bf16 dropped probs
    and d_scores, round_up(S, 16) + 8 wide).  At the quality shape two
    sequences take 161,024 bytes (the attention), a cluster of 3 at path B
    74,368 (the product), S=8 24,608 (the sums), the flagship's width
    74,880 (the attention), 16 heads of 24 (staged padded to 32) 152,704;
    a shape too wide for even one head raises."""
    heads12 = 12 * 2 * 32 * 40 * 2
    assert tfl.bwd_tc_smem_bytes(32, 384, 12, 48, 2, 1, 12) == max(
        64 * 4 + 64 * (1152 + 8) * 2, 64 * 4 + 16 * 3 * 384 * 4,
        64 * 4 + 32 * (1152 + 8) * 2 + 32 * (384 + 8) * 2 + heads12) == 161024
    assert tfl.bwd_tc_smem_bytes(32, 384, 12, 48, 1, 3, 4) == 32 * 4 + 32 * 1160 * 2 == 74368
    assert tfl.bwd_tc_smem_bytes(8, 128, 8, 48, 1, 4, 2) == 8 * 4 + 16 * 3 * 128 * 4 == 24608
    heads8 = 8 * 2 * 32 * 40 * 2
    assert tfl.bwd_tc_smem_bytes(32, 128, 8, 512, 1, 1, 8) == (
        32 * 4 + 32 * (384 + 8) * 2 + 32 * (128 + 8) * 2 + heads8) == 74880
    with pytest.raises(ValueError, match="shared memory"):
        tfl.bwd_tc_heads(64, 2048, 2, 64, 1, 1, 232448)
    # a head width off the k-steps of 16 is staged padded to them: 16 heads
    # of 24 take 16 x 32 columns of q, k, v and gw a row (D=384: 512)
    pad = 32 * 4 + 32 * (3 * 512 + 8) * 2 + 32 * (512 + 8) * 2 + 4 * 2 * 32 * 40 * 2
    assert tfl.bwd_tc_smem_bytes(32, 384, 16, 48, 1, 1, 4) == pad == 152704


@pytest.mark.parametrize(("s", "row_tiles"), [(8, 1), (32, 1), (33, 2), (48, 2), (64, 2)])
def test_f32_tile_plan(s, row_tiles):
    """The f32 products' register tiles: 8 warps of 4 rows, once up to
    S=32 and twice above, cover the rows the buffers hold; each lane 4 of
    a pass's 128 columns, 16 outputs a row tile."""
    plan = tfl.tile_plan(s)
    assert plan["row_tiles"] == row_tiles
    assert plan["rows"] == plan["threads"] // 32 * 4 * row_tiles == 32 * row_tiles >= s
    assert plan["pass_cols"] == 32 * 4 and plan["k_chunk"] == 32
    assert plan["outputs_per_thread"] == 16 * row_tiles


def test_f32_shared_memory_plan():
    """The f32 forward's layout (``F32Layout`` in csrc/fused_layer.cu):
    x, ctx then g, a head group's q|k|v then a and f, over the rows the
    product tiles cover, each row padded to an odd count of 16 bytes, then
    two 32 x 128 weight tiles.  A cluster of 4 at the reference shape takes
    its 3 heads at once (3 its 4), one CTA a sequence 6 of its 12, and S=64
    at D=128, F=512 2 heads of 16, at the card's limit exactly."""
    limit = 232448
    tiles = 4 * 2 * 32 * 128
    assert tfl.smem_bytes(32, 384, 48, 3, 4, 12) == 4 * 32 * 3 * 388 + tiles == 181760
    assert tfl.smem_bytes(32, 384, 48, 4, 4, 12) == 181760
    assert tfl.smem_bytes(32, 384, 48, 6, 4, 12) == 4 * 32 * (2 * 388 + 580) + tiles
    assert tfl.heads_per_stage(32, 384, 48, 12, 4, limit, cluster=4) == 3
    assert tfl.heads_per_stage(32, 384, 48, 12, 4, limit, cluster=3) == 4
    assert tfl.heads_per_stage(64, 128, 512, 8, 4, limit) == 2
    assert tfl.smem_bytes(64, 128, 512, 2, 4, 8) == 4 * 64 * (132 + 516 + 132) + tiles == limit
    assert tfl.smem_bytes(8, 128, 48, 8, 4, 8) == 4 * 32 * (132 + 132 + 388) + tiles
    with pytest.raises(ValueError, match="num_heads"):
        tfl.smem_bytes(32, 384, 48, 3, 4)


def test_f32_backward_shared_memory_plan():
    """The f32 backward's first pass (``F32BwdLayout``): two weight and two
    activation tiles, a head group's q|k|v and gw, its d_scores and dropped
    probs, the mask; a cluster of 4 at the reference shape stages its 3
    heads at once, one CTA a sequence 6 of 12."""
    limit = 232448
    assert tfl.bwd_smem_bytes(32, 384, 12, 3) == 4 * (
        2 * 128 * 36 + 2 * 32 * 36 + 32 * 292 + 32 * 96 + 2 * 3 * 32 * 32) + 4 * 32 == 120448
    assert tfl.bwd_heads_per_stage(32, 384, 12, limit, cluster=4) == 3
    assert tfl.bwd_heads_per_stage(32, 384, 12, limit) == 6
    assert tfl.bwd_heads_per_stage(64, 128, 8, limit) == 2
    with pytest.raises(ValueError, match="shared memory"):
        tfl.bwd_heads_per_stage(64, 1024, 2, limit)


def test_f32_kernels_need_widths_of_whole_16_bytes():
    tfl._check_f32_widths(384, 12, 48)
    for d, h, f in ((96, 16, 48), (130, 2, 48), (128, 8, 50)):
        with pytest.raises(ValueError, match="multiples of 4"):
            tfl._check_f32_widths(d, h, f)


def test_forward_workspace_holds_the_four_weights():
    d, f = 128, 512
    assert tfl.forward_workspace_elems(d, f) == d * 3 * d + d * d + d * f + f * d == 196608


def test_wrapper_rejects_long_sequences():
    weights, x, mask = make_case(3, 1, 8, 16, 16)
    with pytest.raises(ValueError, match="s <= 64"):
        tfl.fused_layer(torch.zeros(1, 65, 16), to_torch(weights), torch.ones(1, 65, dtype=bool),
                        num_heads=2, causal=True, ffn_dim=16)
