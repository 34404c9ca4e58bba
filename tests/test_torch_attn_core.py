"""The port's bf16 split-attention core (``ops/attn_core.py``: the plain
version that runs on the CPU, and wherever the card's kernels #17/#18 do
not take the shape) against the JAX package's ``_attn_core_bf16`` forward
and VJP on the CPU, and the kernels' shape gate.

JAX runs op by op (``jax.disable_jit()``), rounding every bf16 op's
result as the port does (under ``jit`` XLA keeps intermediates in f32: the
stack's trap, ROADMAP C).  Inputs are numpy-seeded bf16 q, k, v of shape
(B, S, H, dh), padded keys in two rows, and an f32 cotangent.
Tolerances: the two sum the f32 scores and products in other orders, so a
score's last bit can move a probability across a bf16 rounding.
- y (the bf16 probs; JAX's residual, rebuilt by the port from each
  row's max and sum): at most one bf16 ulp (2**-8 of a value
  in [0.5, 1], less below), in at most 1% of the probs;
- ctx and dq, dk, dv: 2**-6 of each output's max abs value, the layer
  stack tests' bound on bf16 gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu_torch.ops import attn_core as ac
from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops.hash_dropout import seed_terms

SEED = 0x9E3779B9


def _case(b, s, h, dh, seed, mask_kind="tail"):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(3))
    g = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    mask = np.ones((b, s), bool)
    if mask_kind == "tail":  # padded tails, as the stack's batches pad
        mask[0, s - 7:] = False
        mask[-1, 5:] = False
    elif mask_kind == "left":  # keys 0-9 padded: rows 0-9 have no valid key at t <= s
        mask[:, :10] = False
    else:  # holes
        mask[:, 3:7] = False
        mask[0, s // 2:s // 2 + 9] = False
    return q, k, v, g, mask


def _jax(q, k, v, g, mask, rate, causal):
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    with jax.disable_jit():
        ctx, (_, _, _, y, _) = JT._attn_core_bf16_fwd(*args, jnp.asarray(mask), jnp.uint32(SEED),
                                                     rate, causal)
        _, vjp = jax.vjp(lambda a, b_, c: JT._attn_core_bf16(
            a, b_, c, jnp.asarray(mask), jnp.uint32(SEED), rate, causal), *args)
        grads = vjp(jnp.asarray(g))
    return [np.asarray(t.astype(jnp.float32)) for t in (ctx, y, *grads)]


def _port(q, k, v, g, mask, rate, causal):
    q_, k_, v_ = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v))
    term = seed_terms([SEED])[0]
    ctx = ac.attn_core_bf16(q_, k_, v_, torch.from_numpy(mask), term, rate, causal)
    ctx.backward(torch.from_numpy(g))
    *_, y = ac.attn_core_reference(q_.detach(), k_.detach(), v_.detach(), torch.from_numpy(mask),
                                   term, rate, causal, with_y=True)
    return [t.detach().float().numpy() for t in (ctx, y, q_.grad, k_.grad, v_.grad)]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("s", [65, 128])
def test_plain_core_matches_jax_forward_and_vjp(s, dh, causal, rate):
    q, k, v, g, mask = _case(2, s, 2, dh, seed=s + dh + int(causal))
    want = _jax(q, k, v, g, mask, rate, causal)
    got = _port(q, k, v, g, mask, rate, causal)
    dy = np.abs(got[1] - want[1])
    assert dy.max() <= 2.0**-8 and (dy > 0).mean() <= 0.01
    for name, a, b_ in zip(("ctx", "dq", "dk", "dv"), got[:1] + got[2:], want[:1] + want[2:]):
        assert np.isfinite(a).all(), name
        assert _rel(a, b_) <= 2.0**-6, name


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask_kind", ["left", "holes"])
def test_plain_core_matches_jax_on_left_padded_and_holed_masks(mask_kind, rate):
    """Keys 0-9 padded (causal): rows 0-9 hold no valid key at t <= s, so
    their past (padded) and future (unpadded) keys tie at -1e9 and JAX
    spreads their probability over both; the port must too.  Holes: padded
    keys inside the sequence."""
    q, k, v, g, mask = _case(2, 65, 2, 32, seed=3, mask_kind=mask_kind)
    want = _jax(q, k, v, g, mask, rate, True)
    got = _port(q, k, v, g, mask, rate, True)
    if mask_kind == "left":
        rows = want[1][:, :, :10]  # (B, H, 10, S)
        assert (rows[..., 10:] > 0).all()  # every unpadded key, all in these rows' future
        assert (rows[..., :10][..., np.tril(np.ones((10, 10), bool))] > 0).all()  # padded past
        future = np.triu(np.ones((65, 65), bool), 1)
        assert (want[1][:, :, 10:][..., future[10:]] == 0).all()
    dy = np.abs(got[1] - want[1])
    assert dy.max() <= 2.0**-8 and (dy > 0).mean() <= 0.01
    for name, a, b_ in zip(("ctx", "dq", "dk", "dv"), got[:1] + got[2:], want[:1] + want[2:]):
        assert np.isfinite(a).all(), name
        assert _rel(a, b_) <= 2.0**-6, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mask_kind", ["tail", "left", "holes"])
def test_probs_rebuilt_from_the_row_statistics_are_the_forwards(mask_kind, causal):
    """The backward's y, rebuilt from the forward's (m, l), equals the
    forward's y bit for bit."""
    q, k, v, _, mask = _case(2, 65, 3, 32, seed=4, mask_kind=mask_kind)
    q_, k_, v_ = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    mask_ = torch.from_numpy(mask)
    _, m, l, y = ac.attn_core_reference(q_, k_, v_, mask_, seed_terms([SEED])[0], 0.1, causal,
                                        with_y=True)
    assert m.shape == l.shape == (2, 3, 65) and m.dtype == l.dtype == torch.float32
    rebuilt = ac.probs_from_stats(q_, k_, mask_, m, l, causal)
    assert torch.equal(rebuilt.view(torch.int16), y.view(torch.int16))


def test_plain_core_with_dropout_differs_from_without():
    """rate 0.1 drops probs (the hash is on), rate 0 keeps them all."""
    q, k, v, g, mask = _case(1, 65, 2, 32, seed=1)
    on, off = _port(q, k, v, g, mask, 0.1, True), _port(q, k, v, g, mask, 0.0, True)
    np.testing.assert_array_equal(on[1], off[1])  # y is taken before the dropout
    assert not np.array_equal(on[0], off[0])


@pytest.mark.parametrize(("s", "dh", "dtype", "want"), [
    (128, 32, torch.bfloat16, True),  # configs/ml25m_ccl.yaml: d=256, 8 heads, seq 128
    (128, 64, torch.bfloat16, True),
    (65, 32, torch.bfloat16, True),
    (1, 64, torch.bfloat16, True),
    (129, 32, torch.bfloat16, False),  # past a warp's 16 rows of S x S scores in registers
    (128, 16, torch.bfloat16, False),  # no kernel template for the width
    (128, 48, torch.bfloat16, False),
    (128, 128, torch.bfloat16, False),
    (128, 32, torch.float32, False),  # the f32 split path has no core of its own
])
def test_kernel_gate(s, dh, dtype, want):
    assert ac.kernel_admits(s, dh, dtype) is want


def test_cpu_tensors_launch_no_kernel():
    q, k, v, g, mask = _case(1, 128, 2, 32, seed=2)
    cuda_build.reset_launches()
    _port(q, k, v, g, mask, 0.1, True)
    assert cuda_build.LAUNCHES == dict.fromkeys(cuda_build.KERNELS, 0)
