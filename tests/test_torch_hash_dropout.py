"""The port's dropout hash (transformer_recommenders_tpu_torch/ops/
hash_dropout.py) against the JAX one: keep masks must be bit-identical at
the fused layer's probs-site and hidden-site indices, over several seeds
and rates, because the CUDA kernels and the plain path reproduce the JAX
dropout streams exactly.  Then ``hash_dropout``, the layer stack's
dropout, bit for bit against JAX's ``_dropout_from_seed`` forward and
VJP (its CUDA kernel is held to this plain version on the card,
tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu.ops import fused_layer as jfl
from transformer_recommenders_tpu.ops import hash_dropout as jhd
from transformer_recommenders_tpu_torch.ops import hash_dropout as thd

SEEDS = [0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF]
RATES = [0.0, 0.1, 0.5, 0.9, 1.0]


def test_fmix32_bit_identical():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    h[:6] = [0, 1, 2, 12345, 0xDEADBEEF, 0xFFFFFFFF]
    want = np.asarray(jhd.fmix32(jnp.asarray(h)), np.uint32)
    got = thd.fmix32(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


def test_constants_and_threshold_match():
    assert (thd.PREMIX_IDX, thd.PREMIX_SEED, thd.PREMIX_STREAM) == (
        jhd.PREMIX_IDX, jhd.PREMIX_SEED, jhd.PREMIX_STREAM)
    for rate in RATES + [0.25, 1e-9, 0.999999]:
        assert thd.keep_threshold(rate) == int(jhd.keep_threshold(rate))


def _jax_keep(seed: int, idx: jnp.ndarray, rate: float) -> np.ndarray:
    # the kernel receives seeds as int32 (a bit-reinterpret of the uint32)
    seed_i32 = jnp.asarray(np.asarray(seed, np.uint32).view(np.int32))
    return np.asarray(jfl._keep(seed_i32, idx, rate))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_probs_site(seed, rate):
    """(B, H, S, S) probs index (b*H + h)*S*S + s_q*S + t, elements 0 and 3
    of a batch (the global index wraps past 2**32 for large elem*H*S*S)."""
    h, s = 8, 32
    for elem in (0, 3, 2_000_000):
        idx = jfl._probs_idx(jnp.uint32(elem), h, s)  # (H*S, S) wide rows h*S + s_q
        want = _jax_keep(seed, idx, rate)
        t_idx = (elem * h * s * s + torch.arange(h * s * s, dtype=torch.int64)).view(h * s, s)
        got = thd.keep_mask(t_idx, seed, rate).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_hidden_site(seed, rate):
    """(B*S, D) hidden index row*D + c from a block's base row."""
    rows, cols = 64, 128
    for base_row in (0, 96, 40_000_000):
        want = _jax_keep(seed, jfl._hidden_idx(jnp.uint32(base_row), rows, cols), rate)
        t_idx = (base_row * cols + torch.arange(rows * cols, dtype=torch.int64)).view(rows, cols)
        got = thd.keep_mask(t_idx, seed, rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_keep_rate_is_statistically_right():
    idx = torch.arange(200_000, dtype=torch.int64)
    for rate in (0.1, 0.5):
        kept = thd.keep_mask(idx, 12345, rate).float().mean().item()
        assert abs(kept - (1 - rate)) < 0.005


# -- hash_dropout: the layer stack's dropout, against JAX _dropout_from_seed --------

DROPOUT_SHAPES = {
    "probs_s65": ((2, 3, 65, 65), None),  # (B, H, S, S) at S = 65
    "hidden_odd": ((3, 7, 5), None),  # 105 elements, an odd count
    "transposed": ((33, 20), (1, 0)),  # a non-contiguous view: x.t()
    "permuted_probs": ((2, 65, 3, 65), (0, 2, 1, 3)),  # an einsum's permuted (B, H, S, S)
}


def _bits(a) -> np.ndarray:
    """The bits of a bf16 or f32 array, as f32 bit patterns."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _dropout_case(name, dtype, seed):
    """numpy-seeded x and cotangent g of ``name``'s logical shape, as jax
    arrays and as torch tensors (a strided view where ``name`` permutes)."""
    shape, perm = DROPOUT_SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    if perm is None:
        jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
        tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    else:  # JAX sees the permuted values; the port the same values as a view
        jx = jnp.asarray(x.transpose(perm)).astype(jdt)
        jg = jnp.asarray(g.transpose(perm)).astype(jdt)
        tx = torch.from_numpy(x).to(tdt).permute(perm)
        tg = torch.from_numpy(g).to(tdt).permute(perm)
        assert not tx.is_contiguous()
    return jx, jg, tx, tg


@pytest.mark.parametrize("seed_kind", ["int", "tensor"])
@pytest.mark.parametrize("name", list(DROPOUT_SHAPES))
@pytest.mark.parametrize("rate", [0.1, 0.4942])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_matches_jax_bit_for_bit(dtype, rate, name, seed_kind):
    """hash_dropout (the plain version, on the CPU) against JAX's
    ``_dropout_from_seed`` and its ``jax.vjp``, bit for bit: the logical
    row-major index of a strided view, the divisor rounded to the dtype,
    the true division."""
    seed = 0xDEADBEEF if rate > 0.2 else 12345
    jx, jg, tx, tg = _dropout_case(name, dtype, seed=len(name) + int(rate * 1e4))
    want, vjp = jax.vjp(lambda a: JT._dropout_from_seed(a, rate, jnp.uint32(seed)), jx)
    (want_g,) = vjp(jg)
    term = (thd.seed_terms(torch.tensor(seed)) if seed_kind == "tensor"
            else thd.seed_terms([seed])[0])
    tx = tx.clone().requires_grad_(True)
    got = thd.hash_dropout(tx, rate, term)
    got.backward(tg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(_bits(got.detach().float()), _bits(want.astype(jnp.float32)))
    np.testing.assert_array_equal(_bits(tx.grad.float()), _bits(want_g.astype(jnp.float32)))


def _where_chain(x, rate, term):
    """The layer stack's dropout before the one-pass kernel: an int64 mask
    and a ``torch.where``, differentiated by autograd."""
    idx = torch.arange(x.numel(), dtype=torch.int64).view(x.shape)
    kept = (x.float() / thd.divisor(rate, x.dtype, x.device)).to(x.dtype)
    keep = thd.premixed_keep_mask(idx, term, rate)
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype))


@pytest.mark.parametrize("name", list(DROPOUT_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_backward_equals_autograd_of_the_where_chain(dtype, name):
    """The Function's backward, which saves nothing and applies the same
    map to the cotangent, gives autograd's gradient of the old chain bit for
    bit."""
    _, _, tx, tg = _dropout_case(name, dtype, seed=3)
    term = thd.seed_terms([0x80000001])[0]
    a = tx.clone().requires_grad_(True)
    b = tx.clone().requires_grad_(True)
    thd.hash_dropout(a, 0.1, term).backward(tg)
    _where_chain(b, 0.1, term).backward(tg)
    np.testing.assert_array_equal(_bits(a.grad.float()), _bits(b.grad.float()))


def test_hash_dropout_is_the_identity_without_a_seed_or_rate():
    x = torch.randn(4, 5)
    assert thd.hash_dropout(x, 0.1, None) is x
    assert thd.hash_dropout(x, 0.0, 7) is x


@pytest.mark.parametrize(("shape", "perm", "want"), [
    ((4, 5, 6), None, ([120], [1])),  # contiguous: one dim of stride 1
    ((33, 20), (1, 0), ([20, 33], [1, 20])),  # x.t()
    ((2, 65, 3, 65), (0, 2, 1, 3), ([2, 3, 65, 65], [12675, 65, 195, 1])),
    ((2, 1, 8), (1, 0, 2), ([16], [1])),  # a unit dim moved: still contiguous
])
def test_kernel_layout_merges_dims_that_step_through_memory_as_one(shape, perm, want):
    """The sizes and strides #16 reads a strided x by (``_layout``)."""
    x = torch.zeros(shape)
    if perm is not None:
        x = x.permute(perm)
    assert thd._layout(x) == want
