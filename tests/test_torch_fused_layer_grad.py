"""The port's fused-layer backward (``fused_layer`` under autograd on CPU
tensors, i.e. ``fused_layer_backward_reference``, what the CUDA backward
kernel computes) against ``jax.grad`` through the JAX Pallas kernel in
interpret mode, from the same numpy weights, inputs, dropout seeds and a
random linear probe ``vdot(y, probe)`` as the loss.

Tolerances:
- f32: rtol 1e-4, atol 1e-5, the JAX package's own fused-vs-XLA gradient
  bound (tests/test_fused_layer.py); measured ~6e-7 of each gradient's
  max abs value.  Against autograd of ``fused_layer_reference`` (the two
  agree in f32: no A&S erf there, and both divisors are f32): 1e-5 of each
  gradient's max abs value.
- bf16: 1e-2 of each gradient's max abs value.  Every gradient product
  rounds its operands to bf16, and Pallas interpret mode on the CPU rounds
  its bf16 products differently from the port (see
  test_torch_fused_layer.py), so one-ulp flips (2**-8 relative) of
  intermediate roundings feed thousands of summands; measured 4.7e-3 to
  5.9e-3 over the cases below.
- the dropout-divisor trap: a least-squares scale between the port's and
  the JAX gradient, 1 within 1e-3 (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.ops import fused_layer as JFL
from transformer_recommenders_tpu_torch.ops import fused_layer as tfl
from test_torch_fused_layer import SEEDS, make_case, to_jax

BF16_REL = 1e-2


def jax_grads(weights, x, mask, probe, dtype, *, h, f, causal, attn_rate, hidden_rate, seeds):
    def loss(x_, w_):
        y = JFL.fused_layer(
            x_, w_, jnp.asarray(mask), num_heads=h, causal=causal, attn_dropout=attn_rate,
            hidden_dropout=hidden_rate,
            dropout_seeds=None if seeds is None else jnp.asarray(seeds), ffn_dim=f,
            interpret=True,
        )
        return jnp.vdot(y.astype(jnp.float32), jnp.asarray(probe))

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x).astype(dtype), to_jax(weights))
    flat = {"dx": np.asarray(gx.astype(jnp.float32))}
    flat |= {f"{m}/{n}": np.asarray(gw[m][n]) for m in gw for n in gw[m]}
    return flat


def port_grads(fn, weights, x, mask, probe, dtype, *, h, f, causal, attn_rate, hidden_rate,
               seeds):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = {m: {n: torch.from_numpy(np.array(a)).requires_grad_() for n, a in v.items()}
          for m, v in weights.items()}
    y = fn(xt, wt, torch.from_numpy(mask), num_heads=h, causal=causal, attn_dropout=attn_rate,
           hidden_dropout=hidden_rate,
           dropout_seeds=None if seeds is None else [int(v) for v in seeds], ffn_dim=f)
    (y.float() * torch.from_numpy(probe)).sum().backward()
    assert xt.grad.dtype == tdt
    flat = {"dx": xt.grad.float().numpy()}
    flat |= {f"{m}/{n}": wt[m][n].grad.numpy() for m in wt for n in wt[m]}
    return flat


def rel_errs(got, want):
    return {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()) for k in want}


def setup(b, s, d, f, rate, seed=0):
    weights, x, mask = make_case(seed, b, s, d, f)
    probe = np.random.default_rng(seed + 1).normal(size=(b, s, d)).astype(np.float32)
    return weights, x, mask, probe, (SEEDS if rate else None)


CASES = [
    # (b, s, d, h, f, dtype, causal, dropout)
    (2, 8, 128, 8, 48, "float32", True, 0.0),
    (2, 32, 128, 8, 256, "float32", True, 0.3),
    (1, 32, 128, 8, 256, "float32", False, 0.3),
    (2, 8, 128, 8, 48, "bfloat16", True, 0.0),
    (2, 32, 128, 8, 256, "bfloat16", True, 0.3),
    (1, 8, 128, 8, 48, "bfloat16", False, 0.3),
    (2, 32, 32, 4, 48, "bfloat16", False, 0.0),
]


@pytest.mark.parametrize(("b", "s", "d", "h", "f", "dtype", "causal", "rate"), CASES)
def test_backward_matches_jax_kernel_interpret(b, s, d, h, f, dtype, causal, rate):
    weights, x, mask, probe, seeds = setup(b, s, d, f, rate)
    kw = dict(h=h, f=f, causal=causal, attn_rate=rate, hidden_rate=rate, seeds=seeds)
    want = jax_grads(weights, x, mask, probe, dtype, **kw)
    got = port_grads(tfl.fused_layer, weights, x, mask, probe, dtype, **kw)
    assert set(got) == set(want) and np.abs(want["dx"]).max() > 1e-2  # non-degenerate
    if dtype == "float32":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
        # f32: the JAX backward is the exact derivative of its forward
        auto = port_grads(tfl.fused_layer_reference, weights, x, mask, probe, dtype, **kw)
        errs = rel_errs(got, auto)
        assert max(errs.values()) <= 1e-5, errs
    else:
        errs = rel_errs(got, want)
        assert max(errs.values()) <= BF16_REL, errs


def test_bf16_backward_divides_by_the_f32_keep_rate():
    """The JAX backward divides the hidden-dropout cotangent by the f32
    ``1 - rate``, while its bf16 forward divided by ``1 - rate`` rounded to
    bf16.  At rate 0.4942 the two are 0.5058 and 0.50390625, 0.38% apart,
    so autograd of the port's plain forward scales every gradient that
    flows through a dropout site by 1.0038.  The least-squares scale of the
    port's ``ffn_out`` gradients against JAX's is 1 within 1e-3; autograd's
    is not."""
    b, s, d, h, f, rate = 2, 32, 128, 8, 256, 0.4942
    weights, x, mask, probe, seeds = setup(b, s, d, f, rate, seed=3)
    kw = dict(h=h, f=f, causal=True, attn_rate=0.0, hidden_rate=rate, seeds=seeds)
    want = jax_grads(weights, x, mask, probe, "bfloat16", **kw)
    got = port_grads(tfl.fused_layer, weights, x, mask, probe, "bfloat16", **kw)
    auto = port_grads(tfl.fused_layer_reference, weights, x, mask, probe, "bfloat16", **kw)

    def ls_scale(a, ref):
        return float(np.vdot(a, ref) / np.vdot(ref, ref))

    for k in ("ffn_out/w", "ffn_out/b"):
        assert abs(ls_scale(got[k], want[k]) - 1.0) <= 1e-3, k
        assert abs(ls_scale(auto[k], want[k]) - 1.0038) <= 1e-3, k


def test_bf16_recompute_uses_the_as_erf(monkeypatch):
    """The JAX backward recomputes the GELU with the Abramowitz-Stegun erf
    under bf16 (``_APPROX_RECOMPUTE_ERF``) and with the Eigen polynomial in
    f32; the port's ``_erf_as`` is the same function, and its plain
    backward calls it under bf16 only."""
    xs = np.linspace(-6, 6, 24001).astype(np.float32)
    got = tfl._erf_as(torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, np.asarray(JFL._erf_as(jnp.asarray(xs))), atol=2e-7, rtol=0)
    assert np.abs(got - tfl._erf(torch.from_numpy(xs)).numpy()).max() > 1e-6  # not Eigen's
    assert JFL._APPROX_RECOMPUTE_ERF

    calls = []
    erf_as = tfl._erf_as
    monkeypatch.setattr(tfl, "_erf_as", lambda v: calls.append(v.dtype) or erf_as(v))
    weights, x, mask, probe, _ = setup(1, 8, 32, 48, 0.0)
    for dtype in ("float32", "bfloat16"):
        port_grads(tfl.fused_layer, weights, x, mask, probe, dtype, h=4, f=48, causal=True,
                   attn_rate=0.0, hidden_rate=0.0, seeds=None)
    assert calls == [torch.float32]  # once, from the bf16 backward (its f32 argument)


def test_gelu_grad_is_the_derivative_of_gelu():
    u = torch.linspace(-5, 5, 1001, dtype=torch.float64).requires_grad_()
    gelu = 0.5 * u * (1.0 + torch.erf(u / 2**0.5))
    (want,) = torch.autograd.grad(gelu.sum(), u)
    got = tfl._gelu_grad(u.detach(), torch.erf(u.detach() / 2**0.5))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
