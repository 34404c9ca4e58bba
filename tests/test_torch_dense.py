"""The port's dense (``ops/dense.py``): the ``Dense`` function, with each
kernel of #19 replaced by the plain formula it computes on the card,
against today's plain graph (``dense_reference`` and its autograd) bit
for bit, the plain graph's rounding points, the dispatch by input, and
the forward against the JAX package's ``_dense``.

The function and the dispatch are read with the device check
monkeypatched (the CPU has no card), as ``test_gate_matches_jax_off_the_cpu``
reads the layer gate; the kernels' wrappers are replaced there by
recorders, so no kernel runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops import dense as D


def _case(lead, k, n, x_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(*lead, k)).astype(np.float32)).to(x_dtype)
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=n)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(*lead, n)).astype(np.float32))
    return x, w, b, g


def _run(fn, x, w, b, g, dtype):
    x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
    y = fn(x, w, b, dtype)
    y.backward(g.to(y.dtype))
    return y.detach(), x.grad, w.grad, b.grad


def _recorded(monkeypatch):
    """The kernels' wrappers replaced by the plain formulas, recording each
    call: the dispatch read on the CPU."""
    calls = []

    def fwd(x2, w16, b):
        calls.append("fwd")
        return (x2.float() @ w16.float() + b).to(torch.bfloat16)

    def dgrad(g2, w16):
        calls.append("dgrad")
        return (g2.float() @ w16.float().t()).to(torch.bfloat16)

    def wgrad(x2, g2):
        calls.append("wgrad")
        return (x2.float().t() @ g2.float()).to(torch.bfloat16).float(), g2.float().sum(0)

    monkeypatch.setattr(D, "on_card", lambda t: True)
    monkeypatch.setattr(D, "_fwd_cuda", fwd)
    monkeypatch.setattr(D, "_dgrad_cuda", dgrad)
    monkeypatch.setattr(D, "_wgrad_cuda", wgrad)
    return calls


# (lead, K, N): the stack's qkv and FFN at small rows, a 2-D input
# projection, and widths that no kernel takes
SHAPES = [((2, 16), 32, 96), ((3, 8), 64, 16), ((40,), 48, 24), ((5, 3), 12, 20)]


@pytest.mark.parametrize(("lead", "k", "n"), SHAPES)
@pytest.mark.parametrize(("dtype", "x_dtype"), [
    (torch.bfloat16, torch.bfloat16),  # the stack's activations
    (torch.bfloat16, torch.float32),   # an f32 table through the input projection
    (torch.float32, torch.float32),    # an f32 configuration
])
def test_function_equals_the_plain_graph_bit_for_bit(monkeypatch, lead, k, n, dtype, x_dtype):
    """What runs around the kernels on the card (the operands' rounding
    and reshapes, what the backward keeps and computes, the gradients'
    dtypes) gives the plain graph's bits where each kernel gives its
    formula's; the calls the gate keeps off the kernels (f32, K = 12) run
    the plain graph itself."""
    calls = _recorded(monkeypatch)
    x, w, b, g = _case(lead, k, n, x_dtype, seed=k + n)
    want = _run(D.dense_reference, x, w, b, g, dtype)
    got = _run(D.dense, x, w, b, g, dtype)
    assert bool(calls) == (dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0)
    for name, a, e in zip(("y", "dx", "dW", "db"), got, want):
        assert a.dtype == e.dtype and a.shape == e.shape, name
        assert torch.equal(a, e), name


def test_rounding_points():
    """dW is rounded to bf16 (held in f32), db is the f32 sum of the
    cotangent, dx is bf16 (in x's dtype)."""
    x, w, b, g = _case((4, 32), 64, 48, torch.float32, seed=3)
    y, dx, dw, db = _run(D.dense, x, w, b, g, torch.bfloat16)
    g16 = g.to(torch.bfloat16).float()
    assert y.dtype == torch.bfloat16
    assert dw.dtype == torch.float32 and torch.equal(dw, dw.to(torch.bfloat16).float())
    wide = x.to(torch.bfloat16).float().reshape(-1, 64).t() @ g16.reshape(-1, 48)
    assert not torch.equal(wide, wide.to(torch.bfloat16).float())  # the rounding is not vacuous
    assert torch.equal(dw, wide.to(torch.bfloat16).float())
    assert db.dtype == torch.float32 and torch.equal(db, g16.sum(dim=(0, 1)))
    assert not torch.equal(db, db.to(torch.bfloat16).float())
    assert dx.dtype == torch.float32 and torch.equal(dx, dx.to(torch.bfloat16).float())
    x16 = x.to(torch.bfloat16)
    _, dx16, _, _ = _run(D.dense, x16, w, b, g, torch.bfloat16)
    assert dx16.dtype == torch.bfloat16 and torch.equal(dx16.float(), dx)


@pytest.mark.parametrize(("k", "n", "dtype", "want"), [
    (256, 768, torch.bfloat16, True),   # ml25m_ccl's qkv
    (1024, 256, torch.bfloat16, True),  # its FFN out
    (384, 128, torch.bfloat16, True),   # ml1m_ssm's input projection
    (64, 192, torch.bfloat16, True),    # path C's qkv (d=64)
    (8, 8, torch.bfloat16, True),
    (72, 200, torch.bfloat16, True),    # K and N multiples of 8, not of 64:
    (392, 136, torch.bfloat16, True),   # a ragged last k-block and column tile
    (256, 768, torch.float32, False),   # f32 products stay the plain ops
    (260, 256, torch.bfloat16, False),  # K not a multiple of 8
    (256, 12, torch.bfloat16, False),   # N not a multiple of 8
])
def test_kernel_gate_on_the_card(monkeypatch, k, n, dtype, want):
    monkeypatch.setattr(D, "on_card", lambda t: True)
    assert D.kernel_admits(torch.zeros(2, k), torch.zeros(k, n), dtype) is want


def test_kernel_gate_off_the_card():
    assert not D.kernel_admits(torch.zeros(2, 256), torch.zeros(256, 768), torch.bfloat16)


@pytest.mark.parametrize(("lead", "k", "n", "dtype", "kernels", "plain"), [
    ((2, 16), 32, 96, torch.bfloat16, ["fwd", "dgrad", "wgrad"], 0),
    ((2, 16), 32, 96, torch.float32, [], 0),
    ((2, 16), 12, 96, torch.bfloat16, [], 1),
    ((2, 16), 32, 20, torch.bfloat16, [], 1),
])
def test_dispatch_by_input(monkeypatch, lead, k, n, dtype, kernels, plain):
    calls = _recorded(monkeypatch)
    x, w, b, g = _case(lead, k, n, dtype, seed=7)
    cuda_build.reset_launches()
    got = _run(D.dense, x, w, b, g, dtype)
    assert calls == kernels
    assert cuda_build.LAUNCHES["dense_plain"] == plain
    want = _run(D.dense_reference, x, w, b, g, dtype)
    assert all(torch.equal(a, e) for a, e in zip(got[:2], want[:2]))  # y and dx: the same sums
    cuda_build.reset_launches()


def test_frozen_input_takes_no_dgrad(monkeypatch):
    """The input projection of the frozen table: no dx, the weight's and
    bias's gradients from one wgrad."""
    calls = _recorded(monkeypatch)
    x, w, b, g = _case((40,), 48, 24, torch.float32, seed=8)
    w, b = w.requires_grad_(), b.requires_grad_()
    D.dense(x, w, b, torch.bfloat16).backward(g.to(torch.bfloat16))
    assert calls == ["fwd", "wgrad"] and w.grad is not None and b.grad is not None


def test_no_gradient_takes_the_forward_alone(monkeypatch):
    """Evaluation (no gradient anywhere) launches the forward kernel alone
    and records nothing for a backward."""
    calls = _recorded(monkeypatch)
    x, w, b, _ = _case((2, 16), 32, 96, torch.bfloat16, seed=12)
    with torch.no_grad():
        y = D.dense(x, w.requires_grad_(), b, torch.bfloat16)
    assert calls == ["fwd"] and y.shape == (2, 16, 96)
    assert not y.requires_grad and y.grad_fn is None
    assert torch.equal(y, D.dense_reference(x, w, b, torch.bfloat16))


def test_cpu_tensors_launch_no_kernel():
    x, w, b, g = _case((2, 16), 32, 96, torch.bfloat16, seed=9)
    cuda_build.reset_launches()
    _run(D.dense, x, w, b, g, torch.bfloat16)
    assert cuda_build.LAUNCHES == dict.fromkeys(cuda_build.KERNELS, 0)


def test_stack_dense_is_the_port_dense(monkeypatch):
    seen = []
    monkeypatch.setattr(TT, "dense", lambda *a: seen.append(a) or D.dense(*a))
    x, w, b, _ = _case((2, 4), 16, 8, torch.bfloat16, seed=10)
    y = TT._dense(x, {"w": w, "b": b}, torch.bfloat16)
    assert len(seen) == 1 and torch.equal(y, D.dense_reference(x, w, b, torch.bfloat16))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_matches_jax(dtype):
    """y against JAX's ``_dense`` on the CPU: both sum exact products of
    the rounded operands in f32, in other orders; under bf16 one ulp at
    most, in at most 2% of the outputs, under f32 1e-5 of max(|y|, 1)."""
    x, w, b, _ = _case((3, 16), 64, 96, torch.float32, seed=11)
    tdtype = getattr(torch, dtype)
    got = D.dense(x, w, b, tdtype).float().numpy()
    want = np.asarray(JT._dense(jnp.asarray(x.numpy()), {"w": jnp.asarray(w.numpy()),
                                                          "b": jnp.asarray(b.numpy())},
                                getattr(jnp, dtype)).astype(jnp.float32))
    diff = np.abs(got - want)
    if dtype == "float32":  # sums of 64 terms of magnitude ~1 in another order
        assert (diff <= 1e-5 * np.maximum(np.abs(want), 1.0)).all()
        return
    assert (diff <= np.spacing(np.abs(want).astype(np.float32)) * 2.0**16).all()
    assert (diff > 0).mean() <= 0.02
