"""The port's plain throughput-probe chain (``ops/vpu_calibration.py``
``reference_chain``: what the CUDA kernel computes and what ``vpu_chain``
runs on CPU tensors) against the JAX package's ``vpu_chain`` in interpret
mode and its numpy ``reference_chain``, from the same numpy tile in
[0.5, 1.5).

Tolerance: rtol 2e-5, the JAX package's own kernel-vs-oracle bound
(``tests/test_vpu_calibration.py``).  ``fma`` and ``select`` are held to
the bit as well: each step is one or two correctly rounded f32 operations
(products and sums, none of them a product feeding a sum that a compiler
could contract into an FMA), so every implementation rounds the same way.
``exp`` goes through each library's ``expf``, which may differ by a few
ulp; from [0.5, 1.5) every step's exact value lies within half an ulp of 1
and all of them give 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.ops import vpu_calibration as jvc
from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops import vpu_calibration as tvc

ITERS = 16


def tile(seed=0, shape=(16, 256)):
    return np.random.default_rng(seed).random(shape, np.float32) + 0.5


def port(x, mix, iters=ITERS):
    return tvc.vpu_chain(torch.from_numpy(x), iters=iters, mix=mix).numpy()


def test_ops_per_iter_is_the_jax_count():
    assert tvc.OPS_PER_ITER == jvc.OPS_PER_ITER


@pytest.mark.parametrize("mix", sorted(jvc.OPS_PER_ITER))
def test_chain_matches_jax_kernel_interpret(mix):
    x = tile(0)
    want = np.asarray(jvc.vpu_chain(jnp.asarray(x), iters=ITERS, mix=mix, interpret=True))
    got = port(x, mix)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    if mix != "exp":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mix", sorted(jvc.OPS_PER_ITER))
def test_chain_matches_jax_reference(mix):
    x = tile(1)
    want = np.asarray(jvc.reference_chain(x, iters=ITERS, mix=mix))
    got = port(x, mix)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    if mix != "exp":
        np.testing.assert_array_equal(got, want)


def test_fma_chain_stays_bounded_and_varies():
    """The damped logistic map keeps iterates in (0, 1.001) over a long
    chain (the calibration runs 16,384 steps) and distinct inputs stay
    distinct after a short one."""
    x = tile(2, (64, 64))
    long = port(x, "fma", iters=4096)
    assert (long > 0).all() and (long < 1.001).all()
    assert len(np.unique(port(x, "fma"))) > 1


def test_cpu_chain_launches_nothing():
    cuda_build.reset_launches()
    x = torch.from_numpy(tile(3))
    assert torch.equal(tvc.vpu_chain(x, iters=8, mix="select"),
                       tvc.reference_chain(x, iters=8, mix="select"))
    assert cuda_build.LAUNCHES["vpu_chain"] == 0


@pytest.mark.parametrize(("kwargs", "match"), [
    (dict(iters=16, mix="tanh"), "mix must be one of"),
    (dict(iters=12, mix="fma"), "multiple of 8"),
    (dict(iters=-8, mix="fma"), "multiple of 8"),
    (dict(iters=16, mix="fma", device="meta"), "f32 CUDA tensor"),
    (dict(iters=16, mix="fma", device="meta", dtype=torch.float64), "f32 CUDA tensor"),
])
def test_wrapper_refuses(kwargs, match):
    """What the kernel does not take raises; a tensor that is neither on
    the CPU nor an f32 CUDA tensor gets no plain fallback."""
    x = torch.ones(4, 512, dtype=kwargs.pop("dtype", torch.float32),
                   device=kwargs.pop("device", "cpu"))
    with pytest.raises(ValueError, match=match):
        tvc.vpu_chain(x, **kwargs)


def test_calibration_entry_point_needs_a_card(monkeypatch, tmp_path, capsys):
    """Without a CUDA card the tool exits non-zero and writes nothing: it
    never times the CPU."""
    from transformer_recommenders_tpu_torch.tools import calibrate_vpu

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "calibration.json"
    assert calibrate_vpu.main(["--out", str(out)]) != 0
    assert not out.exists() and "no CUDA device" in capsys.readouterr().err
