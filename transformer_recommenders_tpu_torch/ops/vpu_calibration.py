"""Throughput probe: K chained iterations of an arithmetic mix over a tile
of f32 values, the plain PyTorch version and the wrapper around the CUDA
kernel ``csrc/vpu_calibration.cu``.

Counterpart of ``transformer_recommenders_tpu/ops/vpu_calibration.py``
(``vpu_chain`` and its Pallas ``_chain_kernel``), which measures the TPU's
vector-unit rate.  On the H100 the same chains measure the SM's dispatch
rates: the CUDA-core (FP32) pipes for ``fma`` and ``select``, and the
special-function unit (MUFU) with the FP32 sequence around it for ``exp``.
Timing two chain lengths and taking the slope cancels the launch, the load
and the store (``tools/calibrate_vpu.py``).

The mixes, counted as the JAX package counts them (``OPS_PER_ITER``):

- ``fma``: ``0.999 * x * (2 - x)``, 3 operations.  A damped logistic map:
  composing it squares the polynomial degree, so no compiler can fold the
  chain (the JAX module's docstring tells of two affine bodies, ``|x*a -
  b|`` and ``min(x*a + b, 1)``, that folded), and iterates started in
  [0.5, 1.5) stay in (0, 1.001);
- ``exp``: ``exp(x * 1e-8)``, 2 operations (a product and a
  transcendental); the operand stays near 1;
- ``select``: ``x > 0.5 ? x * 0.999 : x + 0.001``, 4 operations (compare,
  select, product, sum).

Every step is one or two correctly rounded f32 operations with no product
feeding a sum, so the kernel, this plain version and the JAX kernel give
the same bits for ``fma`` and ``select``; ``exp`` depends on each
library's ``expf`` (a few ulp apart at most; from [0.5, 1.5) every step
rounds to exactly 1).
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.ops import cuda_build

OPS_PER_ITER = {"fma": 3, "exp": 2, "select": 4}
MIXES = tuple(OPS_PER_ITER)
UNROLL = 8  # iterations must be a multiple of it, as in the JAX kernel
# csrc/vpu_calibration.cu: a block of 256 threads with two chains each
# covers one 512-element row, and 8 blocks are resident per SM
ELEMENTS_PER_BLOCK = 512
BLOCKS_PER_SM = 8


def reference_chain(x: torch.Tensor, *, iters: int, mix: str = "fma") -> torch.Tensor:
    """Plain PyTorch version: ``iters`` steps of ``mix`` in f32, one
    elementwise op at a time.  The constants are f32 tensors made on the
    device (no copy from the host, so a CUDA graph can capture the loop)."""
    _check_args(iters, mix)
    x = x.float()

    def const(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=torch.float32, device=x.device)

    if mix == "fma":
        a, two = const(0.999), const(2.0)
        for _ in range(iters):
            x = a * x * (two - x)
    elif mix == "exp":
        s = const(1e-8)
        for _ in range(iters):
            x = torch.exp(x * s)
    else:
        half, a, b = const(0.5), const(0.999), const(0.001)
        for _ in range(iters):
            x = torch.where(x > half, x * a, x + b)
    return x


def _check_args(iters: int, mix: str) -> None:
    if mix not in OPS_PER_ITER:
        msg = f"vpu_chain: mix must be one of {MIXES}, got {mix!r}"
        raise ValueError(msg)
    if iters < 0 or iters % UNROLL:
        msg = f"vpu_chain: iters must be a non-negative multiple of {UNROLL}, got {iters}"
        raise ValueError(msg)


def vpu_chain(x: torch.Tensor, *, iters: int, mix: str = "fma") -> torch.Tensor:
    """``iters`` chained steps of ``mix`` over every element of the f32
    tensor ``x`` (a new tensor of its shape).

    On a CPU tensor this runs :func:`reference_chain`; on a CUDA tensor it
    launches the kernel (f32 only, fewer than 2**31 elements) or raises."""
    _check_args(iters, mix)
    if x.device.type == "cpu":
        return reference_chain(x, iters=iters, mix=mix)
    if x.device.type != "cuda" or x.dtype != torch.float32:
        msg = f"vpu_chain: x must be an f32 CUDA tensor, got {x.dtype} on {x.device}"
        raise ValueError(msg)
    if x.numel() >= 2**31:
        msg = f"vpu_chain: {x.numel()} elements, more than the kernel's int index"
        raise ValueError(msg)
    x = x.contiguous()
    y = torch.empty_like(x)
    status = cuda_build.library("vpu_calibration").vpu_chain(
        x.data_ptr(), y.data_ptr(), x.numel(), iters, MIXES.index(mix),
        cuda_build.stream_handle(x.device),
    )
    cuda_build.check(status, "vpu_chain launch")
    cuda_build.LAUNCHES["vpu_chain"] += 1
    return y


def wave_tile(device: torch.device) -> tuple[int, int]:
    """The (rows, 512) tile the kernel covers in exactly one full wave on
    ``device``: one row per block, 8 blocks on each SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return BLOCKS_PER_SM * sms, ELEMENTS_PER_BLOCK
