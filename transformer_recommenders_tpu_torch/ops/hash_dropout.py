"""The counter-based dropout hash (murmur3 ``fmix32`` over the global
element index), shared by the plain paths and, as the same constants, by
the CUDA kernels (``csrc/common.cuh``: the fused layer's in-kernel
dropout, the attention core's and the one-pass dropout of
``csrc/hash_dropout.cu``).

Counterpart of ``transformer_recommenders_tpu/ops/hash_dropout.py``; the
keep masks are bit-identical to the JAX ones.  PyTorch's uint32 coverage
is partial, so the plain path does the uint32 arithmetic in int64 and
masks every product back to 32 bits.

:func:`hash_dropout` is the layer stack's dropout (JAX
``models/transformer._dropout_from_seed``, which JAX leaves to XLA to fuse
into the ops around it): a ``torch.autograd.Function`` that on the card
launches the one-pass kernel (#16) forward and backward, and on the CPU
runs the plain int64 chain (:func:`hash_dropout_reference`).
"""

from __future__ import annotations

import ctypes

import torch

from transformer_recommenders_tpu_torch.ops import cuda_build

PREMIX_IDX = 0x9E3779B1
PREMIX_SEED = 0x85EBCA77
PREMIX_STREAM = 0xC2B2AE3D

_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 ``h`` in [0, 2**32) without int64
    overflow: split ``c`` into 16-bit halves."""
    lo = (h * (c & 0xFFFF)) & _MASK32
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on an int64 tensor holding uint32 values."""
    h = h & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def keep_threshold(rate: float) -> int:
    """uint32 threshold such that P[fmix32(...) >= threshold] = 1 - rate."""
    return min(int(rate * 4294967296.0), 4294967295)


def seed_terms(seeds):
    """``seed * PREMIX_SEED`` mod 2**32 for each seed (the part of the hash
    that depends on the seed alone), worked out once for all of a step's
    dropout sites: a list of ints gives a list of ints (host arithmetic,
    no device work); an integer tensor gives an int64 tensor on its device
    (one op for every site, read there: a CUDA graph's replays each take
    their own)."""
    if isinstance(seeds, torch.Tensor):
        return _mul32(seeds.to(torch.int64) & _MASK32, PREMIX_SEED)
    return [(int(v) & _MASK32) * PREMIX_SEED & _MASK32 for v in seeds]


def keep_mask(idx: torch.Tensor, seed: int | torch.Tensor, rate: float) -> torch.Tensor:
    """Keep mask of the element indices ``idx`` (int64, taken mod 2**32)
    under the uint32 site ``seed``:
    ``fmix32(idx*PREMIX_IDX + seed*PREMIX_SEED) >= keep_threshold(rate)``.
    ``seed`` is an int or a 0-dim integer tensor (on ``idx``'s device, read
    there: a CUDA graph that captured the mask reads each replay's seed)."""
    term = seed_terms(seed) if isinstance(seed, torch.Tensor) else seed_terms([seed])[0]
    return premixed_keep_mask(idx, term, rate)


def premixed_keep_mask(idx: torch.Tensor, seed_term: int | torch.Tensor,
                       rate: float) -> torch.Tensor:
    """:func:`keep_mask` given the site's :func:`seed_terms` value (an int
    or a 0-dim int64 tensor) in place of its seed."""
    h = (_mul32(idx & _MASK32, PREMIX_IDX) + seed_term) & _MASK32
    return fmix32(h) >= keep_threshold(rate)


def seed_tensor(seeds, device) -> torch.Tensor:
    """uint32 dropout seeds as a contiguous 1-D int64 tensor on ``device``
    (a kernel reads it by address).  A tensor is reshaped (and moved or
    copied where it lies elsewhere or is strided); a list is written there
    element by element (fills, with no copy from the host), so a CUDA
    graph that captures the call keeps its values."""
    if isinstance(seeds, torch.Tensor):
        return seeds.reshape(-1).to(device=device, dtype=torch.int64).contiguous()
    values = [int(v) & _MASK32 for v in seeds]
    out = torch.empty(len(values), dtype=torch.int64, device=device)
    for i, v in enumerate(values):
        # the value goes as the fill kernel's argument (``out[i] = v`` would
        # copy a host tensor, which a capture refuses)
        out[i].fill_(v)
    return out


def keep_divisor(rate: float, dtype) -> float:
    """``1 - rate`` as the JAX package divides by it: a Python float meets a
    ``dtype`` array, so it is rounded to ``dtype`` first (0.8984375 in bf16
    at rate 0.1).  Returned as a Python float (exact), so no tensor crosses
    to the device."""
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def divisor(rate: float, dtype, device) -> torch.Tensor:
    """:func:`keep_divisor` as a 0-dim f32 tensor made on ``device`` (no
    copy from the host, so a CUDA graph can capture it).  A tensor, not a
    Python float: CUDA divides by a host scalar as a product with its
    reciprocal, which is not always the correctly rounded quotient."""
    return torch.full((), keep_divisor(rate, dtype), dtype=torch.float32, device=device)


def hash_dropout_reference(x: torch.Tensor, rate: float,
                           seed_term: int | torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`hash_dropout` (the int64 chain): each
    element of ``x`` at its logical row-major index ``i`` (mod 2**32) is
    kept where ``premixed_keep_mask(i, seed_term, rate)``, as
    ``float(x) / keep_divisor(rate, x.dtype)`` (a true division) rounded
    to ``x.dtype``, else 0."""
    idx = torch.arange(x.numel(), device=x.device, dtype=torch.int64).view(x.shape)
    kept = (x.float() / divisor(rate, x.dtype, x.device)).to(x.dtype)
    keep = premixed_keep_mask(idx, seed_term, rate)
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype, device=x.device))


def seed_argument(seed_term: int | torch.Tensor, device) -> tuple[int | None, int]:
    """(address, value) that a kernel takes for a site's :func:`seed_terms`
    value: a 0-dim tensor by the address of its int64 on ``device`` (read
    there, so a CUDA graph's replays each read their own), an int by value
    (a kernel argument, no copy from the host)."""
    if isinstance(seed_term, torch.Tensor):
        term = seed_term.reshape(()).to(device=device, dtype=torch.int64)
        return term.data_ptr(), 0
    return None, int(seed_term) & _MASK32


_MAX_DIMS = 8  # csrc/hash_dropout.cu kMaxDims


def _layout(x: torch.Tensor) -> tuple[list[int], list[int]]:
    """``x``'s sizes and strides (elements) with unit dims dropped and
    dims that step through memory as one merged: a contiguous tensor gives
    one dim of stride 1."""
    dims: list[list[int]] = []
    for size, stride in zip(x.shape, x.stride()):
        if size == 1:
            continue
        if dims and dims[-1][1] == stride * size:
            dims[-1] = [dims[-1][0] * size, stride]
        else:
            dims.append([size, stride])
    dims = dims or [[1, 1]]
    if len(dims) > _MAX_DIMS:
        msg = f"hash_dropout: {len(dims)} strided dims, the kernel takes at most {_MAX_DIMS}"
        raise ValueError(msg)
    return [d[0] for d in dims], [d[1] for d in dims]


def _hash_dropout_cuda(x: torch.Tensor, rate: float, seed_term) -> torch.Tensor:
    """#16 on ``x``'s card: one pass reading ``x`` by its strides (no copy)
    and writing a contiguous result."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        msg = f"hash_dropout: x must be f32 or bf16 on the card, got {x.dtype}"
        raise ValueError(msg)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    sizes, strides = _layout(x)
    dims = ctypes.c_longlong * len(sizes)
    ptr, value = seed_argument(seed_term, x.device)
    status = cuda_build.library("hash_dropout").hash_dropout(
        x.data_ptr(), out.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16), len(sizes),
        dims(*sizes), dims(*strides), ptr, value, keep_threshold(rate),
        keep_divisor(rate, x.dtype), cuda_build.stream_handle(x.device))
    cuda_build.check(status, "hash_dropout launch")
    cuda_build.LAUNCHES["hash_dropout"] += 1
    return out


def _dropout_map(x: torch.Tensor, rate: float, seed_term) -> torch.Tensor:
    if x.device.type == "cpu":
        return hash_dropout_reference(x, rate, seed_term)
    return _hash_dropout_cuda(x, rate, seed_term)


class _HashDropout(torch.autograd.Function):
    """Dropout is linear in ``x``, so its VJP is the same map on the
    cotangent; the mask is recomputed from the hash, nothing is saved."""

    @staticmethod
    def forward(ctx, x, rate, seed_term):
        ctx.rate, ctx.seed_term = rate, seed_term
        return _dropout_map(x, rate, seed_term)

    @staticmethod
    def backward(ctx, g):
        return _dropout_map(g, ctx.rate, ctx.seed_term), None, None


def hash_dropout(x: torch.Tensor, rate: float,
                 seed_term: int | torch.Tensor | None) -> torch.Tensor:
    """Hash dropout over the logical row-major index of ``x`` (JAX
    ``_dropout_from_seed``): kept elements divided by ``1 - rate`` rounded
    to ``x.dtype``, the quotient rounded to ``x.dtype``; differentiable,
    its backward the same map on the cotangent (what autograd through the
    plain chain gives, bit for bit).  ``seed_term``: the site seed's
    :func:`seed_terms` value (an int or a 0-dim int64 tensor), or ``None``
    for no dropout.

    On CPU tensors this runs :func:`hash_dropout_reference`; on CUDA
    tensors it launches ``csrc/hash_dropout.cu`` or raises."""
    if seed_term is None or rate <= 0.0:
        return x
    return _HashDropout.apply(x, rate, seed_term)
