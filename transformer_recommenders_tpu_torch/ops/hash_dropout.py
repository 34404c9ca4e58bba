"""The counter-based dropout hash (murmur3 ``fmix32`` over the global
element index), shared by the plain paths and, as the same constants, by
the CUDA fused-layer kernel (``csrc/fused_layer.cu``).

Counterpart of ``transformer_recommenders_tpu/ops/hash_dropout.py``; the
keep masks are bit-identical to the JAX ones.  PyTorch's uint32 coverage
is partial, so the plain path does the uint32 arithmetic in int64 and
masks every product back to 32 bits.
"""

from __future__ import annotations

import torch

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
