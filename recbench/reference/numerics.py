"""Products at a stated precision, and the counter-based dropout hash.

The hash is murmur3's ``fmix32`` over each element's row-major index and
the site seed, kept where ``fmix32(i * 0x9E3779B1 + seed * 0x85EBCA77) >=
rate * 2**32`` (the recommender's dropout: the program draws its masks
the same way).  The uint32 arithmetic runs in int64 with every product
masked back to 32 bits.
"""

from __future__ import annotations

import contextlib

import torch

PREMIX_IDX = 0x9E3779B1
PREMIX_SEED = 0x85EBCA77
MASK32 = 0xFFFFFFFF
FP8_MAX = 448.0  # float8 e4m3fn's largest finite value


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = (h * (c & 0xFFFF)) & MASK32
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h & MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_mask(shape, seed: int, rate: float, device) -> torch.Tensor:
    """Bool keep mask of a tensor of ``shape`` at the dropout site ``seed``."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, device=device, dtype=torch.int64).view(shape)
    term = (int(seed) & MASK32) * PREMIX_SEED & MASK32
    h = (_mul32(idx, PREMIX_IDX) + term) & MASK32
    return fmix32(h) >= min(int(rate * 4294967296.0), MASK32)


def dropout(x: torch.Tensor, rate: float, seed: int | None) -> torch.Tensor:
    """Inverted dropout: kept elements divided by ``1 - rate``."""
    if seed is None or rate <= 0.0:
        return x
    keep = keep_mask(x.shape, seed, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude mapped to 448), returned in f32."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to fp8; the backward's two
    products round theirs (the cotangent included) the same way."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_fp8(a) @ round_fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = round_fp8(g)
        return g8 @ round_fp8(b).transpose(-1, -2), round_fp8(a).transpose(-1, -2) @ g8


class Precision:
    """What a matrix product rounds its operands to, and what an
    activation is stored in: ``"f32"`` (nothing rounded) or ``"fp8"`` (the
    control: each product's operands, the backward's included, and each
    activation the program keeps in its compute dtype (a dense's output,
    a residual sum, a LayerNorm's output, the GELU's) rounded to fp8; the
    activations' gradient passes through their rounding unchanged)."""

    def __init__(self, name: str = "f32") -> None:
        if name not in ("f32", "fp8"):
            msg = f"precision must be f32 or fp8, got {name!r}"
            raise ValueError(msg)
        self.name = name

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return x + (round_fp8(x) - x).detach()
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b


@contextlib.contextmanager
def no_tf32():
    """Full f32 products for the duration (TF32 off for cuBLAS and cuDNN)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
