"""The layer stack's bf16 split-attention core: the plain PyTorch version
and the wrappers around the CUDA kernels of ``csrc/attn_core.cu`` (#17
forward, #18 backward).

Counterpart of ``transformer_recommenders_tpu/models/transformer.py``
``_attn_core_bf16``, a custom-VJP function that JAX leaves to XLA (there
is no Pallas kernel): q k^T -> f32 softmax -> bf16 -> hash dropout -> P V
over (B, S, H, dh) bf16 q, k, v, giving f32 ctx.  JAX keeps the bf16
probs y as its residual; the port keeps each row's softmax max m and sum
l (f32, (B, H, S)) instead and rebuilds y from them, with the forward's
own ops, bit for bit.  The backward rebuilds the dropped probs from the
hash, rounds the cotangent and the score gradient to bf16 before their
products, and gives bf16 dq, dk, dv.

:func:`attn_core_bf16` is a ``torch.autograd.Function`` that dispatches
by a stated shape gate (:func:`kernel_admits`: S <= 128 and dh in {32,
64}; ``configs/ml25m_ccl.yaml``'s dh = 32 at seq 128): on CUDA tensors
the gate's shapes launch the kernels (or raise), and the others run the
plain version, whose three dropout masks are ``hash_dropout``'s (#16).  On
CPU tensors it runs the plain version.
"""

from __future__ import annotations

import math

import torch

from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops.fused_layer import attention_bias
from transformer_recommenders_tpu_torch.ops.hash_dropout import (
    hash_dropout,
    keep_divisor,
    keep_threshold,
    seed_argument,
)

MAX_SEQ = 128  # csrc/attn_core.cu kMaxS: a warp holds 16 rows of S x S scores in registers
HEAD_DIMS = (32, 64)  # the kernels' head widths (templates)


def kernel_admits(s: int, dh: int, dtype) -> bool:
    """Whether #17/#18 take the core on the card: the gate's shapes."""
    return dtype == torch.bfloat16 and 1 <= s <= MAX_SEQ and dh in HEAD_DIMS


class Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum, and the
    transpose of its custom JVP, y * (g - sum(g * y))."""

    @staticmethod
    def forward(ctx, x):
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        y = e / e.sum(dim=-1, keepdim=True)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * (g - (g * y).sum(dim=-1, keepdim=True))


def _scores(q, k, key_mask, causal: bool):
    """The f32 scores (B, H, S, S): q k^T * (1 / sqrt(dh)) + the bias."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
            + attention_bias(key_mask, q.shape[1], causal))


def probs_from_stats(q, k, key_mask, m, l, causal: bool):
    """y, the bf16 probs (B, H, S, S), from the rows' max ``m`` and sum
    ``l``: exp(scores - m) / l with the forward's own ops, so on one device
    bit for bit the forward's y (``Softmax``'s exp(x - max) / sum)."""
    e = torch.exp(_scores(q, k, key_mask, causal) - m[..., None])
    return (e / l[..., None]).to(torch.bfloat16)


def attn_core_reference(q, k, v, key_mask, seed_term, rate: float, causal: bool, *,
                        with_y: bool = False):
    """The plain forward: (ctx f32 (B, S, H, dh), m, l f32 (B, H, S)), and
    with ``with_y`` y bf16 (B, H, S, S) after them."""
    scores = _scores(q, k, key_mask, causal)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    l = e.sum(dim=-1)
    y = (e / l[..., None]).to(torch.bfloat16)
    probs = hash_dropout(y, rate, seed_term)
    ctx = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return (ctx, m, l, y) if with_y else (ctx, m, l)


def attn_core_backward_reference(q, k, v, key_mask, m, l, g, seed_term, rate: float,
                                 causal: bool):
    """The plain backward from the forward's ``m``, ``l`` and the ctx
    cotangent ``g``: (dq, dk, dv), bf16.  y is rebuilt from the statistics;
    the probs' dropout divides by ``1 - rate`` rounded to bf16, their
    cotangent's (f32) by it in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    y16 = probs_from_stats(q, k, key_mask, m, l, causal)
    g16 = g.to(torch.bfloat16).float()
    probs = hash_dropout(y16, rate, seed_term).float()
    dv = torch.einsum("bhst,bshd->bthd", probs, g16).to(v.dtype)
    dp = hash_dropout(torch.einsum("bshd,bthd->bhst", g16, v.float()), rate, seed_term)
    y = y16.float()
    ds = (y * (dp - (dp * y).sum(dim=-1, keepdim=True)) * scale).to(torch.bfloat16).float()
    dq = torch.einsum("bhst,bthd->bshd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float()).to(k.dtype)
    return dq, dk, dv


def _heads(q, k, v):
    """q, k, v as the kernels read them: one set of strides, dh contiguous.
    The layer stack's are views of one qkv tensor and pass as they are;
    others are copied."""
    if not q.stride() == k.stride() == v.stride() or q.stride(-1) != 1:
        q, k, v = (t.contiguous() for t in (q, k, v))
    return q, k, v


def _check(q, k, v) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        msg = f"attn_core: q, k, v on {q.device}, {k.device}, {v.device}"
        raise ValueError(msg)
    if q.dim() != 4 or not q.shape == k.shape == v.shape:
        msg = f"attn_core: q, k, v must share a (B, S, H, dh) shape, got {q.shape}"
        raise ValueError(msg)


def _mask(key_mask, device):
    """The (B, S) key mask as the kernels read it: bool, contiguous."""
    return key_mask.to(device=device, dtype=torch.bool).contiguous()


def _dropout_args(seed_term, rate: float, device):
    """(seed address, seed value, threshold, on) of the kernels."""
    if seed_term is None or rate <= 0.0:
        return None, 0, 0, 0
    ptr, value = seed_argument(seed_term, device)
    return ptr, value, keep_threshold(rate), 1


def _fwd_cuda(q, k, v, key_mask, seed_term, rate: float, causal: bool, *, with_y: bool = False):
    """#17: (ctx, m, l, y, (q, k, v)): ctx f32 (B, S, H, dh), m and l f32
    (B, H, S), y bf16 (B, H, S, S) with ``with_y`` (else None; the main
    path never writes it), and the q, k, v it read."""
    q, k, v = _heads(q, k, v)
    b, s, h, dh = q.shape
    m, l = (torch.empty((b, h, s), dtype=torch.float32, device=q.device) for _ in range(2))
    y = torch.empty((b, h, s, s), dtype=torch.bfloat16, device=q.device) if with_y else None
    ctx = torch.empty((b, s, h, dh), dtype=torch.float32, device=q.device)
    mask = _mask(key_mask, q.device)
    ptr, value, threshold, on = _dropout_args(seed_term, rate, q.device)
    status = cuda_build.library("attn_core").attn_core_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        mask.data_ptr(), m.data_ptr(), l.data_ptr(), y.data_ptr() if with_y else None,
        ctx.data_ptr(), b, s, h, dh, int(causal), 1.0 / math.sqrt(dh), ptr, value, threshold,
        keep_divisor(rate, torch.bfloat16) if on else 1.0, on,
        cuda_build.stream_handle(q.device))
    cuda_build.check(status, "attn_core_fwd launch")
    cuda_build.LAUNCHES["attn_core_fwd"] += 1
    return ctx, m, l, y, (q, k, v)


def _bwd_cuda(q, k, v, key_mask, m, l, g, seed_term, rate: float, causal: bool):
    """#18: (dq, dk, dv), bf16 (B, S, H, dh), from q, k, v as #17 read
    them, the key mask, #17's ``m`` and ``l`` and the f32 ctx cotangent
    ``g``."""
    b, s, h, dh = q.shape
    g = g.float().contiguous()  # the cotangent of #17's contiguous f32 ctx: no copy
    mask = _mask(key_mask, q.device)
    dq, dk, dv = (torch.empty((b, s, h, dh), dtype=torch.bfloat16, device=q.device)
                  for _ in range(3))
    ptr, value, threshold, on = _dropout_args(seed_term, rate, q.device)
    status = cuda_build.library("attn_core").attn_core_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        mask.data_ptr(), m.data_ptr(), l.data_ptr(), g.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h, dh, int(causal), 1.0 / math.sqrt(dh), ptr,
        value, threshold, keep_divisor(rate, torch.bfloat16) if on else 1.0,
        keep_divisor(rate, torch.float32) if on else 1.0, on,
        cuda_build.stream_handle(q.device))
    cuda_build.check(status, "attn_core_bwd launch")
    cuda_build.LAUNCHES["attn_core_bwd"] += 1
    return dq, dk, dv


def ctas_per_sm(backward: bool, s: int, dh: int) -> int:
    """The CTAs of #17 (or #18) that one SM of the current card holds at
    (S, dh), by the CUDA occupancy calculator."""
    n = cuda_build.library("attn_core").attn_core_ctas_per_sm(int(backward), s, dh)
    if n < 0:
        msg = f"attn_core_ctas_per_sm: CUDA error at S={s}, dh={dh}"
        raise RuntimeError(msg)
    return n


def probs_through_dv(q, k, v, key_mask, m, l, causal: bool):
    """y as #18 rebuilds it from #17's ``m`` and ``l``, read back through
    dv at rate 0: with g = 1 where s == c + j dh and 0 elsewhere, dv[t, c]
    = y[c + j dh, t] exactly (one product by 1 in an f32 sum of zeros);
    the windows j = 0 ... ceil(S / dh) - 1 give every row of y (B, H, S,
    S).  A check of the backward's y against the forward's optional one."""
    b, s, h, dh = q.shape
    y = torch.zeros((b, h, s, s), dtype=torch.bfloat16, device=q.device)
    for j in range(-(-s // dh)):
        rows = torch.arange(j * dh, min((j + 1) * dh, s), device=q.device)
        g = torch.zeros((b, s, h, dh), device=q.device)
        g[:, rows, :, rows - j * dh] = 1.0
        _, _, dv = _bwd_cuda(q, k, v, key_mask, m, l, g, None, 0.0, causal)
        y[:, :, rows, :] = dv[:, :, :, rows - j * dh].permute(0, 2, 3, 1)
    return y


def division_mismatches(b: float, device) -> int:
    """Of every float a in the kernels' branch-free range (0, or |a| in
    [2^-80, 2^80]), how many the kernels' division by ``b`` (in [2^-8,
    2^8]) gives other bits than ``__fdiv_rn`` for, on ``device``."""
    bad = torch.zeros((), dtype=torch.int64, device=device)
    status = cuda_build.library("attn_core").attn_core_div_check(
        b, 0, 1 << 32, bad.data_ptr(), cuda_build.stream_handle(bad.device))
    cuda_build.check(status, "attn_core_div_check launch")
    return int(bad)


class _AttnCoreBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, seed_term, rate, causal):
        ctx.kernel = q.device.type != "cpu" and kernel_admits(q.shape[1], q.shape[-1], q.dtype)
        if ctx.kernel:
            _check(q, k, v)
            key_mask = _mask(key_mask, q.device)
            out, m, l, _, (q, k, v) = _fwd_cuda(q, k, v, key_mask, seed_term, rate, causal)
        else:
            out, m, l = attn_core_reference(q, k, v, key_mask, seed_term, rate, causal)
        ctx.save_for_backward(q, k, v, key_mask, m, l)
        ctx.seed_term, ctx.rate, ctx.causal = seed_term, rate, causal
        return out

    @staticmethod
    def backward(ctx, g):
        args = (*ctx.saved_tensors, g, ctx.seed_term, ctx.rate, ctx.causal)
        grads = _bwd_cuda(*args) if ctx.kernel else attn_core_backward_reference(*args)
        return (*grads, None, None, None, None)


def attn_core_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor,
                   seed_term: int | torch.Tensor | None, rate: float,
                   causal: bool) -> torch.Tensor:
    """The bf16 attention core (JAX ``_attn_core_bf16``): f32 ctx (B, S, H,
    dh) of bf16 q, k, v (B, S, H, dh) under the (B, S) key mask, with hash
    dropout at ``rate`` under the site's ``seed_terms`` value (``None``: no
    dropout); differentiable in q, k and v.

    CPU tensors run the plain version; CUDA tensors launch #17/#18 where
    :func:`kernel_admits` the shape, else the plain version with #16."""
    return _AttnCoreBf16.apply(q, k, v, key_mask, seed_term, rate, causal)
