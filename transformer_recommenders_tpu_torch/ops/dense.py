"""The dense of the layer stack and the input projection: the plain
PyTorch version and the wrappers around the CUDA kernels of
``csrc/dense.cu`` (#19: forward, dgrad, wgrad).

Counterpart of ``transformer_recommenders_tpu/models/transformer.py``
``_dense``, ``jnp.dot(x.astype(dtype), w.astype(dtype),
preferred_element_type=f32) + b`` narrowed to ``dtype``, which JAX leaves
to XLA (there is no Pallas kernel).  With ``g`` the cotangent of ``y`` in
``dtype``, the plain graph's autograd computes

- ``y  = dtype(sum_k dtype(x) dtype(w) [f32] + b [f32])``;
- ``dx = dtype(sum_n g dtype(w) [f32])``, then in x's dtype;
- ``dW = f32(dtype(sum_t dtype(x) g [f32]))`` (the backward of the weight's
  rounding rounds its gradient);
- ``db = sum_t g`` in f32.

:func:`dense` dispatches by input (:func:`kernel_admits`): bf16 on the
card with K and N multiples of 8 (the 16-byte rows TMA reads) runs
:class:`Dense` on the kernels; everything else, f32 configurations and
the CPU included, runs :func:`dense_reference`, today's ops, and a bf16
call on the card that does so is counted under ``dense_plain``.
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.ops import cuda_build

ALIGN = 8  # K and N in elements: 16-byte rows of bf16


def dense_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Matmul on ``dtype``-rounded operands with f32 products and sums, an
    f32 bias, and the result narrowed back to ``dtype``.  f32 matmuls stay
    in full f32 (TF32 is off by default)."""
    out = x.to(dtype).float() @ w.to(dtype).float() + b
    return out.to(dtype)


def on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def kernel_admits(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether #19 takes the dense: bf16 on the card, K and N multiples of
    8."""
    k, n = w.shape
    return on_card(x) and dtype == torch.bfloat16 and k % ALIGN == 0 and n % ALIGN == 0


def _rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` as a contiguous bf16 (rows, width) matrix at a 16-byte aligned
    address, as the kernels' tensor maps read it."""
    t = t.to(torch.bfloat16).reshape(-1, width).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_cuda(x2: torch.Tensor, w16: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y (M, N) bf16 of x2 (M, K) and w16 (K, N) bf16 and b (N,) f32."""
    (m, k), n = x2.shape, w16.shape[1]
    b = b.float().contiguous()
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    status = cuda_build.library("dense").dense_fwd(
        x2.data_ptr(), w16.data_ptr(), b.data_ptr(), y.data_ptr(), m, k, n,
        cuda_build.stream_handle(x2.device))
    cuda_build.check(status, "dense_fwd launch")
    cuda_build.LAUNCHES["dense_fwd"] += 1
    return y


def _dgrad_cuda(g2: torch.Tensor, w16: torch.Tensor) -> torch.Tensor:
    """dx (M, K) bf16 of g2 (M, N) and w16 (K, N) bf16."""
    (m, n), k = g2.shape, w16.shape[0]
    dx = torch.empty((m, k), dtype=torch.bfloat16, device=g2.device)
    status = cuda_build.library("dense").dense_dgrad(
        g2.data_ptr(), w16.data_ptr(), dx.data_ptr(), m, k, n,
        cuda_build.stream_handle(g2.device))
    cuda_build.check(status, "dense_dgrad launch")
    cuda_build.LAUNCHES["dense_dgrad"] += 1
    return dx


def wgrad_splits(t: int, k: int, n: int, device) -> int:
    """The splits of the T rows that the wgrad kernel takes on ``device``."""
    return cuda_build.splits("dense", "dense_wgrad_splits", torch.device(device).index or 0,
                             t, k, n)


def _wgrad_cuda(x2: torch.Tensor, g2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW (K, N), db (N,)), f32, of x2 (T, K) and g2 (T, N) bf16."""
    (t, k), n = x2.shape, g2.shape[1]
    if t == 0:
        return (torch.zeros((k, n), dtype=torch.float32, device=x2.device),
                torch.zeros(n, dtype=torch.float32, device=x2.device))
    splits = wgrad_splits(t, k, n, x2.device)
    part = torch.empty(splits * k * n, dtype=torch.float32, device=x2.device)
    db_part = torch.empty(splits * n, dtype=torch.float32, device=x2.device)
    dw = torch.empty((k, n), dtype=torch.float32, device=x2.device)
    db = torch.empty(n, dtype=torch.float32, device=x2.device)
    status = cuda_build.library("dense").dense_wgrad(
        x2.data_ptr(), g2.data_ptr(), part.data_ptr(), db_part.data_ptr(), dw.data_ptr(),
        db.data_ptr(), t, k, n, splits, cuda_build.stream_handle(x2.device))
    cuda_build.check(status, "dense_wgrad launch")
    cuda_build.LAUNCHES["dense_wgrad"] += 1
    return dw, db


class Dense(torch.autograd.Function):
    """The bf16 dense on the kernels (the caller has checked
    :func:`kernel_admits`), with the plain graph's rounding points (the
    module's docstring).  Keeps ``bf16(x)`` and ``bf16(w)`` for the
    backward, not their f32 copies."""

    @staticmethod
    def forward(ctx, x, w, b):
        k, n = w.shape
        ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype
        x16, w16 = _rows(x, k), _rows(w, n)
        ctx.save_for_backward(x16, w16)
        return _fwd_cuda(x16, w16, b).reshape(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        k, n = w16.shape
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        g2 = _rows(g, n)
        if need_x:
            dx = _dgrad_cuda(g2, w16).reshape(*g.shape[:-1], k).to(ctx.x_dtype)
        if need_w or need_b:
            dw, db = _wgrad_cuda(x16, g2)
            dw = dw.to(ctx.w_dtype)
        return dx, dw, db


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``transformer._dense``: x (..., K) by w (K, N) plus b (N,), operands
    rounded to ``dtype``, f32 sums and bias, the result in ``dtype``;
    differentiable in x, w and b.  #19 where :func:`kernel_admits` the
    call, else the plain ops (counted under ``dense_plain`` when a bf16
    call on the card takes them)."""
    if kernel_admits(x, w, dtype):
        return Dense.apply(x, w, b)
    if dtype == torch.bfloat16 and on_card(x):
        cuda_build.LAUNCHES["dense_plain"] += 1
    return dense_reference(x, w, b, dtype)
