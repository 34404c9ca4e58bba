"""The fused layer cut into sections: the plain versions and the wrappers
around the section variants of the kernels in ``csrc/fused_layer.cu``.

Counterpart of the stage kernels of the JAX package's
``scripts/profile_fused_sections.py`` (``_stage_fwd_kernel`` and
``_stage_bwd_kernel``).  Each runs the layer, or its backward, up to a
stage and stores that stage's (B, S, D) tensor in the input's type, so the
differences of the cumulative variants' times attribute the layer's time to
its sections (``tools/profile_fused_sections.py``):

- forward (``FWD_STAGES``): ``qkv`` the first D columns of the qkv dense
  (q), ``attn`` ctx, ``out_ln1`` x1 = LN1(x + dropout(ctx Wout + b)),
  ``ffn_gelu`` the first D columns of the GELU (needs F >= D), ``full``
  the layer's output;
- backward (``BWD_STAGES``): the layer recomputed from x, then
  ``recompute`` the recomputed output (with the A&S erf under bf16, so not
  the forward's), ``ffn_bwd`` T(dctx) after the VJP of LN2, the FFN and
  LN1, ``attn_bwd`` dx after the attention VJP and the qkv product,
  ``full`` dx of the whole backward (which also writes the parameter
  gradients).

The plain versions are the port's plain layer and backward cut at the
stage (``ops/fused_layer.py``: one helper each serves the whole function
and its cuts, so a section cannot drift from the layer).  The kernels are
the layer's forward kernel and the first pass of its backward compiled with
a stop stage; their ``full`` variants are the production kernels, and the
backward's ``full`` runs all three passes.

Two differences from the JAX stages, neither of them in the math: the JAX
backward's ``full`` stores ``dx + 1e-30 * sum(parameter-gradient
products)`` so that the TPU compiler keeps those products, which equals dx
wherever |dx| is above ~1e-20; and the JAX stages lane-pack four sequences
per attention tile, a TPU layout the port does not reproduce.
"""

from __future__ import annotations

import torch

from transformer_recommenders_tpu_torch.ops import fused_layer as fl

FWD_STAGES = fl.FWD_STAGES
BWD_STAGES = fl.BWD_STAGES


def _check(stage: str, stages, x: torch.Tensor, layer_params) -> None:
    if stage not in stages:
        msg = f"fused_sections: stage must be one of {stages}, got {stage!r}"
        raise ValueError(msg)
    s, d = x.shape[1], x.shape[2]
    if s > 64:
        msg = f"fused_sections: the fused layer supports s <= 64 (got s={s})"
        raise ValueError(msg)
    if stage == "ffn_gelu" and layer_params["ffn_in"]["w"].shape[1] < d:
        msg = "fused_sections: the ffn_gelu stage stores D columns of the FFN and needs F >= D"
        raise ValueError(msg)


def layer_stage_forward_reference(
    x: torch.Tensor,
    layer_params,
    key_mask: torch.Tensor,
    *,
    stage: str,
    num_heads: int,
    causal: bool,
    attn_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    dropout_seeds=None,
    layer_norm_eps: float = 1e-12,
) -> torch.Tensor:
    """Plain PyTorch version of the forward cut after ``stage``; at
    ``full`` it is ``fused_layer_reference``."""
    _check(stage, FWD_STAGES, x, layer_params)
    return fl._layer_forward(x, layer_params, key_mask, stage=stage, num_heads=num_heads,
                             causal=causal, attn_dropout=attn_dropout,
                             hidden_dropout=hidden_dropout, dropout_seeds=dropout_seeds,
                             layer_norm_eps=layer_norm_eps)


def layer_stage_backward_reference(
    x: torch.Tensor,
    layer_params,
    key_mask: torch.Tensor,
    dy: torch.Tensor,
    *,
    stage: str,
    num_heads: int,
    causal: bool,
    attn_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    dropout_seeds=None,
    layer_norm_eps: float = 1e-12,
) -> torch.Tensor:
    """Plain PyTorch version of the backward cut after ``stage``; at
    ``full`` (and at ``attn_bwd``) it is ``fused_layer_backward_reference``'s
    dx."""
    _check(stage, BWD_STAGES, x, layer_params)
    out = fl._layer_backward(x, layer_params, key_mask, dy, stage=stage, num_heads=num_heads,
                             causal=causal, attn_dropout=attn_dropout,
                             hidden_dropout=hidden_dropout, dropout_seeds=dropout_seeds,
                             layer_norm_eps=layer_norm_eps)
    return out[0] if stage == "full" else out


def layer_stage_forward(
    x: torch.Tensor,
    layer_params,
    key_mask: torch.Tensor,
    *,
    stage: str,
    num_heads: int,
    causal: bool,
    attn_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    dropout_seeds=None,
    layer_norm_eps: float = 1e-12,
) -> torch.Tensor:
    """The forward cut after ``stage``: its (B, S, D) tensor in ``x.dtype``.

    Args as ``fused_layer`` (f32 parameters, three dropout site seeds or
    ``None``).  On CPU tensors this runs
    :func:`layer_stage_forward_reference`; on CUDA tensors it launches the
    forward kernel's variant for ``stage`` or raises."""
    kw = dict(stage=stage, num_heads=num_heads, causal=causal, attn_dropout=attn_dropout,
              hidden_dropout=hidden_dropout, dropout_seeds=dropout_seeds,
              layer_norm_eps=layer_norm_eps)
    if x.device.type == "cpu":
        return layer_stage_forward_reference(x, layer_params, key_mask, **kw)
    _check(stage, FWD_STAGES, x, layer_params)
    params = [layer_params[m][n] for m, n in fl._PARAM_ORDER]
    return fl._fwd_cuda(x, params, key_mask, ffn_dim=None, counter="fused_layer_stage_fwd", **kw)


def layer_stage_backward(
    x: torch.Tensor,
    layer_params,
    key_mask: torch.Tensor,
    dy: torch.Tensor,
    *,
    stage: str,
    num_heads: int,
    causal: bool,
    attn_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    dropout_seeds=None,
    layer_norm_eps: float = 1e-12,
) -> torch.Tensor:
    """The backward cut after ``stage``: its (B, S, D) tensor in
    ``x.dtype`` (dx at ``attn_bwd`` and ``full``).

    On CPU tensors this runs :func:`layer_stage_backward_reference`; on
    CUDA tensors it launches the first backward pass's variant for
    ``stage`` (at ``full``, the whole three-pass backward) or raises."""
    kw = dict(stage=stage, num_heads=num_heads, causal=causal, attn_dropout=attn_dropout,
              hidden_dropout=hidden_dropout, dropout_seeds=dropout_seeds,
              layer_norm_eps=layer_norm_eps)
    if x.device.type == "cpu":
        return layer_stage_backward_reference(x, layer_params, key_mask, dy, **kw)
    _check(stage, BWD_STAGES, x, layer_params)
    params = [layer_params[m][n] for m, n in fl._PARAM_ORDER]
    dx, _ = fl._bwd_cuda(x, params, key_mask, dy, ffn_dim=None,
                         counter="fused_layer_stage_bwd", **kw)
    return dx
