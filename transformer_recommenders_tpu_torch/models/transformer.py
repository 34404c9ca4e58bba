"""Causal transformer encoder over item-embedding sequences.

Counterpart of ``transformer_recommenders_tpu/models/transformer.py``.
Parameters are a nested dict of f32 tensors with the JAX pytree's layout
(``pos_embed``, ``embed_ln``, ``input_proj`` and the ``layers`` stacked
along a leading (num_layers, ...) axis), so :func:`params_from_jax` carries
JAX weights across unchanged and ``params.npz`` files are interchangeable.

The layers run one of two paths, chosen as the JAX package chooses them
(:func:`_fused_layer_mode`, by configuration and shape alone):

- the fused layer (``ops.fused_layer.fused_layer``: the CUDA kernel on the
  card, its plain version on the CPU) where ``use_fused_layer`` is set,
  ``hidden_size`` is a multiple of 128 and the sequence length a multiple
  of 8 of at most 64;
- otherwise the layer stack of PyTorch ops with autograd for the
  backward (JAX's XLA path: ``_attention`` in its ``masked`` and ``split``
  forms, the bf16 attention core with its own backward, ``_ffn``, the
  one-sweep LayerNorm variance at s > 64, ``remat_layers`` as activation
  checkpointing).  What JAX leaves to XLA has kernels of its own on the
  card: the denses under bf16 (``ops.dense``, #19, forward and both
  gradients; the plain ops elsewhere), the hash dropout at every site
  (``ops.hash_dropout``, #16) and the bf16 attention core at S <= 128,
  dh 32 or 64 (``ops.attn_core``, #17/#18).

The stack rounds to the compute dtype where the JAX source does, op by op
(as JAX runs its ops one at a time): each dense's output, each residual
sum before its f32 LayerNorm, and under bf16 every step of the GELU.
JAX's compiled step fuses some of these and keeps the intermediate in f32
(the residual sums, the GELU's ``erfc`` argument): one bf16 ulp apart here
and there, a mean of ~3e-3 on a layer's outputs.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from transformer_recommenders_tpu_torch import resolve_device, tracing
from transformer_recommenders_tpu_torch.configs import ModelConfig
from transformer_recommenders_tpu_torch.ops.attn_core import Softmax, attn_core_bf16
from transformer_recommenders_tpu_torch.ops.dense import dense
from transformer_recommenders_tpu_torch.ops.fused_layer import attention_bias, fused_layer
from transformer_recommenders_tpu_torch.ops.hash_dropout import hash_dropout, seed_tensor, seed_terms

Params = dict[str, Any]

_NEG_INF = -1e9
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def _dense_init(gen: torch.Generator, d_in: int, d_out: int, std: float) -> Params:
    return {"w": std * torch.randn(d_in, d_out, generator=gen), "b": torch.zeros(d_out)}


def _ln_init(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def _layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, f = cfg.hidden_size, cfg.intermediate_size
    std = cfg.initializer_range
    return {
        "qkv": _dense_init(gen, d, 3 * d, std),
        "out": _dense_init(gen, d, d, std),
        "ln1": _ln_init(d),
        "ffn_in": _dense_init(gen, d, f, std),
        "ffn_out": _dense_init(gen, f, d, std),
        "ln2": _ln_init(d),
    }


def _stack(trees: list[Params]) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_transformer_params(
    generator: torch.Generator, cfg: ModelConfig, *, device=None
) -> Params:
    """Encoder parameters (f32) drawn from ``generator`` (a CPU generator,
    so a seed gives the same weights on every device), with the layers
    stacked along a leading (num_layers, ...) axis."""
    per_layer = [_layer_init(generator, cfg) for _ in range(cfg.num_hidden_layers)]
    params: Params = {
        "pos_embed": cfg.initializer_range
        * torch.randn(cfg.max_seq_length, cfg.hidden_size, generator=generator),
        "embed_ln": _ln_init(cfg.hidden_size),
        "layers": _stack(per_layer),
    }
    if cfg.resolved_input_dim != cfg.hidden_size:
        params["input_proj"] = _dense_init(
            generator, cfg.resolved_input_dim, cfg.hidden_size, cfg.initializer_range
        )
    dev = resolve_device(device)
    return _map(lambda t: t.to(dev), params)


def params_from_jax(tree_of_numpy, *, device=None) -> Params:
    """The JAX parameter pytree (nested dicts of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) as f32 tensors on ``device``."""
    dev = resolve_device(device)
    return _map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev),
        tree_of_numpy,
    )


def tree_leaves(tree: Params) -> list[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, depth first."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template: Params, leaves: list) -> Params:
    """Inverse of :func:`tree_leaves` against a template of the structure."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)

    out = fill(template)
    if next(it, None) is not None:
        msg = "more leaves than the template has"
        raise ValueError(msg)
    return out


def unstack_layer(params: Params, i: int) -> Params:
    """Per-layer view of the stacked layer parameters."""
    return _map(lambda t: t[i], params["layers"])


def _layer_norm(
    x: torch.Tensor,
    p: Params,
    eps: float,
    out_dtype: torch.dtype | None = None,
    *,
    fast_variance: bool = False,
) -> torch.Tensor:
    """LayerNorm in f32; the output joins the activation stream in
    ``out_dtype``.  The variance is two-pass, or with ``fast_variance`` the
    one-sweep E[x^2] - E[x]^2 clamped at 0 (JAX's form at s > 64)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    if fast_variance:
        var = (x32.square().mean(dim=-1, keepdim=True) - mean.square()).clamp(min=0.0)
    else:
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(out_dtype) if out_dtype is not None else out


def _dense(x: torch.Tensor, p: Params, dtype: torch.dtype) -> torch.Tensor:
    """Matmul on ``dtype``-rounded operands with f32 products and sums, an
    f32 bias, and the result narrowed back to ``dtype``: ``ops.dense.dense``
    (#19 on the card under bf16, else the plain ops; f32 matmuls stay in
    full f32, TF32 is off by default)."""
    return dense(x, p["w"], p["b"], dtype)


def _fused_layer_mode(cfg: ModelConfig, s: int) -> bool:
    """Whether the layers run the fused layer (else the layer stack): JAX
    ``_fused_layer_mode``'s gate, by configuration and shape alone.  JAX
    also sends the CPU to its stack, because a Pallas kernel does not
    compile there; the port's fused layer has a plain version on the CPU,
    so the CPU takes the card's path."""
    return bool(cfg.use_fused_layer) and cfg.hidden_size % 128 == 0 and s % 8 == 0 and s <= 64


def _attention(x: torch.Tensor, p: Params, cfg: ModelConfig, key_mask: torch.Tensor,
               seed_term: int | torch.Tensor | None) -> torch.Tensor:
    """The stack's attention block (JAX ``_attention``): the qkv dense,
    then ``masked`` (every head's scores over all D channels of a
    head-masked q, dropout on the f32 probs) or ``split`` (per-head
    scores; under bf16 ``ops.attn_core.attn_core_bf16``), then the out dense.
    ``auto`` is ``masked`` at s <= 64."""
    b, s, d = x.shape
    h = cfg.num_attention_heads
    dh = d // h
    dtype = compute_dtype(cfg)
    rate = cfg.attention_dropout if seed_term is not None else 0.0
    qkv = _dense(x, p["qkv"], dtype)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    scale = 1.0 / math.sqrt(dh)
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "masked" if s <= 64 else "split"
    if impl == "masked":
        # channel c belongs to head c // dh: each head's product over all D
        # channels of q times its 0/1 mask is exact
        heads = torch.arange(h, device=x.device)[:, None]
        hmask = (torch.arange(d, device=x.device)[None, :] // dh == heads).to(dtype)
        qh = q[:, None] * hmask[None, :, None, :]
        scores = torch.einsum("bhsc,btc->bhst", qh.float(), k.float()) * scale
        probs = hash_dropout(Softmax.apply(scores + attention_bias(key_mask, s, cfg.is_decoder)),
                             rate, seed_term)
        ctx_full = torch.einsum("bhst,btc->bhsc", probs.to(dtype).float(), v.float()).to(dtype)
        ctx = (ctx_full * hmask[None, :, None, :]).sum(dim=1)
        return _dense(ctx, p["out"], dtype)
    q, k, v = (t.reshape(b, s, h, dh) for t in (q, k, v))
    if dtype == torch.bfloat16:
        ctx = attn_core_bf16(q, k, v, key_mask, seed_term, rate, cfg.is_decoder)
    else:
        scores = torch.einsum("bshd,bthd->bhst", q, k)
        probs = Softmax.apply(scores * scale + attention_bias(key_mask, s, cfg.is_decoder))
        ctx = torch.einsum("bhst,bthd->bshd", hash_dropout(probs, rate, seed_term).to(dtype), v)
    return _dense(ctx.reshape(b, s, d), p["out"], dtype)


_SQRT_HALF = math.sqrt(0.5)


def _gelu(u: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=False)``, 0.5 * u * erfc(-u * sqrt(0.5)),
    with the constant in u's dtype and every op's result rounded to u's
    dtype, as JAX computes it op by op: under bf16 the product -u * c, its
    ``erfc`` (taken in f32) and the final product each round to bf16.
    (JAX's compiled CPU step keeps -u * c in f32; it differs from this in
    about a third of the bf16 outputs, by one ulp.)"""
    c = torch.full((), _SQRT_HALF, dtype=u.dtype, device=u.device)  # no copy from the host
    e = torch.erfc((-u * c).float()).to(u.dtype)
    return (0.5 * u) * e


def _ffn(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    dtype = compute_dtype(cfg)
    return _dense(_gelu(_dense(x, p["ffn_in"], dtype)), p["ffn_out"], dtype)


def _stack_layer(x: torch.Tensor, layer: Params, cfg: ModelConfig, key_mask: torch.Tensor,
                 terms, fast_ln: bool) -> torch.Tensor:
    """One layer of the stack (JAX ``layer_fn``): attention, dropout,
    post-LN; FFN, dropout, post-LN.  ``terms``: the ``seed_terms``
    values of the layer's three site seeds, or ``None``."""
    dtype = compute_dtype(cfg)
    eps = cfg.layer_norm_eps
    r1, r2, r3 = terms if terms is not None else (None, None, None)
    attn = hash_dropout(_attention(x, layer, cfg, key_mask, r1), cfg.hidden_dropout, r2)
    x = _layer_norm(x + attn, layer["ln1"], eps, dtype, fast_variance=fast_ln)
    ffn = hash_dropout(_ffn(x, layer, cfg), cfg.hidden_dropout, r3)
    return _layer_norm(x + ffn, layer["ln2"], eps, dtype, fast_variance=fast_ln)


def pool_tokens(
    token_embeddings: torch.Tensor, attention_mask: torch.Tensor, mode: str
) -> torch.Tensor:
    """Sequence pooling (sentence-transformers ``Pooling``)."""
    mask_f = attention_mask.float()[..., None]
    if mode == "mean":
        total = (token_embeddings * mask_f).sum(dim=-2)
        count = mask_f.sum(dim=-2).clamp(min=1e-9)
        return total / count
    if mode == "max":
        masked = torch.where(attention_mask[..., None].bool(), token_embeddings, _NEG_INF)
        return masked.amax(dim=-2)
    if mode == "cls":
        return token_embeddings[..., 0, :]
    if mode == "lasttoken":
        last = (attention_mask.long().sum(dim=-1) - 1).clamp(min=0)
        index = last[..., None, None].expand(*last.shape, 1, token_embeddings.shape[-1])
        return torch.gather(token_embeddings, -2, index).squeeze(-2)
    msg = f"unknown pooling_mode: {mode}"
    raise ValueError(msg)


def transformer_encode(
    params: Params,
    cfg: ModelConfig,
    input_embeds: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    *,
    dropout_seeds=None,
    inputs_projected: bool = False,
) -> dict[str, torch.Tensor]:
    """Encode a batch of embedding sequences.

    Args:
        params: from :func:`init_transformer_params` or :func:`params_from_jax`.
        cfg: model config.
        input_embeds: ``(batch, seq, input_dim)`` float tensor, already cut
            to at most ``cfg.max_seq_length`` positions.
        attention_mask: optional ``(batch, seq)`` bool; by default a
            position is valid when any component of the UNPROJECTED input
            is nonzero.
        dropout_seeds: ``None`` (inference) or ``1 + 3 * num_layers`` uint32
            seeds: the embedding site, then each layer's three sites; a
            list or an integer tensor.

    Returns:
        ``token_embeddings`` (B, S, D) f32, ``sentence_embedding`` (B, D)
        f32 and ``attention_mask`` (B, S) bool.
    """
    s = input_embeds.shape[-2]
    if s > cfg.max_seq_length:
        msg = f"sequence length {s} exceeds max_seq_length {cfg.max_seq_length}"
        raise ValueError(msg)
    dtype = compute_dtype(cfg)
    n_layers = cfg.num_hidden_layers
    fast_ln = s > 64  # JAX's one-sweep variance where no fused layer runs
    with tracing.span("embed", request=False):
        if attention_mask is None:
            attention_mask = (input_embeds != 0).any(dim=-1)
        attention_mask = attention_mask.bool()
        seeds = terms = None
        if dropout_seeds is not None:
            # a tensor becomes one int64 tensor on the inputs' device, read
            # there by every dropout site (no copy to the host: a CUDA graph
            # of the step reads each replay's seeds); a list stays host
            # ints.  The plain sites take their seeds' share of the hash,
            # worked out here once for all of them
            if isinstance(dropout_seeds, torch.Tensor):
                seeds = seed_tensor(dropout_seeds, input_embeds.device)
            else:
                seeds = [int(v) for v in dropout_seeds]
            if len(seeds) != 1 + 3 * n_layers:
                msg = f"dropout_seeds needs {1 + 3 * n_layers} seeds, got {len(seeds)}"
                raise ValueError(msg)
            terms = seed_terms(seeds)

        x = input_embeds
        if "input_proj" in params and not inputs_projected:
            x = _dense(x, params["input_proj"], dtype)
        x = x.to(dtype) + params["pos_embed"][:s].to(dtype)
        x = _layer_norm(x, params["embed_ln"], cfg.layer_norm_eps, dtype, fast_variance=fast_ln)
        x = hash_dropout(x, cfg.hidden_dropout, terms[0] if terms is not None else None)
    x = tracing.mark_backward(x, "embed")
    with tracing.span("encoder", request=False):
        fused = _fused_layer_mode(cfg, s)
        for i in range(n_layers):
            layer = unstack_layer(params, i)
            layer_seeds = seeds[1 + 3 * i : 4 + 3 * i] if seeds is not None else None
            layer_terms = terms[1 + 3 * i : 4 + 3 * i] if terms is not None else None
            if fused:
                x = fused_layer(
                    x,
                    layer,
                    attention_mask,
                    num_heads=cfg.num_attention_heads,
                    causal=cfg.is_decoder,
                    attn_dropout=cfg.attention_dropout if seeds is not None else 0.0,
                    hidden_dropout=cfg.hidden_dropout if seeds is not None else 0.0,
                    dropout_seeds=layer_seeds,
                    ffn_dim=cfg.intermediate_size,
                    layer_norm_eps=cfg.layer_norm_eps,
                )
            elif cfg.remat_layers and torch.is_grad_enabled():
                # recompute the layer's internals in the backward instead of
                # keeping them (the hash dropout recomputes the same masks)
                x = checkpoint(_stack_layer, x, layer, cfg, attention_mask, layer_terms, fast_ln,
                               use_reentrant=False)
            else:
                x = _stack_layer(x, layer, cfg, attention_mask, layer_terms, fast_ln)

        token_embeddings = x.float()
        sentence_embedding = pool_tokens(token_embeddings, attention_mask, cfg.pooling_mode)
        if cfg.is_normalized:
            norm = torch.linalg.vector_norm(sentence_embedding, dim=-1, keepdim=True)
            sentence_embedding = sentence_embedding / norm.clamp(min=1e-12)
        return {
            "token_embeddings": token_embeddings,
            "sentence_embedding": sentence_embedding,
            "attention_mask": attention_mask,
        }

