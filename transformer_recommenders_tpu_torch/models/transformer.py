"""Causal transformer encoder over item-embedding sequences.

Counterpart of ``transformer_recommenders_tpu/models/transformer.py``.
Parameters are a nested dict of f32 tensors with the JAX pytree's layout
(``pos_embed``, ``embed_ln``, ``input_proj`` and the ``layers`` stacked
along a leading (num_layers, ...) axis), so :func:`params_from_jax` carries
JAX weights across unchanged and ``params.npz`` files are interchangeable.

Every encoder layer goes through ``ops.fused_layer.fused_layer``: the CUDA
kernel on the card, its plain version on the CPU.  Sequences longer than
64 (the JAX package's XLA layer stack) are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from transformer_recommenders_tpu_torch import resolve_device
from transformer_recommenders_tpu_torch.configs import ModelConfig
from transformer_recommenders_tpu_torch.ops.fused_layer import _divisor, fused_layer
from transformer_recommenders_tpu_torch.ops.hash_dropout import keep_mask

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
    x: torch.Tensor, p: Params, eps: float, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """Two-pass LayerNorm in f32; the output joins the activation stream in
    ``out_dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(out_dtype) if out_dtype is not None else out


def _dense(x: torch.Tensor, p: Params, dtype: torch.dtype) -> torch.Tensor:
    """Matmul on ``dtype``-rounded operands with f32 products and sums, an
    f32 bias, and the result narrowed back to ``dtype``.  A plain matrix
    product outside any kernel (the JAX package leaves it to XLA); f32
    matmuls stay in full f32 (TF32 is off by default)."""
    out = x.to(dtype).float() @ p["w"].to(dtype).float() + p["b"]
    return out.to(dtype)


def _dropout(x: torch.Tensor, rate: float, seed: int | None) -> torch.Tensor:
    """Hash dropout over the linear index of ``x`` (JAX ``_dropout``)."""
    if seed is None or rate <= 0.0:
        return x
    idx = torch.arange(x.numel(), device=x.device, dtype=torch.int64).view(x.shape)
    kept = (x.float() / _divisor(rate, x.dtype, x.device)).to(x.dtype)
    return torch.where(keep_mask(idx, seed, rate), kept, torch.zeros((), dtype=x.dtype, device=x.device))


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
            seeds: the embedding site, then each layer's three sites.

    Returns:
        ``token_embeddings`` (B, S, D) f32, ``sentence_embedding`` (B, D)
        f32 and ``attention_mask`` (B, S) bool.
    """
    if attention_mask is None:
        attention_mask = (input_embeds != 0).any(dim=-1)
    attention_mask = attention_mask.bool()
    s = input_embeds.shape[-2]
    if s > cfg.max_seq_length:
        msg = f"sequence length {s} exceeds max_seq_length {cfg.max_seq_length}"
        raise ValueError(msg)
    if s > 64:
        msg = (
            f"sequence length {s} > 64: the long-sequence encoder (the JAX "
            "package's XLA layer stack) is not ported yet"
        )
        raise NotImplementedError(msg)
    dtype = compute_dtype(cfg)
    n_layers = cfg.num_hidden_layers
    seeds = None
    if dropout_seeds is not None:
        seeds = [int(v) for v in (
            dropout_seeds.reshape(-1).tolist()
            if isinstance(dropout_seeds, torch.Tensor) else dropout_seeds
        )]
        if len(seeds) != 1 + 3 * n_layers:
            msg = f"dropout_seeds needs {1 + 3 * n_layers} seeds, got {len(seeds)}"
            raise ValueError(msg)

    x = input_embeds
    if "input_proj" in params and not inputs_projected:
        x = _dense(x, params["input_proj"], dtype)
    x = x.to(dtype) + params["pos_embed"][:s].to(dtype)
    x = _layer_norm(x, params["embed_ln"], cfg.layer_norm_eps, dtype)
    x = _dropout(x, cfg.hidden_dropout, seeds[0] if seeds else None)

    for i in range(n_layers):
        x = fused_layer(
            x,
            unstack_layer(params, i),
            attention_mask,
            num_heads=cfg.num_attention_heads,
            causal=cfg.is_decoder,
            attn_dropout=cfg.attention_dropout if seeds else 0.0,
            hidden_dropout=cfg.hidden_dropout if seeds else 0.0,
            dropout_seeds=seeds[1 + 3 * i : 4 + 3 * i] if seeds else None,
            ffn_dim=cfg.intermediate_size,
            layer_norm_eps=cfg.layer_norm_eps,
        )

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

