"""One whole post-LN transformer encoder layer: the plain PyTorch version
and the wrapper around the CUDA kernel ``csrc/fused_layer.cu``.

Counterpart of ``transformer_recommenders_tpu/ops/fused_layer.py``
(``fused_layer`` and its Pallas ``_fwd_kernel``).  The layer is

    qkv dense -> per-head softmax(q k^T / sqrt(dh) + bias) -> hash dropout
    -> P V -> out dense -> dropout -> LN1(x + .) -> erf-GELU FFN
    -> dropout -> LN2(x1 + .)

with the JAX kernel's numerics: matmuls on compute-dtype operands with f32
accumulation plus an f32 bias, narrowed after each dense; residual adds in
the compute dtype before an f32 two-pass LayerNorm; probs cast to the
compute dtype before P V; the additive -1e9 key-padding plus causal bias;
the Eigen erf polynomial; the fmix32 dropout over the global element index
with three uint32 site seeds.  The TPU layout (head-masked wide tiles, the
FFN zero-padded to 128) is not carried over: the plain version uses
head-split attention and the real FFN width, which give the same output.

The backward (``fused_layer_backward_reference`` and the kernel's
``fused_layer_bwd``) follows the JAX ``_bwd_kernel`` step by step, not
autograd of the forward, because the JAX backward deliberately differs
from the exact derivative of its own forward in three places:

- its recompute of the layer uses the Abramowitz-Stegun erf (``_erf_as``)
  in the GELU under bf16 (``_APPROX_RECOMPUTE_ERF``), so the recomputed
  GELU and everything after it differ slightly from the forward's;
- its hidden-dropout VJP divides an f32 cotangent by the f32 ``1 - rate``,
  where the forward divided a bf16 activation by ``1 - rate`` rounded to
  bf16 (0.8984375 at rate 0.1);
- the cotangent is rounded to ``x.dtype`` first.

Every gradient product takes operands rounded to the compute dtype and
sums in f32; ``dx`` comes out in ``x.dtype`` and the 12 parameter
gradients in f32, summed over the batch.  :func:`fused_layer` is a
``torch.autograd.Function`` over the two.

Both plain versions, and both kernels, also stop after a stage of the
layer for its section profile (``FWD_STAGES``, ``BWD_STAGES``;
``ops/fused_sections.py``).
"""

from __future__ import annotations

import functools
import math

import torch

from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops.hash_dropout import (
    divisor,
    keep_divisor,
    keep_mask,
    keep_threshold,
    seed_tensor,
)

_NEG_INF = -1e9
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
_ERF_NUM = (2.77068142495902e-08, -2.10102402082508e-06, -5.69250639462346e-05,
            -7.34990630326855e-04, -2.95459980854025e-03, -1.60960333262415e-02)
_ERF_DEN = (-2.13374055278905e-04, -1.68282697438203e-03, -7.37332916720468e-03,
            -1.42647390514189e-02)


def _erf(x: torch.Tensor) -> torch.Tensor:
    """f32 erf as the Eigen/XLA rational polynomial (JAX ``_erf``)."""
    x = x.clamp(-3.832506856900711, 3.832506856900711)
    x2 = x * x
    a = torch.full_like(x, -2.72614225801306e-10)
    for c in _ERF_NUM:
        a = a * x2 + c
    a = a * x
    b = torch.full_like(x, -1.45660718464996e-05)
    for c in _ERF_DEN:
        b = b * x2 + c
    return a / b


def _erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf (JAX ``_erf_as``), which the JAX
    backward's recompute uses under bf16."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.47047 * ax)
    poly = t * (0.3480242 + t * (-0.0958798 + t * 0.7478556))
    mag = 1.0 - poly * torch.exp(-ax * ax)
    return torch.where(x < 0.0, -mag, mag)


def _gelu_grad(u: torch.Tensor, erf_u: torch.Tensor) -> torch.Tensor:
    """gelu'(u) = Phi(u) + u phi(u), with the recompute's erf of u/sqrt(2)."""
    phi = torch.exp(-0.5 * u * u) * _INV_SQRT2PI
    return 0.5 * (1.0 + erf_u) + u * phi


def _matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``transformer._dense``: operands rounded to ``dtype``, products and
    sums in f32 (a product of two bf16 values is exact in f32), f32 bias,
    result narrowed to ``dtype``."""
    out = x.to(dtype).float() @ w.to(dtype).float() + b.float()
    return out.to(dtype)


def _layer_norm(h: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """Two-pass f32 LayerNorm (JAX ``_ln_fwd``)."""
    h = h.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    return (h - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _hidden_dropout(a: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Dropout at a hidden site: index ``row * D + c`` over (B*S, D)."""
    b, s, d = a.shape
    idx = torch.arange(b * s * d, device=a.device, dtype=torch.int64).view(b, s, d)
    keep = keep_mask(idx, seed, rate)
    kept = (a.float() / divisor(rate, a.dtype, a.device)).to(a.dtype)
    return torch.where(keep, kept, torch.zeros((), dtype=a.dtype, device=a.device))


def attention_bias(key_mask: torch.Tensor, s: int, causal: bool) -> torch.Tensor:
    """(B, 1, S, S) additive f32 bias: key padding -1e9 plus causal -1e9."""
    bias = torch.where(key_mask[:, None, None, :].bool(), 0.0, _NEG_INF).float()
    if causal:
        tri = torch.ones((s, s), dtype=torch.bool, device=key_mask.device).tril()
        bias = bias + torch.where(tri, 0.0, _NEG_INF).float()
    return bias


def _seeds(dropout_seeds):
    """The three site seeds as ``keep_mask`` takes them: ints from a list,
    0-dim int64 tensors from a tensor (read on its device, never copied to
    the host)."""
    if dropout_seeds is None:
        return [0, 0, 0]
    if isinstance(dropout_seeds, torch.Tensor):
        seeds = list(dropout_seeds.reshape(-1).to(torch.int64))
    else:
        seeds = [int(v) & 0xFFFFFFFF for v in dropout_seeds]
    if len(seeds) != 3:
        msg = f"dropout_seeds needs 3 site seeds, got {len(seeds)}"
        raise ValueError(msg)
    return seeds


def fused_layer_reference(
    x: torch.Tensor,
    layer_params,
    key_mask: torch.Tensor,
    *,
    num_heads: int,
    causal: bool,
    attn_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    dropout_seeds=None,
    ffn_dim: int,
    layer_norm_eps: float = 1e-12,
) -> torch.Tensor:
    """Plain PyTorch version of the layer (see the module docstring)."""
    del ffn_dim  # the weights carry it
    return _layer_forward(x, layer_params, key_mask, stage="full", num_heads=num_heads,
                          causal=causal, attn_dropout=attn_dropout, hidden_dropout=hidden_dropout,
                          dropout_seeds=dropout_seeds, layer_norm_eps=layer_norm_eps)


# the section-profile variants of the kernels (csrc/fused_layer.cu FwdStop
# and BwdStop, in order): where each stops
FWD_STAGES = ("qkv", "attn", "out_ln1", "ffn_gelu", "full")
BWD_STAGES = ("recompute", "ffn_bwd", "attn_bwd", "full")


def _layer_forward(x, p, key_mask, *, stage, num_heads, causal, attn_dropout, hidden_dropout,
                   dropout_seeds, layer_norm_eps):
    """The layer of :func:`fused_layer_reference`, cut after ``stage`` (one
    of ``FWD_STAGES``): that stage's (B, S, D) tensor in ``x.dtype``; the
    first D columns of the (B, S, 3D) qkv and of the (B, S, F) GELU."""
    if dropout_seeds is None:
        attn_dropout = hidden_dropout = 0.0
    seeds = _seeds(dropout_seeds)
    dtype = x.dtype
    b, s, d = x.shape
    h = num_heads
    dh = d // h

    qkv = _matmul(x, p["qkv"]["w"], p["qkv"]["b"], dtype)
    if stage == "qkv":
        return qkv[..., :d]
    qkv = qkv.view(b, s, 3, h, dh)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3).float() for i in range(3))
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    # softmax spelled out as jax.nn.softmax computes it: exp(z - max) / sum
    z = scores + attention_bias(key_mask, s, causal)
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    if attn_dropout > 0.0:
        idx = torch.arange(b * h * s * s, device=x.device, dtype=torch.int64)
        keep = keep_mask(idx.view(b, h, s, s), seeds[0], attn_dropout)
        probs = torch.where(keep, probs / divisor(attn_dropout, torch.float32, x.device), 0.0)
    ctx = torch.matmul(probs.to(dtype).float(), v).to(dtype)
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, d)
    if stage == "attn":
        return ctx

    a = _matmul(ctx, p["out"]["w"], p["out"]["b"], dtype)
    if hidden_dropout > 0.0:
        a = _hidden_dropout(a, hidden_dropout, seeds[1])
    x1 = _layer_norm(x + a, p["ln1"]["scale"], p["ln1"]["bias"], layer_norm_eps).to(dtype)
    if stage == "out_ln1":
        return x1

    u = _matmul(x1, p["ffn_in"]["w"], p["ffn_in"]["b"], dtype).float()
    g = (0.5 * u * (1.0 + _erf(u * _INV_SQRT2))).to(dtype)
    if stage == "ffn_gelu":
        return g[..., :d]
    f = _matmul(g, p["ffn_out"]["w"], p["ffn_out"]["b"], dtype)
    if hidden_dropout > 0.0:
        f = _hidden_dropout(f, hidden_dropout, seeds[2])
    return _layer_norm(x1 + f, p["ln2"]["scale"], p["ln2"]["bias"], layer_norm_eps).to(dtype)


def _ln_stats(h32: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, rstd) of JAX ``_ln_fwd``: the pre-affine normalized value."""
    mean = h32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((h32 - mean).square().mean(dim=-1, keepdim=True) + eps)
    return (h32 - mean) * rstd, rstd


def _ln_bwd(dy32, n, rstd, scale):
    """JAX ``_ln_bwd``: dh = rstd * (g - mean(g) - n * mean(g * n)), g = dy * scale."""
    g = dy32 * scale.float()
    d = g.shape[-1]
    gm = g.sum(dim=-1, keepdim=True) / d
    gnm = (g * n).sum(dim=-1, keepdim=True) / d
    return rstd * (g - gm - n * gnm)


def _hidden_keep(shape, rate: float, seed: int, device) -> torch.Tensor:
    b, s, d = shape
    idx = torch.arange(b * s * d, device=device, dtype=torch.int64).view(b, s, d)
    return keep_mask(idx, seed, rate)


def _mm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """f32 product of ``dtype``-rounded operands (exact products, f32 sums)."""
    return a.to(dtype).float() @ b.to(dtype).float()


def fused_layer_backward_reference(
    x: torch.Tensor,
    layer_params,
    key_mask: torch.Tensor,
    dy: torch.Tensor,
    *,
    num_heads: int,
    causal: bool,
    attn_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    dropout_seeds=None,
    ffn_dim: int,
    layer_norm_eps: float = 1e-12,
):
    """Plain PyTorch version of the layer's backward: ``(dx, dparams)``.

    Step by step after the JAX ``_bwd_kernel`` (not autograd of
    :func:`fused_layer_reference`; see the module docstring): the layer is
    recomputed from ``x`` with the A&S erf under bf16, the cotangent is
    rounded to ``x.dtype``, the hidden-dropout VJP divides by the f32
    ``1 - rate``.  ``dx`` is in ``x.dtype``; ``dparams`` has the layout of
    ``layer_params``, f32, summed over every row of the batch."""
    del ffn_dim
    return _layer_backward(x, layer_params, key_mask, dy, stage="full", num_heads=num_heads,
                           causal=causal, attn_dropout=attn_dropout,
                           hidden_dropout=hidden_dropout, dropout_seeds=dropout_seeds,
                           layer_norm_eps=layer_norm_eps)


def _layer_backward(x, p, key_mask, dy, *, stage, num_heads, causal, attn_dropout,
                    hidden_dropout, dropout_seeds, layer_norm_eps):
    """The backward of :func:`fused_layer_backward_reference`, cut after
    ``stage`` (one of ``BWD_STAGES``): the recomputed y, ``T(dctx)`` or
    ``dx`` in ``x.dtype``; at ``full``, ``(dx, dparams)``."""
    if dropout_seeds is None:
        attn_dropout = hidden_dropout = 0.0
    seeds = _seeds(dropout_seeds)
    dtype = x.dtype
    b, s, d = x.shape
    h = num_heads
    dh = d // h
    scale = 1.0 / math.sqrt(dh)
    eps = layer_norm_eps

    # ---- recompute (JAX _layer_fwd_block with want_residuals=True)
    qkv = _matmul(x, p["qkv"]["w"], p["qkv"]["b"], dtype)
    q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, s, h, dh).permute(0, 2, 1, 3).float()
               for i in range(3))
    z = torch.matmul(q, k.transpose(-1, -2)) * scale + attention_bias(key_mask, s, causal)
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    attn_div = divisor(attn_dropout, torch.float32, x.device)
    if attn_dropout > 0.0:
        idx = torch.arange(b * h * s * s, device=x.device, dtype=torch.int64).view(b, h, s, s)
        dropped = torch.where(keep_mask(idx, seeds[0], attn_dropout), probs / attn_div, 0.0)
    else:
        dropped = probs
    ctx = torch.matmul(dropped.to(dtype).float(), v).to(dtype)
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, d)
    a = _matmul(ctx, p["out"]["w"], p["out"]["b"], dtype)
    if hidden_dropout > 0.0:
        a = _hidden_dropout(a, hidden_dropout, seeds[1])
    n1, rstd1 = _ln_stats((x + a).float(), eps)
    x1 = (n1 * p["ln1"]["scale"] + p["ln1"]["bias"]).to(dtype)
    u32 = _matmul(x1, p["ffn_in"]["w"], p["ffn_in"]["b"], dtype).float()
    erf_u = (_erf_as if dtype == torch.bfloat16 else _erf)(u32 * _INV_SQRT2)
    g = (0.5 * u32 * (1.0 + erf_u)).to(dtype)
    f = _matmul(g, p["ffn_out"]["w"], p["ffn_out"]["b"], dtype)
    if hidden_dropout > 0.0:
        f = _hidden_dropout(f, hidden_dropout, seeds[2])
    n2, rstd2 = _ln_stats((x1 + f).float(), eps)
    if stage == "recompute":
        return (n2 * p["ln2"]["scale"] + p["ln2"]["bias"]).to(dtype)

    # ---- the VJP down to dx
    hid_div = divisor(hidden_dropout, torch.float32, x.device)
    dy32 = dy.to(dtype).float()
    dh2 = _ln_bwd(dy32, n2, rstd2, p["ln2"]["scale"])
    df = dh2
    if hidden_dropout > 0.0:
        df = torch.where(_hidden_keep(x.shape, hidden_dropout, seeds[2], x.device),
                         df / hid_div, 0.0)
    du = _mm(df, p["ffn_out"]["w"].T, dtype) * _gelu_grad(u32, erf_u)
    dx1 = dh2 + _mm(du, p["ffn_in"]["w"].T, dtype)
    dh1 = _ln_bwd(dx1, n1, rstd1, p["ln1"]["scale"])
    da = dh1
    if hidden_dropout > 0.0:
        da = torch.where(_hidden_keep(x.shape, hidden_dropout, seeds[1], x.device),
                         da / hid_div, 0.0)
    dctx = _mm(da, p["out"]["w"].T, dtype)
    if stage == "ffn_bwd":
        return dctx.to(dtype)

    # attention, per head: gw = T(dctx), dv = T(dropped)^T gw, the dropout
    # VJP with the keep mask read off ``dropped != 0`` (the JAX kernel's),
    # the softmax VJP, d_scores rounded to T before dq and dk
    gw = dctx.to(dtype).float().view(b, s, h, dh).permute(0, 2, 1, 3)
    dv = torch.matmul(dropped.to(dtype).float().transpose(-1, -2), gw)
    d_probs = torch.matmul(gw, v.transpose(-1, -2))
    if attn_dropout > 0.0:
        d_probs = torch.where(dropped != 0.0, d_probs / attn_div, 0.0)
    d_scores = probs * (d_probs - (d_probs * probs).sum(dim=-1, keepdim=True))
    d_scores = (d_scores * scale).to(dtype).float()
    dq = torch.matmul(d_scores, k)
    dk = torch.matmul(d_scores.transpose(-1, -2), q)
    dqkv = torch.cat([t.permute(0, 2, 1, 3).reshape(b, s, d) for t in (dq, dk, dv)], dim=-1)
    dx = (dh1 + _mm(dqkv, p["qkv"]["w"].T, dtype)).to(dtype)
    if stage == "attn_bwd":
        return dx

    # ---- the parameter gradients, row sums over all B*S rows
    def rows(t):
        return t.reshape(b * s, t.shape[-1])

    grads = {
        "ln2": {"scale": rows(dy32 * n2).sum(0), "bias": rows(dy32).sum(0)},
        "ffn_out": {"w": _mm(rows(g).T, rows(df), dtype), "b": rows(df).sum(0)},
        "ffn_in": {"w": _mm(rows(x1).T, rows(du), dtype), "b": rows(du).sum(0)},
        "ln1": {"scale": rows(dx1 * n1).sum(0), "bias": rows(dx1).sum(0)},
        "out": {"w": _mm(rows(ctx).T, rows(da), dtype), "b": rows(da).sum(0)},
        "qkv": {"w": _mm(rows(x).T, rows(dqkv), dtype), "b": rows(dqkv).sum(0)},
    }
    return dx, grads


# csrc/fused_layer.cu: the f32 products' tiles (f32_product) and passes
F32_THREADS = 256  # kThreads: 8 warps
PASS_COLS = 128  # kPassCols: output columns of a pass, 4 a lane
K_CHUNK = 32  # kKChunk: k of a staged weight (and activation) tile
_TILE_LD = K_CHUNK + 4  # kWtLd, kALd: a transposed weight tile's and an activation tile's rows


def tile_plan(s: int) -> dict:
    """The f32 products' register tiles at sequence length ``s``: each of
    the 8 warps holds 4 rows, once for S <= 32 and twice above (the rows
    the tiles cover, which the shared-memory buffers hold), each lane 4 of
    a pass's 128 columns; weight tiles of 32 k, double-buffered."""
    row_tiles = 1 if s <= 32 else 2
    return {"threads": F32_THREADS, "row_tiles": row_tiles, "rows": 32 * row_tiles,
            "pass_cols": PASS_COLS, "k_chunk": K_CHUNK, "outputs_per_thread": 16 * row_tiles}


def _odd_ld(w: int) -> int:
    """csrc/fused_layer.cu odd_ld: a row of ``w`` floats padded so that its
    16-byte count is odd (conflict-free 16-byte reads across rows)."""
    return w if (w // 4) % 2 else w + 4


def smem_bytes(s: int, d: int, f: int, heads_per_stage: int, elem: int,
               num_heads: int | None = None) -> int:
    """Dynamic shared memory of one CTA of the forward kernel (the layouts
    described in ``csrc/fused_layer.cu``): ``elem`` 2 the bf16 tensor-core
    kernel's ``TcLayout``, 4 the f32 kernel's ``F32Layout``, which holds
    the q, k and v of ``heads_per_stage`` of ``num_heads`` heads."""
    if elem == 2:  # the scores stay in registers: no heads_per_stage
        sp = -(-s // 16) * 16  # whole m-tiles of rows
        rows = sp * (d + 8) * 2  # sx, ctx, hb: bf16 at leading dimension D + 8
        big = sp * (max(3 * d, f) + 8) * 2  # qkv, then the GELU output
        return 3 * rows + big + s * 4  # and the mask
    if num_heads is None:
        msg = "fused_layer: the f32 layout needs num_heads"
        raise ValueError(msg)
    rows = tile_plan(s)["rows"]
    ldx, ldf = _odd_ld(d), _odd_ld(f)  # rows of D and of F
    group = _odd_ld(3 * heads_per_stage * (d // num_heads))  # a head group's q|k|v
    # sx; ctx, then g; the group, then a and f; two weight tiles
    return 4 * rows * (ldx + max(ldx, ldf) + max(group, ldx)) + 4 * 2 * K_CHUNK * PASS_COLS


def bwd_smem_bytes(s: int, d: int, num_heads: int, heads_per_stage: int) -> int:
    """Dynamic shared memory of one CTA of the f32 backward's first pass
    (``F32BwdLayout``): two weight tiles and two activation tiles, a head
    group's q, k, v and gw, its d_scores and dropped probs, the mask."""
    hg, dh = heads_per_stage, d // num_heads
    rows = tile_plan(s)["rows"]
    floats = (2 * PASS_COLS * _TILE_LD + 2 * rows * _TILE_LD + s * _odd_ld(3 * hg * dh)
              + s * hg * dh + 2 * hg * s * s)
    return 4 * floats + 4 * s


def _most_heads(share: int, fits, what: str) -> int:
    for hg in range(share, 0, -1):
        if share % hg == 0 and fits(hg):
            return hg
    raise ValueError(what)


def heads_per_stage(s: int, d: int, f: int, num_heads: int, elem: int, limit: int,
                    cluster: int = 1) -> int:
    """The most heads whose buffers fit beside the activations in ``limit``
    bytes (a divisor of the ``num_heads // cluster`` heads of one CTA);
    raises when not even one does."""
    return _most_heads(
        num_heads // cluster,
        lambda hg: smem_bytes(s, d, f, hg, elem, num_heads) <= limit,
        f"fused_layer: S={s}, D={d}, F={f} needs {smem_bytes(s, d, f, 1, elem, num_heads)} "
        f"bytes of shared memory per block with {elem}-byte activations, "
        f"more than the {limit} this device allows")


def bwd_heads_per_stage(s: int, d: int, num_heads: int, limit: int, cluster: int = 1) -> int:
    """The f32 backward's heads a group: the most (a divisor of the CTA's
    ``num_heads // cluster``) whose attention buffers fit in ``limit``
    bytes; raises when not even one does."""
    return _most_heads(
        num_heads // cluster,
        lambda hg: bwd_smem_bytes(s, d, num_heads, hg) <= limit,
        f"fused_layer backward: S={s}, D={d} needs {bwd_smem_bytes(s, d, num_heads, 1)} bytes "
        f"of shared memory per block in f32, more than the {limit} this device allows")


CLUSTER_SIZES = (4, 2, 1)  # csrc/fused_layer.cu kMaxCluster and its divisors: the bf16 forward
F32_CLUSTER_SIZES = (4, 3, 2, 1)  # the f32 kernels and the bf16 pass 1: any size up to 4


def cluster_size(b: int, d: int, num_heads: int, sms: int, elem: int = 2,
                 max_active: dict | None = None, sizes: tuple | None = None) -> int:
    """CTAs of a cluster for one sequence: the largest size (``sizes``,
    by default bf16, ``elem`` 2: 4, 2, 1; f32: 4, 3, 2, 1) whose ``b``
    clusters the card holds at once, that splits the heads evenly and
    gives each CTA whole column blocks of q, k and v (8 columns in bf16, 4
    in f32).  ``max_active`` maps a size to the clusters the card holds at
    once (the occupancy API's count, which a GPC's SMs bound: 30 clusters
    of 4 on an H100 with the f32 kernels' one CTA an SM); without it,
    ``sms // size`` (one CTA an SM).  B=64 on 132 SMs takes 2, B=32 takes 4
    (f32 with the H100's counts: 3), B >= 67 takes 1."""
    block = 8 if elem == 2 else 4
    for c in sizes or (CLUSTER_SIZES if elem == 2 else F32_CLUSTER_SIZES):
        room = (max_active or {}).get(c, sms // c)
        if b <= room and num_heads % c == 0 and d % (block * c) == 0:
            return c
    return 1


# csrc/fused_layer.cu fused_layer_max_clusters: the kernels it counts
F32_FWD, F32_BWD, TC_FWD, TC_BWD = range(4)


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, kernel: int, s: int, d: int, h: int, f: int, hg: int,
                  c: int) -> int:
    """The clusters of ``c`` CTAs of one of the layer's kernels (``F32_FWD``,
    ``F32_BWD``, ``TC_FWD``, ``TC_BWD``: the forwards and the backwards'
    first passes) that card ``index`` holds at once (csrc/fused_layer.cu
    fused_layer_max_clusters, the occupancy API)."""
    with torch.cuda.device(index):
        n = cuda_build.library("fused_layer").fused_layer_max_clusters(kernel, s, d, h, f, hg, c)
    if n < 0:
        msg = f"fused_layer_max_clusters: CUDA error {-n}"
        raise RuntimeError(msg)
    return n


def _active_clusters(device, kernel: int, sizes: tuple, block: int, s: int, d: int, h: int,
                     f: int, heads_of) -> dict:
    """The card's count of co-resident clusters of ``kernel`` at each size
    of ``sizes`` above 1 that splits the ``h`` heads evenly and ``d`` into
    whole ``block``-column blocks a CTA, ``heads_of(size)`` heads a stage:
    the ``max_active`` of :func:`cluster_size`."""
    index = torch.device(device).index or 0
    return {c: _max_clusters(index, kernel, s, d, h, f, heads_of(c), c)
            for c in sizes[:-1] if h % c == 0 and d % (block * c) == 0}


def _f32_cluster(b: int, s: int, d: int, h: int, f: int, device, backward: bool) -> int:
    """The f32 kernels' cluster size on ``device``: :func:`cluster_size`
    with the card's count of co-resident clusters at each size."""
    limit = cuda_build.max_shared_memory(device)
    active = _active_clusters(
        device, F32_BWD if backward else F32_FWD, F32_CLUSTER_SIZES, 4, s, d, h, f,
        lambda c: (bwd_heads_per_stage(s, d, h, limit, c) if backward
                   else heads_per_stage(s, d, f, h, 4, limit, c)))
    return cluster_size(b, d, h, cuda_build.sm_count(device), 4, active)


def _tc_cluster(b: int, s: int, d: int, h: int, f: int, device) -> int:
    """The bf16 forward's cluster size on ``device``: :func:`cluster_size`
    with the card's count of co-resident clusters of its kernel at each
    size (the H100 holds 30 of 4 at one CTA an SM, so path B's B=32 takes
    2, not 4)."""
    active = _active_clusters(device, TC_FWD, CLUSTER_SIZES, 8, s, d, h, f, lambda c: 0)
    return cluster_size(b, d, h, cuda_build.sm_count(device), 2, active)


BWD_ROWS = 64  # the most rows a CTA of the bf16 backward's pass 1 takes: four m-tiles
BWD_WARPS = 16  # its warps (csrc/fused_layer.cu kBwdTcThreads / 32)


def bwd_tc_smem_bytes(s: int, d: int, num_heads: int, f: int, seqs: int, cluster: int,
                      heads_per_stage: int) -> int:
    """Dynamic shared memory of one CTA of the bf16 backward's first pass
    (``BwdTcLayout`` in csrc/fused_layer.cu): the mask of its ``seqs * s``
    rows, then the largest of a product's operand (those rows in whole
    m-tiles, ``max(3d, f) + 8`` bf16 wide), the row steps' column sums
    (``3 d`` f32 for each of the 16 warps) and one sequence's attention
    (its rows of the CTA's heads' q|k|v and gw, each head's columns padded
    to whole k-steps of 16, then ``heads_per_stage`` heads' bf16 dropped
    probs and d_scores), the attention's rows in whole 16-row blocks, its
    S x S buffers (round_up(s, 16) + 8) wide."""
    hg, sp = heads_per_stage, -(-s // 16) * 16
    hc = num_heads // cluster * -(-(d // num_heads) // 16) * 16
    ops = -(-seqs * s // 4) * 4 * 4
    operand = -(-seqs * s // 16) * 16 * (max(3 * d, f) + 8) * 2
    product = max(operand, BWD_WARPS * 3 * d * 4)
    attention = ops + sp * (3 * hc + 8) * 2 + sp * (hc + 8) * 2 + hg * 2 * sp * (sp + 8) * 2
    return max(ops + product, attention)


def bwd_tc_heads(s: int, d: int, num_heads: int, f: int, seqs: int, cluster: int,
                 limit: int) -> int:
    """The bf16 backward's heads a stage: the most (a divisor of the CTA's
    ``num_heads // cluster``) whose buffers fit in ``limit`` bytes; raises
    when not even one does."""
    return _most_heads(
        num_heads // cluster,
        lambda hg: bwd_tc_smem_bytes(s, d, num_heads, f, seqs, cluster, hg) <= limit,
        f"fused_layer backward: S={s}, D={d}, H={num_heads}, F={f} needs "
        f"{bwd_tc_smem_bytes(s, d, num_heads, f, seqs, cluster, 1)} bytes of shared memory per "
        f"block in "
        f"bf16, more than the {limit} this device allows")


def bwd_tc_plan_for(s: int, d: int, num_heads: int, f: int, seqs: int, cluster: int,
                    limit: int) -> dict:
    """The rest of the first pass's plan for ``seqs`` sequences a CTA on
    clusters of ``cluster``: the most heads a stage that fit (``limit``
    bytes) and the layout's bytes."""
    hg = bwd_tc_heads(s, d, num_heads, f, seqs, cluster, limit)
    return {"seqs": seqs, "cluster": cluster, "heads_per_stage": hg,
            "smem": bwd_tc_smem_bytes(s, d, num_heads, f, seqs, cluster, hg)}


def bwd_tc_plan(b: int, s: int, d: int, num_heads: int, f: int, sms: int, limit: int,
                max_active: dict | None = None) -> dict:
    """The bf16 backward's first pass at (``b``, ``s``, ``d``, ``num_heads``,
    ``f``) on a card of ``sms`` SMs (one CTA an SM) and ``limit`` bytes of
    shared memory a CTA:

    - ``seqs``: the sequences a CTA takes, as many as one wave of ``sms``
      CTAs needs, at most ``BWD_ROWS`` rows (the quality run's B=256 takes
      2: 128 CTAs, each weight fragment feeding 64 rows);
    - ``cluster``: with one sequence a CTA, the CTAs it is split across,
      the largest size (4, 3, 2) whose ``b`` clusters the card holds at once
      (``max_active``: the card's count by size, else ``sms // size``) that
      splits the heads evenly in whole 8-column blocks (path B's B=32 on an
      H100 takes 3);
    - ``heads_per_stage`` and the layout's ``smem`` bytes as
      :func:`bwd_tc_plan_for` gives them;
    - ``ctas``: the grid.

    Raises when not even one head fits."""
    seqs = max(1, min(BWD_ROWS // s, -(-b // sms)))
    cluster = 1 if seqs > 1 else cluster_size(b, d, num_heads, sms, 2, max_active,
                                              F32_CLUSTER_SIZES)
    return bwd_tc_plan_for(s, d, num_heads, f, seqs, cluster, limit) | {
        "ctas": -(-b // seqs) * cluster}


def _bwd_tc_plan(b: int, s: int, d: int, h: int, f: int, device) -> dict:
    """:func:`bwd_tc_plan` on ``device``, with the card's count of
    co-resident clusters of the first pass at each size."""
    limit = cuda_build.max_shared_memory(device)
    active = _active_clusters(device, TC_BWD, F32_CLUSTER_SIZES, 8, s, d, h, f,
                              lambda c: bwd_tc_heads(s, d, h, f, 1, c, limit))
    return bwd_tc_plan(b, s, d, h, f, cuda_build.sm_count(device), limit, active)


def forward_workspace_elems(d: int, f: int) -> int:
    """bf16 elements of the forward's weight workspace: the four weights
    rounded once, packed in B-fragment order (csrc/fused_layer.cu
    WOffsets, pack_weights_kernel)."""
    return 4 * d * d + 2 * d * f


_PARAM_ORDER = (
    ("qkv", "w"), ("qkv", "b"), ("out", "w"), ("out", "b"), ("ffn_in", "w"),
    ("ffn_in", "b"), ("ffn_out", "w"), ("ffn_out", "b"), ("ln1", "scale"),
    ("ln1", "bias"), ("ln2", "scale"), ("ln2", "bias"),
)


def _unflatten(flat) -> dict:
    out: dict = {}
    for (m, n), t in zip(_PARAM_ORDER, flat):
        out.setdefault(m, {})[n] = t
    return out


def _check_cuda(x, params, key_mask, num_heads: int) -> int:
    """Validate a CUDA call; returns the FFN width."""
    b, s, d = x.shape
    if x.device.type != "cuda":
        msg = f"fused_layer: unsupported device {x.device}"
        raise ValueError(msg)
    if x.dtype not in (torch.bfloat16, torch.float32):
        msg = f"fused_layer: x must be bf16 or f32, got {x.dtype}"
        raise ValueError(msg)
    if d % num_heads:
        msg = f"fused_layer: D={d} not divisible by num_heads={num_heads}"
        raise ValueError(msg)
    if key_mask.shape != (b, s):
        msg = f"fused_layer: key_mask must be {(b, s)}, got {tuple(key_mask.shape)}"
        raise ValueError(msg)
    f = params[4].shape[1]
    expected = [(d, 3 * d), (3 * d,), (d, d), (d,), (d, f), (f,), (f, d), (d,)] + [(d,)] * 4
    for (m, n), t, shape in zip(_PARAM_ORDER, params, expected):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            msg = f"fused_layer: {m}/{n} must be f32 {shape} on {x.device}"
            raise ValueError(msg)
    return f


def _dropout_args(attn_dropout: float, hidden_dropout: float, dropout_seeds, device):
    """The kernels' dropout arguments: the address of the three seeds on
    ``device`` (an int64 tensor the kernel reads; a list is written there
    by fills, so a CUDA graph captures its values; null for none), the
    keep thresholds and divisors, the two rates."""
    if dropout_seeds is None:
        attn_dropout = hidden_dropout = 0.0
        seeds = None
    else:
        seeds = seed_tensor(dropout_seeds, device)
        if seeds.numel() != 3:
            msg = f"dropout_seeds needs 3 site seeds, got {seeds.numel()}"
            raise ValueError(msg)
    return (seeds, keep_threshold(attn_dropout),
            keep_threshold(hidden_dropout), keep_divisor(attn_dropout, torch.float32),
            attn_dropout, hidden_dropout)


def _check_f32_widths(d: int, num_heads: int, f: int) -> None:
    """The f32 kernels read rows and weights 16 bytes at a time."""
    if d % 4 or f % 4 or (d // num_heads) % 4:
        msg = (f"fused_layer: f32 needs D, the FFN width and the head width multiples of 4, "
               f"got D={d}, H={num_heads}, F={f}")
        raise ValueError(msg)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes
    (a view at an odd offset), for the kernels' 16-byte loads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_cuda(x, params, key_mask, *, num_heads, causal, attn_dropout, hidden_dropout,
              dropout_seeds, ffn_dim, layer_norm_eps, stage="full", counter="fused_layer"):
    """The forward kernel, or with ``stage`` a section variant of it (see
    ``FWD_STAGES``); adds one to ``LAUNCHES[counter]``."""
    del ffn_dim
    f = _check_cuda(x, params, key_mask, num_heads)
    b, s, d = x.shape
    seeds, attn_thr, hidden_thr, attn_div, attn_dropout, hidden_dropout = _dropout_args(
        attn_dropout, hidden_dropout, dropout_seeds, x.device)
    elem = x.element_size()
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (d % 16 or f % 16 or (d // num_heads) % 2 or d // num_heads > 64):
        msg = (f"fused_layer: bf16 needs D and the FFN width multiples of 16 and an even head "
               f"width of at most 64, got D={d}, H={num_heads}, F={f}")
        raise ValueError(msg)
    if bf16:
        cluster = _tc_cluster(b, s, d, num_heads, f, x.device)
    else:
        _check_f32_widths(d, num_heads, f)
        cluster = _f32_cluster(b, s, d, num_heads, f, x.device, backward=False)
    hg = heads_per_stage(s, d, f, num_heads, elem, cuda_build.max_shared_memory(x.device),
                         cluster)
    smem = smem_bytes(s, d, f, hg, elem, num_heads)
    x = _aligned(x.contiguous())
    params = [_aligned(t.contiguous()) for t in params]
    mask = key_mask.to(torch.int32).contiguous()
    y = torch.empty_like(x)
    wt16 = (torch.empty(forward_workspace_elems(d, f), dtype=torch.bfloat16, device=x.device)
            if bf16 else None)
    status = cuda_build.library("fused_layer").fused_layer_fwd(
        x.data_ptr(), y.data_ptr(), mask.data_ptr(), *(t.data_ptr() for t in params),
        b, s, d, num_heads, f, int(causal), int(bf16), hg, cluster,
        cuda_build.pointer(seeds), attn_thr, hidden_thr, attn_div,
        keep_divisor(hidden_dropout, x.dtype), int(attn_dropout > 0.0),
        int(hidden_dropout > 0.0), float(layer_norm_eps), smem, FWD_STAGES.index(stage), None if wt16 is None else wt16.data_ptr(),
        cuda_build.stream_handle(x.device),
    )
    cuda_build.check(status, "fused_layer_fwd launch")
    cuda_build.LAUNCHES[counter] += 1
    return y


_WG_TILE = 64  # csrc/fused_layer.cu kWgTile: a block's tile of a weight gradient
_WG_ROWS = 32  # kWgRows: the least rows of a split
_WG_BLOCKS = 512  # the blocks pass 2 of the backward aims for


def _weight_grad_splits(r: int, d: int, f: int) -> int:
    """Row splits of the backward's pass 2 (a split-K product): about
    ``_WG_BLOCKS`` blocks over the 64 x 64 tiles of the four weight
    gradients, each split at least 32 rows."""
    tiles = sum(-(-k // _WG_TILE) * -(-n // _WG_TILE)
                for k, n in ((d, 3 * d), (d, d), (d, f), (f, d)))
    return max(1, min(-(-_WG_BLOCKS // tiles), -(-r // _WG_ROWS)))


def _bwd_cuda(x, params, key_mask, dy, *, num_heads, causal, attn_dropout, hidden_dropout,
              dropout_seeds, ffn_dim, layer_norm_eps, stage="full", counter="fused_layer_bwd"):
    """The backward kernel: recompute, dx and the 12 f32 parameter
    gradients.  Its device-memory workspace (the recomputed activations and
    the per-sequence partial sums: ~36 MB at B=128, S=32, D=128, F=512 in
    bf16, ~92 MB at the quality run's B=256, D=384, F=48) is allocated here
    and freed with the call; bf16 plans its first pass with
    :func:`bwd_tc_plan`.  With ``stage`` a section variant of its first pass
    alone (see ``BWD_STAGES``): the stage's tensor in ``dx``, the parameter
    gradients left unwritten.  Adds one to ``LAUNCHES[counter]``."""
    del ffn_dim
    f = _check_cuda(x, params, key_mask, num_heads)
    b, s, d = x.shape
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (d % 16 or f % 16 or (d // num_heads) % 2):
        msg = (f"fused_layer backward: bf16 needs D and the FFN width multiples of 16 and an "
               f"even head width, got D={d}, H={num_heads}, F={f}")
        raise ValueError(msg)
    if bf16:
        plan = _bwd_tc_plan(b, s, d, num_heads, f, x.device)
        cluster, hg, seqs = plan["cluster"], plan["heads_per_stage"], plan["seqs"]
    else:
        _check_f32_widths(d, num_heads, f)
        cluster = _f32_cluster(b, s, d, num_heads, f, x.device, backward=True)
        hg = bwd_heads_per_stage(s, d, num_heads, cuda_build.max_shared_memory(x.device), cluster)
        seqs = 1
    r = b * s
    seeds, attn_thr, hidden_thr, attn_div, attn_dropout, hidden_dropout = _dropout_args(
        attn_dropout, hidden_dropout, dropout_seeds, x.device)
    x = _aligned(x.contiguous())
    dy = _aligned(dy.to(x.dtype).contiguous())  # the JAX kernel's g.astype(x.dtype)
    params = [_aligned(t.contiguous()) for t in params]
    mask = key_mask.to(torch.int32).contiguous()
    dx = torch.empty_like(x)
    dparams = [torch.empty_like(t) for t in params]

    def act(cols):
        return torch.empty((r, cols), dtype=x.dtype, device=x.device)

    def f32(rows, cols):
        return torch.empty((rows, cols), dtype=torch.float32, device=x.device)

    # BwdParams order in csrc/fused_layer.cu: qkv ctx x1 u g h1 h2 stats dfm
    # dum dam dqm dres duf (bf16: du in f32, before its rounding into dum)
    # partial
    ws = [act(3 * d), act(d), act(d), act(f), act(f), act(d), act(d), f32(r, 4), act(d),
          act(f), act(d), act(3 * d), f32(r, d), f32(r, f) if bf16 else None,
          f32(b, 9 * d + f)]
    # bf16 (the tensor-core path): the weights rounded to bf16 and packed,
    # W and W^T; both: pass 2's partial weight-gradient tiles
    n_weights = 4 * d * d + 2 * d * f
    splits = _weight_grad_splits(r, d, f)
    ws += [torch.empty(2 * n_weights, dtype=torch.bfloat16, device=x.device) if bf16 else None,
           f32(splits, n_weights)]
    status = cuda_build.library("fused_layer").fused_layer_bwd(
        x.data_ptr(), dy.data_ptr(), mask.data_ptr(), *(t.data_ptr() for t in params),
        dx.data_ptr(), *(t.data_ptr() for t in dparams),
        *(None if t is None else t.data_ptr() for t in ws),
        b, s, d, num_heads, f, int(causal), int(bf16), splits, cluster, hg, seqs,
        cuda_build.pointer(seeds), attn_thr, hidden_thr, attn_div,
        keep_divisor(hidden_dropout, x.dtype), keep_divisor(hidden_dropout, torch.float32),
        int(attn_dropout > 0.0), int(hidden_dropout > 0.0), float(layer_norm_eps),
        BWD_STAGES.index(stage), cuda_build.stream_handle(x.device),
    )
    cuda_build.check(status, "fused_layer_bwd launch")
    cuda_build.LAUNCHES[counter] += 1
    return dx, dparams


class _FusedLayer(torch.autograd.Function):
    """Forward: the kernel (or the plain version on the CPU), saving only
    ``x``, the mask and the parameters, as the TPU kernel does.  Backward:
    the backward kernel (or its plain version), which recomputes the layer."""

    @staticmethod
    def forward(ctx, x, key_mask, opts, *params):
        ctx.save_for_backward(x, key_mask, *params)
        ctx.opts = opts
        if x.device.type == "cpu":
            return fused_layer_reference(x, _unflatten(params), key_mask, **opts)
        return _fwd_cuda(x, params, key_mask, **opts)

    @staticmethod
    def backward(ctx, dy):
        x, key_mask, *params = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, grads = fused_layer_backward_reference(
                x, _unflatten(params), key_mask, dy, **ctx.opts)
            dparams = [grads[m][n] for m, n in _PARAM_ORDER]
        else:
            dx, dparams = _bwd_cuda(x, params, key_mask, dy, **ctx.opts)
        return (dx, None, None, *dparams)


def fused_layer(
    x: torch.Tensor,
    layer_params,
    key_mask: torch.Tensor,
    *,
    num_heads: int,
    causal: bool,
    attn_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    dropout_seeds=None,
    ffn_dim: int,
    layer_norm_eps: float = 1e-12,
) -> torch.Tensor:
    """One fused post-LN layer, differentiable in ``x`` and the parameters.

    Args:
        x: (B, S, D) activations in the compute dtype (bf16 or f32).
        layer_params: one layer's dict (``qkv``/``out``/``ffn_in``/
            ``ffn_out`` with ``w``/``b``, ``ln1``/``ln2`` with
            ``scale``/``bias``), f32.
        key_mask: (B, S) key validity.
        dropout_seeds: three uint32 site seeds (attention probs, post-attn
            hidden, post-FFN hidden), a list or an int64 tensor (the
            kernels read a tensor on the card where it lies, so a CUDA
            graph replays with the seeds written there); ``None`` turns
            dropout off.

    On CPU tensors this runs :func:`fused_layer_reference` and, for the
    gradient, :func:`fused_layer_backward_reference`; on CUDA tensors it
    launches the forward kernel (a cluster of :func:`cluster_size` CTAs per
    sequence) and the backward kernel (bf16: its first pass as
    :func:`bwd_tc_plan` says; f32: on the forward's clusters), or raises.
    """
    s = x.shape[1]
    if s > 64:
        msg = f"fused_layer supports s <= 64 (got s={s})"
        raise ValueError(msg)
    opts = dict(
        num_heads=num_heads, causal=causal, attn_dropout=attn_dropout,
        hidden_dropout=hidden_dropout, dropout_seeds=dropout_seeds,
        ffn_dim=ffn_dim, layer_norm_eps=layer_norm_eps,
    )
    params = [layer_params[m][n] for m, n in _PARAM_ORDER]
    return _FusedLayer.apply(x, key_mask, opts, *params)
