"""Digests of the pool, pairwise and table InfoNCE kernels' outputs, and of
the layer stack's (the hash dropout, the attention core forward and
backward), on fixed seeded inputs, to hold a kernel's output bits across a
change of the code it shares with others.

    python3 transformer_recommenders_tpu_torch/tools/kernel_digest.py \\
        [--tree PATH] [--out FILE]

imports the port from the checkout at ``PATH`` (by default the one that
holds this file), runs each kernel through its wrapper on the card at the
training paths' shapes and a ragged one, and prints one JSON object: the
sha256 of each output's bytes by case.  Run it on two checkouts on one
card and compare the objects: equal digests are equal bits.  Without a
CUDA card it exits 2 and prints nothing.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

POOL_SHAPES = {"A": (4096, 4096, 128), "B": (1024, 1024, 384), "ragged": (1000, 777, 128)}
PAIRWISE_SHAPES = {"C": (4096, 4096, 64), "D128": (4096, 4096, 128), "ragged": (1000, 777, 64)}
TABLE_SHAPE = (4096, 3707, 128)
HEADS = ("ContrastiveLoss", "PairwiseHingeLoss", "PairwiseLogisticLoss", "NCELoss")
# the hash dropout: the scale step's hidden site, path C's f32 probs, an odd size
DROPOUT_SHAPES = {"scale_hidden": ((256, 128, 256), "bfloat16"),
                  "C_probs": ((128, 4, 32, 32), "float32"), "odd": ((3, 7, 5), "bfloat16")}
# the attention core: (B, S, H, dh) of the scale step and off the 16-row tiles
ATTN_SHAPES = ((256, 128, 8, 32), (4, 65, 2, 64))


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def pool_inputs(seed: int, r: int, rn: int, d: int):
    """f32 queries, bf16 positive and pool rows (every ninth pool row a copy
    of a positive), a tenth of rows and pool rows invalid, from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(r, d, generator=gen)
    p = 0.3 * torch.randn(r, d, generator=gen)
    n = 0.3 * torch.randn(rn, d, generator=gen)
    n[::9] = p[torch.randint(0, r, (len(range(0, rn, 9)),), generator=gen)]
    row_valid = torch.rand(r, generator=gen) > 0.1
    neg_valid = torch.rand(rn, generator=gen) > 0.1
    return (q.cuda(), p.to("cuda", torch.bfloat16), n.to("cuda", torch.bfloat16),
            row_valid.float().cuda(), neg_valid.cuda())


def digests() -> dict[str, str]:
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi
    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp
    from transformer_recommenders_tpu_torch.ops import fused_table_infonce as fti

    out = {}
    for name, (r, rn, d) in POOL_SHAPES.items():
        q, p, n, g, nv = pool_inputs(r + rn + d, r, rn, d)
        for mask_fn, scale in ((True, 1.0), (False, 2.5)):
            case = f"pool {name} mask={mask_fn} scale={scale}"
            ce, lse, pos = fi._fwd_cuda(q, p, n, nv, scale, mask_fn)
            out[f"{case} fwd (ce, lse, pos)"] = digest(ce, lse, pos)
            out[f"{case} dq (dq, dp)"] = digest(
                *fi._dq_cuda(q, p, n, nv, lse, g, pos, scale, mask_fn))
            out[f"{case} dn"] = digest(fi._dn_cuda(q, p, n, nv, lse, g, pos, scale, mask_fn))
    for name, (r, rn, d) in PAIRWISE_SHAPES.items():
        q, p, n, g, nv = pool_inputs(r + rn + d + 1, r, rn, d)
        for head in HEADS:
            for mask_fn, margin in ((True, 0.5), (False, 0.0)):
                case = f"pairwise {name} {head} mask={mask_fn} margin={margin}"
                args = (head, margin, mask_fn)
                o, den, pos = fp._fwd_cuda(q, p, n, nv, *args)
                out[f"{case} fwd (out, den, pos)"] = digest(o, den, pos)
                out[f"{case} dq (dq, dp)"] = digest(*fp._dq_cuda(q, p, n, nv, den, g, pos, *args))
                out[f"{case} dn"] = digest(fp._dn_cuda(q, p, n, nv, den, g, pos, *args))
    r, nrows, d = TABLE_SHAPE
    q, _, table, g, _ = pool_inputs(7, r, nrows, d)
    gen = torch.Generator().manual_seed(8)
    pos_idx = torch.randint(0, nrows, (r,), generator=gen).cuda()
    counts = torch.randint(0, 3, (nrows,), generator=gen).float().cuda()
    for mask_fn in (True, False):
        ce, lse = fti._fwd_cuda(q, table, pos_idx, counts, 1.0, mask_fn)
        out[f"table mask={mask_fn} fwd (ce, lse)"] = digest(ce, lse)
        out[f"table mask={mask_fn} bwd (dq, dT)"] = digest(
            *fti._bwd_cuda(q, table, pos_idx, counts, lse, g, 1.0, mask_fn))
    out |= stack_digests()
    torch.cuda.synchronize()
    return out


def stack_digests() -> dict[str, str]:
    """The hash dropout's and the attention core's outputs (seed term of
    seed 5, dropout 0.1; the core causal, at rates 0 and 0.1: ctx and its
    optional y, the rows' softmax statistics, the backward)."""
    import torch

    from transformer_recommenders_tpu_torch.ops import attn_core as ac
    from transformer_recommenders_tpu_torch.ops import hash_dropout as hd

    out = {}
    gen = torch.Generator().manual_seed(9)
    term = hd.seed_terms([5])[0]
    for name, (shape, dtype) in DROPOUT_SHAPES.items():
        x = torch.randn(shape, generator=gen).to("cuda", getattr(torch, dtype))
        out[f"hash_dropout {name}"] = digest(hd._hash_dropout_cuda(x, 0.1, term))
    for b, s, h, dh in ATTN_SHAPES:
        qkv = torch.randn(b, s, 3 * h * dh, generator=gen).to("cuda", torch.bfloat16)
        q, k, v = (t.reshape(b, s, h, dh) for t in qkv.chunk(3, dim=-1))
        mask = (torch.arange(s)[None, :] < torch.randint(1, s + 1, (b, 1), generator=gen)).cuda()
        g = torch.randn(b, s, h, dh, generator=gen).cuda()
        for rate in (0.0, 0.1):
            case = f"attn_core {b}x{s}x{h}x{dh} rate={rate}"
            ctx, m, l, y, _ = ac._fwd_cuda(q, k, v, mask, term, rate, True, with_y=True)
            out[f"{case} fwd (ctx, y)"] = digest(ctx, y)
            out[f"{case} fwd (m, l)"] = digest(m, l)
            out[f"{case} bwd (dq, dk, dv)"] = digest(
                *ac._bwd_cuda(q, k, v, mask, m, l, g, term, rate, True))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="the checkout whose port to import")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_digest: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    record = digests()
    text = json.dumps(record, indent=1, sort_keys=True)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
