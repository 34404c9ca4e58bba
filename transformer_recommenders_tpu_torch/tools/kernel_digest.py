"""Digests of the pool, pairwise and table InfoNCE kernels' outputs, of the
layer stack's (the hash dropout, the attention core forward and backward)
and of the fused layer's (#3, #4, bf16 and f32), on fixed seeded inputs, to
hold a kernel's output bits across a change of the code it shares with
others.

    python3 transformer_recommenders_tpu_torch/tools/kernel_digest.py \\
        [--tree PATH] [--out FILE] [--tensors FILE] [--against FILE]

imports the port from the checkout at ``PATH`` (by default the one that
holds this file), runs each kernel through its wrapper on the card at the
training paths' shapes and a ragged one, and prints one JSON object: the
sha256 of each output's bytes by case.  Run it on two checkouts on one
card and compare the objects: equal digests are equal bits.  A change
meant to move only the sum order of a layer kernel holds its outputs to
the kernels' tolerances instead: ``--tensors`` saves the layer's outputs
(torch.save) from one run, ``--against`` holds this run's to the saved
ones and exits 1 when one is not held: f32, the forward within 2e-5, dx
and each parameter gradient within 1e-4 of its max abs; bf16, the forward
bit for bit, dx and each gradient within 1e-2 of its max abs (the bf16
backward's bound against its plain version, ``tests/test_torch_cuda.py``
``GRAD_TOL``).  Without a CUDA card it exits 2 and prints nothing.
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
# the fused layer: (B, S, D, H, F, dtype) of the serving batch, path B and
# the quality run in bf16; the seed spread's train and validation batches,
# the flagship's width and S=64 in f32
LAYER_CASES = {
    "serving": (64, 32, 128, 8, 512, "bfloat16"), "B": (32, 32, 384, 12, 48, "bfloat16"),
    "quality": (256, 32, 384, 12, 48, "bfloat16"),
    "seed_spread": (32, 32, 384, 12, 48, "float32"), "eval_f32": (256, 32, 384, 12, 48, "float32"),
    "flagship_f32": (128, 32, 128, 8, 512, "float32"), "s64_f32": (8, 64, 128, 8, 512, "float32"),
}
# tests/test_torch_cuda.py's bounds: f32 y (abs) and gradients (of their max
# abs); bf16 y bit for bit (0), gradients as GRAD_TOL
LAYER_TOL = {"float32": {"forward": 2e-5, "backward": 1e-4},
             "bfloat16": {"forward": 0.0, "backward": 1e-2}}


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


def layer_outputs() -> dict:
    """Each LAYER_CASES case's forward y, and its backward's dx and 12
    parameter gradients, at dropout 0 and 0.1 (causal; a padded tail on
    the last sequence, left padding on the first)."""
    import torch

    from transformer_recommenders_tpu_torch.ops import fused_layer as fl

    out = {}
    for name, (b, s, d, h, f, dtype) in LAYER_CASES.items():
        gen = torch.Generator().manual_seed(b + s + d)
        x = torch.randn(b, s, d, generator=gen).to("cuda", getattr(torch, dtype))
        dy = torch.randn(b, s, d, generator=gen).to("cuda", getattr(torch, dtype))
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[-1, s // 2:] = False
        mask[0, :s // 4] = False
        mask = mask.cuda()
        params = [(torch.randn(*shape, generator=gen) * scale + shift).cuda()
                  for shape, scale, shift in (
                      ((d, 3 * d), d ** -0.5, 0.0), ((3 * d,), 0.1, 0.0), ((d, d), d ** -0.5, 0.0),
                      ((d,), 0.1, 0.0), ((d, f), d ** -0.5, 0.0), ((f,), 0.1, 0.0),
                      ((f, d), f ** -0.5, 0.0), ((d,), 0.1, 0.0), ((d,), 0.1, 1.0),
                      ((d,), 0.1, 0.0), ((d,), 0.1, 1.0), ((d,), 0.1, 0.0))]
        for rate in (0.0, 0.1):
            kw = dict(num_heads=h, causal=True, attn_dropout=rate, hidden_dropout=rate,
                      dropout_seeds=[3, 4, 5] if rate else None, ffn_dim=f, layer_norm_eps=1e-12)
            with torch.no_grad():
                y = fl._fwd_cuda(x, params, mask, **kw)
                dx, grads = fl._bwd_cuda(x, params, mask, dy, **kw)
            out[f"fused_layer {dtype} {name} rate={rate}"] = {"y": y, "dx": dx, "grads": grads}
    return out


def layer_digests(outputs: dict) -> dict[str, str]:
    out = {}
    for case, t in outputs.items():
        out[f"{case} fwd (y)"] = digest(t["y"])
        out[f"{case} bwd (dx, 12 grads)"] = digest(t["dx"], *t["grads"])
    return out


def hold_layer(outputs: dict, saved: dict) -> bool:
    """This run's layer outputs against ``saved`` (another checkout's): y
    within LAYER_TOL's forward bound, dx and each gradient within its
    backward bound of the saved one's max abs; prints each case's worst."""
    ok = True
    for case, t in outputs.items():
        tol = LAYER_TOL["float32" if "float32" in case else "bfloat16"]
        want = saved[case]
        fwd = float((t["y"].float() - want["y"].cuda().float()).abs().max())
        rels = [float((g.float() - w.cuda().float()).abs().max()
                      / w.float().abs().max().clamp(min=1e-30))
                for g, w in zip([t["dx"], *t["grads"]], [want["dx"], *want["grads"]])]
        good = fwd <= tol["forward"] and max(rels) <= tol["backward"]
        ok &= good
        print(f"{case}: y max abs {fwd:.3g}, dx and grads worst relative {max(rels):.3g} "
              f"({'within' if good else 'OUTSIDE'} {tol})", file=sys.stderr)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="the checkout whose port to import")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    ap.add_argument("--tensors", default=None, help="save the layer outputs here")
    ap.add_argument("--against", default=None,
                    help="hold the layer outputs to those saved here by --tensors")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_digest: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    layers = layer_outputs()
    record = digests() | layer_digests(layers)
    text = json.dumps(record, indent=1, sort_keys=True)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    if args.tensors:
        torch.save({k: {"y": v["y"].cpu(), "dx": v["dx"].cpu(),
                        "grads": [g.cpu() for g in v["grads"]]}
                    for k, v in layers.items()}, args.tensors)
    if args.against and not hold_layer(layers, torch.load(args.against)):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
