"""Where a query's encoding starts to depend on the batch it is encoded in.

    python3 -m transformer_recommenders_tpu_torch.tools.batch_invariance \\
        [--batches 64 256] [--queries 64] [--device cuda] [--out FILE]

Encodes random histories of input embeddings (padded at the tail) through
the serving encoder as ``ModelService.embed`` calls it
(``RecommenderModel`` on item embeddings), for the flagship model
(``configs/ml1m_ssm.yaml``'s widths, random weights from a seed): each of
the first ``--queries`` alone, and all of them as the first rows of
batches of the other sizes.  For each batch size it counts the queries
whose embedding differs from the lone one and the largest difference.
Then, for the first such query (or the first query where none differs),
a ``TorchDispatchMode`` records every aten op of its lone run and of the
batch with it in row 0: row 0's share of each input and output (the first
n rows of a tensor whose leading dimension is n times the batch; tensors
that do not scale with the batch whole).  Kernels of the port called
through ``ctypes`` are not aten ops: their outputs show as the inputs of
the next op.  It reports the first op whose row-0 output differs, whether
that op's inputs agreed (then the op itself depends on the batch) or not
(the difference came from a kernel between two aten ops), its shapes and
its largest difference.  Prints one JSON object (with the card's name and
power limit on the card).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

# configs/ml1m_ssm.yaml, the flagship model
FLAGSHIP = dict(
    input_dim=384, hidden_size=128, num_hidden_layers=4, num_attention_heads=8,
    intermediate_size=512, max_seq_length=32, compute_dtype="bfloat16", pooling_mode="mean",
)
# outputs written later by a kernel, or never defined
_UNDEFINED = ("empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided")


def _share(t, batch: int, one):
    """Row 0's share of tensor ``t`` of a batch-``batch`` run, where ``one``
    is the same op's tensor in the lone query's run; None where the shapes
    do not say."""
    if t.shape == one.shape:
        return t
    if t.dim() == one.dim() and t.dim() > 0 and t.shape[1:] == one.shape[1:] \
            and t.shape[0] == batch * one.shape[0]:
        return t[:one.shape[0]]
    return None


def record(fn):
    """(fn's result, [(op name, input tensors, output tensors)]) with every
    tensor copied to the host as the op saw it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    ops = []

    def tensors(tree):
        return [t.detach().cpu().clone() for t in tree_flatten(tree)[0]
                if isinstance(t, torch.Tensor)]

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            ins = tensors((args, kwargs))
            outs = [] if name in _UNDEFINED else tensors(out)
            ops.append((name, ins, outs))
            return out

    with Recorder():
        result = fn()
    return result, ops


def _equal_shares(got, want, batch: int):
    """Whether every tensor of ``got`` (a batch-``batch`` run) holds row 0's
    share equal to ``want``'s; the largest difference where not."""
    import torch

    same, diff = True, 0.0
    for t, w in zip(got, want):
        share = _share(t, batch, w)
        if share is None:
            continue
        if not torch.equal(share, w):
            same = False
            if share.is_floating_point():
                diff = max(diff, float((share.double() - w.double()).abs().max()))
    return same, diff


def first_difference(ops_one, ops_n, batch: int) -> dict:
    """The first op whose row-0 output differs between the runs."""
    for i, ((name, ins1, outs1), (name_n, ins_n, outs_n)) in enumerate(zip(ops_one, ops_n)):
        if name != name_n:
            return {"index": i, "op": f"{name} / {name_n}", "note": "the op sequences part"}
        same_out, diff = _equal_shares(outs_n, outs1, batch)
        if not same_out:
            same_in, in_diff = _equal_shares(ins_n, ins1, batch)
            return {"index": i, "op": name, "inputs_agree": same_in,
                    "input_max_abs_diff": in_diff, "output_max_abs_diff": diff,
                    "input_shapes": [list(t.shape) for t in ins_n],
                    "output_shapes": [list(t.shape) for t in outs_n],
                    "previous_ops": [o[0] for o in ops_n[max(0, i - 4):i]]}
    return {"index": None, "op": None, "ops": len(ops_one)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()

    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.configs import ModelConfig
    from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel

    if args.device == "cuda" and not torch.cuda.is_available():
        print("batch_invariance: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(**FLAGSHIP)
    model = RecommenderModel(cfg, generator=torch.Generator().manual_seed(0), device=args.device)
    rng = np.random.default_rng(0)
    s, dim = cfg.max_seq_length, cfg.resolved_input_dim

    def histories(n: int) -> np.ndarray:
        x = rng.normal(size=(n, s, dim)).astype(np.float32)
        for row, length in zip(x, rng.integers(1, s + 1, n)):
            row[length:] = 0.0
        return x

    data = histories(max(args.batches + [args.queries]))

    def encode(x):
        return model(item_embeds=x)["sentence_embedding"]

    alone = torch.cat([encode(data[i:i + 1]) for i in range(args.queries)])
    report = {"model": "configs/ml1m_ssm.yaml widths, random weights (seed 0)",
              "device": args.device, "queries": args.queries, "by_batch": {}}
    if args.device == "cuda":
        from transformer_recommenders_tpu_torch.tools import card

        report["card"] = card()
    for n in args.batches:
        k = min(n, args.queries)
        diff = (encode(data[:n])[:k] - alone[:k]).abs().amax(dim=-1)
        moved = [int(i) for i in torch.nonzero(diff > 0).flatten()]
        q = moved[0] if moved else 0
        _, ops_one = record(lambda q=q: encode(data[q:q + 1]))
        _, ops_n = record(lambda q=q, n=n: encode(np.roll(data[:n], -q, axis=0)))
        report["by_batch"][n] = {
            "queries_moved": len(moved), "of": k,
            "embedding_max_abs_diff": float(diff.max()),
            "traced_query": q,
            "first_difference": first_difference(ops_one, ops_n, n),
        }
    text = json.dumps(report, indent=1)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
