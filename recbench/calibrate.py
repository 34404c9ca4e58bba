"""Readings the limits of ``correct`` are set from (not part of a run):

    python -m recbench.calibrate --workload <cell> --seeds 12 --control-seeds 3

(or ``--seed-list a,b,c`` for chosen seeds; the control seeds are the first).

For each of ``--seeds`` seeds, the program's numbers at the cell's own
size: a training cell's first call (the K steps a run checks), or a
recommendation cell's every pool call once, then the same sample of users
a run checks.  For ``--control-seeds`` seeds, the control's numbers: the
reference computed with fp8 products, put in the program's place; and the
faults' numbers, each planted in the f32 reference put in the program's
place (training: ``half``, ``altered``, ``unchanged``; recommendation:
``half``, ``altered``).  One JSON object a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

from recbench import check, spec
from recbench.reference import model as ref
from recbench.run import Context, log
from recbench.traffic import derived_seeds

FAULTS = {"train": ("half", "altered", "unchanged"), "recommend": ("half", "altered")}


def readings(root: pathlib.Path, workload: str, seeds: list[int], control_seeds: list[int],
             device: str = "cuda"):
    s = spec.load(root, workload)
    dev = torch.device(device)
    driver = spec.driver(root, s.kind)
    if dev.type == "cuda":
        from transformer_recommenders_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    for seed in seeds:
        ctx = Context(root, s.cell, s.config, s.traffic, seed, derived_seeds(seed), dev)
        t = time.perf_counter()
        inputs = driver.make_inputs(ctx)
        if s.kind == "train":
            session = driver.Session(ctx, inputs)
            program = session.program_out
            session.free()
            t_ref = time.perf_counter()
            reference = driver.reference_out(ctx, inputs)
            t_ref = time.perf_counter() - t_ref
            p0 = ref.leaves(inputs.params)

            def judge(out):
                return check.train_numbers(out, reference, p0)

            detail = {"losses": program["losses"], "reference_losses": reference["losses"]}
        else:
            session = driver.Session(ctx, inputs)
            for _ in range(len(inputs.pool)):
                session._call()
            users = driver.sample_users(ctx, inputs, session.answers)
            program = driver.program_answer(session, users)
            session.free()
            t_ref = time.perf_counter()
            reference = driver.reference_scores(ctx, inputs, users)
            t_ref = time.perf_counter() - t_ref

            def judge(out):
                return check.recommend_numbers(*out, reference)

            detail = {}
        yield {"who": "program", "seed": seed, **judge(program), **detail,
               "reference_s": t_ref, "s": time.perf_counter() - t}
        if seed not in control_seeds:
            continue
        for who in ("control",) + FAULTS[s.kind]:
            precision = "fp8" if who == "control" else "f32"
            fault = None if who == "control" else who
            if s.kind == "train":
                out = driver.reference_out(ctx, inputs, precision, fault)
                detail = {"losses": out["losses"]}
            else:
                out = driver.reference_answer(ctx, inputs, users, precision, fault)
                detail = {}
            yield {"who": who, "seed": seed, **judge(out), **detail}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--first-seed", type=int, default=1_000_003)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seed-list", default="",
                        help="comma-separated seeds in place of --first-seed and --seeds")
    args = parser.parse_args(argv)
    seeds = ([int(v) for v in args.seed_list.split(",")] if args.seed_list
             else [args.first_seed + 7919 * i for i in range(args.seeds)])
    if not torch.cuda.is_available():
        log("recbench.calibrate: needs a CUDA device")
        return 2
    for reading in readings(pathlib.Path.cwd(), args.workload, seeds,
                            seeds[:args.control_seeds]):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
