"""One serving worker, spawned by ``asgi.serve_workers``.

Each worker is a fresh process: it applies its core set
(``XRT_WORKER_CPUS``) before torch loads, loads the Service artifact on
``--device`` (``cuda`` by default) and binds the shared port with
SO_REUSEPORT.  On SIGTERM it prints its kernel launch counts
(``worker <pid> launches {...}``) and exits with code 0.

Usage: python -m transformer_recommenders_tpu_torch.serving.worker \\
           <artifact_dir> <host> <port> [--device D]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import sys


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="transformer_recommenders_tpu_torch.serving.worker")
    parser.add_argument("artifact")
    parser.add_argument("host")
    parser.add_argument("port", type=int)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    def stop(signum, frame) -> None:
        # the worker's kernel launches, one line on the way out, for a
        # caller that counts which kernels a pool's requests went through
        from transformer_recommenders_tpu_torch.ops import cuda_build

        # one write: the pool's workers share their standard output
        sys.stdout.write(f"worker {os.getpid()} launches {json.dumps(cuda_build.LAUNCHES)}\n")
        sys.stdout.flush()
        sys.exit(0)

    signal.signal(signal.SIGTERM, stop)
    cpus = os.environ.get("XRT_WORKER_CPUS")
    if cpus:
        # before torch loads: its thread pools size themselves to the cores
        # this process may use
        os.sched_setaffinity(0, {int(c) for c in cpus.split(",")})
    import torch

    if cpus:
        torch.set_num_threads(len(cpus.split(",")))
    from transformer_recommenders_tpu_torch.serving.asgi import serve
    from transformer_recommenders_tpu_torch.serving.service import Service

    service = Service(pathlib.Path(args.artifact), device=args.device)
    serve(service.to_asgi(), host=args.host, port=args.port, reuse_port=True)


if __name__ == "__main__":
    main()
