"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its
own shared library under ``build/kernels/`` at the repository root, named
by the hash of the source and the flags, so an edit rebuilds and an
unchanged source is reused.  ``build_all`` starts one ``nvcc`` per source
at once.  Libraries are loaded with ``ctypes``; every entry point returns
its ``cudaError_t`` and :func:`check` raises on a non-zero status, so a
launch the CUDA runtime refused (too many threads, too much shared memory)
never passes silently.

Nothing here runs at import time: the CPU tests import every module, and
the CPU has no ``nvcc``.

``LAUNCHES`` counts kernel launches by kernel name (``KERNELS``).  A
wrapper adds one where it launches its kernel and nowhere else, so a
caller can reset the counts, drive a path and see which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel library name -> source file and the C functions' argument types
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES: dict[str, tuple[str, dict[str, list]]] = {
    "fused_layer": (
        "fused_layer.cu",
        {
            # x, y, mask, 12 params, B S D H F causal is_bf16 heads_per_stage
            # cluster, seeds (3 int64 on the card, or null), attn/hidden
            # thresholds, attn/hidden keep divisors, attn/hidden dropout on,
            # eps, dynamic smem bytes, stage, bf16 weight workspace, stream
            "fused_layer_fwd": [_P, _P, _P] + [_P] * 12
            + [_I] * 9 + [_P] + [_U, _U, _F, _F, _I, _I, _F, _I, _I, _P, _P],
            # S, D, F, heads per stage, bytes per activation, H
            "fused_layer_smem_bytes": [_I] * 6,
            # S, D, H, heads per stage: the f32 backward's pass 1
            "fused_layer_bwd_smem_bytes": [_I] * 4,
            # S, D, H, F, sequences a CTA, cluster, heads per stage: the
            # bf16 backward's pass 1
            "fused_layer_bwd_tc_smem_bytes": [_I] * 7,
            # kernel (0 f32 forward, 1 f32 pass 1, 2 bf16 forward, 3 bf16
            # pass 1), S, D, H, F, heads per stage, cluster: the clusters
            # the card holds at once
            "fused_layer_max_clusters": [_I] * 7,
            # x, dy, mask, 12 params, dx, 12 param grads, 17 workspace
            # buffers, B S D H F causal is_bf16 splits cluster
            # heads_per_stage seqs, seeds (as the forward's), attn/hidden
            # thresholds, attn keep divisor, hidden keep divisors of the
            # forward recompute and of the backward, attn/hidden dropout on,
            # eps, stage, stream
            "fused_layer_bwd": [_P, _P, _P] + [_P] * 12 + [_P] + [_P] * 12 + [_P] * 17
            + [_I] * 11 + [_P] + [_U, _U, _F, _F, _F, _I, _I, _F, _I, _P],
        },
    ),
    "vpu_calibration": (
        "vpu_calibration.cu",
        # x, y (f32), n, iters, mix (0 fma, 1 exp, 2 select), stream
        {"vpu_chain": [_P, _P, _I, _I, _I, _P]},
    ),
    "gather_rows": (
        "gather_rows.cu",
        {
            # table, idx, out, N, D, R, table_is_bf16, out_is_bf16,
            # idx_is_64, stream
            "gather_rows_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
            # an empty kernel on gather_rows_fwd's grid: D, R, out_is_bf16,
            # stream
            "gather_rows_launch_floor": [_I, _I, _I, _P],
            # idx, int32 workspace (keys, order, bounds, the tiled sort's buffers), N, R,
            # idx_is_64, tiled (1 forces the tiled sort), stream
            "gather_rows_group": [_P, _P, _I, _I, _I, _I, _P],
            # g, sorted idx, order, bounds (or null), idx_is_64, dtable,
            # partial sums (f32 workspace), N, D, R, g_is_bf16,
            # dtable_is_bf16, stream
            "gather_rows_bwd": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
        },
    ),
    "fused_table_infonce": (
        "fused_table_infonce.cu",
        {
            # R, N, D, pass (0 forward, 1 dq, 2 dT): the splits of a launch
            "table_infonce_splits": [_I] * 4,
            # q, table (bf16), pos_idx (int32), counts (f32), ce, lse, pos,
            # split workspace (f32), R, N, D, scale, mask_false_negatives,
            # splits, stream
            "table_infonce_fwd": [_P] * 8 + [_I, _I, _I, _F, _I, _I, _P],
            # q, table, pos_idx, counts, lse, g, dq (f32), dtable (f32), pos
            # workspace, dq and dT split workspaces (f32), R, N, D, scale,
            # mask_false_negatives, dq splits, dT splits, stream
            "table_infonce_bwd": [_P] * 11 + [_I, _I, _I, _F, _I, _I, _I, _P],
        },
    ),
    "fused_infonce": (
        "fused_infonce.cu",
        {
            # R, Rn, D, pass (0 forward, 1 dq, 2 dn): the splits of a launch
            "pool_infonce_splits": [_I] * 4,
            # q, p, n (bf16), nv (f32), ce, lse, pos, split workspace (f32),
            # R, Rn, D, scale, mask_false_negatives, splits, stream
            "pool_infonce_fwd": [_P] * 8 + [_I, _I, _I, _F, _I, _I, _P],
            # q, p, n, nv, lse, g, pos, dq, dp (f32), split workspace (f32;
            # null with one split), R, Rn, D, scale, mask_false_negatives,
            # splits, stream
            "pool_infonce_dq": [_P] * 10 + [_I, _I, _I, _F, _I, _I, _P],
            # q, n, nv, lse, g, pos, dn (f32), split workspace (f32; null
            # with one split), R, Rn, D, scale, mask_false_negatives,
            # splits, stream
            "pool_infonce_dn": [_P] * 8 + [_I, _I, _I, _F, _I, _I, _P],
        },
    ),
    "fused_pairwise": (
        "fused_pairwise.cu",
        {
            # R, Rn, D, pass (0 forward, 1 dn, 2 dq): the splits of a launch
            "pairwise_splits": [_I] * 4,
            # q, p, n (bf16), nv (f32), out, den, pos, split workspace (f32),
            # R, Rn, D, head, margin, 1 - margin, mask_false_negatives,
            # splits, stream
            "pairwise_fwd": [_P] * 8 + [_I, _I, _I, _I, _F, _F, _I, _I, _P],
            # q, p, n, nv, den, g, pos, dq, dp (f32), split workspace (f32;
            # null with one split), R, Rn, D, head, margin, 1 - margin,
            # mask_false_negatives, splits, stream
            "pairwise_dq": [_P] * 10 + [_I, _I, _I, _I, _F, _F, _I, _I, _P],
            # q, n, nv, den, g, pos, dn (f32), split workspace (f32; null
            # with one split), R, Rn, D, head, margin, 1 - margin,
            # mask_false_negatives, splits, stream
            "pairwise_dn": [_P] * 8 + [_I, _I, _I, _I, _F, _F, _I, _I, _P],
        },
    ),
    "hash_dropout": (
        "hash_dropout.cu",
        # x, y, n, is_bf16, ndim, sizes, strides (host int64 arrays), seed
        # term (an int64 on the card, or null), seed value, threshold,
        # divisor, stream
        {"hash_dropout": [_P, _P, _L, _I, _I, _P, _P, _P, _U, _U, _F, _P]},
    ),
    "attn_core": (
        "attn_core.cu",
        {
            # q, k, v, their b/s/h strides, key mask, m, l, y (or null),
            # ctx, B S H dh causal, scale, seed term (or null), seed value,
            # threshold, bf16 keep divisor, dropout on, stream
            "attn_core_fwd": [_P] * 3 + [_L] * 3 + [_P] * 5 + [_I] * 5
            + [_F, _P, _U, _U, _F, _I, _P],
            # q, k, v, their strides, key mask, m, l, g, dq, dk, dv, B S H
            # dh causal, scale, seed term (or null), seed value, threshold,
            # bf16 and f32 keep divisors, dropout on, stream
            "attn_core_bwd": [_P] * 3 + [_L] * 3 + [_P] * 7 + [_I] * 5
            + [_F, _P, _U, _U, _F, _F, _I, _P],
            # backward, S, dh: the CTAs an SM holds
            "attn_core_ctas_per_sm": [_I] * 3,
            # b, the first and last + 1 float bit patterns, the count (one
            # uint64 on the card), stream: the branch-free division's check
            "attn_core_div_check": [_F, ctypes.c_ulonglong, ctypes.c_ulonglong, _P, _P],
        },
    ),
    "dense": (
        "dense.cu",
        {
            # x, w (bf16), bias (f32), y (bf16), M, K, N, stream
            "dense_fwd": [_P] * 4 + [_I] * 3 + [_P],
            # g, w (bf16), dx (bf16), M, K, N, stream
            "dense_dgrad": [_P] * 3 + [_I] * 3 + [_P],
            # T, K, N: the splits of T a wgrad takes
            "dense_wgrad_splits": [_I] * 3,
            # x, g (bf16), the dW and db partials (f32 workspaces), dW, db
            # (f32), T, K, N, splits, stream
            "dense_wgrad": [_P] * 6 + [_I] * 4 + [_P],
        },
    ),
}

# the kernels a wrapper counts, by name: a C entry point that launches
# more than one CUDA kernel for one function (a backward's passes) counts
# once per call; the section-profile variants of the layer's kernels count
# apart from the layer's own launches
KERNELS = (
    "gather_rows", "gather_rows_bwd", "fused_layer", "fused_layer_bwd",
    "table_infonce_fwd", "table_infonce_bwd",
    "pool_infonce_fwd", "pool_infonce_dq", "pool_infonce_dn",
    "pairwise_fwd", "pairwise_dq", "pairwise_dn",
    "vpu_chain", "fused_layer_stage_fwd", "fused_layer_stage_bwd",
    "hash_dropout", "attn_core_fwd", "attn_core_bwd",
    "dense_fwd", "dense_dgrad", "dense_wgrad",
    # not a kernel: the bf16 denses on the card that took the plain path
    "dense_plain",
)
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        msg = "nvcc not found: the CUDA kernels need the CUDA toolkit"
        raise RuntimeError(msg)
    return path


def _target(name: str) -> pathlib.Path:
    src = CSRC / SIGNATURES[name][0]
    digest = hashlib.sha256()
    for part in (src.read_bytes(), (CSRC / "common.cuh").read_bytes(),
                 " ".join(NVCC_FLAGS).encode()):
        digest.update(part)
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, pathlib.Path]:
    """Compile every (or the named) kernel library that is missing, one
    ``nvcc`` process per source, all started together.  Raises with the
    compiler's output when one fails."""
    names = list(names or SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SIGNATURES[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
        else:
            tmp.replace(targets[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in SIGNATURES[name][1].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def splits(name: str, planner: str, device_index: int, *shape: int) -> int:
    """The splits that the C function ``planner`` of kernel library
    ``name`` plans for ``shape`` (its rows, pool or catalog rows, D and
    pass) on card ``device_index``; a wrapper sizes its split workspace by
    it."""
    with torch.cuda.device(device_index):
        planned = getattr(library(name), planner)(*shape)
    if planned < 1:
        msg = f"{planner}: CUDA error planning {shape}"
        raise RuntimeError(msg)
    return planned


def check(status: int, what: str) -> None:
    if status != 0:
        msg = f"{what}: CUDA error {status}"
        raise RuntimeError(msg)


def workspace(elems: int, device) -> torch.Tensor | None:
    """An f32 workspace of ``elems`` elements for a kernel, or None (a null
    pointer: the kernel takes none) for 0."""
    return torch.empty(elems, dtype=torch.float32, device=device) if elems else None


def pointer(t: torch.Tensor | None) -> int | None:
    """The address a C entry point takes for ``t``; None (null) for none."""
    return None if t is None else t.data_ptr()


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _max_shared_memory(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return int(props.shared_memory_per_block_optin)


def max_shared_memory(device: torch.device) -> int:
    """Dynamic shared memory one block may opt into on ``device``."""
    return _max_shared_memory(torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return int(torch.cuda.get_device_properties(index).multi_processor_count)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``."""
    return _sm_count(torch.device(device).index or 0)
