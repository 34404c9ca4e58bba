"""Build on first use + ctypes binding for the native batch sampler (JAX
``native/build.py``).

``sampler.cpp`` is the JAX package's source, copied: the same C++ gives
the same batches from the same seed in both packages.  It is compiled with
``g++`` into ``build/native/`` beside the package (git-ignored), under a
name holding the source's hash, so an edit rebuilds.  It is built for the
generic target, not ``-march=native`` as the JAX package builds it: the
directory travels with the checkout to other machines, and the sampler's
arithmetic is integer only, so the batches are the same.  Where no compiler
exists, :func:`load_native_sampler` returns None and the numpy sampler
(``data/dataset.py``) takes over.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess
import tempfile

import numpy as np

_SRC = pathlib.Path(__file__).parent / "sampler.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"


class NativeSampler:
    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.sample_batch.argtypes = [
            i32p, u8p, i64p, ctypes.c_int64,
            i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
            i32p, i32p, i32p,
        ]
        lib.sample_batch.restype = None
        lib.shuffled_order.argtypes = [ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64, i64p]
        lib.shuffled_order.restype = None

    def sample_batch(
        self,
        values: np.ndarray,
        labels: np.ndarray,
        offsets: np.ndarray,
        row_indices: np.ndarray,
        *,
        max_seq: int,
        pos_lookahead: int,
        num_items: int,
        seed: int,
        epoch: int,
        num_threads: int = 0,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One batch of (hist, pos, neg) int32 (B, max_seq) arrays.
        ``num_threads=0`` means the hardware's concurrency; the per-row
        streams are keyed, so any thread count gives the same batches.  The
        ctypes call releases the GIL."""
        b = len(row_indices)
        hist = np.zeros((b, max_seq), np.int32)
        pos = np.zeros((b, max_seq), np.int32)
        neg = np.zeros((b, max_seq), np.int32)
        self._lib.sample_batch(
            values, labels, offsets, len(offsets) - 1,
            np.ascontiguousarray(row_indices, np.int64), b,
            max_seq, pos_lookahead, num_items,
            seed & 0xFFFFFFFFFFFFFFFF, epoch, num_threads,
            hist, pos, neg,
        )
        return hist, pos, neg

    def shuffled_order(self, n: int, seed: int, epoch: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        self._lib.shuffled_order(n, seed & 0xFFFFFFFFFFFFFFFF, epoch, out)
        return out


def _build() -> pathlib.Path | None:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"sampler_{digest}.so"
    if so.exists():
        return so
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = pathlib.Path(tmp) / "sampler.so"
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            # std::thread needs -pthread where glibc is older than 2.34
            "-pthread",
            str(_SRC), "-o", str(tmp_so),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
        tmp_so.rename(so)
    return so


_cached: NativeSampler | None | bool = False  # False: not attempted


def load_native_sampler() -> NativeSampler | None:
    """Build and load the native sampler; None without a C++ toolchain."""
    global _cached
    if _cached is False:
        so = _build()
        _cached = NativeSampler(ctypes.CDLL(str(so))) if so else None
    return _cached
