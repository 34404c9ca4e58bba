"""Device time a training step, or a recommendation call, of the kernels
that no port library launched (PyTorch's and cuBLAS's: products, casts,
elementwise ops, reductions, sorts, copies)."""

from recbench.trace import ms_per_unit


def read(trace):
    return ms_per_unit(trace, trace.library_s.get("library"))
