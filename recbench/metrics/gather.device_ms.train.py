"""Device time a training step of the embedding gather and its backward
(``csrc/gather_rows.cu``, #1/#2)."""

from recbench.trace import ms_per_unit


def read(trace):
    return ms_per_unit(trace, trace.library_s.get("gather_rows"))
