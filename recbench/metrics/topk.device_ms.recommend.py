"""Device time a call of retrieval (``ops/topk.py``: the catalog's
scores, the exclusion of each user's history, the top k), from the
kernels inside the spans the harness puts around those calls."""

from recbench.trace import ms_per_unit


def read(trace):
    return ms_per_unit(trace, trace.span_s.get("recbench.topk"))
