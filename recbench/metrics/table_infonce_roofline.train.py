"""Share of its roofline of the function that the port's
``csrc/fused_table_infonce.cu`` computes: the least time of what the traced
window ran (``roofline``) over the device time of that library's kernels."""

from recbench.trace import roofline_share


def read(trace):
    return roofline_share(trace, "fused_table_infonce", "table_infonce")
