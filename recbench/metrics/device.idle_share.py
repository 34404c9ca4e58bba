"""Share of the traced window in which no operation ran on the device
(busy_s is the union of device intervals)."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
