"""The model FLOPs of what the traced window ran, at the peak of each
product's dtype (``roofline``: a training step's input projection, encoder
forward and backward, and the loss head's scores and two gradients at the
bf16 peak; a recommendation call's projection and encoder at the bf16 peak
and the catalog's f32 cosine scores at the f32 peak), as a share of the
window's wall time."""


def read(trace):
    least = trace.least_s.get("model")
    if not least:
        return None
    return 100.0 * least / trace.window_s
