"""Plain float32 reference of the benchmark's two entry points: three
training steps (gather, encoder with hash dropout, loss head, autograd
backward, AdamW) and batch recommendation (catalog projection, encoder,
cosine scoring, exclusion, top-k).

It imports torch alone: nothing of the program under test, nothing of the
JAX package.  It recomputes everything from the inputs the benchmark hands
to both sides (weights, item table, batches, dropout seeds), with TF32
off.  With ``Precision("fp8")`` every matrix product rounds its operands to
float8 e4m3 (per-tensor scaled), forward and backward: the lower precision
that serves as the comparison's control.
"""
