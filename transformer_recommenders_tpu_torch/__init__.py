"""PyTorch/CUDA port of ``transformer_recommenders_tpu``.

The JAX package stays the reference; this package mirrors its module and
function names so each counterpart is easy to find.  It imports ``torch``
and never ``jax``, and nothing from the JAX package: the host modules it
needs (``params``, ``configs``, ``index/*``, ``serving/asgi``) are its own
copies.

Every TPU kernel on a ported path is a hand-written CUDA kernel for Hopper
(``csrc/*.cu``, built by ``ops/cuda_build.py``); its wrapper runs the plain
PyTorch version only for tensors on the CPU.  Entry points default to the
``cuda`` device and raise when no card is present.
"""

from __future__ import annotations


def resolve_device(device: str | torch.device | None) -> torch.device:  # noqa: F821
    """``None`` means ``cuda``.  A CUDA device without a card raises: the
    port never carries on silently on the CPU (pass ``device="cpu"`` for
    that, as the tests do)."""
    # torch is imported here, not with the package: a serving worker sets
    # its CPU affinity before torch loads (``serving/worker.py``)
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        msg = (
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
        raise RuntimeError(msg)
    return dev
