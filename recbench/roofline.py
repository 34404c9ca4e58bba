"""Published peaks of one NVIDIA H100 and the least work of each layer's
function, from shapes and from what the inputs need.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (989 TFLOP/s on bf16
operands, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM3), as
``chip_smoke.py`` of the repository states them; they assume the card's
700 W limit.

Least work (``chip_smoke.py``'s counts, restated for a function's forward
and backward together and for these inputs):

- the encoder layer (``layer_bound_ms`` and ``time_layer_bwd``): each
  dense ``2 rows d_in d_out`` forward and twice that backward, attention
  ``2 * 2 * pairs * D`` forward (q k^T and P V) and twice that backward;
  rows are the positions that hold an item, pairs the causal pairs of
  those (a position sees itself and the positions before it), since a
  padded position's output is never used;
- table InfoNCE (``time_table_infonce``): the scores ``2 R N D`` once, dq
  and dT one product each, over the query rows that have a positive and
  the catalog rows the loss needs (the positives and the pool's items);
- the pairwise heads (``time_pairwise``): the scores ``2 R Rn D`` once,
  dq and dn one product each, over the rows that have a positive and the
  pool rows that are valid;
- the attention core (#17/#18; ``attn_core`` rows of chip_smoke): its
  products, and its bytes, each input read once and each output written
  once (q, k, v bf16 and the mask in; the f32 context out; backward: the
  f32 cotangent in, dq, dk, dv bf16 out), over the valid positions;
- bytes elsewhere: each input read once and each output written once,
  activations at 2 bytes, parameters and their gradients at 4.

A roofline share is the least time, ``max(flops / peak, bytes / 3.35
TB/s)``, over the device time of the kernels that computed the function.
"""

from __future__ import annotations

import torch

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    return max(flops / peak, nbytes / BYTES_PER_S)


def sequence_counts(history: torch.Tensor) -> dict:
    """Valid positions and causal pairs of a (B, S) batch whose items sit
    at the front of each row (0 = padding)."""
    lengths = (history != 0).sum(dim=1).double()
    return {"rows": float(lengths.sum()), "pairs": float((lengths * (lengths + 1) / 2).sum()),
            "slots": float(history.numel())}


def layer_params(d: int, f: int) -> int:
    return 4 * d * d + 2 * d * f + 9 * d + f


def encoder_layer_flops(model: dict, rows: float, pairs: float, backward: bool) -> float:
    """One layer's products: forward, and with ``backward`` the backward too."""
    d, f = model["hidden_size"], model["intermediate_size"]
    fwd = 2 * rows * (4 * d * d + 2 * d * f) + 4 * pairs * d
    return 3 * fwd if backward else fwd


def fused_layer_seconds(model: dict, counts: dict, backward: bool) -> float:
    """The least time of every layer of a batch through the fused layer."""
    d, f = model["hidden_size"], model["intermediate_size"]
    np_ = layer_params(d, f)
    acts = 2 if not backward else 4  # x in, y out; and dy in, dx out
    nbytes = acts * counts["rows"] * d * 2 + counts["slots"] + (2 if backward else 1) * 4 * np_
    flops = encoder_layer_flops(model, counts["rows"], counts["pairs"], backward)
    return model["num_hidden_layers"] * least_seconds(flops, nbytes)


def attn_core_seconds(model: dict, counts: dict, backward: bool) -> float:
    """The least time of every layer's attention core of a batch."""
    d = model["hidden_size"]
    flops = (12 if backward else 4) * counts["pairs"] * d
    per_row = (6 + 4 + 4 + 6) if backward else (6 + 4)
    nbytes = per_row * counts["rows"] * d + counts["slots"]
    return model["num_hidden_layers"] * least_seconds(flops, nbytes)


def table_infonce_seconds(d: int, rows: float, columns: float, catalog: float) -> float:
    """Forward and backward of the catalog-scored InfoNCE."""
    nbytes = (rows * d * 2 + columns * d * 2 + catalog * 4 + rows * 8
              + rows * 4 + rows * d * 2 + columns * d * 2)
    return least_seconds(6 * rows * columns * d, nbytes)


def pairwise_seconds(d: int, rows: float, pool: float) -> float:
    """Forward and backward of a pairwise head over the batch's pool."""
    nbytes = 2 * (2 * rows * d + pool * d) + 4 * pool + 4 * rows + 2 * (2 * rows * d + pool * d)
    return least_seconds(6 * rows * pool * d, nbytes)


def train_step_flops(model: dict, counts: dict, distinct_items: float, loss_rows: float,
                     loss_columns: float) -> float:
    """The model FLOPs of one training step: the input projection of the
    items the step uses (forward and the weight's gradient), every
    encoder layer forward and backward, the loss head's scores, dq and
    its other gradient (``6 R C D``)."""
    d = model["hidden_size"]
    proj = 4 * distinct_items * model["input_dim"] * d
    layers = model["num_hidden_layers"] * encoder_layer_flops(model, counts["rows"],
                                                              counts["pairs"], True)
    return proj + layers + 6 * loss_rows * loss_columns * d


def recommend_call_seconds(model: dict, counts: dict, distinct_items: float, users: float,
                           catalog: float) -> float:
    """The least time of one recommendation call's products at their
    precision's peak: the window items' projection and the encoder on
    bf16 operands, the f32 cosine scores of every catalog item."""
    d = model["hidden_size"]
    bf16 = 2 * distinct_items * model["input_dim"] * d + model["num_hidden_layers"] * \
        encoder_layer_flops(model, counts["rows"], counts["pairs"], False)
    return bf16 / BF16_FLOPS + 2 * users * catalog * d / F32_FLOPS
