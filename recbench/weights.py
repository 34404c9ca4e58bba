"""The model's weights and the frozen item table, made on the device from
the run's seed in a few large draws.

Weights follow the model's initializer: normal with ``initializer_range``
for every matrix and the position embeddings, zero biases, unit
LayerNorm scales, all f32 (the program trains f32 master weights and
rounds them to its compute dtype).  The item table stands for the
catalog's sentence embeddings (``item_table`` in the configuration): each
item's row is its genre's direction plus its own, mixed so that two items
of one genre have cosine ``genre_share``, then row-normalised; genres are
runs of ``genre_size`` consecutive items on the traffic's item ring; row 0
is the zero padding row.
"""

from __future__ import annotations

import torch


def param_shapes(model: dict) -> dict:
    """The parameter tree's shapes: name -> (shape, init) with init one of
    ``normal``, ``zeros``, ``ones``."""
    d, f, n = model["hidden_size"], model["intermediate_size"], model["num_hidden_layers"]
    din, s = model["input_dim"], model["max_seq_length"]

    def dense(i, o, layers=True):
        lead = (n,) if layers else ()
        return {"w": (lead + (i, o), "normal"), "b": (lead + (o,), "zeros")}

    def ln(layers=True):
        lead = (n,) if layers else ()
        return {"scale": (lead + (d,), "ones"), "bias": (lead + (d,), "zeros")}

    tree = {
        "pos_embed": ((s, d), "normal"),
        "embed_ln": ln(False),
        "layers": {"qkv": dense(d, 3 * d), "out": dense(d, d), "ln1": ln(),
                   "ffn_in": dense(d, f), "ffn_out": dense(f, d), "ln2": ln()},
    }
    if din != d:
        tree["input_proj"] = dense(din, d, False)
    return tree


def _walk(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def make_params(model: dict, generator: torch.Generator, device) -> dict:
    """The parameter tree, every normal leaf carved from one draw."""
    shapes = param_shapes(model)
    named = dict(_walk(shapes))
    total = sum(_numel(shape) for shape, init in named.values() if init == "normal")
    normal = torch.randn(total, generator=generator, device=device) * model["initializer_range"]
    out, start = {}, 0
    for name, (shape, init) in named.items():
        if init == "normal":
            n = _numel(shape)
            out[name] = normal[start:start + n].view(shape)
            start += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return _nest(shapes, out)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _nest(template, named, prefix=""):
    return {k: _nest(v, named, f"{prefix}{k}.") if isinstance(v, dict) else named[prefix + k]
            for k, v in template.items()}


def make_item_table(num_items: int, dim: int, spec: dict, generator: torch.Generator,
                    device) -> torch.Tensor:
    """(num_items + 1, dim) f32: a zero padding row, then one unit row per
    item (see the module docstring)."""
    size, share = spec["genre_size"], spec["genre_share"]
    genres = -(-num_items // size)
    centre = torch.randn(genres, dim, generator=generator, device=device)
    own = torch.randn(num_items, dim, generator=generator, device=device)
    centre = centre / centre.norm(dim=1, keepdim=True)
    own = own / own.norm(dim=1, keepdim=True)
    genre = torch.arange(num_items, device=device) // size
    rows = share ** 0.5 * centre[genre] + (1.0 - share) ** 0.5 * own
    rows = rows / rows.norm(dim=1, keepdim=True)
    return torch.cat([torch.zeros(1, dim, device=device), rows])
