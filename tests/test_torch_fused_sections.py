"""The port's plain section variants of the fused layer
(``ops/fused_sections.py``: what the CUDA kernels' section variants compute
and what the wrappers run on CPU tensors) against the JAX package's stage
kernels (``scripts/profile_fused_sections.py``: ``_stage_fwd_kernel``,
``_stage_bwd_kernel``) in interpret mode, at the script's ``tiny`` shape,
from the same numpy weights, inputs, mask, cotangent and dropout seeds
(1, 2, 3), dropout 0.1 on every site, causal.

bf16 runs through the script's own ``_build`` (one kernel call: its
``INNER_ITERS`` set to 1), with every parameter rounded to bf16 as the
script does; the port takes those values as f32 (exact).  f32 runs through
this file's ``pallas_call`` over the same stage bodies, as ``_build``'s
``call_once`` makes it.

Tolerances:
- f32: the forward stages 2e-5 abs and rel (``test_torch_fused_layer.py``),
  the backward stages rtol 1e-4, atol 1e-5 (``test_torch_fused_layer_grad``);
- bf16 forward stages and the recomputed output: at most 2**-4, mean at
  most 2**-8 (``test_torch_fused_layer.py``: one-ulp flips of intermediate
  bf16 roundings, which Pallas interpret mode makes in other places);
- bf16 backward stages (T(dctx), dx): 1e-2 of the max abs value
  (``test_torch_fused_layer_grad.py``).  The JAX ``full`` stage stores
  dx + 1e-30 * (a sum of the parameter-gradient products), which is dx to
  the last bit wherever |dx| > ~1e-20, so it is held to the same bound.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_fused_layer import layer_weights
from transformer_recommenders_tpu.ops import fused_layer as JFL
from transformer_recommenders_tpu_torch.models.transformer import params_from_jax
from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops import fused_layer as tfl
from transformer_recommenders_tpu_torch.ops import fused_sections as fs

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "profile_fused_sections.py"
SEEDS = [1, 2, 3]
RATE = 0.1


@pytest.fixture(scope="module")
def script():
    """The JAX script as a module.  Importing it points JAX's compilation
    cache at a directory outside the repository; nothing is compiled before
    the setting is put back."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("profile_fused_sections", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return mod


def make_case(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    b, s, d, f = shape["b"], shape["s"], shape["d"], shape["f"]
    weights = layer_weights(rng, d, f)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    dy = rng.normal(size=(b, s, d)).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[-1, s // 2:] = False  # a padded tail
    if dtype == "bfloat16":  # the script's cast of every f32 parameter
        weights = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                                                    .astype(jnp.float32)), weights)
    return weights, x, dy, mask


def jax_stage(script, shape, stage, direction, dtype, weights, x, dy, mask):
    jdt = jnp.dtype(dtype)
    flat = tuple(a.astype(jdt) for a in JFL._flatten_params(jax.tree.map(jnp.asarray, weights)))
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    maskj = jnp.asarray(mask.astype(np.int32)[:, None, :])
    seeds = jnp.asarray(SEEDS, jnp.int32)
    extra = [] if direction == "fwd" else [gj]
    if dtype == "bfloat16":
        fn, _ = script._build(shape, stage, direction, True)
        return np.asarray(fn(xj, maskj, seeds, flat, *extra).astype(jnp.float32))
    # f32: call_once of _build with the f32 compute type
    cfg = dict(num_heads=shape["h"], s=shape["s"], d=shape["d"], causal=True, attn_rate=RATE,
               hidden_rate=RATE, eps=1e-12, dtype=jnp.float32)
    b, s, d = x.shape
    bt = JFL._pick_block_batch(b, s, d, shape["f"], shape["h"])
    x_spec, mask_spec, seed_spec, const = JFL._specs(bt, s, d)
    body = script._stage_fwd_kernel if direction == "fwd" else script._stage_bwd_kernel
    with JFL._maybe_interpret(True):
        out = pl.pallas_call(
            functools.partial(body, stage=stage, **cfg), grid=(b // bt,),
            in_specs=[x_spec, mask_spec, seed_spec] + [x_spec] * len(extra)
            + [const] * len(flat),
            out_specs=x_spec, out_shape=jax.ShapeDtypeStruct((b, s, d), xj.dtype),
        )(xj, maskj, seeds, *extra, *flat)
    return np.asarray(out)


def port_stage(shape, stage, direction, dtype, weights, x, dy, mask):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    params = params_from_jax(weights, device="cpu")
    kw = dict(stage=stage, num_heads=shape["h"], causal=True, attn_dropout=RATE,
              hidden_dropout=RATE, dropout_seeds=SEEDS)
    xt, maskt = torch.from_numpy(x).to(tdt), torch.from_numpy(mask)
    if direction == "fwd":
        out = fs.layer_stage_forward(xt, params, maskt, **kw)
    else:
        out = fs.layer_stage_backward(xt, params, maskt, torch.from_numpy(dy).to(tdt), **kw)
    assert out.dtype == tdt and tuple(out.shape) == x.shape
    return out.float().numpy()


STAGES = [("fwd", s) for s in fs.FWD_STAGES] + [("bwd", s) for s in fs.BWD_STAGES]
GRADIENTS = {("bwd", "ffn_bwd"), ("bwd", "attn_bwd"), ("bwd", "full")}


@pytest.mark.parametrize(("direction", "stage"), STAGES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stage_matches_jax_stage_kernel_interpret(script, monkeypatch, direction, stage, dtype):
    monkeypatch.setattr(script, "INNER_ITERS", 1)
    shape = script.SHAPES["tiny"]
    weights, x, dy, mask = make_case(shape, dtype)
    want = jax_stage(script, shape, stage, direction, dtype, weights, x, dy, mask)
    got = port_stage(shape, stage, direction, dtype, weights, x, dy, mask)
    assert np.abs(want).max() > 1e-2  # non-degenerate
    if (direction, stage) in GRADIENTS:
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        else:
            assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        err = np.abs(got - want)
        assert err.max() <= 2.0**-4 and err.mean() <= 2.0**-8, (err.max(), err.mean())


def _torch_case(dtype, seed=1, b=3, s=8, d=32, h=4, f=64):
    weights, x, dy, mask = make_case(dict(b=b, s=s, d=d, f=f), "float32", seed)
    tdt = getattr(torch, dtype)
    kw = dict(num_heads=h, causal=True, attn_dropout=RATE, hidden_dropout=RATE,
              dropout_seeds=SEEDS)
    return (torch.from_numpy(x).to(tdt), params_from_jax(weights, device="cpu"),
            torch.from_numpy(mask), torch.from_numpy(dy).to(tdt), kw)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_stages_are_the_layer_and_its_backward(dtype):
    """One helper computes the layer and its cuts, so the full stages are
    the plain layer and the plain backward's dx bit for bit (and attn_bwd,
    whose cut is after dx, too)."""
    x, params, mask, dy, kw = _torch_case(dtype)
    y = fs.layer_stage_forward(x, params, mask, stage="full", **kw)
    assert torch.equal(y, tfl.fused_layer_reference(x, params, mask, ffn_dim=64, **kw))
    dx, _ = tfl.fused_layer_backward_reference(x, params, mask, dy, ffn_dim=64, **kw)
    for stage in ("attn_bwd", "full"):
        assert torch.equal(fs.layer_stage_backward(x, params, mask, dy, stage=stage, **kw), dx)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_recompute_stage_is_the_forward_only_in_f32(dtype):
    """The backward recomputes the GELU with the A&S erf under bf16 (the
    JAX backward's choice), so its recomputed output is not the forward's;
    in f32 both use the Eigen polynomial and agree bit for bit."""
    x, params, mask, dy, kw = _torch_case(dtype)
    y = fs.layer_stage_forward(x, params, mask, stage="full", **kw)
    rec = fs.layer_stage_backward(x, params, mask, dy, stage="recompute", **kw)
    assert torch.equal(rec, y) == (dtype == "float32")


def test_cpu_stages_launch_nothing():
    x, params, mask, dy, kw = _torch_case("float32")
    cuda_build.reset_launches()
    for stage in fs.FWD_STAGES:
        fs.layer_stage_forward(x, params, mask, stage=stage, **kw)
    for stage in fs.BWD_STAGES:
        fs.layer_stage_backward(x, params, mask, dy, stage=stage, **kw)
    assert not any(cuda_build.LAUNCHES.values())


@pytest.mark.parametrize(("case", "match"), [
    ("unknown_stage", "stage must be one of"),
    ("backward_stage_forward", "stage must be one of"),
    ("ffn_narrower_than_d", "F >= D"),
    ("long_sequence", "s <= 64"),
    ("not_cuda", "unsupported device"),
])
def test_wrappers_refuse(case, match):
    x, params, mask, dy, kw = _torch_case("float32")
    stage = {"unknown_stage": "ln2", "backward_stage_forward": "recompute"}.get(case, "ffn_gelu")
    if case == "ffn_narrower_than_d":
        x, params, mask, dy, kw = _torch_case("float32", d=32, f=16)
    elif case == "long_sequence":
        x, params, mask, dy, kw = _torch_case("float32", s=65)
    elif case == "not_cuda":  # a device the kernels do not take: no plain fallback
        x, mask = x.to("meta"), mask.to("meta")
    with pytest.raises(ValueError, match=match):
        fs.layer_stage_forward(x, params, mask, stage=stage, **kw)


def test_profile_entry_point_needs_a_card(monkeypatch, tmp_path, capsys):
    """Without a CUDA card the tool exits non-zero and writes nothing: it
    never times the CPU."""
    from transformer_recommenders_tpu_torch.tools import profile_fused_sections

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "sections.json"
    assert profile_fused_sections.main(["--shape", "tiny", "--out", str(out)]) != 0
    assert not out.exists() and "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_profile_inputs_take_a_dtype(dtype):
    """``--dtype`` sets the activations' type; bf16 rounds the weights to
    bf16 as the JAX script casts them, f32 keeps them; ``--dropout 0``
    passes no seeds.  The section variants run on the CPU inputs."""
    from transformer_recommenders_tpu_torch.tools import profile_fused_sections as pfs

    shape = pfs.SHAPES["tiny"]
    layer, x, dy, mask, opts = pfs.make_inputs(shape, "cpu", dtype, dropout=0.0)
    assert x.dtype == dy.dtype == getattr(torch, dtype) and opts["dropout_seeds"] is None
    w = layer["qkv"]["w"]
    assert w.dtype == torch.float32
    assert torch.equal(w, w.to(torch.bfloat16).float()) == (dtype == "bfloat16")
    _, _, _, _, drop = pfs.make_inputs(shape, "cpu", dtype)
    assert drop["attn_dropout"] == drop["hidden_dropout"] == 0.1
    y = fs.layer_stage_forward(x, layer, mask, stage="full", **opts)
    assert y.dtype == x.dtype and y.shape == x.shape
    with pytest.raises(ValueError, match="dtype must be one of"):
        pfs.make_inputs(shape, "cpu", "float16")


def test_profile_entry_point_takes_the_seed_spread_layer_in_f32(monkeypatch, capsys):
    """The f32 profile of the seed spread's layer parses (and, without a
    card, exits 2 as every measurement entry point does)."""
    from transformer_recommenders_tpu_torch.tools import profile_fused_sections as pfs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pfs.SHAPES["seed_spread"] == dict(b=32, s=32, d=384, h=12, f=48)
    assert pfs.main(["--shape", "seed_spread", "--dtype", "float32", "--dropout", "0",
                     "--tree", "."]) == 2
    with pytest.raises(SystemExit):
        pfs.main(["--dtype", "int8"])
    assert "invalid choice" in capsys.readouterr().err


def test_profile_entry_point_takes_the_quality_layer_in_bf16(monkeypatch):
    """``--shape quality``, the same layer at the quality run's batch
    (B=256, bf16, dropout 0.1 by default), parses and, without a card,
    exits 2."""
    from transformer_recommenders_tpu_torch.tools import profile_fused_sections as pfs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pfs.SHAPES["quality"] == dict(b=256, s=32, d=384, h=12, f=48)
    assert pfs.main(["--shape", "quality", "--dtype", "bfloat16", "--tree", "."]) == 2


@pytest.mark.parametrize("name", ["train", "quality"])
def test_section_flops_add_up_to_the_layer(name):
    """The forward's sections sum to the layer's products and the
    backward's to three times its dense products plus four attention
    products (the bound chip_smoke.py gives the layer backward), at the
    flagship's training batch and the quality run's D=384 (F=48 < D: the
    ffn_gelu variant does not run, its work counts with the next)."""
    from transformer_recommenders_tpu_torch.tools.profile_fused_sections import (
        SHAPES, section_flops)

    shape = SHAPES[name]
    b, s, d, f = (shape[k] for k in "bsdf")
    flops = section_flops(shape)
    fwd = sum(v for k, v in flops.items() if k.startswith("fwd/"))
    bwd = sum(v for k, v in flops.items() if k.startswith("bwd/"))
    assert fwd == 2 * b * s * (4 * d * d + 2 * d * f) + 4 * b * s * s * d
    assert bwd == 6 * b * s * (4 * d * d + 2 * d * f) + 12 * b * s * s * d
