"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip where there is no card (the kernels have
no CPU or interpret mode); on a machine with an H100 run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest.py imports jax, which the card's
machine does not need.)

Tolerances (kernel vs plain version, same inputs, same device):
- f32 fused layer: 2e-5 (both sum in f32, in other orders);
- bf16 fused layer: at most 2**-4, mean at most 2**-8 (one-ulp flips of
  intermediate bf16 roundings, outputs |y| < 8 after LayerNorm);
- gather: exact (a copy);
- the backward kernels: see ``GRAD_TOL`` below;
- the hash dropout (#16): exact (the same hash and the same true
  division);
- the attention core (#17, #18): see ``test_attn_core_kernels_match_plain``.
"""

import math

import pytest
import torch

from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.ops import fused_layer as fl
from transformer_recommenders_tpu_torch.ops import fused_table_infonce as fti
from transformer_recommenders_tpu_torch.ops import gather_matmul as gm
from transformer_recommenders_tpu_torch.ops.fused_layer import (
    _PARAM_ORDER,
    fused_layer,
    fused_layer_backward_reference,
    fused_layer_reference,
    heads_per_stage,
    smem_bytes,
)
from transformer_recommenders_tpu_torch.ops.gather_matmul import (
    gather_rows,
    gather_rows_backward_reference,
    gather_rows_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _weights(gen, d, f, device):
    def dense(i, o):
        return {"w": (torch.randn(i, o, generator=gen) / math.sqrt(i)).to(device),
                "b": (0.1 * torch.randn(o, generator=gen)).to(device)}

    def ln(n):
        return {"scale": (1 + 0.1 * torch.randn(n, generator=gen)).to(device),
                "bias": (0.1 * torch.randn(n, generator=gen)).to(device)}

    return {"qkv": dense(d, 3 * d), "out": dense(d, d), "ffn_in": dense(d, f),
            "ffn_out": dense(f, d), "ln1": ln(d), "ln2": ln(d)}


@pytest.mark.parametrize(("b", "s", "d", "h", "f"), [
    (64, 32, 128, 8, 512),   # configs/ml1m_ssm.yaml, a serving batch (bf16: clusters of 2)
    (128, 32, 128, 8, 512),  # its training batch (clusters of 1)
    (8, 32, 384, 12, 48),    # configs/ml1m_reference.yaml
    (32, 32, 384, 12, 48),   # its training batch, path B (clusters of 4)
    (4, 8, 64, 4, 256),      # configs/ml100k_bpr.yaml at seq 8
    (3, 64, 128, 8, 512),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_layer_kernel_matches_plain(cuda, b, s, d, h, f, dtype, rate):
    gen = torch.Generator().manual_seed(b * s + d)
    x = torch.randn(b, s, d, generator=gen).to(cuda, dtype)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[-1, s // 2:] = False
    mask = mask.to(cuda)
    params = _weights(gen, d, f, cuda)
    kw = dict(num_heads=h, causal=True, attn_dropout=rate, hidden_dropout=rate,
              dropout_seeds=[1, 2, 3] if rate else None, ffn_dim=f)
    with torch.no_grad():
        got = fused_layer(x, params, mask, **kw)
        want = fused_layer_reference(x, params, mask, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5
    else:
        assert err.max().item() <= 2.0**-4 and err.mean().item() <= 2.0**-8


def _layer_inputs(cuda, b, s, d, h, f, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, d, generator=gen).to(cuda, dtype)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[-1, s // 2:] = False
    mask[0, s - 3:] = False
    return x, _weights(gen, d, f, cuda), mask.to(cuda)


@pytest.mark.parametrize(("b", "s", "d", "h", "f"), [
    (64, 32, 128, 8, 512),   # the serving batch
    (32, 32, 384, 12, 48),   # path B
    (5, 8, 64, 4, 256),      # S=8, a ragged batch
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_layer_forward_bits_do_not_depend_on_the_cluster(cuda, monkeypatch, b, s, d, h, f,
                                                              rate):
    """The bf16 forward split across clusters of 1, 2 and 4 CTAs matches
    its plain version under the layer's bounds and gives the same bits
    for every cluster size (each output's k-sum stays in one warp)."""
    x, params, mask = _layer_inputs(cuda, b, s, d, h, f, seed=b + d)
    kw = dict(num_heads=h, causal=True, attn_dropout=rate, hidden_dropout=rate,
              dropout_seeds=[1, 2, 3] if rate else None, ffn_dim=f)
    with torch.no_grad():
        want = fused_layer_reference(x, params, mask, **kw)
        outs = {}
        for c in fl.CLUSTER_SIZES:
            monkeypatch.setattr(fl, "cluster_size", lambda *_, c=c: c)
            outs[c] = fused_layer(x, params, mask, **kw)
    torch.cuda.synchronize()
    for c, got in outs.items():
        err = (got.float() - want.float()).abs()
        assert err.max().item() <= 2.0**-4 and err.mean().item() <= 2.0**-8, c
        assert torch.equal(got, outs[1]), c


@pytest.mark.parametrize(("b", "s", "d", "h", "f"), [
    (64, 32, 128, 8, 512), (128, 32, 128, 8, 512), (32, 32, 384, 12, 48),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_layer_forward_kernel_is_deterministic(cuda, b, s, d, h, f, dtype):
    """No atomics: two calls of the forward give the same bits."""
    x, params, mask = _layer_inputs(cuda, b, s, d, h, f, dtype, seed=b + d + 1)
    kw = dict(num_heads=h, causal=True, attn_dropout=0.1, hidden_dropout=0.1,
              dropout_seeds=[5, 6, 7], ffn_dim=f)
    with torch.no_grad():
        first = fused_layer(x, params, mask, **kw)
        second = fused_layer(x, params, mask, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_shared_memory_layouts_agree(cuda):
    lib = cuda_build.library("fused_layer")
    limit = cuda_build.max_shared_memory(cuda)
    for s, d, f, h, elem in [(32, 128, 512, 8, 2), (32, 384, 48, 12, 4), (8, 64, 256, 4, 2),
                             (32, 384, 48, 12, 2), (64, 128, 512, 8, 2), (64, 128, 512, 8, 4),
                             (8, 64, 256, 4, 4), (32, 384, 48, 16, 2)]:
        for cluster in (1, 2, 4):
            hg = heads_per_stage(s, d, f, h, elem, limit, cluster)
            assert lib.fused_layer_smem_bytes(s, d, f, hg, elem, h) == smem_bytes(s, d, f, hg,
                                                                                 elem, h)
            if elem == 4:  # the f32 backward's first pass
                hg = fl.bwd_heads_per_stage(s, d, h, limit, cluster)
                assert lib.fused_layer_bwd_smem_bytes(s, d, h, hg) == fl.bwd_smem_bytes(s, d, h,
                                                                                        hg)
            else:  # the bf16 backward's, one sequence a CTA or clusters
                hg = fl.bwd_tc_heads(s, d, h, f, 1, cluster, limit)
                assert lib.fused_layer_bwd_tc_smem_bytes(s, d, h, f, 1, cluster, hg) \
                    == fl.bwd_tc_smem_bytes(s, d, h, f, 1, cluster, hg)
        if elem == 2 and 64 // s >= 2:  # and two sequences a CTA
            plan = fl.bwd_tc_plan_for(s, d, h, f, 2, 1, limit)
            assert lib.fused_layer_bwd_tc_smem_bytes(
                s, d, h, f, 2, 1, plan["heads_per_stage"]) == plan["smem"] <= limit


def test_cluster_plans_use_the_cards_count(cuda):
    """The bf16 forward's and backward's plans take the card's count of
    co-resident clusters: every planned cluster of path B's B=32 fits at
    once (on an H100, 30 clusters of 4 do not: the forward takes 2, pass 1
    of the backward 3), and the quality run's B=256 backward takes two
    sequences a CTA in one wave."""
    b, s, d, h, f = 32, 32, 384, 12, 48
    index = cuda.index or 0
    c = fl._tc_cluster(b, s, d, h, f, cuda)
    assert c == 1 or b <= fl._max_clusters(index, fl.TC_FWD, s, d, h, f, 0, c)
    plan = fl._bwd_tc_plan(b, s, d, h, f, cuda)
    hg, cb = plan["heads_per_stage"], plan["cluster"]
    assert plan["seqs"] == 1
    assert cb == 1 or b <= fl._max_clusters(index, fl.TC_BWD, s, d, h, f, hg, cb)
    quality = fl._bwd_tc_plan(256, s, d, h, f, cuda)
    assert quality["ctas"] <= cuda_build.sm_count(cuda) < 256
    assert quality["seqs"] == 2 and quality["cluster"] == 1


def test_fused_layer_counts_launches_forward_and_backward(cuda):
    gen = torch.Generator().manual_seed(0)
    params = _weights(gen, 64, 128, cuda)
    x = torch.randn(2, 8, 64, generator=gen).to(cuda, torch.bfloat16)
    mask = torch.ones(2, 8, dtype=torch.bool, device=cuda)
    cuda_build.reset_launches()
    with torch.no_grad():
        fused_layer(x, params, mask, num_heads=4, causal=True, ffn_dim=128)
    assert cuda_build.LAUNCHES["fused_layer"] == 1
    y = fused_layer(x.requires_grad_(), params, mask, num_heads=4, causal=True, ffn_dim=128)
    y.float().sum().backward()
    assert cuda_build.LAUNCHES == {**cuda_build.LAUNCHES, "fused_layer": 2, "fused_layer_bwd": 1}
    assert x.grad is not None and x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("d", [6, 128, 384])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset-view"])
def test_gather_kernel_matches_plain(cuda, d, table_dtype, out_dtype, idx_dtype, aligned):
    """Every dtype pair of the 16-byte path and its scalar tail, exactly:
    widths 6 (no whole 16-byte item), 128 and 384; indices out of range
    on both sides; and a table view whose base is one element past a
    16-byte boundary, which no row of can take a 16-byte access."""
    gen = torch.Generator().manual_seed(d)
    n, r = 777, 3001
    base = torch.randn(n * d + 1, generator=gen).to(cuda, table_dtype)
    table = (base[:-1] if aligned else base[1:]).view(n, d)
    assert (table.data_ptr() % 16 == 0) == aligned
    idx = torch.randint(-5, n + 5, (r,), generator=gen).to(cuda, idx_dtype)
    got = gather_rows(table, idx, out_dtype)
    want = gather_rows_reference(table, idx, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (r, d)
    assert torch.equal(got, want)
    assert not got[(idx < 0) | (idx >= n)].any()


def test_gather_kernel_takes_more_than_2_31_items(cuda):
    """A gather of more than 2**31 16-byte output items (R = 16,387 bf16
    rows of width 2**20: 32 GiB) takes the kernel's 64-bit item indexing;
    rows on both sides of item 2**31 and every row, in chunks, are exact."""
    n, d, r = 4, 2**20, 16387
    assert r * (d // 8) > 2**31
    gen = torch.Generator().manual_seed(11)
    table = torch.randn(n, d, generator=gen).to(cuda, torch.bfloat16)
    idx = torch.randint(-1, n + 1, (r,), generator=gen).to(cuda)
    out = gather_rows(table, idx, torch.bfloat16)
    torch.cuda.synchronize()
    assert out.shape == (r, d)
    for start in range(0, r, 1024):
        rows = slice(start, min(start + 1024, r))
        assert torch.equal(out[rows], gather_rows_reference(table, idx[rows], torch.bfloat16))
    del out
    torch.cuda.empty_cache()


# Backward kernels against their plain versions, each gradient's max abs
# error relative to its max abs value:
# - f32: both sum in f32 in other orders (the parameter gradients over all
#   B*S rows), ~1e-6 measured;
# - bf16: every gradient product rounds its operands to bf16, and a
#   one-ulp flip of a rounding (2**-8 relative) in one of thousands of
#   summands moves a sum far less than one ulp of its largest term; up to
#   6e-3 measured on the H100.  The dropout-divisor trap moves gradients by
#   less than that and has a test of its own;
# - the gather's gradient sums the same values in another order (f32; a
#   bf16 table rounds the sum once);
# - table InfoNCE: exp/log and dl's bf16 rounding, near-tie rows left out
#   as for the pool kernels below.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize(("b", "s", "d", "h", "f", "causal", "rate"), [
    (128, 32, 128, 8, 512, True, 0.0),   # configs/ml1m_ssm.yaml, a train batch
    (128, 32, 128, 8, 512, True, 0.1),
    (16, 32, 128, 8, 512, False, 0.1),
    (4, 8, 128, 8, 48, True, 0.1),
    (4, 48, 64, 4, 256, True, 0.0),
    (128, 32, 64, 4, 256, True, 0.1),    # configs/ml100k_bpr.yaml, a train batch
    (3, 64, 128, 8, 512, True, 0.1),
    (4, 32, 384, 12, 48, True, 0.1),     # configs/ml1m_reference.yaml
    (32, 32, 384, 12, 48, True, 0.1),    # its training batch, path B
    (256, 32, 384, 12, 48, True, 0.1),   # the quality run's (tools/quality_run.py)
    # head widths off the bf16 backward's k-steps of 16, staged padded:
    (16, 32, 128, 16, 512, True, 0.1),   # 8 (16-byte copies)
    (8, 32, 384, 16, 48, True, 0.1),     # 24, on clusters of 2
    (4, 16, 64, 16, 256, True, 0.1),     # 4 (4-byte copies)
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_layer_backward_kernel_matches_plain(cuda, b, s, d, h, f, causal, rate, dtype):
    gen = torch.Generator().manual_seed(b + s + d)
    x = torch.randn(b, s, d, generator=gen).to(cuda, dtype).requires_grad_()
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[-1, s // 2:] = False
    mask[0, s - 3:] = False
    mask = mask.to(cuda)
    params = _weights(gen, d, f, cuda)
    leaves = [params[m][n].requires_grad_() for m, n in _PARAM_ORDER]
    kw = dict(num_heads=h, causal=causal, attn_dropout=rate, hidden_dropout=rate,
              dropout_seeds=[5, 6, 7] if rate else None, ffn_dim=f)
    dy = torch.randn(b, s, d, generator=gen).to(cuda, dtype)
    y = fused_layer(x, params, mask, **kw)
    y.backward(dy)
    with torch.no_grad():
        dx_want, grads = fused_layer_backward_reference(x.detach(), params, mask, dy, **kw)
    torch.cuda.synchronize()
    errs = {"dx": rel_err(x.grad, dx_want)}
    errs |= {f"{m}/{n}": rel_err(t.grad, grads[m][n]) for (m, n), t in zip(_PARAM_ORDER, leaves)}
    print(dict(sorted(errs.items(), key=lambda kv: -kv[1])[:3]))
    assert x.grad.dtype == dtype
    assert max(errs.values()) <= GRAD_TOL[dtype], errs


def test_bf16_backward_kernel_divides_by_the_f32_keep_rate(cuda):
    """The JAX backward divides the hidden-dropout cotangent by the f32
    ``1 - rate``, its bf16 forward by that rounded to bf16: at rate 0.4942,
    0.5058 against 0.50390625, 0.38% apart.  That sits inside the bf16
    kernel's rounding noise as ``GRAD_TOL`` reads it, so the least-squares
    scale of the kernel's ``ffn_out`` gradients against the plain backward
    is held to 1 within 1e-3; autograd of the plain forward (the wrong
    divisor) reads 1.0038 and is held to that, so the check can tell them
    apart."""
    b, s, d, h, f, rate = 64, 32, 128, 8, 512, 0.4942
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(b, s, d, generator=gen).to(cuda, torch.bfloat16)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[-1, s // 2:] = False
    mask = mask.to(cuda)
    dy = torch.randn(b, s, d, generator=gen).to(cuda, torch.bfloat16)
    kw = dict(num_heads=h, causal=True, attn_dropout=0.0, hidden_dropout=rate,
              dropout_seeds=[5, 6, 7], ffn_dim=f)

    def ffn_out_grads(fn, params):
        leaves = [params["ffn_out"][n].requires_grad_() for n in ("w", "b")]
        fn(x, params, mask, **kw).backward(dy)
        return [t.grad.double() for t in leaves]

    params = _weights(gen, d, f, cuda)
    got = ffn_out_grads(fused_layer, params)
    auto = ffn_out_grads(fused_layer_reference, {m: {n: t.detach().clone() for n, t in v.items()}
                                                 for m, v in params.items()})
    with torch.no_grad():
        _, want = fused_layer_backward_reference(x, params, mask, dy, **kw)
    torch.cuda.synchronize()

    def ls_scale(a, ref):
        return float((a * ref).sum() / (ref * ref).sum())

    for name, g, a in zip(("w", "b"), got, auto):
        ref = want["ffn_out"][name].double()
        print(name, ls_scale(g, ref), ls_scale(a, ref))
        assert abs(ls_scale(g, ref) - 1.0) <= 1e-3, name
        assert abs(ls_scale(a, ref) - 1.0038) <= 1e-3, name


def test_bf16_backward_kernel_recomputes_with_the_as_erf(cuda, monkeypatch):
    """The bf16 backward recomputes the GELU with the A&S erf (within
    2.5e-5 of Eigen's, which the forward uses).  That flips bf16 roundings
    of the recomputed GELU and its derivative and moves the gradients by
    about 0.2% of their norm, inside ``GRAD_TOL``.  So the kernel's
    deviation from the plain backward (A&S) is projected on the direction
    from that to the plain backward with Eigen's erf: about 0 if the kernel
    follows the JAX backward, about 1 if it took Eigen's erf."""
    b, s, d, h, f = 128, 32, 128, 8, 512
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(b, s, d, generator=gen).to(cuda, torch.bfloat16).requires_grad_()
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[-1, s // 2:] = False
    mask = mask.to(cuda)
    dy = torch.randn(b, s, d, generator=gen).to(cuda, torch.bfloat16)
    params = _weights(gen, d, f, cuda)
    kw = dict(num_heads=h, causal=True, ffn_dim=f)
    qkv_w = params["qkv"]["w"].requires_grad_()
    fused_layer(x, params, mask, **kw).backward(dy)
    with torch.no_grad():
        dx_as, g_as = fused_layer_backward_reference(x.detach(), params, mask, dy, **kw)
        monkeypatch.setattr(fl, "_erf_as", fl._erf)
        dx_eigen, g_eigen = fused_layer_backward_reference(x.detach(), params, mask, dy, **kw)
    torch.cuda.synchronize()
    for name, got, a, e in (("dx", x.grad, dx_as, dx_eigen),
                            ("qkv/w", qkv_w.grad, g_as["qkv"]["w"], g_eigen["qkv"]["w"])):
        got, a, e = got.double(), a.double(), e.double()
        c = float(((got - a) * (e - a)).sum() / ((e - a) ** 2).sum())
        print(name, c, float((e - a).norm() / a.norm()), float((got - a).norm() / a.norm()))
        assert abs(c) <= 0.25, (name, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_backward_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(2)
    for n, d, r in [(3707, 128, 4096), (3707, 384, 2048), (100, 6, 37)]:
        table = torch.randn(n, d, generator=gen).to(cuda, dtype).requires_grad_()
        idx = torch.randint(-5, 40, (r,), generator=gen).to(cuda)  # duplicates, out of range
        idx[: r // 2] = torch.randint(0, n, (r // 2,), generator=gen).to(cuda)
        g = torch.randn(r, d, generator=gen).to(cuda, dtype)
        cuda_build.reset_launches()
        gather_rows(table, idx, dtype).backward(g)
        want = gather_rows_backward_reference(g, idx, n, dtype)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["gather_rows_bwd"] == 1
        assert table.grad.dtype == dtype
        assert rel_err(table.grad, want) <= (2.0**-8 if dtype == torch.bfloat16 else 1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_backward_kernel_sums_in_the_plain_order(cuda, dtype):
    """The logging step's gather (3 x 128 x 32 rows) with a 4,608-row
    padding segment on row 0, catalog rows no index names, out-of-range
    indices: the kernel sums in the plain version's order, so the two agree
    bit for bit, and two calls give the same bits."""
    gen = torch.Generator().manual_seed(8)
    n, d, r = 3707, 128, 3 * 128 * 32
    idx = torch.randint(1, n // 2, (r,), generator=gen)  # the upper half is never named
    idx[torch.randperm(r, generator=gen)[:4608]] = 0
    idx[:5] = torch.tensor([-1, n, n + 7, -3, n])
    idx = idx.to(cuda)
    g = torch.randn(r, d, generator=gen).to(cuda, dtype)
    cuda_build.reset_launches()
    first = gm._gather_bwd_cuda(g, idx, n, dtype)
    second = gm._gather_bwd_cuda(g, idx, n, dtype)
    want = gather_rows_backward_reference(g, idx, n, dtype)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["gather_rows_bwd"] == 2
    assert torch.equal(first, second)
    assert torch.equal(first, want)
    assert not first[n // 2:].any() and first[0].abs().sum() > 0


# the gathers whose gradient the main path takes: the flagship's hot and
# logging (A) steps into its projected catalog, and the scale
# configuration's hot step at B=256 (``chip_smoke.py`` phases 4 and 17);
# and R a multiple of no warp step, item group, tile or chunk: (N, D, R,
# rows on the padding row 0)
GROUP_SHAPES = {"hot": (3707, 128, 4096, 1472), "A": (3707, 128, 12288, 4701),
                "scale": (62001, 256, 98304, 36892), "ragged": (1000, 72, 5001, 1700)}


def _group_case(cuda, shape, idx_dtype):
    n, d, r, pad = GROUP_SHAPES[shape]
    gen = torch.Generator().manual_seed(r)
    idx = torch.randint(1, n, (r,), generator=gen)
    idx[torch.randperm(r, generator=gen)[:pad]] = 0
    idx[:5] = torch.tensor([-1, n, n + 7, -3, n])
    return n, d, idx.to(cuda, idx_dtype), gen


@pytest.mark.parametrize("shape", list(GROUP_SHAPES))
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("tiled", [False, True])
def test_grouping_kernel_is_the_stable_sort(cuda, shape, idx_dtype, tiled):
    """The grouping kernel (as planned: one block but at the scale; or
    forced to tiles) places every in-range row where
    ``torch.sort(stable=True)`` does, every out-of-range index as -1 or N,
    and gives each bucket's bounds."""
    n, _, idx, _ = _group_case(cuda, shape, idx_dtype)
    keys, order, bounds = gm._group_cuda(idx, n, tiled=tiled)
    sorted_idx, sorted_rows = torch.sort(idx.long(), stable=True)
    torch.cuda.synchronize()
    valid = (sorted_idx >= 0) & (sorted_idx < n)
    assert torch.equal(keys.long()[valid], sorted_idx[valid])
    assert torch.equal(order.long()[valid], sorted_rows[valid])
    assert torch.equal(keys.long(), sorted_idx.clamp(-1, n))
    counts = torch.bincount(idx.long().clamp(-1, n) + 1, minlength=n + 2)
    first = torch.cat([counts.new_zeros(1), counts.cumsum(0)[:-1]])
    bounds = bounds.long()
    assert torch.equal(bounds[:, 1] - bounds[:, 0], counts)
    assert torch.equal(bounds[counts > 0, 0], first[counts > 0])


@pytest.mark.parametrize("shape", list(GROUP_SHAPES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_backward_bits_eager_twice_and_graphed(cuda, shape, dtype):
    """The backward as the main path calls it (the grouping kernel, then
    the two passes) equals the plain version bit for bit, two calls give
    the same bits, and a CUDA-graph capture of it, replayed, gives the
    eager call's bits."""
    n, d, idx, gen = _group_case(cuda, shape, torch.int64)
    g = torch.randn(idx.numel(), d, generator=gen).to(cuda, dtype)
    cuda_build.reset_launches()
    first = gm._gather_bwd_cuda(g, idx, n, dtype)
    second = gm._gather_bwd_cuda(g, idx, n, dtype)
    assert cuda_build.LAUNCHES["gather_rows_bwd"] == 2
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gm._gather_bwd_cuda(g, idx, n, dtype)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graphed = gm._gather_bwd_cuda(g, idx, n, dtype)
    graph.replay()
    want = gather_rows_backward_reference(g, idx, n, dtype)
    torch.cuda.synchronize()
    assert torch.equal(first, want)
    assert torch.equal(first, second)
    assert torch.equal(graphed, first)


def _f32_layer_case(cuda, b, s, d, h, f, mask_kind, seed):
    """f32 inputs, weights and a cotangent at (b, s, d, h, f) with a key
    mask: a padded tail on the first and last sequences (``tail``), or
    left padding of random length on every sequence (``left``, as the
    seed spread's histories are padded; one sequence fully valid)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, d, generator=gen).to(cuda)
    if mask_kind == "left":
        lengths = torch.randint(1, s + 1, (b,), generator=gen)
        lengths[0] = s
        mask = torch.arange(s)[None, :] >= (s - lengths)[:, None]
    else:
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[-1, s // 2:] = False
        mask[0, s - 3:] = False
    params = _weights(gen, d, f, cuda)
    dy = torch.randn(b, s, d, generator=gen).to(cuda)
    return x, params, mask.to(cuda), dy


def _layer_fwd_bwd(x, params, mask, dy, kw):
    """The layer's output, dx and the 12 parameter gradients through the
    kernels (the forward and the backward wrapper's autograd)."""
    xr = x.clone().requires_grad_()
    leaves = {m: {n: t.detach().clone().requires_grad_() for n, t in v.items()}
              for m, v in params.items()}
    y = fused_layer(xr, leaves, mask, **kw)
    y.backward(dy)
    return y.detach(), xr.grad, [leaves[m][n].grad for m, n in _PARAM_ORDER]


@pytest.mark.parametrize("mask_kind", ["tail", "left"])
@pytest.mark.parametrize(("causal", "rate"), [(True, 0.0), (True, 0.1), (False, 0.0),
                                              (False, 0.1)])
def test_f32_layer_at_the_seed_spread_shape(cuda, causal, rate, mask_kind):
    """The f32 forward and backward at the seed spread's layer (B=32, S=32,
    D=384, 12 heads, FFN 48; clusters of 4) against their plain versions:
    y within 2e-5, dx and the 12 parameter gradients within GRAD_TOL."""
    b, s, d, h, f = 32, 32, 384, 12, 48
    for backward in (False, True):  # 4 where the card holds 32 clusters of 4 at once, else 3
        assert fl._f32_cluster(b, s, d, h, f, cuda, backward) in (3, 4)
    x, params, mask, dy = _f32_layer_case(cuda, b, s, d, h, f, mask_kind, seed=int(causal) + 2)
    kw = dict(num_heads=h, causal=causal, attn_dropout=rate, hidden_dropout=rate,
              dropout_seeds=[5, 6, 7] if rate else None, ffn_dim=f)
    y, dx, grads = _layer_fwd_bwd(x, params, mask, dy, kw)
    with torch.no_grad():
        want = fused_layer_reference(x, params, mask, **kw)
        dx_want, grads_want = fused_layer_backward_reference(x, params, mask, dy, **kw)
    torch.cuda.synchronize()
    assert (y - want).abs().max().item() <= 2e-5
    errs = {"dx": rel_err(dx, dx_want)}
    errs |= {f"{m}/{n}": rel_err(g, grads_want[m][n]) for (m, n), g in zip(_PARAM_ORDER, grads)}
    assert max(errs.values()) <= GRAD_TOL[torch.float32], errs


@pytest.mark.parametrize(("b", "s", "d", "h", "f", "mask_kind"), [
    (32, 32, 384, 12, 48, "left"),   # the seed spread's layer
    (8, 64, 128, 8, 512, "tail"),    # S=64: two row tiles a warp, two heads a group
    (6, 8, 64, 4, 256, "left"),      # S=8, 16-wide heads
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_layer_bits_do_not_depend_on_the_cluster(cuda, monkeypatch, b, s, d, h, f, mask_kind,
                                                     rate):
    """Each output of the f32 kernels is one thread's k-sum in a fixed
    order whatever the split, so the forward, dx and every parameter
    gradient have the same bits with clusters of 1 to 4 CTAs (those that
    split the heads), and on two calls."""
    x, params, mask, dy = _f32_layer_case(cuda, b, s, d, h, f, mask_kind, seed=b + s)
    kw = dict(num_heads=h, causal=True, attn_dropout=rate, hidden_dropout=rate,
              dropout_seeds=[9, 8, 7] if rate else None, ffn_dim=f)
    outs = {}
    for c in fl.F32_CLUSTER_SIZES:
        if h % c or d % (4 * c):
            continue
        monkeypatch.setattr(fl, "cluster_size", lambda *_, c=c: c)
        outs[c] = _layer_fwd_bwd(x, params, mask, dy, kw)
    again = _layer_fwd_bwd(x, params, mask, dy, kw)  # a cluster of 1, a second time
    torch.cuda.synchronize()
    assert 4 in outs and (3 in outs) == (h % 3 == 0)
    for got in (*outs.values(), again):
        assert torch.equal(got[0], outs[1][0]) and torch.equal(got[1], outs[1][1])
        for a, w in zip(got[2], outs[1][2]):
            assert torch.equal(a, w)
    with torch.no_grad():
        want = fused_layer_reference(x, params, mask, **kw)
    assert (outs[4][0] - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize(("b", "s", "d", "h", "f"), [
    (128, 32, 128, 8, 512),   # configs/ml1m_ssm.yaml
    (32, 32, 384, 12, 48),    # configs/ml1m_reference.yaml (path B)
    (128, 32, 64, 4, 256),    # configs/ml100k_bpr.yaml's width (D=64)
    (256, 32, 384, 12, 48),   # the quality run's
    (16, 32, 128, 16, 512),   # heads of 8, staged padded to 16
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_layer_backward_kernel_is_deterministic(cuda, b, s, d, h, f, dtype):
    """No atomics: two calls of the backward give the same bits, dx and
    every parameter gradient."""
    gen = torch.Generator().manual_seed(b + d)
    x = torch.randn(b, s, d, generator=gen).to(cuda, dtype)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[-1, s // 2:] = False
    mask = mask.to(cuda)
    params = _weights(gen, d, f, cuda)
    flat = [params[m][n] for m, n in _PARAM_ORDER]
    dy = torch.randn(b, s, d, generator=gen).to(cuda, dtype)
    kw = dict(num_heads=h, causal=True, attn_dropout=0.1, hidden_dropout=0.1,
              dropout_seeds=[5, 6, 7], ffn_dim=f, layer_norm_eps=1e-12)
    first = fl._bwd_cuda(x, flat, mask, dy, **kw)
    second = fl._bwd_cuda(x, flat, mask, dy, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for a, c in zip(first[1], second[1]):
        assert torch.equal(a, c)


@pytest.mark.parametrize(("b", "s", "d", "h", "f"), [
    (32, 32, 384, 12, 48),   # path B
    (7, 32, 128, 8, 512),    # the flagship's width, a ragged last CTA at two sequences
    (5, 16, 64, 4, 256),     # path C's width, up to four sequences a CTA
    (3, 48, 96, 6, 48),      # S off the 16-row tiles, six heads
    (8, 32, 384, 16, 48),    # heads of 24, staged padded to 32, on clusters of 2 and 4
])
@pytest.mark.parametrize("stage", ["attn_bwd", "full"])
def test_bf16_backward_bits_do_not_depend_on_the_plan(cuda, monkeypatch, b, s, d, h, f, stage):
    """Pass 1 of the bf16 backward with one sequence a CTA, with several
    (up to its 64 rows) and split across clusters of 2, 3 and 4 gives the
    same bits in dx,
    the four weight gradients and the qkv and ffn_in biases' (each output's
    k-sum stays in one warp's mma chain, each of those column sums in one
    thread's or one warp's fixed order, whatever the plan); the LayerNorm,
    out and ffn_out bias gradients, summed by the row steps' warps and then
    over them, move only with that order, within 1e-4 of their max abs."""
    from transformer_recommenders_tpu_torch.ops import fused_sections as fs

    x, params, mask = _layer_inputs(cuda, b, s, d, h, f, seed=b + s + d)
    flat = [params[m][n] for m, n in _PARAM_ORDER]
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(cuda, x.dtype)
    kw = dict(num_heads=h, causal=True, attn_dropout=0.1, hidden_dropout=0.1,
              dropout_seeds=[5, 6, 7], ffn_dim=f, layer_norm_eps=1e-12)
    limit = cuda_build.max_shared_memory(cuda)
    plans = [(n, 1) for n in (1, 2, 4) if n * s <= 64 and n <= b]
    plans += [(1, c) for c in (2, 3, 4) if h % c == 0 and d % (8 * c) == 0]
    plans = [fl.bwd_tc_plan_for(s, d, h, f, n, c, limit) for n, c in plans]
    outs = {}
    for plan in plans:
        monkeypatch.setattr(fl, "_bwd_tc_plan", lambda *_, plan=plan: plan)
        key = (plan["seqs"], plan["cluster"])
        with torch.no_grad():
            if stage == "full":
                dx, grads = fl._bwd_cuda(x, flat, mask, dy, **kw)
                outs[key] = [dx, *grads]
            else:
                outs[key] = [fs.layer_stage_backward(x, params, mask, dy, stage=stage,
                                                     **{k: v for k, v in kw.items()
                                                        if k != "ffn_dim"})]
    torch.cuda.synchronize()
    assert len(plans) >= 3
    want = next(iter(outs.values()))
    with torch.no_grad():
        dx_ref, grads_ref = fused_layer_backward_reference(x, params, mask, dy, **kw)
    assert rel_err(want[0], dx_ref) <= GRAD_TOL[torch.bfloat16]
    if stage == "full":
        for (m, n), got in zip(_PARAM_ORDER, want[1:]):
            assert rel_err(got, grads_ref[m][n]) <= GRAD_TOL[torch.bfloat16], (m, n)
    # dx, then the gradients in _PARAM_ORDER: the row steps sum out/b,
    # ffn_out/b and the LayerNorms' in the plan's order
    by_rows = {("out", "b"), ("ffn_out", "b"), ("ln1", "scale"), ("ln1", "bias"),
               ("ln2", "scale"), ("ln2", "bias")}
    names = [("dx", "")] + list(_PARAM_ORDER)
    for key, got in outs.items():
        for name, a, c in zip(names, got, want):
            if name in by_rows:
                assert rel_err(a, c) <= 1e-4, (key, name)
            else:
                assert torch.equal(a, c), (key, name)


def table_case(gen, cuda, r=4096, n=3707, d=128, exact=False):
    """Table InfoNCE operands as the hot step gives them: f32 queries, a
    bf16 catalog with a zero pad row, a duplicate-heavy pool whose every
    seventh entry is its row's positive (the mask must drop that column),
    a tenth of rows and pool entries invalid.  exact: values k/8 with
    |k| <= 8, so every partial sum of a score is exact in f32 and the
    kernels' tensor-core chain and the plain version's increasing-k chain
    give the same scores bit for bit."""
    def draw(*shape):
        if exact:
            return torch.randint(-8, 9, shape, generator=gen).float() / 8
        return torch.randn(shape, generator=gen)

    q = draw(r, d)
    table = draw(n, d) * (1.0 if exact else 0.3)
    table[0] = 0
    pos = torch.randint(1, n, (r,), generator=gen)
    neg = torch.randint(1, 64, (r,), generator=gen)
    pos[::7] = neg[::7]
    row_valid = torch.rand(r, generator=gen) > 0.1
    neg_valid = torch.rand(r, generator=gen) > 0.1
    pos = torch.where(row_valid, pos, 0)
    pos, neg, row_valid, neg_valid = (t.to(cuda) for t in (pos, neg, row_valid, neg_valid))
    counts = fti.neg_pool_counts(neg, neg_valid, n)
    return q.to(cuda), table.to(cuda, torch.bfloat16), pos, counts, row_valid


def table_near_tie_rows(q, table, pos_idx, counts, scale):
    """(R,) bool: rows with a counted column within delta of their pos in
    the plain scores, that column neither pos_idx nor a copy of the
    positive's row (delta as near_tie_rows below: the kernels sum on the
    tensor cores, the plain version in increasing k)."""
    x, pos, sel, _ = fti._scores(q, table, pos_idx, counts, scale, False)
    delta = scale * 2.0**-13 * math.ceil(q.shape[1] / 128)
    near = ((x - pos[:, None]).abs() <= delta) & (counts.reshape(1, -1) > 0) & ~sel
    r, j = near.nonzero(as_tuple=True)
    tb = table.to(torch.bfloat16)
    copy = (tb[pos_idx.long()[r]] == tb[j]).all(dim=1)
    near[r[copy], j[copy]] = False
    return near.any(dim=1)


def run_table_infonce(q, table, pos, counts, g, scale, mask_fn):
    """ce and the gradients in q and the table through the wrapper."""
    q, table = (a.detach().clone().requires_grad_() for a in (q, table))
    ce = fti.table_infonce_rowwise(q, table, pos, counts, scale, mask_fn)
    ce.backward(g)
    return ce.detach(), q.grad, table.grad


# Table InfoNCE kernels against their plain versions: exp/log (ce, 1e-5 of
# its max abs) and dl's bf16 rounding (dq, dT, 1e-2 of each gradient's max
# abs).  The two sum the scores in other orders: on Gaussian inputs with
# the mask on, a column within a rounding step of pos may count in one and
# not in the other, so ce is held on the rows without a near-tie
# (table_near_tie_rows) and those rows take no cotangent; on exact-sum
# inputs every row is held and takes its cotangent.
@pytest.mark.parametrize("mask_fn", [True, False])
def test_table_infonce_kernels_match_plain(cuda, mask_fn):
    gen = torch.Generator().manual_seed(3)
    q, table, pos, counts, row_valid = table_case(gen, cuda)
    keep = torch.ones_like(row_valid)
    if mask_fn:
        keep = ~table_near_tie_rows(q, table, pos, counts, 2.0)
    g = (row_valid & keep).float()
    cuda_build.reset_launches()
    ce, dq, dt = run_table_infonce(q, table, pos, counts, g, 2.0, mask_fn)
    with torch.no_grad():
        ce_want, lse_want = fti.table_infonce_reference(q, table, pos, counts, scale=2.0,
                                                        mask_false_negatives=mask_fn)
        dq_want, dt_want = fti.table_infonce_backward_reference(
            q, table, pos, counts, lse_want, g, scale=2.0, mask_false_negatives=mask_fn)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["table_infonce_fwd"] == 1
    assert cuda_build.LAUNCHES["table_infonce_bwd"] == 1
    errs = {"ce": rel_err(ce[keep], ce_want[keep]), "dq": rel_err(dq, dq_want),
            "dtable": rel_err(dt, dt_want)}
    print(errs, f"near-tie rows left out: {int((~keep).sum())} of {len(keep)}")
    assert errs["ce"] <= 1e-5 and errs["dq"] <= 1e-2 and errs["dtable"] <= 1e-2, errs


@pytest.mark.parametrize(("r", "n", "d"), [(4096, 3707, 128), (1000, 777, 384), (300, 41, 64)])
def test_table_infonce_kernels_match_plain_on_exact_sums(cuda, r, n, d):
    """Mask on, every row held: on values k/8 both chains give the same
    scores, so both drop the same columns.  Rows whose pos_idx lies outside
    [0, N) get pos 0 and no positive column."""
    gen = torch.Generator().manual_seed(r + n + d)
    q, table, pos, counts, row_valid = table_case(gen, cuda, r, n, d, exact=True)
    pos[1::11] = -1
    pos[2::11] = n
    g = row_valid.float()
    ce, dq, dt = run_table_infonce(q, table, pos, counts, g, 2.0, True)
    with torch.no_grad():
        ce_want, lse_want = fti.table_infonce_reference(q, table, pos, counts, scale=2.0)
        dq_want, dt_want = fti.table_infonce_backward_reference(q, table, pos, counts, lse_want,
                                                                g, scale=2.0)
    torch.cuda.synchronize()
    errs = {"ce": rel_err(ce, ce_want), "dq": rel_err(dq, dq_want), "dtable": rel_err(dt, dt_want)}
    assert errs["ce"] <= 1e-5 and errs["dq"] <= 1e-2 and errs["dtable"] <= 1e-2, errs


def test_table_infonce_kernels_take_no_query_rows(cuda):
    """R = 0: ce and dq are empty and dT is 0, whatever the splits the
    planner gives the dq pass (its workspace is then empty)."""
    gen = torch.Generator().manual_seed(5)
    q, table, pos, counts, row_valid = table_case(gen, cuda, 0, 300, 64, exact=True)
    ce, dq, dt = run_table_infonce(q, table, pos, counts, row_valid.float(), 2.0, True)
    with torch.no_grad():
        ce_want, lse_want = fti.table_infonce_reference(q, table, pos, counts, scale=2.0)
        dq_want, dt_want = fti.table_infonce_backward_reference(
            q, table, pos, counts, lse_want, row_valid.float(), scale=2.0)
    torch.cuda.synchronize()
    for name, a, b in (("ce", ce, ce_want), ("dq", dq, dq_want), ("dtable", dt, dt_want)):
        assert_agree(name, a, b, 0.0)


def test_table_infonce_kernels_are_deterministic(cuda):
    gen = torch.Generator().manual_seed(4)
    q, table, pos, counts, row_valid = table_case(gen, cuda)
    g = row_valid.float()
    first = run_table_infonce(q, table, pos, counts, g, 1.0, True)
    second = run_table_infonce(q, table, pos, counts, g, 1.0, True)
    torch.cuda.synchronize()
    for name, a, b in zip(("ce", "dq", "dtable"), first, second):
        assert torch.equal(a, b), name


def pool_case(gen, cuda, r, rn, d):
    """Pool InfoNCE operands as the train step gives them: f32 queries,
    bf16 positive and pool rows; pool rows that copy a positive (the mask
    must drop them) and a row 0 whose positive is below every pool score
    (with the mask on it counts no negative: ce = 0)."""
    q = torch.randn(r, d, generator=gen)
    p = 0.3 * torch.randn(r, d, generator=gen)
    n = 0.3 * torch.randn(rn, d, generator=gen)
    n[::9] = p[torch.randint(0, r, (len(range(0, rn, 9)),), generator=gen)]
    p[0] = -4.0 * q[0]
    row_valid = torch.rand(r, generator=gen) > 0.1
    neg_valid = torch.rand(rn, generator=gen) > 0.1
    return (q.to(cuda), p.to(cuda, torch.bfloat16), n.to(cuda, torch.bfloat16),
            row_valid.to(cuda), neg_valid.to(cuda))


def exact_pool_case(gen, cuda, r, rn, d):
    """Pool InfoNCE operands whose every partial sum is exact in f32:
    values k/8 with |k| <= 8, so the kernels' tensor-core chain and the
    plain version's increasing-k chain give the same scores bit for bit.
    Every ninth pool row copies a positive; row 0's query is +-1 and its
    positive -4 times it, below every pool score but its own copies."""
    def draw(*shape):
        return torch.randint(-8, 9, shape, generator=gen).float() / 8

    q, p, n = draw(r, d), draw(r, d), draw(rn, d)
    n[::9] = p[torch.randint(0, r, (len(range(0, rn, 9)),), generator=gen)]
    q[0] = torch.where(torch.rand(d, generator=gen) < 0.5, -1.0, 1.0)
    p[0] = -4.0 * q[0]
    row_valid = torch.rand(r, generator=gen) > 0.1
    neg_valid = torch.rand(rn, generator=gen) > 0.1
    return (q.to(cuda), p.to(cuda, torch.bfloat16), n.to(cuda, torch.bfloat16),
            row_valid.to(cuda), neg_valid.to(cuda))


def near_tie_rows(q, p, n, neg_valid, scale):
    """(R,) bool: the rows with a valid pool score within delta of their
    pos in the plain scores, that pool row not a copy of the row's
    positive.  The kernels sum on the tensor cores, the plain version in
    increasing k: each score's two values differ by a few ulps of its
    partial sums (|s| < 2**5, ulp <= 2**-18, D/16 and D roundings), so only
    there can the mask x < pos decide otherwise, a chance equality in one
    version included.  delta = scale * 2**-13 per 128 of D; copies of the
    positive (exactly pos in both) stay in the check."""
    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    x, pos = fi._scores(q, p, n, scale)
    delta = scale * 2.0**-13 * math.ceil(q.shape[1] / 128)
    near = ((x - pos[:, None]).abs() <= delta) & (neg_valid.reshape(1, -1) > 0)
    r, j = near.nonzero(as_tuple=True)
    copy = (p.to(torch.bfloat16)[r] == n.to(torch.bfloat16)[j]).all(dim=1)
    near[r[copy], j[copy]] = False
    return near.any(dim=1)


def run_pool_infonce(q, p, n, neg_valid, g, scale, mask_fn):
    """ce and the gradients in q, p and n through the wrapper."""
    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    q, p, n = (a.detach().clone().requires_grad_() for a in (q, p, n))
    ce = fi.fused_infonce_rowwise(q, p, n, neg_valid, scale, mask_fn)
    ce.backward(g)
    return ce.detach(), q.grad, p.grad, n.grad


POOL_SHAPES = [
    (4096, 4096, 128),   # configs/ml1m_ssm.yaml: B=128, S=32
    (1024, 1024, 384),   # configs/ml1m_reference.yaml: B=32, S=32
    (1000, 777, 128),    # ragged: neither a multiple of a block
]


# Pool InfoNCE kernels against their plain versions: exp/log (ce, 1e-5 of
# its max abs) and dl's bf16 rounding (dq, dp, dn, 1e-2 of each gradient's
# max abs, as the other backward kernels).  The two sum the scores in other
# orders: on Gaussian inputs with the mask on, a score within a rounding
# step of pos may count in one and not in the other, so ce is held on the
# rows without a near-tie (near_tie_rows) and those rows take no cotangent
# (every element of dq, dp and dn is still compared); on exact-sum inputs
# every row is held and takes its cotangent.
@pytest.mark.parametrize(("r", "rn", "d"), POOL_SHAPES)
@pytest.mark.parametrize(("mask_fn", "scale"), [(True, 1.0), (False, 2.5)])
@pytest.mark.parametrize("inputs", ["gaussian", "exact"])
def test_pool_infonce_kernels_match_plain(cuda, r, rn, d, mask_fn, scale, inputs):
    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    gen = torch.Generator().manual_seed(r + rn + d)
    case = pool_case if inputs == "gaussian" else exact_pool_case
    q, p, n, row_valid, neg_valid = case(gen, cuda, r, rn, d)
    keep = torch.ones(r, dtype=torch.bool, device=cuda)
    if mask_fn and inputs == "gaussian":
        keep = ~near_tie_rows(q, p, n, neg_valid, scale)
    q, p, n = (a.requires_grad_() for a in (q, p, n))
    cuda_build.reset_launches()
    ce = fi.fused_infonce_rowwise(q, p, n, neg_valid, scale, mask_fn)
    g = (row_valid & keep).float()
    ce.backward(g)
    kw = dict(scale=scale, mask_false_negatives=mask_fn)
    with torch.no_grad():
        ce_want, lse_want, _ = fi.fused_infonce_reference(q, p, n, neg_valid, **kw)
        dq_want, dp_want = fi.fused_infonce_dq_reference(q, p, n, neg_valid, lse_want, g, **kw)
        dn_want = fi.fused_infonce_dn_reference(q, p, n, neg_valid, lse_want, g, **kw)
    torch.cuda.synchronize()
    assert {k: cuda_build.LAUNCHES[k] for k in ("pool_infonce_fwd", "pool_infonce_dq",
                                                "pool_infonce_dn")} == \
        {"pool_infonce_fwd": 1, "pool_infonce_dq": 1, "pool_infonce_dn": 1}
    if mask_fn:
        assert ce[0].item() == 0.0
    assert (q.grad.dtype, p.grad.dtype, n.grad.dtype) == (torch.float32, torch.bfloat16,
                                                          torch.bfloat16)
    errs = {"ce": rel_err(ce.detach()[keep], ce_want[keep]), "dq": rel_err(q.grad, dq_want),
            "dp": rel_err(p.grad, dp_want), "dn": rel_err(n.grad, dn_want)}
    print(errs, f"near-tie rows left out: {int((~keep).sum())} of {r}")
    assert errs["ce"] <= 1e-5, errs
    assert max(errs["dq"], errs["dp"], errs["dn"]) <= 1e-2, errs


@pytest.mark.parametrize(("r", "rn", "d"), POOL_SHAPES)
@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_pool_infonce_kernels_drop_every_copy_of_the_positive(cuda, r, rn, d, scale):
    """Every row shares one positive, and every seventh pool row is a copy
    of it: with the mask on, the three kernels give the same bits as with
    those rows marked invalid (each scores a copy exactly pos)."""
    gen = torch.Generator().manual_seed(r + rn + d + 1)
    q, p, n, row_valid, neg_valid = pool_case(gen, cuda, r, rn, d)
    p = p[1].expand_as(p).contiguous()
    copies = torch.zeros(rn, dtype=torch.bool, device=cuda)
    copies[::7] = True
    n = torch.where(copies[:, None], p[0], n)
    g = row_valid.float()
    with_copies = run_pool_infonce(q, p, n, neg_valid | copies, g, scale, True)
    without = run_pool_infonce(q, p, n, (neg_valid | copies) & ~copies, g, scale, True)
    torch.cuda.synchronize()
    for name, a, b in zip(("ce", "dq", "dp", "dn"), with_copies, without):
        assert torch.equal(a, b), name


@pytest.mark.parametrize(("r", "rn", "d"), POOL_SHAPES)
def test_pool_infonce_kernels_are_deterministic(cuda, r, rn, d):
    gen = torch.Generator().manual_seed(r + rn + d + 2)
    q, p, n, row_valid, neg_valid = pool_case(gen, cuda, r, rn, d)
    g = row_valid.float()
    first = run_pool_infonce(q, p, n, neg_valid, g, 1.0, True)
    second = run_pool_infonce(q, p, n, neg_valid, g, 1.0, True)
    torch.cuda.synchronize()
    for name, a, b in zip(("ce", "dq", "dp", "dn"), first, second):
        assert torch.equal(a, b), name


def assert_agree(name, got, want, tol):
    """got within tol of want's max abs value, or exactly 0 where want is
    all 0; empty tensors by shape."""
    assert got.shape == want.shape, name
    if not want.numel():
        return
    if not want.float().abs().max().item():
        assert not got.float().abs().max().item(), name
        return
    assert bool(torch.isfinite(got.float()).all()), name
    assert rel_err(got, want) <= tol, (name, rel_err(got, want))


# One split against the planned splits: the same scores, only the order in
# which the splits' f32 partial sums add differs (the forward's (max, sum)
# merges too, so lse, and with it a dl's bf16 rounding, may move by an
# ulp).  The stated tolerances of the plain-version checks: ce 1e-5, the
# gradients 1e-2 of each one's max abs.
@pytest.mark.parametrize(("r", "rn", "d"), POOL_SHAPES)
@pytest.mark.parametrize(("mask_fn", "scale"), [(True, 1.0), (False, 2.5)])
def test_pool_infonce_kernels_agree_over_splits(cuda, monkeypatch, r, rn, d, mask_fn, scale):
    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    gen = torch.Generator().manual_seed(r + rn + d + 3)
    q, p, n, row_valid, neg_valid = pool_case(gen, cuda, r, rn, d)
    g = row_valid.float()
    splits = {k: fi._splits(cuda.index or 0, r, rn, d, i)
              for i, k in enumerate(("fwd", "dq", "dn"))}
    assert splits["dq"] > 1 and splits["dn"] > 1, splits
    planned = run_pool_infonce(q, p, n, neg_valid, g, scale, mask_fn)
    monkeypatch.setattr(fi, "_splits", lambda *args: 1)
    one = run_pool_infonce(q, p, n, neg_valid, g, scale, mask_fn)
    torch.cuda.synchronize()
    print(splits, {k: rel_err(a, b) for k, a, b in zip(("ce", "dq", "dp", "dn"), one, planned)})
    for name, a, b, tol in zip(("ce", "dq", "dp", "dn"), one, planned, (1e-5, 1e-2, 1e-2, 1e-2)):
        assert_agree(name, a, b, tol)


def exact_case(gen, cuda, r, rn, d):
    """Values k/8 (every partial sum of a score exact in f32: the kernels
    and the plain version score alike on every row), any R and Rn."""
    def draw(*shape):
        return torch.randint(-8, 9, shape, generator=gen).float() / 8

    q, p, n = draw(r, d), draw(r, d), draw(rn, d)
    neg_valid = torch.rand(rn, generator=gen) > 0.1
    g = (torch.rand(r, generator=gen) > 0.1).float()
    return (q.to(cuda), p.to(cuda, torch.bfloat16), n.to(cuda, torch.bfloat16), neg_valid.to(cuda),
            g.to(cuda))


# Degenerate shapes: no query row (dn = 0), no pool row (ce = 0, dq = dp =
# 0), a pool of fewer rows than a tile (one pool tile, the dn pass split
# over the query rows), against the plain versions on exact-sum inputs.
DEGENERATE_SHAPES = [(0, 300, 64), (300, 0, 64), (300, 20, 64)]


@pytest.mark.parametrize(("r", "rn", "d"), DEGENERATE_SHAPES)
@pytest.mark.parametrize("mask_fn", [True, False])
def test_pool_infonce_kernels_take_degenerate_shapes(cuda, r, rn, d, mask_fn):
    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    gen = torch.Generator().manual_seed(r + rn + d + 4)
    q, p, n, neg_valid, g = exact_case(gen, cuda, r, rn, d)
    ce, dq, dp, dn = run_pool_infonce(q, p, n, neg_valid, g, 1.0, mask_fn)
    kw = dict(scale=1.0, mask_false_negatives=mask_fn)
    with torch.no_grad():
        ce_want, lse, _ = fi.fused_infonce_reference(q, p, n, neg_valid, **kw)
        dq_want, dp_want = fi.fused_infonce_dq_reference(q, p, n, neg_valid, lse, g, **kw)
        dn_want = fi.fused_infonce_dn_reference(q, p, n, neg_valid, lse, g, **kw)
    torch.cuda.synchronize()
    for name, a, b, tol in (("ce", ce, ce_want, 1e-5), ("dq", dq, dq_want, 1e-2),
                            ("dp", dp, dp_want, 1e-2), ("dn", dn, dn_want, 1e-2)):
        assert_agree(name, a, b, tol)


def test_pool_infonce_skips_the_dn_kernel_for_frozen_pool_rows(cuda):
    from transformer_recommenders_tpu_torch.ops import fused_infonce as fi

    gen = torch.Generator().manual_seed(9)
    q, p, n, row_valid, neg_valid = pool_case(gen, cuda, 256, 300, 384)
    q.requires_grad_()
    cuda_build.reset_launches()
    fi.fused_infonce_loss(q, p, n, row_valid, neg_valid).backward()
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["pool_infonce_dq"] == 1
    assert cuda_build.LAUNCHES["pool_infonce_dn"] == 0
    assert torch.isfinite(q.grad).all()


PAIRWISE_SHAPES = [
    (4096, 4096, 64),    # configs/ml100k_bpr.yaml: B=128, S=32, d=64
    (4096, 4096, 128),   # the flagship's width
    (1000, 777, 64),     # ragged: neither a multiple of a block
]
PAIRWISE_HEADS = ["ContrastiveLoss", "PairwiseHingeLoss", "PairwiseLogisticLoss", "NCELoss"]
# configs/ml25m_ccl.yaml's width at B=64, S=128 (scripts/bench_config4.py's
# batch): one split of each kernel fills the card there
PAIRWISE_SCALE = (8192, 8192, 256)


def run_pairwise(q, p, n, neg_valid, g, head, margin, mask_fn):
    """out and the gradients in q, p and n through the wrapper."""
    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    q, p, n = (a.detach().clone().requires_grad_() for a in (q, p, n))
    out = fp.fused_pairwise_rowwise(q, p, n, neg_valid, head=head, margin=margin,
                                    mask_false_negatives=mask_fn)
    out.backward(g)
    return out.detach(), q.grad, p.grad, n.grad


# Pairwise pool kernels against their plain versions: relu or softplus and
# a weighted mean (out, 1e-5 of its max abs) and dl's bf16 rounding (dq,
# dp, dn, 1e-2 of each gradient's max abs).  The kernels sum the scores on
# the tensor cores, the plain version in increasing k: on Gaussian inputs
# a pool score within a rounding step of pos (the mask) or, for the relu
# heads, an s within a rounding step of 0 (f' steps there) may be decided
# otherwise, so out is held on the rows without such a near tie
# (fused_pairwise.near_tie_rows) and those rows take no cotangent (every
# element of dq, dp and dn is still compared); on exact-sum inputs every
# row is held and takes its cotangent.
@pytest.mark.parametrize(("r", "rn", "d"), [*PAIRWISE_SHAPES, PAIRWISE_SCALE])
@pytest.mark.parametrize("head", PAIRWISE_HEADS)
@pytest.mark.parametrize(("mask_fn", "margin"), [(True, 0.0), (False, 0.5)])
@pytest.mark.parametrize("inputs", ["gaussian", "exact"])
def test_pairwise_kernels_match_plain(cuda, r, rn, d, head, mask_fn, margin, inputs):
    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    gen = torch.Generator().manual_seed(r + rn + d)
    case = pool_case if inputs == "gaussian" else exact_pool_case
    q, p, n, row_valid, neg_valid = case(gen, cuda, r, rn, d)
    kw = dict(head=head, margin=margin, mask_false_negatives=mask_fn)
    keep = torch.ones(r, dtype=torch.bool, device=cuda)
    if inputs == "gaussian":
        keep = ~fp.near_tie_rows(q, p, n, neg_valid, **kw)
    q, p, n = (a.requires_grad_() for a in (q, p, n))
    cuda_build.reset_launches()
    out = fp.fused_pairwise_rowwise(q, p, n, neg_valid, **kw)
    g = (row_valid & keep).float()
    out.backward(g)
    with torch.no_grad():
        out_want, den, _ = fp.fused_pairwise_reference(q, p, n, neg_valid, **kw)
        dq_want, dp_want = fp.fused_pairwise_dq_reference(q, p, n, neg_valid, den, g, **kw)
        dn_want = fp.fused_pairwise_dn_reference(q, p, n, neg_valid, den, g, **kw)
    torch.cuda.synchronize()
    assert {k: cuda_build.LAUNCHES[k] for k in ("pairwise_fwd", "pairwise_dq", "pairwise_dn")} \
        == {"pairwise_fwd": 1, "pairwise_dq": 1, "pairwise_dn": 1}
    if mask_fn:
        assert out[0].item() == 0.0  # row 0 counts no negative
    assert (q.grad.dtype, p.grad.dtype, n.grad.dtype) == (torch.float32, torch.bfloat16,
                                                          torch.bfloat16)
    errs = {"out": rel_err(out.detach()[keep], out_want[keep]), "dq": rel_err(q.grad, dq_want),
            "dn": rel_err(n.grad, dn_want)}
    if head in ("PairwiseHingeLoss", "PairwiseLogisticLoss"):
        errs["dp"] = rel_err(p.grad, dp_want)
    else:  # pos is not in the score: no gradient reaches the positive
        assert not p.grad.float().abs().max().item()
    print(errs, f"near-tie rows left out: {int((~keep).sum())} of {r}")
    if head == "PairwiseHingeLoss" and mask_fn and margin == 0.0:
        assert not out.abs().max().item()  # every counted score is below its positive
        return
    assert errs["out"] <= 1e-5, errs
    assert max(v for k, v in errs.items() if k != "out") <= 1e-2, errs


@pytest.mark.parametrize(("r", "rn", "d"), [*PAIRWISE_SHAPES, PAIRWISE_SCALE])
@pytest.mark.parametrize("head", PAIRWISE_HEADS)
@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_pairwise_kernels_drop_every_copy_of_the_positive(cuda, r, rn, d, head, margin):
    """Every row shares one positive, and every seventh pool row is a copy
    of it: with the mask on, the three kernels give the same bits as with
    those rows marked invalid (each scores a copy exactly pos)."""
    gen = torch.Generator().manual_seed(r + rn + d + 1)
    q, p, n, row_valid, neg_valid = pool_case(gen, cuda, r, rn, d)
    p = p[1].expand_as(p).contiguous()
    copies = torch.zeros(rn, dtype=torch.bool, device=cuda)
    copies[::7] = True
    n = torch.where(copies[:, None], p[0], n)
    g = row_valid.float()
    with_copies = run_pairwise(q, p, n, neg_valid | copies, g, head, margin, True)
    without = run_pairwise(q, p, n, (neg_valid | copies) & ~copies, g, head, margin, True)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dq", "dp", "dn"), with_copies, without):
        assert torch.equal(a, b), name


@pytest.mark.parametrize(("r", "rn", "d"), [*PAIRWISE_SHAPES, PAIRWISE_SCALE])
@pytest.mark.parametrize("head", PAIRWISE_HEADS)
def test_pairwise_kernels_are_deterministic(cuda, r, rn, d, head):
    gen = torch.Generator().manual_seed(r + rn + d + 2)
    q, p, n, row_valid, neg_valid = pool_case(gen, cuda, r, rn, d)
    g = row_valid.float()
    first = run_pairwise(q, p, n, neg_valid, g, head, 0.5, True)
    second = run_pairwise(q, p, n, neg_valid, g, head, 0.5, True)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dq", "dp", "dn"), first, second):
        assert torch.equal(a, b), name


# One split against the planned splits, as for the pool kernels: the dq
# kernel's splits' partial dq and sums of w f' add in its last kernel, in
# place on dq with one split.
@pytest.mark.parametrize(("r", "rn", "d"), PAIRWISE_SHAPES)
@pytest.mark.parametrize("head", PAIRWISE_HEADS)
@pytest.mark.parametrize(("mask_fn", "margin"), [(True, 0.0), (False, 0.5)])
def test_pairwise_kernels_agree_over_splits(cuda, monkeypatch, r, rn, d, head, mask_fn, margin):
    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    gen = torch.Generator().manual_seed(r + rn + d + 3)
    q, p, n, row_valid, neg_valid = pool_case(gen, cuda, r, rn, d)
    g = row_valid.float()
    splits = {k: fp._splits(cuda.index or 0, r, rn, d, i)
              for i, k in enumerate(("fwd", "dn", "dq"))}
    assert splits["dq"] > 1 and splits["dn"] > 1, splits
    planned = run_pairwise(q, p, n, neg_valid, g, head, margin, mask_fn)
    monkeypatch.setattr(fp, "_splits", lambda *args: 1)
    one = run_pairwise(q, p, n, neg_valid, g, head, margin, mask_fn)
    torch.cuda.synchronize()
    print(splits, {k: rel_err(a, b) for k, a, b in zip(("out", "dq", "dp", "dn"), one, planned)})
    for name, a, b, tol in zip(("out", "dq", "dp", "dn"), one, planned, (1e-5, 1e-2, 1e-2, 1e-2)):
        assert_agree(name, a, b, tol)


@pytest.mark.parametrize(("r", "rn", "d"), DEGENERATE_SHAPES)
@pytest.mark.parametrize("head", PAIRWISE_HEADS)
@pytest.mark.parametrize(("mask_fn", "margin"), [(True, 0.0), (False, 0.5)])
def test_pairwise_kernels_take_degenerate_shapes(cuda, r, rn, d, head, mask_fn, margin):
    """As the pool kernels' degenerate shapes; with no pool row dq = dpos p
    with dpos = 0."""
    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    gen = torch.Generator().manual_seed(r + rn + d + 4)
    q, p, n, neg_valid, g = exact_case(gen, cuda, r, rn, d)
    out, dq, dp, dn = run_pairwise(q, p, n, neg_valid, g, head, margin, mask_fn)
    kw = dict(head=head, margin=margin, mask_false_negatives=mask_fn)
    with torch.no_grad():
        out_want, den, _ = fp.fused_pairwise_reference(q, p, n, neg_valid, **kw)
        dq_want, dp_want = fp.fused_pairwise_dq_reference(q, p, n, neg_valid, den, g, **kw)
        dn_want = fp.fused_pairwise_dn_reference(q, p, n, neg_valid, den, g, **kw)
    torch.cuda.synchronize()
    for name, a, b, tol in (("out", out, out_want, 1e-5), ("dq", dq, dq_want, 1e-2),
                            ("dp", dp, dp_want, 1e-2), ("dn", dn, dn_want, 1e-2)):
        assert_agree(name, a, b, tol)


def test_pairwise_skips_the_dn_kernel_for_frozen_pool_rows(cuda):
    from transformer_recommenders_tpu_torch.ops import fused_pairwise as fp

    gen = torch.Generator().manual_seed(10)
    q, p, n, row_valid, neg_valid = pool_case(gen, cuda, 256, 300, 64)
    q.requires_grad_()
    cuda_build.reset_launches()
    fp.fused_pairwise_loss(q, p, n, row_valid, neg_valid, head="PairwiseLogisticLoss",
                           margin=0.0).backward()
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["pairwise_dq"] == 1
    assert cuda_build.LAUNCHES["pairwise_dn"] == 0
    assert torch.isfinite(q.grad).all()


# The throughput probe against its plain version: fma and select are the
# same correctly rounded f32 operations, bit for bit; exp is the kernel's
# expf against torch's exp (2e-5 relative, the JAX package's bound).
@pytest.mark.parametrize("mix", ["fma", "exp", "select"])
def test_vpu_chain_kernel_matches_plain(cuda, mix):
    from transformer_recommenders_tpu_torch.ops import vpu_calibration as vc

    gen = torch.Generator(device=cuda).manual_seed(4)
    for shape in (vc.wave_tile(cuda), (1024, 512), (3, 100)):  # one wave, the JAX tile, ragged
        x = torch.rand(shape, generator=gen, device=cuda) + 0.5
        cuda_build.reset_launches()
        got = vc.vpu_chain(x, iters=64, mix=mix)
        want = vc.reference_chain(x, iters=64, mix=mix)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["vpu_chain"] == 1
        if mix == "exp":
            torch.testing.assert_close(got, want, rtol=2e-5, atol=0)
        else:
            assert torch.equal(got, want)


def _section_case(cuda, dtype, b=16, s=32, d=128, h=8, f=512):
    gen = torch.Generator().manual_seed(b + s + d)
    x = torch.randn(b, s, d, generator=gen).to(cuda, dtype)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[-1, s // 2:] = False
    dy = torch.randn(b, s, d, generator=gen).to(cuda, dtype)
    params = _weights(gen, d, f, cuda)
    kw = dict(num_heads=h, causal=True, attn_dropout=0.1, hidden_dropout=0.1,
              dropout_seeds=[1, 2, 3])
    return x, params, mask.to(cuda), dy, kw


# The section variants of the layer's kernels against the plain stage
# versions: the forward stages and the recomputed output with the layer's
# bounds above, the backward's T(dctx) and dx with GRAD_TOL.
@pytest.mark.parametrize(("direction", "stage"), [
    ("fwd", "qkv"), ("fwd", "attn"), ("fwd", "out_ln1"), ("fwd", "ffn_gelu"), ("fwd", "full"),
    ("bwd", "recompute"), ("bwd", "ffn_bwd"), ("bwd", "attn_bwd"), ("bwd", "full"),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_section_kernels_match_plain(cuda, direction, stage, dtype):
    from transformer_recommenders_tpu_torch.ops import fused_sections as fs

    x, params, mask, dy, kw = _section_case(cuda, dtype)
    cuda_build.reset_launches()
    with torch.no_grad():
        if direction == "fwd":
            got = fs.layer_stage_forward(x, params, mask, stage=stage, **kw)
            want = fs.layer_stage_forward_reference(x, params, mask, stage=stage, **kw)
        else:
            got = fs.layer_stage_backward(x, params, mask, dy, stage=stage, **kw)
            want = fs.layer_stage_backward_reference(x, params, mask, dy, stage=stage, **kw)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[f"fused_layer_stage_{direction}"] == 1
    assert got.dtype == dtype and got.shape == x.shape
    if direction == "bwd" and stage != "recompute":
        assert rel_err(got, want) <= GRAD_TOL[dtype]
        return
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5
    else:
        assert err.max().item() <= 2.0**-4 and err.mean().item() <= 2.0**-8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_full_section_variants_are_the_production_kernels(cuda, dtype):
    from transformer_recommenders_tpu_torch.ops import fused_sections as fs

    x, params, mask, dy, kw = _section_case(cuda, dtype)
    with torch.no_grad():
        y = fs.layer_stage_forward(x, params, mask, stage="full", **kw)
        dx = fs.layer_stage_backward(x, params, mask, dy, stage="full", **kw)
    xr = x.clone().requires_grad_()
    y_prod = fused_layer(xr, params, mask, ffn_dim=512, **kw)
    y_prod.backward(dy)
    torch.cuda.synchronize()
    assert torch.equal(y, y_prod.detach())
    assert torch.equal(dx, xr.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_layer_device_seeds_equal_list_seeds(cuda, dtype):
    """The kernels read their three seeds from device memory: a tensor of
    seeds on the card (a view into a longer buffer, as the encoder passes
    a layer's three, or a strided view, which the wrapper makes
    contiguous) gives the forward's and the backward's bits of the list
    form; the same buffer rewritten gives the other seeds' bits."""
    x, params, mask = _layer_inputs(cuda, 128, 32, 128, 8, 512, dtype, seed=11)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(12)).to(cuda, dtype)
    kw = dict(num_heads=8, causal=True, attn_dropout=0.1, hidden_dropout=0.1, ffn_dim=512)
    seeds = [0x12345678, 4000000000, 7]
    buf = torch.tensor([1, *seeds, 2], dtype=torch.int64, device=cuda)

    def run(s):
        xr = x.clone().requires_grad_()
        y = fused_layer(xr, params, mask, dropout_seeds=s, **kw)
        y.backward(dy)
        return y.detach(), xr.grad

    want_y, want_dx = run(seeds)
    got_y, got_dx = run(buf[1:4])
    spaced = torch.tensor([seeds[0], 9, seeds[1], 9, seeds[2]], dtype=torch.int64, device=cuda)
    strided_y, strided_dx = run(spaced[::2])
    buf[1:4] = torch.tensor([5, 6, 7], device=cuda)
    other_y, _ = run(buf[1:4])
    again_y, _ = run([5, 6, 7])
    torch.cuda.synchronize()
    assert torch.equal(got_y, want_y) and torch.equal(got_dx, want_dx)
    assert torch.equal(strided_y, want_y) and torch.equal(strided_dx, want_dx)
    assert torch.equal(other_y, again_y) and not torch.equal(other_y, want_y)


def _scan_case(cuda, config, n_items, b, k, seed=0):
    import numpy as np

    from transformer_recommenders_tpu_torch.configs import TrainConfig
    from transformer_recommenders_tpu_torch.models.recommender import build_item_table
    from transformer_recommenders_tpu_torch.models.transformer import init_transformer_params
    from transformer_recommenders_tpu_torch.training import train_state as ts

    cfg = TrainConfig(**config)
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n_items, cfg.resolved_input_dim)).astype(np.float32)
    table = build_item_table(emb / np.linalg.norm(emb, axis=1, keepdims=True), device=cuda)
    params = init_transformer_params(torch.Generator().manual_seed(seed), cfg, device=cuda)
    s = cfg.max_seq_length
    batches = []
    for _ in range(k):
        lengths = rng.integers(1, s + 1, size=b)
        valid = np.arange(s)[None, :] < lengths[:, None]
        batch = {key: (rng.integers(1, n_items + 1, size=(b, s)) * valid).astype(np.int32)
                 for key in ("history_item_idx", "pos_item_idx", "neg_item_idx")}
        batch["pos_item_idx"][rng.random((b, s)) < 0.1] = 0
        batches.append(batch)
    gen = torch.Generator().manual_seed(seed + 1)
    seeds = [ts.draw_dropout_seeds(gen, cfg) for _ in range(k)]
    return cfg, table, ts.init_train_state(cfg, params), batches, seeds


SCAN_CONFIGS = {
    # configs/ml1m_ssm.yaml: the fused layer, the table-scored InfoNCE
    "flagship": (dict(input_dim=384, hidden_size=128, num_hidden_layers=4,
                      num_attention_heads=8, intermediate_size=512, max_seq_length=32,
                      train_loss="InfoNCELoss"), 3706, 128),
    # configs/ml100k_bpr.yaml (path C): the layer stack, the pairwise kernels
    "ml100k_bpr": (dict(input_dim=384, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=256, max_seq_length=32,
                        train_loss="PairwiseLogisticLoss", margin=0.0), 1682, 128),
    # configs/ml25m_ccl.yaml at 2 of its 6 layers: the layer stack at seq
    # 128 (the hash dropout, the attention core), the pairwise kernels
    "scale_narrow": (dict(input_dim=384, hidden_size=256, num_hidden_layers=2,
                          num_attention_heads=8, intermediate_size=1024, max_seq_length=128,
                          train_loss="ContrastiveLoss", margin=0.5), 4000, 64),
}


@pytest.mark.parametrize(("name", "k", "accumulate"), [
    ("flagship", 4, 1), ("flagship", 4, 2), ("ml100k_bpr", 3, 1), ("scale_narrow", 3, 1),
])
def test_graphed_window_equals_eager_steps(cuda, name, k, accumulate):
    """K graphed steps against K eager ``make_train_step(full_logs=False)``
    steps with the same batches and seeds: parameters, moments, count,
    accumulator and logs bit for bit; a second call's launch counts are K
    times one eager step's (the replays counted, not the capture)."""
    from transformer_recommenders_tpu_torch.training import train_state as ts
    from transformer_recommenders_tpu_torch.training.scan_steps import (
        make_scanned_train_steps, stack_batches)

    config, n_items, b = SCAN_CONFIGS[name]
    cfg, table, state0, batches, seeds = _scan_case(
        cuda, {**config, "accumulate_grad_batches": accumulate}, n_items, b, k)
    step = ts.make_train_step(cfg, full_logs=False)
    eager, losses = state0, []
    cuda_build.reset_launches()
    for batch, s in zip(batches, seeds):
        eager, logs = step(eager, table, batch, s)
        losses.append(logs[f"loss/{cfg.train_loss}"])
    per_k_steps = dict(cuda_build.LAUNCHES)
    steps = make_scanned_train_steps(cfg)
    stacked = stack_batches(batches)
    got, got_logs = steps(state0, table, stacked, torch.tensor(seeds))
    torch.cuda.synchronize()
    assert torch.equal(ts.flatten(got.params), ts.flatten(eager.params))
    for field in ("count", "mu", "nu", "acc"):
        a, e = getattr(got.opt_state, field), getattr(eager.opt_state, field)
        assert (a is None and e is None) or torch.equal(a, e), field
    assert torch.equal(got_logs[f"loss/{cfg.train_loss}"], torch.stack(losses))
    assert got_logs["batch/positive_non_zero"].tolist() == [
        float((bt["pos_item_idx"] != 0).sum()) for bt in batches]
    cuda_build.reset_launches()
    again, _ = steps(state0, table, stacked, torch.tensor(seeds))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES == per_k_steps
    assert torch.equal(ts.flatten(again.params), ts.flatten(got.params))


def test_fit_on_the_card_resumes_bit_for_bit(cuda, tmp_path):
    """A short fit of the trainer on the card (synthetic data, a d=128
    model that takes the fused layer, K=4 graphed windows with logging
    steps); a fresh trainer restored from the best checkpoint validates
    bit for bit as the fit's best validation did."""
    import json

    from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig, TrainConfig
    from transformer_recommenders_tpu_torch.data.module import SeqDataModule
    from transformer_recommenders_tpu_torch.training.trainer import Trainer

    dm = SeqDataModule(SeqDataModuleConfig(
        data_dir=str(tmp_path / "data"), dataset="synthetic", embedder="hash",
        embedding_dim=64, max_seq_length=16, batch_size=32, synthetic_num_users=120,
        synthetic_num_items=200, synthetic_num_events=8000))
    cfg = TrainConfig(input_dim=64, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=256, max_seq_length=16, max_epochs=2,
                      steps_per_dispatch=4, log_every_n_steps=8, use_mlflow=False,
                      ckpt_dir=str(tmp_path / "ckpt"))
    trainer = Trainer(cfg, dm, log_dir=str(tmp_path / "logs"))
    assert trainer.device.type == "cuda"
    trainer.fit()
    assert trainer.phase_counts["windows"] > 0 and trainer.phase_counts["log_events"] > 0
    best = tmp_path / "ckpt" / "best"
    best_val = json.loads((best / "meta.json").read_text())["metrics"]
    fresh = Trainer(cfg, dm, log_dir=str(tmp_path / "logs2"))
    fresh.restore(str(best))
    assert fresh.validate() == best_val
    assert trainer.validate() == best_val
    trainer.close()
    fresh.close()


# -- the parallel layer and the serving pool on the card ----------------------------------------


def _chip_smoke():
    import pathlib
    import sys

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


def test_parallel_layer_on_a_1x1_nccl_mesh(cuda):
    """The parallel layer over a real NCCL group of one rank
    (``chip_smoke.parallel_phase``): the flagship's sharded hot step (the
    table branch) and logging step (the pool branch) at B=128 bit for bit
    against the one-device steps, with their launches; a graphed sharded
    window of K=4 bit for bit against eager sharded steps (its NCCL calls
    inside the capture); the sharded evaluator against the one-device
    one."""
    launches = _chip_smoke().parallel_phase(k=4, calls=1, users=64)
    assert launches["parallel_hot"]["table_infonce_fwd"] == 1
    assert launches["parallel_logging"]["pool_infonce_fwd"] == 1
    assert launches["parallel_scan"]["fused_layer"] == 4 * 4


def test_worker_pool_on_the_card(cuda, tmp_path):
    """``serve_workers`` with two workers on the card
    (``chip_smoke.workers_phase``): the nine APIs and a concurrent burst
    over HTTP answer as the in-process Service, the pool stops, and its
    requests went through the fused layer."""
    smoke = _chip_smoke()
    smoke.build_artifact(tmp_path / "artifact", device="cuda", num_items=500, num_users=100)
    launches = smoke.workers_phase(tmp_path / "artifact", requests=16)
    assert launches["fused_layer"] > 0


# -- the layer stack's kernels: the hash dropout (#16), the attention core (#17, #18) ------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its width (equal bits, not equal values:
    -0 differs from 0)."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


# name: (shape, dtype, permutation of a contiguous tensor or None); the
# scale step's (configs/ml25m_ccl.yaml, B=256) and path C's (ml100k_bpr,
# B=128) sites, strided views and odd sizes
DROPOUT_SITES = {
    "scale_probs": ((256, 8, 128, 128), torch.bfloat16, None),  # the plain core's y
    "scale_dp_view": ((256, 128, 8, 128), torch.float32, (0, 2, 1, 3)),  # an einsum's view
    "scale_hidden": ((256, 128, 256), torch.bfloat16, None),
    "C_probs": ((128, 4, 32, 32), torch.float32, None),  # the masked path's f32 probs
    "C_hidden": ((128, 32, 64), torch.bfloat16, None),
    "odd": ((3, 7, 5), torch.bfloat16, None),
    "transposed": ((333, 65), torch.float32, (1, 0)),
}


@pytest.mark.parametrize("seed_kind", ["int", "tensor"])
@pytest.mark.parametrize("name", list(DROPOUT_SITES))
def test_hash_dropout_kernel_matches_plain_bit_for_bit(cuda, name, seed_kind):
    """#16 forward and backward (one launch each) against the plain int64
    chain, bit for bit, at the main paths' sites, on contiguous and strided
    inputs, with an int seed term and one read on the card."""
    from transformer_recommenders_tpu_torch.ops import hash_dropout as hd

    shape, dtype, perm = DROPOUT_SITES[name]
    gen = torch.Generator().manual_seed(len(name))
    x = torch.randn(shape, generator=gen).to(cuda, dtype)
    g = torch.randn(shape, generator=gen).to(cuda, dtype)
    if perm is not None:
        x, g = x.permute(perm), g.permute(perm)
    seed = 0xDEADBEEF
    term = (hd.seed_terms(torch.tensor([seed], device=cuda))[0] if seed_kind == "tensor"
            else hd.seed_terms([seed])[0])
    xr = x.detach().requires_grad_(True)
    cuda_build.reset_launches()
    y = hd.hash_dropout(xr, 0.1, term)
    y.backward(g)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["hash_dropout"] == 2
    assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous()
    assert torch.equal(_bits(y), _bits(hd.hash_dropout_reference(x, 0.1, term)))
    assert torch.equal(_bits(xr.grad), _bits(hd.hash_dropout_reference(g, 0.1, term)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_hash_dropout_kernel_takes_unaligned_views_and_tails(cuda, dtype, offset):
    """A view that starts off a 16-byte boundary, and element counts that
    leave a tail after the 16-byte steps."""
    from transformer_recommenders_tpu_torch.ops import hash_dropout as hd

    base = torch.randn(4099 + offset, generator=torch.Generator().manual_seed(offset))
    x = base.to(cuda, dtype)[offset:]
    term = hd.seed_terms([7])[0]
    got = hd.hash_dropout(x, 0.4942, term)
    assert torch.equal(_bits(got), _bits(hd.hash_dropout_reference(x, 0.4942, term)))


def _attn_inputs(cuda, b, s, h, dh, seed=0, mask_kind="tail"):
    """q, k, v as the layer stack gives them (views of one (B, S, 3 H dh)
    qkv tensor), a (B, S) key mask, an f32 cotangent.  The mask: padded
    tails of random lengths (the stack's batches); keys 0-9 padded
    (``left``: rows 0-9 have no valid key at t <= s, so the causal kernels
    may not skip their future tiles); or holes inside the sequences."""
    gen = torch.Generator().manual_seed(seed)
    d = h * dh
    qkv = torch.randn(b, s, 3 * d, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, s, h, dh) for i in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    mask = torch.arange(s)[None, :] < lengths[:, None]
    if mask_kind == "left":
        mask = torch.arange(s)[None, :].expand(b, s) >= min(10, s - 1)
    elif mask_kind == "holes":
        mask = torch.rand(b, s, generator=gen) > 0.3
        mask[:, 0] = True
    g = torch.randn(b, s, h, dh, generator=gen).to(cuda)
    return q, k, v, mask.to(cuda), g


# (B, S, H, dh): the scale step's B=256 and bench_config4's B=64
# (configs/ml25m_ccl.yaml: d=256, 8 heads, seq 128), dh 64, S off 16, S=1
ATTN_SHAPES = [(256, 128, 8, 32), (64, 128, 8, 32), (3, 128, 4, 64), (4, 65, 2, 64),
               (5, 33, 3, 32), (2, 1, 2, 32)]
ATTN_TOL = 1e-2  # GRAD_TOL's bf16 bound, relative to each output's max abs


@pytest.mark.parametrize(("b", "s", "h", "dh"), ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask_kind", ["tail", "left", "holes"])
def test_attn_core_kernels_match_plain(cuda, b, s, h, dh, causal, rate, mask_kind):
    """#17 against the plain forward and #18 against the plain backward
    from the same (m, l).  The kernels sum the scores and products on the
    tensor cores, the plain version with f32 torch.matmul over the same
    bf16 values (exact products): the orders differ, so a score's last bit
    may move y across a bf16 rounding (one ulp, at most 2**-8 at y <= 1, in
    at most 1% of the probs), and ctx, dq, dk, dv within ATTN_TOL of
    their max abs values; m and l are those of the kernel's own scores, so
    they are held through y and ctx.  Two calls of each kernel give the
    same bits, with y written or not."""
    from transformer_recommenders_tpu_torch.ops import attn_core as ac
    from transformer_recommenders_tpu_torch.ops.hash_dropout import seed_terms

    q, k, v, mask, g = _attn_inputs(cuda, b, s, h, dh, seed=b + s + dh, mask_kind=mask_kind)
    term = seed_terms(torch.tensor([12345], device=cuda))[0]
    ctx, m, l, y, _ = ac._fwd_cuda(q, k, v, mask, term, rate, causal, with_y=True)
    ctx2, m2, l2, _, _ = ac._fwd_cuda(q, k, v, mask, term, rate, causal)
    want_ctx, _, _, want_y = ac.attn_core_reference(q, k, v, mask, term, rate, causal,
                                                    with_y=True)
    grads = ac._bwd_cuda(q, k, v, mask, m, l, g, term, rate, causal)
    again = ac._bwd_cuda(q, k, v, mask, m, l, g, term, rate, causal)
    want = ac.attn_core_backward_reference(q, k, v, mask, m, l, g, term, rate, causal)
    torch.cuda.synchronize()
    for a, a2 in zip((ctx, m, l, *grads), (ctx2, m2, l2, *again)):
        assert torch.equal(_bits(a), _bits(a2))
    dy = (y.float() - want_y.float()).abs()
    assert dy.max().item() <= 2.0**-8 and (dy > 0).float().mean().item() <= 0.01
    for name, got, ref in zip(("ctx", "dq", "dk", "dv"), (ctx, *grads), (want_ctx, *want)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert torch.isfinite(got).all(), name
        assert rel_err(got, ref) <= ATTN_TOL, name


@pytest.mark.parametrize(("b", "s", "h", "dh"), [(64, 128, 8, 32), (4, 65, 2, 64), (5, 33, 3, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mask_kind", ["tail", "left", "holes"])
def test_attn_core_backward_rebuilds_the_forwards_probs(cuda, b, s, h, dh, causal, mask_kind):
    """#18's y, rebuilt from #17's (m, l) and read back through dv, equals
    #17's optional y output bit for bit."""
    from transformer_recommenders_tpu_torch.ops import attn_core as ac

    q, k, v, mask, _ = _attn_inputs(cuda, b, s, h, dh, seed=s + dh, mask_kind=mask_kind)
    _, m, l, y, _ = ac._fwd_cuda(q, k, v, mask, None, 0.0, causal, with_y=True)
    rebuilt = ac.probs_through_dv(q, k, v, mask, m, l, causal)
    torch.cuda.synchronize()
    assert torch.equal(_bits(rebuilt), _bits(y))


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5, 0.9])
def test_attn_core_fast_division_is_the_true_one(cuda, rate):
    """The kernels divide without __fdiv_rn's branch where the operands
    allow (csrc/attn_core.cu, div_rn): over every float dividend in that
    range, the bits equal __fdiv_rn's, for the dropout's two divisors
    (1 - rate in bf16 and in f32) and for softmax sums l in [1, 128]."""
    from transformer_recommenders_tpu_torch.ops import attn_core as ac
    from transformer_recommenders_tpu_torch.ops.hash_dropout import keep_divisor

    gen = torch.Generator().manual_seed(int(rate * 100))
    sums = [1.0, 1.5, 3.0, 127.99, 128.0, *(1 + 127 * torch.rand(3, generator=gen)).tolist()]
    for b in (keep_divisor(rate, torch.bfloat16), keep_divisor(rate, torch.float32), *sums):
        assert ac.division_mismatches(b, cuda) == 0, b


def test_attn_core_main_path_allocates_no_probs_tensor(cuda):
    """Through autograd at (64, 128, 8, 32), the forward allocates ctx, m
    and l and the backward dq, dk, dv and nothing of (B, H, S, S): a bf16
    one would add 16.8 MB to either peak."""
    from transformer_recommenders_tpu_torch.ops import attn_core as ac

    b, s, h, dh = 64, 128, 8, 32
    q, k, v, mask, g = _attn_inputs(cuda, b, s, h, dh, seed=7)
    leaves = [t.detach().contiguous().requires_grad_(True) for t in (q, k, v)]
    probs_bytes = b * h * s * s * 2
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ac.attn_core_bf16(*leaves, mask, 11, 0.1, True)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated() - base
    fwd_want = out.nbytes + 2 * b * h * s * 4  # ctx, m, l
    assert fwd_peak <= fwd_want + (1 << 20) < fwd_want + probs_bytes
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out.backward(g)
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - base
    assert bwd_peak <= 3 * q.numel() * 2 + (1 << 20) < probs_bytes  # dq, dk, dv


def test_attn_core_counts_launches_and_copies_unshared_strides(cuda):
    """Through autograd the core launches #17 and #18 once each; q, k, v
    with strides of their own are copied to one layout first and give the
    same bits as views of one qkv tensor."""
    from transformer_recommenders_tpu_torch.ops import attn_core as ac

    q, k, v, mask, g = _attn_inputs(cuda, 8, 128, 8, 32, seed=5)
    term = 987654321

    def run(q_, k_, v_):
        leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
        out = ac.attn_core_bf16(*leaves, mask, term, 0.1, True)
        out.backward(g)
        return [out] + [t.grad for t in leaves]

    cuda_build.reset_launches()
    views = run(q, k, v)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["attn_core_fwd"] == 1 and cuda_build.LAUNCHES["attn_core_bwd"] == 1
    assert cuda_build.LAUNCHES["hash_dropout"] == 0
    copies = run(q.contiguous(), k, v)
    for a, c in zip(views, copies):
        assert torch.equal(_bits(a), _bits(c))


def test_attn_core_outside_the_gate_runs_the_plain_core_with_the_dropout_kernel(cuda):
    """S = 129 is past the gate: the plain core runs on the card, its three
    masks through #16, and neither #17 nor #18 launches."""
    from transformer_recommenders_tpu_torch.ops import attn_core as ac

    q, k, v, mask, g = _attn_inputs(cuda, 2, 129, 2, 32, seed=6)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    cuda_build.reset_launches()
    ac.attn_core_bf16(*leaves, mask, 11, 0.1, False).backward(g)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["hash_dropout"] == 3
    assert cuda_build.LAUNCHES["attn_core_fwd"] == cuda_build.LAUNCHES["attn_core_bwd"] == 0


# -- the layer stack's dense (#19) -----------------------------------------------------------------


# (M, K, N): the scale recommend call's qkv, out and FFN (B=512 x S=128),
# the scale step's (B=256 x S=128), the scale catalog's projection (62,424
# rows), the flagship's (3,706), path C's d=64, a ragged M, and K and N
# that the gate admits (multiples of 8) but no 64-wide k-block or 64-column
# store box divides: the last k-block read partly out of range (zeros into
# wgmma) and the last output box stored clipped
DENSE_SHAPES = [
    (65536, 256, 768), (65536, 256, 256), (65536, 256, 1024), (65536, 1024, 256),
    (32768, 256, 768), (32768, 1024, 256), (62424, 384, 256), (3706, 384, 128),
    (1000, 64, 192), (1000, 256, 128), (1000, 72, 200), (3706, 392, 136),
]


def _dense_inputs(cuda, m, k, n, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(k, n, generator=gen) / math.sqrt(k)).to(cuda)
    b = (0.1 * torch.randn(n, generator=gen)).to(cuda)
    g = torch.randn(m, n, generator=gen).to(cuda, torch.bfloat16)
    return x, w, b, g


def _dense_grads(fn, x, w, b, g):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    y = fn(*leaves, torch.bfloat16)
    y.backward(g)
    return [y.detach()] + [t.grad for t in leaves]


def _within_sum_order(got, want, scale):
    """``got`` against ``want``, sums of the same exact products in other
    orders rounded to bf16: one bf16 ulp of |want|, plus what the f32 sum
    order can move (2**-16 of ``scale``, the sum of the terms' magnitudes)
    where the sum cancels.  Returns the share of outputs that differ."""
    got, want = got.float(), want.float()
    ulp = torch.abs(want) * 2.0**-7 + 2.0**-133
    assert (torch.abs(got - want) <= ulp + 2.0**-16 * scale).all()
    return float((got != want).float().mean())


@pytest.mark.parametrize(("m", "k", "n"), DENSE_SHAPES)
def test_dense_kernels_match_plain(cuda, m, k, n):
    """#19 forward, dgrad and wgrad against the plain graph on the card: y
    and dx within one bf16 ulp where they differ (at most 1% of them), dW
    likewise before its rounding, db within an f32 sum-order bound."""
    from transformer_recommenders_tpu_torch.ops import dense as D

    x, w, b, g = _dense_inputs(cuda, m, k, n, seed=m + k + n)
    cuda_build.reset_launches()
    got = _dense_grads(D.dense, x, w, b, g)
    torch.cuda.synchronize()
    assert {name: cuda_build.LAUNCHES[name] for name in
            ("dense_fwd", "dense_dgrad", "dense_wgrad", "dense_plain")} == {
        "dense_fwd": 1, "dense_dgrad": 1, "dense_wgrad": 1, "dense_plain": 0}
    want = _dense_grads(D.dense_reference, x, w, b, g)
    xa, wa, ga = x.float().abs(), w.to(torch.bfloat16).float().abs(), g.float().abs()
    assert _within_sum_order(got[0], want[0], xa @ wa + b.abs()) <= 0.01
    assert _within_sum_order(got[1], want[1], ga @ wa.t()) <= 0.01
    assert _within_sum_order(got[2], want[2], xa.t() @ ga) <= 0.01
    assert got[2].dtype == torch.float32 and torch.equal(got[2], got[2].to(torch.bfloat16).float())
    assert (torch.abs(got[3] - want[3]) <= 2.0**-16 * ga.sum(0)).all()


@pytest.mark.parametrize(("k", "n"), [(384, 256), (256, 768), (1024, 256), (64, 192)])
def test_dense_rows_do_not_depend_on_the_batch(cuda, k, n):
    """A row's forward output is the same bits at M = 64 as inside M =
    65,536 (no split of K, one K-loop order whatever M is): ROADMAP C.1."""
    from transformer_recommenders_tpu_torch.ops import dense as D

    x, w, b, _ = _dense_inputs(cuda, 65536, k, n, seed=k * n)
    with torch.no_grad():
        whole = D.dense(x, w, b, torch.bfloat16)
        for lo in (0, 1000, 65536 - 64):
            part = D.dense(x[lo:lo + 64].clone(), w, b, torch.bfloat16)
            assert torch.equal(_bits(part), _bits(whole[lo:lo + 64]))


@pytest.mark.parametrize(("m", "k", "n"), [(32768, 256, 768), (62424, 384, 256), (3706, 384, 128),
                                         (3706, 392, 136)])
def test_dense_wgrad_bits_eager_twice_and_graphed(cuda, m, k, n):
    """The wgrad (its splits of T summed in a fixed order, no atomics) gives
    the same bits on two eager runs and on a CUDA graph's capture and
    replay."""
    from transformer_recommenders_tpu_torch.ops import dense as D

    x, _, _, g = _dense_inputs(cuda, m, k, n, seed=m)
    first = D._wgrad_cuda(x, g)
    second = D._wgrad_cuda(x, g)
    assert D.wgrad_splits(m, k, n, cuda) > 1
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        D._wgrad_cuda(x, g)  # the capture's warm-up
        with torch.cuda.graph(graph, stream=stream):
            captured = D._wgrad_cuda(x, g)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    for a, e, c in zip(first, second, captured):
        assert torch.equal(_bits(a), _bits(e)) and torch.equal(_bits(a), _bits(c))


def test_dense_plain_path_on_the_card_is_counted(cuda):
    """A bf16 dense the kernels do not take (N not a multiple of 8) runs the
    plain ops and is counted; an f32 one is not."""
    from transformer_recommenders_tpu_torch.ops import dense as D

    x, w, b, _ = _dense_inputs(cuda, 64, 64, 20, seed=1)
    cuda_build.reset_launches()
    y = D.dense(x, w, b, torch.bfloat16)
    D.dense(x.float(), w, b, torch.float32)
    assert cuda_build.LAUNCHES["dense_plain"] == 1 and cuda_build.LAUNCHES["dense_fwd"] == 0
    assert torch.equal(y, D.dense_reference(x, w, b, torch.bfloat16))


def test_dense_counts_over_a_scale_step_and_a_recommend_call(cuda):
    """``configs/ml25m_ccl.yaml`` at full width and depth: one hot step
    launches #19 as ``chip_smoke.expected_launches`` counts (25 forwards, 24
    dgrads, 25 wgrads: the 6 layers' 4 denses and the catalog's
    projection), one recommend call of 512 users 25 forwards; neither
    takes the plain path."""
    from transformer_recommenders_tpu_torch.configs import TrainConfig
    from transformer_recommenders_tpu_torch.models.recommender import build_item_table
    from transformer_recommenders_tpu_torch.models.transformer import init_transformer_params
    from transformer_recommenders_tpu_torch.training import train_state as ts
    from transformer_recommenders_tpu_torch.training.evaluator import make_eval_step

    import numpy as np

    smoke = _chip_smoke()
    cfg = TrainConfig.from_dict(smoke.scale_sections()[0])
    n_items, b, s = 62423, smoke.SCALE_BATCH, cfg.max_seq_length
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(n_items, cfg.resolved_input_dim)).astype(np.float32)
    table = build_item_table(emb / np.linalg.norm(emb, axis=1, keepdims=True), device=cuda)
    params = init_transformer_params(torch.Generator().manual_seed(0), cfg, device=cuda)
    batch = smoke.train_batch(rng, b, s, n_items)
    seeds = ts.draw_dropout_seeds(torch.Generator().manual_seed(1), cfg)
    step = ts.make_train_step(cfg, full_logs=False)
    want = smoke.expected_launches(cfg, table.shape[0], ts.table_pool_rows(cfg, batch), False)
    cuda_build.reset_launches()
    step(ts.init_train_state(cfg, params), table, batch, seeds)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES == want
    assert (want["dense_fwd"], want["dense_dgrad"], want["dense_wgrad"]) == (25, 24, 25)

    prepare, eval_step = make_eval_step(cfg)
    items = prepare(params, table)
    users = 512
    window = rng.integers(1, n_items + 1, size=(users, s))
    cuda_build.reset_launches()
    eval_step(params, table, items, window, window, window[:, :1], np.ones(users))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["dense_fwd"] == 25 and cuda_build.LAUNCHES["dense_plain"] == 0
    assert cuda_build.LAUNCHES["dense_dgrad"] == cuda_build.LAUNCHES["dense_wgrad"] == 0
