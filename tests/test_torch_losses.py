"""The port's loss library (``ops/losses.py``) against the JAX package's,
function by function, on the same numpy inputs in f32.

Tolerances: 1e-5 relative (atol 1e-6) for every loss, logit and
statistic.  Both compute in f32 and differ only in the order of their
sums (~1e-7 relative); the masks compare logits, and the inputs have no
near-tie within that noise except where a test builds exact ties.  The
masks themselves must agree exactly.  Exact ties are built from small
integer vectors, whose dot products are exact in any order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.configs import LossConfig as JaxLossConfig
from transformer_recommenders_tpu.ops import losses as JL
from transformer_recommenders_tpu_torch.configs import LossConfig
from transformer_recommenders_tpu_torch.ops import losses as TL

RTOL, ATOL = 1e-5, 1e-6


def configs(**kw):
    return JaxLossConfig(**kw), LossConfig(**kw)


def make_pool(seed, r=40, d=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(r, d)).astype(np.float32)
    p = (q + rng.normal(size=(r, d))).astype(np.float32)  # positives near their query
    n = rng.normal(size=(r, d)).astype(np.float32)
    row_valid = rng.random(r) > 0.2
    neg_valid = rng.random(r) > 0.2
    return q, p, n, row_valid, neg_valid


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_normalize_and_weighted_mean_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    x[2] = 0.0  # a zero row: the norm clamps at 1e-8
    w = (rng.random((5, 7)) > 0.4).astype(np.float32)
    close(TL._l2_normalize(t(x)), JL._l2_normalize(jnp.asarray(x)))
    for axis in (None, 0, 1):
        close(TL.weighted_mean(t(x), t(w), axis=axis),
              JL.weighted_mean(jnp.asarray(x), jnp.asarray(w), axis=axis))


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_pair_logits_match_jax(similarity):
    q, p, n, _, _ = make_pool(1)
    want_pos, want_neg = JL.compute_pair_logits(jnp.asarray(q), jnp.asarray(p), jnp.asarray(n),
                                                similarity=similarity)
    got_pos, got_neg = TL.compute_pair_logits(t(q), t(p), t(n), similarity=similarity)
    assert got_pos.dtype == got_neg.dtype == torch.float32
    close(got_pos, want_pos)
    close(got_neg, want_neg)


@pytest.mark.parametrize("hard", [0, 3, 100], ids=["all", "top3", "k-above-pool"])
@pytest.mark.parametrize("mask_fn", [True, False], ids=["fnmask", "nofnmask"])
def test_negative_mask_matches_jax(mask_fn, hard):
    jcfg, tcfg = configs(mask_false_negatives=mask_fn, num_hard_negatives=hard)
    q, p, n, _, neg_valid = make_pool(2)
    pos, neg = JL.compute_pair_logits(jnp.asarray(q), jnp.asarray(p), jnp.asarray(n),
                                      similarity="dot")
    want = JL.negative_mask(jcfg, pos, neg, jnp.asarray(neg_valid))
    got = TL.negative_mask(tcfg, t(pos), t(neg), t(neg_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hard_negative_ties_keep_the_lower_index():
    """Duplicate pool rows give exactly equal logits; where they straddle
    the k-th place, ``jax.lax.top_k`` keeps the lower index, and so must
    the port (``torch.topk`` promises no order among equals)."""
    rng = np.random.default_rng(3)
    q = rng.integers(-3, 4, size=(6, 8)).astype(np.float32)
    p = q.copy()  # pos = |q|^2 is above every pool logit, so the mask keeps all
    n = rng.integers(-3, 4, size=(12, 8)).astype(np.float32)
    n[4:9] = n[3]  # six equal rows: ties at and around the k-th place
    neg_valid = np.ones(12, bool)
    neg_valid[5] = False
    jcfg, tcfg = configs(num_hard_negatives=4)
    pos, neg = JL.compute_pair_logits(jnp.asarray(q), jnp.asarray(p), jnp.asarray(n),
                                      similarity="dot")
    want = np.asarray(JL.negative_mask(jcfg, pos, neg, jnp.asarray(neg_valid)))
    got = TL.negative_mask(tcfg, t(pos), t(neg), t(neg_valid)).numpy()
    np.testing.assert_array_equal(got, want)
    # the rule itself: among valid candidates, the 4 largest by (value,
    # then lower index)
    neg = np.asarray(neg)
    for row in range(6):
        order = sorted((j for j in range(12) if neg_valid[j] and neg[row, j] < pos[row]),
                       key=lambda j: (-neg[row, j], j))
        assert set(np.flatnonzero(got[row])) == set(order[:4]), row
    assert (np.abs(neg[:, 3:9] - neg[:, 3:4]) == 0).all()  # the ties are exact
    tied = got[:, [3, 4, 6, 7, 8]].sum(axis=1)  # the valid copies kept, by row
    assert ((tied > 0) & (tied < 5)).any()  # the k-th place splits the ties


def test_hard_negatives_rank_negative_zero_below_positive_zero():
    """``jax.lax.top_k`` ranks -0.0 below +0.0 (a sort of the floats ties
    them): where signed zeros straddle the k-th place, the port keeps the
    +0.0 entries, as JAX does.  The logits are given directly: a dot head
    meets an exact zero only at a zero row, so the test builds one."""
    neg = np.array([[-0.0, 0.0, -0.0, 0.0, 1.0, -1.0, -0.0, 0.0],
                    [0.0, -0.0, -0.0, -0.0, -2.0, 0.5, 0.0, -0.0]], np.float32)
    pos = np.full(2, 4.0, np.float32)
    neg_valid = np.ones(8, bool)
    neg_valid[3] = False
    for k in (2, 3, 4):
        jcfg, tcfg = configs(num_hard_negatives=k)
        want = np.asarray(JL.negative_mask(jcfg, jnp.asarray(pos), jnp.asarray(neg),
                                           jnp.asarray(neg_valid)))
        got = TL.negative_mask(tcfg, t(pos), t(neg), t(neg_valid)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")
    # k=3: row 0 keeps 1.0 and its two valid +0.0 (columns 1, 7), no -0.0;
    # a stable sort of the floats would keep column 0's -0.0 instead of 7
    jcfg, tcfg = configs(num_hard_negatives=3)
    got = TL.negative_mask(tcfg, t(pos), t(neg), t(neg_valid)).numpy()
    assert set(np.flatnonzero(got[0])) == {1, 4, 7}
    assert set(np.flatnonzero(got[1])) == {0, 5, 6}


@pytest.mark.parametrize("hard", [0, 5], ids=["all", "top5"])
@pytest.mark.parametrize("mask_fn", [True, False], ids=["fnmask", "nofnmask"])
def test_every_loss_head_matches_jax(mask_fn, hard):
    jcfg, tcfg = configs(mask_false_negatives=mask_fn, num_hard_negatives=hard, scale=3.0,
                         margin=0.3)
    q, p, n, row_valid, neg_valid = make_pool(4 + hard)
    want = JL.compute_losses(jcfg, *(jnp.asarray(a) for a in (q, p, n, row_valid, neg_valid)))
    got = TL.compute_losses(tcfg, *(t(a) for a in (q, p, n, row_valid, neg_valid)))
    assert list(got) == list(want) == list(TL.LOSS_FNS)
    for name in want:
        assert got[name].dim() == 0 and got[name].dtype == torch.float32, name
        close(got[name], want[name])
    one = TL.compute_losses(tcfg, *(t(a) for a in (q, p, n, row_valid, neg_valid)),
                            loss_names=("NCELoss",))
    assert list(one) == ["NCELoss"] and float(one["NCELoss"]) == float(got["NCELoss"])


@pytest.mark.parametrize("hard", [0, 5], ids=["all", "top5"])
@pytest.mark.parametrize("mask_fn", [True, False], ids=["fnmask", "nofnmask"])
def test_logits_statistics_match_jax(mask_fn, hard):
    jcfg, tcfg = configs(mask_false_negatives=mask_fn, num_hard_negatives=hard)
    q, p, n, row_valid, neg_valid = make_pool(8)
    args_j = [jnp.asarray(a) for a in (q, p, n, row_valid, neg_valid)]
    args_t = [t(a) for a in (q, p, n, row_valid, neg_valid)]
    want_m = JL.logits_statistics_moments(jcfg, *args_j)
    got_m = TL.logits_statistics_moments(tcfg, *args_t)
    assert set(got_m) == set(want_m)
    for key in want_m:
        close(got_m[key], want_m[key])
    want = JL.logits_statistics(jcfg, *args_j)
    got = TL.logits_statistics(tcfg, *args_t)
    assert set(got) == set(want) and len(got) == 9
    for key in want:
        close(got[key], want[key])


@pytest.mark.parametrize("target_position", ["first", "diagonal"])
@pytest.mark.parametrize("name", list(TL.LOSS_FNS))
def test_loss_from_candidates_matches_jax(name, target_position):
    jcfg, tcfg = configs(target_position=target_position, scale=2.0,
                         num_hard_negatives=3 if target_position == "diagonal" else 0)
    rng = np.random.default_rng(len(name))
    b, c, d = 6, 6, 12
    query = rng.normal(size=(b, d)).astype(np.float32)
    cand = rng.normal(size=(b, c, d)).astype(np.float32)
    want = JL.loss_from_candidates(jcfg, name, jnp.asarray(query), jnp.asarray(cand))
    got = TL.loss_from_candidates(tcfg, name, t(query), t(cand))
    close(got, want)
    # an explicit target overrides the position
    target = np.asarray([5, 0, 2, 2, 1, 3], np.int32)
    close(TL.loss_from_candidates(tcfg, name, t(query), t(cand), t(target)),
          JL.loss_from_candidates(jcfg, name, jnp.asarray(query), jnp.asarray(cand),
                                  jnp.asarray(target)))


def test_loss_from_candidates_needs_a_target():
    tcfg = LossConfig(target_position=None)
    with pytest.raises(ValueError, match="target"):
        TL.loss_from_candidates(tcfg, "InfoNCELoss", torch.zeros(2, 4), torch.zeros(2, 3, 4))
