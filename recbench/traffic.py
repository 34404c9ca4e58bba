"""The one traffic generator: users, their event sequences, the training
rows and the recommendation batches, on the device, from the run's seed.

What it reads: the configuration's ``dataset`` (catalog size, users,
events, the least and most events of a user, the assumed median) and the
traffic mix's parameters (``zipf_exponent``, ``jump_probability``, pool
sizes).  Its rules, copied from the program's data modules:

- events per user: at least ``min_events_per_user``, heavy-tailed (the
  minimum plus a lognormal whose median is the assumed one), capped at the
  dataset's most, with the mean the dataset's published events / users.
  The lengths are the distribution's quantiles at (i + 1/2) / U, so every
  seed has the same set of lengths, dealt to users in the seed's order;
- a user's sequence walks the item ring (``data/synthetic.py``): the first
  event and, with ``jump_probability``, any later one is drawn by
  popularity (Zipf, ``1 / rank ** zipf_exponent``, rank = ring position),
  else the walk steps 1 to 3 items along the ring;
- training rows (``data/dataset.py``): each user repeated
  ``(n - 1) // S + 1`` times an epoch, the rows in the seed's order; a
  row's query positions are a sorted sample without replacement of at most
  S of the positions 0..n-2; each position's positive is a uniform draw
  among the later events; its negative a draw, uniform and without
  replacement within the row, among the items not in the user's history;
  rows padded with zeros at the tail;
- recommendation batches (``data/module.py``): a user's last event is the
  target; the window is the last S events before it (zeros at the tail);
  the whole history before it is excluded, padded to the batch's next
  power of two.

Integer tensors are int64 (training) and int32 (recommendation, as the
program's evaluator receives them).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def derived_seeds(seed: int) -> dict[str, int]:
    """Independent 63-bit seeds of the run's parts from ``--seed``."""
    names = ("traffic", "weights", "dropout", "sample")
    states = np.random.SeedSequence(int(seed)).spawn(len(names))
    return {n: int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for n, s in zip(names, states)}


def _ndtri(p: np.ndarray) -> np.ndarray:
    """The standard normal's quantile function (Acklam's rational
    approximation, relative error below 1.2e-9)."""
    a = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
    b = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00)
    p = np.asarray(p, np.float64)
    out = np.empty_like(p)
    lo, hi = p < 0.02425, p > 1 - 0.02425
    mid = ~(lo | hi)
    q = np.sqrt(-2 * np.log(p[lo]))
    out[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
        ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = np.sqrt(-2 * np.log(1 - p[hi]))
    out[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
        ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p[mid] - 0.5
    r = q * q
    out[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
        (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    return out


def user_lengths(dataset: dict, users: int) -> np.ndarray:
    """The events of ``users`` users in increasing order (module docstring):
    ``min + exp(mu + sigma z)`` rounded, capped, with ``sigma`` from the
    assumed median and ``mu`` then moved until the mean is the dataset's."""
    lo, hi = dataset["min_events_per_user"], dataset["max_events_per_user"]
    mean = dataset["events"] / dataset["users"]
    z = _ndtri((np.arange(users) + 0.5) / users)
    mu0 = math.log(dataset["median_events_per_user"] - lo)
    sigma = math.sqrt(2.0 * math.log((mean - lo) / (dataset["median_events_per_user"] - lo)))

    def lengths(mu):
        return np.minimum(lo + np.rint(np.exp(mu + sigma * z)), hi).astype(np.int64)

    a, b = mu0 - 3.0, mu0 + 3.0  # the mean rises with mu
    for _ in range(60):
        mid = 0.5 * (a + b)
        if lengths(mid).mean() < mean:
            a = mid
        else:
            b = mid
    return lengths(0.5 * (a + b))


def _popularity_cdf(num_items: int, exponent: float, device) -> torch.Tensor:
    pop = 1.0 / torch.arange(1, num_items + 1, device=device, dtype=torch.float64) ** exponent
    cdf = pop.cumsum(0)
    return cdf / cdf[-1]


def walk(lengths: torch.Tensor, num_items: int, mix: dict, gen: torch.Generator, device
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every user's sequence, concatenated: (items (E,) int64 1-based,
    offsets (U + 1,) int64)."""
    counts = lengths.to(device=device, dtype=torch.int64)
    offsets = torch.zeros(len(counts) + 1, dtype=torch.int64, device=device)
    offsets[1:] = counts.cumsum(0)
    e = int(offsets[-1])
    first = torch.zeros(e, dtype=torch.bool, device=device)
    first[offsets[:-1]] = True
    jump = (torch.rand(e, generator=gen, device=device) < mix["jump_probability"]) | first
    cdf = _popularity_cdf(num_items, mix["zipf_exponent"], device)
    u = torch.rand(e, generator=gen, device=device, dtype=torch.float64)
    jump_to = torch.searchsorted(cdf, u, right=True).clamp(max=num_items - 1)
    steps = torch.randint(1, 4, (e,), generator=gen, device=device)
    cs = steps.cumsum(0)
    idx = torch.arange(e, device=device)
    last = torch.cummax(torch.where(jump, idx, 0), 0).values
    ring = (jump_to[last] + (cs - cs[last])) % num_items
    return ring + 1, offsets


def _sorted_sample(m: torch.Tensor, s: int, gen, device):
    """(R, s) int64 positions: for a row with ``m <= s`` candidates 0..m-1
    then zeros, else a sorted sample of ``s`` of them without replacement;
    and the (R, s) bool of the positions that exist."""
    r = len(m)
    out = torch.arange(s, device=device).expand(r, s).clone()
    valid = out < m[:, None]
    big = torch.nonzero(m > s).flatten()
    if len(big):
        width = int(m[big].max())
        rows = max(1, (1 << 26) // width)  # keys of at most 64M positions at once
        for lo in range(0, len(big), rows):
            sel = big[lo:lo + rows]
            keys = torch.rand(len(sel), width, generator=gen, device=device)
            keys = torch.where(torch.arange(width, device=device)[None, :] < m[sel, None],
                               keys, 2.0)
            out[sel] = torch.sort(torch.topk(keys, s, dim=1, largest=False).indices,
                                  dim=1).values
    return torch.where(valid, out, 0), valid


def _negatives(hist_keys: torch.Tensor, rows: int, s: int, need: torch.Tensor,
               num_items: int, gen, device) -> torch.Tensor:
    """(rows, s) int64: row r's first ``need[r]`` entries uniform without
    replacement among the items whose key ``r * (num_items + 1) + item``
    is not in the sorted ``hist_keys``; zeros after them."""
    width = 2 * s + 16
    out = torch.zeros(rows, s, dtype=torch.int64, device=device)
    todo = torch.arange(rows, device=device)
    while len(todo):
        draw = torch.randint(1, num_items + 1, (len(todo), width), generator=gen, device=device)
        keys = todo[:, None] * (num_items + 1) + draw
        at = torch.searchsorted(hist_keys, keys).clamp(max=len(hist_keys) - 1)
        seen = hist_keys[at] == keys
        # a repeat of an earlier draw in its row: a stable sort by item keeps
        # draw order among equal items, so every equal item after the first
        # of its run is a repeat
        by_item, order = torch.sort(draw, dim=1, stable=True)
        repeat_sorted = torch.zeros_like(seen)
        repeat_sorted[:, 1:] = by_item[:, 1:] == by_item[:, :-1]
        repeat = torch.zeros_like(seen).scatter_(1, order, repeat_sorted)
        ok = ~(seen | repeat)
        short = ok.sum(dim=1) < need[todo]
        pick = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)[:, :s]
        chosen = draw.gather(1, pick)
        keep = torch.arange(s, device=device)[None, :] < need[todo][:, None]
        done = todo[~short]
        out[done] = torch.where(keep[~short], chosen[~short], 0)
        todo = todo[short]
    return out


def _deal(dataset: dict, users: int, gen, device) -> torch.Tensor:
    """The ``users`` quantile lengths in the seed's order."""
    lengths = torch.as_tensor(user_lengths(dataset, users), device=device)
    return lengths[torch.randperm(users, generator=gen, device=device)]


def train_pool(dataset: dict, batch_size: int, seq: int, mix: dict, seed: int, device) -> dict:
    """``pool_calls * steps_per_call`` training batches: (P, B, S) int64
    ``history_item_idx``, ``pos_item_idx``, ``neg_item_idx``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_items = dataset["items"]
    lengths = _deal(dataset, dataset["users"], gen, device)
    copies = (lengths - 1) // seq + 1
    owner = torch.repeat_interleave(torch.arange(len(lengths), device=device), copies)
    p = mix["pool_calls"] * mix["steps_per_call"]
    rows = owner[torch.randperm(len(owner), generator=gen, device=device)[:p * batch_size]]
    users, row_user = torch.unique(rows, return_inverse=True)
    items, offsets = walk(lengths[users], n_items, mix, gen, device)
    n = lengths[users][row_user]
    start = offsets[:-1][row_user]
    at, valid = _sorted_sample(n - 1, seq, gen, device)
    hist = torch.where(valid, items[start[:, None] + at], 0)
    later = n[:, None] - 1 - at  # events after each position (>= 1 where valid)
    ahead = 1 + (torch.rand(at.shape, generator=gen, device=device) * later).long()
    pos = torch.where(valid, items[start[:, None] + (at + ahead).clamp(max=(n - 1)[:, None])], 0)
    # each row's whole history as sorted (row, item) keys
    row_of = torch.repeat_interleave(torch.arange(len(rows), device=device), n)
    first = torch.zeros(len(rows), dtype=torch.int64, device=device)
    first[1:] = n.cumsum(0)[:-1]
    at_event = torch.arange(len(row_of), device=device) - first[row_of]
    hist_keys = torch.sort(row_of * (n_items + 1) + items[start[row_of] + at_event]).values
    neg = _negatives(hist_keys, len(rows), seq, valid.sum(dim=1), n_items, gen, device)
    shape = (p, batch_size, seq)
    return {"history_item_idx": hist.view(shape), "pos_item_idx": pos.view(shape),
            "neg_item_idx": neg.view(shape)}


def recommend_pool(dataset: dict, users_per_call: int, seq: int, mix: dict, seed: int, device
                   ) -> list[dict]:
    """The pool's calls: ``users`` users (``"dataset"``: all of the
    dataset's) in batches of ``users_per_call``; each a dict of int32
    ``history_window`` (U, S), ``history_full`` (U, H), ``targets`` (U, 1),
    ``n_targets`` (U,) and the count of real users ``n_real`` (the last
    batch is padded with empty users)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = dataset["users"] if mix["users"] == "dataset" else int(mix["users"])
    lengths = _deal(dataset, u, gen, device)
    items, offsets = walk(lengths, dataset["items"], mix, gen, device)
    calls = []
    for lo in range(0, u, users_per_call):
        hi = min(lo + users_per_call, u)
        n = lengths[lo:hi]
        h = n - 1  # the history before the target
        start = offsets[lo:hi]
        width = 1 << max(int(h.max()) - 1, 0).bit_length()
        span = torch.arange(width, device=device)[None, :]
        full = torch.where(span < h[:, None], items[(start[:, None] + span).clamp(
            max=len(items) - 1)], 0)
        w_start = (h - seq).clamp(min=0)
        s_span = torch.arange(seq, device=device)[None, :]
        at = ((start + w_start)[:, None] + s_span).clamp(max=len(items) - 1)
        window = torch.where(s_span < (h - w_start)[:, None], items[at], 0)
        target = items[start + h][:, None]
        pad = users_per_call - (hi - lo)

        def padded(t):
            return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]).to(torch.int32)

        calls.append({"history_window": padded(window), "history_full": padded(full),
                      "targets": padded(target), "n_targets": padded(torch.ones_like(h)),
                      "n_real": hi - lo})
    return calls
