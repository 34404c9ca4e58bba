"""Synthetic MovieLens-compatible dataset generator (JAX
``data/synthetic.py``).

Emits raw frames in the raw loaders' schema and runs the real split and
processing (``movielens.prepare_movielens`` with ``raw=``).  The draws are
the JAX package's, in the same order, so one seed gives the same raw
frames in both packages.  Items live on a ring of genres; each user
random-walks with popularity (zipf) mixing, so the next item is
predictable from recent history.
"""

from __future__ import annotations

import bisect
import json
import pathlib

import numpy as np

from transformer_recommenders_tpu_torch.data import movielens
from transformer_recommenders_tpu_torch.data.movielens import Frame, _strings

GENRES = [
    "Action", "Comedy", "Drama", "Horror", "Romance", "Sci-Fi", "Thriller",
    "Animation", "Documentary", "Fantasy",
]


def generate_raw(
    num_users: int = 200,
    num_items: int = 500,
    num_events: int = 20_000,
    seed: int = 0,
) -> tuple[Frame, Frame, Frame]:
    """Build (items, users, events) frames in the raw-loader schema."""
    rng = np.random.default_rng(seed)

    item_ids = [str(i + 1) for i in range(num_items)]
    items = {
        "item_id": _strings(item_ids),
        "item_text": _strings([
            json.dumps({"title": f"Movie {i + 1} ({1990 + i % 30})",
                        "genres": [GENRES[i % len(GENRES)]]}, separators=(",", ":"))
            for i in range(num_items)
        ]),
    }

    user_ids = [str(u + 1) for u in range(num_users)]
    users = {
        "user_id": _strings(user_ids),
        "user_text": _strings([
            json.dumps(
                {
                    "gender": "MF"[int(rng.integers(2))],
                    "age": int(rng.choice([1, 18, 25, 35, 45, 50, 56])),
                    "occupation": int(rng.integers(21)),
                    "zipcode": f"{rng.integers(10000, 99999)}",
                },
                separators=(",", ":"),
            )
            for _ in user_ids
        ]),
    }

    # popularity: zipf-ish weights
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    pop /= pop.sum()

    events_per_user = rng.multinomial(num_events - 5 * num_users, np.full(num_users, 1 / num_users))
    events_per_user += 5  # every user gets at least 5 events

    if num_events >= 2_000_000:
        events = _events_vectorized(rng, num_items, events_per_user, pop)
    else:
        events = _events_loop(rng, user_ids, item_ids, num_items, events_per_user, pop)
    n = len(events["user_id"])
    events["event_name"] = _strings(["rating"] * n)
    events["label"] = np.ones(n, bool)
    return items, users, events


def _popularity_draw(rng: np.random.Generator, cdf: list[float]) -> int:
    """``rng.choice(len(cdf), p=pop)`` with the cdf computed once:
    ``Generator.choice`` draws one ``random()`` and takes
    ``cdf.searchsorted(u, side="right")``, which is what this does."""
    return bisect.bisect_right(cdf, rng.random())


def _events_loop(rng, user_ids, item_ids, num_items, events_per_user, pop) -> Frame:
    """The per-event walk (datasets under 2M events): the JAX package's
    loop, draw for draw."""
    cdf = pop.cumsum()
    cdf /= cdf[-1]
    cdf = cdf.tolist()
    rows_user, rows_item, rows_time, rows_val = [], [], [], []
    t0 = 978_300_000  # ~2001, like ml-1m timestamps
    for u, n in enumerate(events_per_user):
        # random walk: next item near the previous one on the ring w.p. 0.7
        cur = _popularity_draw(rng, cdf)
        t = t0 + int(rng.integers(0, 10_000_000))
        uid = user_ids[u]
        for _ in range(int(n)):
            rows_user.append(uid)
            rows_item.append(item_ids[cur])
            rows_time.append(t)
            rows_val.append(int(rng.integers(1, 6)))
            t += int(rng.integers(60, 100_000))
            if rng.random() < 0.7:
                cur = (cur + int(rng.integers(1, 4))) % num_items
            else:
                cur = _popularity_draw(rng, cdf)
    return {
        "user_id": _strings(rows_user),
        "item_id": _strings(rows_item),
        "event_value": np.asarray(rows_val, np.int32),
        "datetime": np.asarray(rows_time, np.int64),
    }


def _events_vectorized(rng, num_items, events_per_user, pop) -> Frame:
    """The same ring walk in a handful of length-E numpy passes (datasets
    of 2M events and more), the JAX package's draws: a popularity jump with
    p = 0.3 (always at a user's first event), otherwise a ring step of
    1..3; positions and timestamps by segmented cumulative sums."""
    counts = events_per_user.astype(np.int64)
    e_total = int(counts.sum())
    first_idx = np.concatenate([[0], np.cumsum(counts)[:-1]])
    is_first = np.zeros(e_total, bool)
    is_first[first_idx] = True

    jumps = (rng.random(e_total) < 0.3) | is_first
    jump_vals = rng.choice(num_items, size=e_total, p=pop)
    steps = rng.integers(1, 4, size=e_total)
    cs = np.cumsum(steps)
    last_jump = np.maximum.accumulate(np.where(jumps, np.arange(e_total), 0))
    item_pos = (jump_vals[last_jump] + (cs - cs[last_jump])) % num_items

    incs = rng.integers(60, 100_000, size=e_total)
    cs_t = np.cumsum(incs)
    t0s = 978_300_000 + rng.integers(0, 10_000_000, size=len(counts))
    user_first = np.repeat(first_idx, counts)
    times = np.repeat(t0s, counts) + (cs_t - cs_t[user_first])

    user_num = np.repeat(np.arange(1, len(counts) + 1), counts)
    return {
        "user_id": user_num.astype(str).astype(object),
        "item_id": (item_pos + 1).astype(str).astype(object),
        "event_value": rng.integers(1, 6, size=e_total).astype(np.int32),
        "datetime": times.astype(np.int64),
    }


def prepare_synthetic(
    data_dir: str,
    *,
    num_users: int = 200,
    num_items: int = 500,
    num_events: int = 20_000,
    seed: int = 0,
    overwrite: bool = False,
) -> pathlib.Path:
    """Generate and run the shared ETL into ``<data_dir>/synthetic/``;
    returns that directory."""
    out_dir = pathlib.Path(data_dir, "synthetic")
    if not overwrite and (out_dir / "users.json").exists():
        return out_dir
    raw = generate_raw(num_users, num_items, num_events, seed)
    movielens.prepare_movielens(data_dir, "synthetic", overwrite=overwrite, raw=raw)
    return out_dir
