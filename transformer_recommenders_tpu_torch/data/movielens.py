"""MovieLens ETL: download, parse, split and process (host-side).

Counterpart of ``transformer_recommenders_tpu/data/movielens.py`` on numpy
and the standard library (no pandas or pyarrow).  A frame is a dict of
equal-length numpy columns, string columns as object arrays.  The split
and the per-user processing give the JAX package's values; the artifacts
differ in format only:

- ``items.json`` and ``users.json``: JSON lists of records with the JAX
  parquet files' fields (a user's ``history`` and ``target`` are dicts of
  lists: ``datetime``, ``event_name``, ``event_value``, ``label``,
  ``item_id``, ``item_text``);
- ``events.npz``: the split events' own columns (``user_id``,
  ``item_id``, ``event_value``, ``datetime``, ``event_name``, ``label``
  and the four split flags).  The joined ``item_text``/``user_text``
  columns of JAX's ``events.parquet`` are not stored: they are the items'
  and users' texts by id, joined again on load.

The download functions use ``urllib``; nothing in the tests or the smoke
run calls them.
"""

from __future__ import annotations

import csv
import json
import pathlib
import shutil
import tempfile
import urllib.request

import numpy as np

from transformer_recommenders_tpu_torch.params import DATA_DIR, MOVIELENS_1M_URL

Frame = dict[str, np.ndarray]

SPLIT_FLAGS = ("is_train", "is_val", "is_test", "is_predict")
ML100K_GENRES = [
    "unknown", "Action", "Adventure", "Animation", "Children's", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror",
    "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]


def _strings(values) -> np.ndarray:
    out = np.empty(len(values), object)
    out[:] = list(values)
    return out


# ---------------------------------------------------------------------------
# download (needs network access; nothing in the tests or smoke run calls it)
# ---------------------------------------------------------------------------


def download_data(
    url: str = MOVIELENS_1M_URL, dest_dir: str = DATA_DIR, *, overwrite: bool = False
) -> pathlib.Path:
    """Stream the archive to ``dest_dir``; idempotent unless ``overwrite``."""
    dest = pathlib.Path(dest_dir, pathlib.Path(url).name)
    dest.parent.mkdir(parents=True, exist_ok=True)
    if not dest.exists() or overwrite:
        with urllib.request.urlopen(url) as resp:  # noqa: S310 - a fixed https URL
            with tempfile.NamedTemporaryFile(delete=False, dir=dest.parent) as f:
                shutil.copyfileobj(resp, f)
        pathlib.Path(f.name).rename(dest)
    return dest


def unpack_data(archive_file: str | pathlib.Path, *, overwrite: bool = False) -> list[str]:
    """Unpack next to the archive."""
    archive_file = pathlib.Path(archive_file)
    dest_dir = archive_file.parent / archive_file.stem
    if not dest_dir.exists() or overwrite:
        shutil.unpack_archive(archive_file, dest_dir.parent)
    return [p.name for p in dest_dir.iterdir()]


def download_unpack_data(
    url: str = MOVIELENS_1M_URL, dest_dir: str = DATA_DIR, *, overwrite: bool = False
) -> list[str]:
    return unpack_data(download_data(url, dest_dir, overwrite=overwrite), overwrite=overwrite)


# ---------------------------------------------------------------------------
# raw loaders
# ---------------------------------------------------------------------------


def _rows(path: pathlib.Path, sep: str, encoding: str = "utf-8") -> list[list[str]]:
    with open(path, encoding=encoding) as f:
        return [line.rstrip("\r\n").split(sep) for line in f if line.strip()]


def _csv_rows(path: pathlib.Path) -> tuple[list[str], list[list[str]]]:
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        return header, [row for row in reader if row]


def _json(payload: dict) -> str:
    return json.dumps(payload, separators=(",", ":"))


def load_items(src_dir: str = DATA_DIR, dataset: str = "ml-1m") -> Frame:
    """Items with JSON ``item_text`` = {"title", "genres"}."""
    root = pathlib.Path(src_dir, dataset)
    if dataset == "ml-1m":
        rows = _rows(root / "movies.dat", "::", "iso-8859-1")
        ids = [r[0] for r in rows]
        texts = [_json({"title": r[1], "genres": r[2].split("|")}) for r in rows]
    elif dataset == "ml-100k":
        rows = _rows(root / "u.item", "|", "iso-8859-1")
        ids = [r[0] for r in rows]
        texts = [
            _json({"title": r[1],
                   "genres": [ML100K_GENRES[i] for i, flag in enumerate(r[5:24]) if int(flag)]})
            for r in rows
        ]
    elif dataset == "ml-25m":
        header, rows = _csv_rows(root / "movies.csv")
        col = {name: i for i, name in enumerate(header)}
        ids = [r[col["movieId"]] for r in rows]
        texts = [_json({"title": r[col["title"]], "genres": r[col["genres"]].split("|")})
                 for r in rows]
    else:
        msg = f"unknown dataset: {dataset}"
        raise ValueError(msg)
    return {"item_id": _strings(ids), "item_text": _strings(texts)}


def load_users(src_dir: str = DATA_DIR, dataset: str = "ml-1m") -> Frame:
    """Users with JSON ``user_text`` demographics (ml-25m publishes none:
    empty JSON)."""
    root = pathlib.Path(src_dir, dataset)
    if dataset == "ml-1m":
        rows = _rows(root / "users.dat", "::")
        ids = [r[0] for r in rows]
        texts = [_json({"gender": r[1], "age": int(r[2]), "occupation": int(r[3]),
                        "zipcode": r[4]}) for r in rows]
    elif dataset == "ml-100k":
        rows = _rows(root / "u.user", "|")
        ids = [r[0] for r in rows]
        texts = [_json({"gender": r[2], "age": int(r[1]), "occupation": r[3],
                        "zipcode": r[4]}) for r in rows]
    elif dataset == "ml-25m":
        header, rows = _csv_rows(root / "ratings.csv")
        col = header.index("userId")
        ids = list(dict.fromkeys(r[col] for r in rows))
        texts = ["{}"] * len(ids)
    else:
        msg = f"unknown dataset: {dataset}"
        raise ValueError(msg)
    return {"user_id": _strings(ids), "user_text": _strings(texts)}


def _events(users, items, values, times, value_dtype) -> Frame:
    n = len(users)
    return {
        "user_id": _strings(users),
        "item_id": _strings(items),
        "event_value": np.asarray(values, value_dtype),
        "datetime": np.asarray(times, np.int64),
        "event_name": _strings(["rating"] * n),
        "label": np.ones(n, bool),
    }


def load_events(src_dir: str = DATA_DIR, dataset: str = "ml-1m") -> Frame:
    """Rating events: user_id, item_id, event_value, datetime (epoch s),
    event_name="rating", label=True (every rating is a positive)."""
    root = pathlib.Path(src_dir, dataset)
    if dataset in ("ml-1m", "ml-100k"):
        rows = (_rows(root / "ratings.dat", "::") if dataset == "ml-1m"
                else _rows(root / "u.data", "\t"))
        cols = list(zip(*rows)) if rows else [(), (), (), ()]
        return _events(cols[0], cols[1], [int(v) for v in cols[2]],
                       [int(v) for v in cols[3]], np.int32)
    if dataset == "ml-25m":
        header, rows = _csv_rows(root / "ratings.csv")
        c = {name: i for i, name in enumerate(header)}
        return _events([r[c["userId"]] for r in rows], [r[c["movieId"]] for r in rows],
                       [float(r[c["rating"]]) for r in rows],
                       [int(r[c["timestamp"]]) for r in rows], np.float32)
    msg = f"unknown dataset: {dataset}"
    raise ValueError(msg)


# ---------------------------------------------------------------------------
# split + processing
# ---------------------------------------------------------------------------


def train_test_split(
    events: Frame,
    *,
    group_col: str = "user_id",
    order_col: str = "datetime",
    train_prop: float = 0.8,
    val_prop: float = 0.2,
) -> Frame:
    """Per-user temporal split, the JAX package's (pandas ``rank``) on
    sorted numpy arrays:

    - within each user, rank events by time (min rank for ties); the
      earliest ``train_prop`` fraction -> train;
    - users are ranked by their leftover (non-train) event count; the top
      ``val_prop`` of those users contribute the val set, the rest test;
    - ``is_predict`` is always True."""
    events = dict(events)
    n = len(events[order_col])
    _, group = np.unique(events[group_col].astype(str), return_inverse=True)
    order = np.lexsort((events[order_col], group))
    g_sorted, t_sorted = group[order], events[order_col][order]
    idx = np.arange(n)
    new_group = np.ones(n, bool)
    new_group[1:] = g_sorted[1:] != g_sorted[:-1]
    new_tie = new_group.copy()
    new_tie[1:] |= t_sorted[1:] != t_sorted[:-1]
    group_start = np.maximum.accumulate(np.where(new_group, idx, 0))
    tie_start = np.maximum.accumulate(np.where(new_tie, idx, 0))
    rank = np.empty(n, np.float64)
    rank[order] = tie_start - group_start  # rank(method="min") - 1
    count = np.bincount(group)[group]
    is_train = (rank / count) < train_prop

    leftover = np.bincount(group[~is_train], minlength=group.max(initial=-1) + 1)
    has_left = leftover > 0
    left = leftover[has_left]
    val_group = np.zeros(len(leftover), bool)
    if len(left) > 0:
        below = np.searchsorted(np.sort(left), left, side="left")  # rank(min) - 1
        val_group[np.flatnonzero(has_left)] = below / len(left) >= 1 - val_prop
    in_val_user = val_group[group] if n else np.zeros(0, bool)
    events["is_train"] = is_train
    events["is_val"] = ~is_train & in_val_user
    events["is_test"] = ~is_train & ~in_val_user
    events["is_predict"] = np.ones(n, bool)
    return events


def _lookup(ids: np.ndarray, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
    """``values`` of ``keys`` at each of ``ids`` (None where absent): the
    JAX package's left merge on a unique key."""
    table = dict(zip(keys.tolist(), values.tolist()))
    return _strings([table.get(i) for i in ids.tolist()])


_EVENT_COLS = ("user_id", "item_id", "event_value", "datetime", "event_name", "label",
               *SPLIT_FLAGS)


def process_events(
    events: Frame,
    items: Frame,
    users: Frame,
    *,
    out_dir: pathlib.Path,
    overwrite: bool = False,
) -> Frame:
    """Split events joined with the items' and users' texts; writes
    ``events.npz`` (without the joined texts)."""
    out = out_dir / "events.npz"
    if out.exists() and not overwrite:
        with np.load(out) as data:
            events = {k: data[k] for k in data.files}
        for k in ("user_id", "item_id", "event_name"):
            events[k] = _strings(events[k].tolist())
    else:
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savez(out, **{k: (events[k].astype(str) if events[k].dtype == object else events[k])
                         for k in _EVENT_COLS})
    df = dict(events)
    df["item_text"] = _lookup(df["item_id"], items["item_id"], items["item_text"])
    df["user_text"] = _lookup(df["user_id"], users["user_id"], users["user_text"])
    return df


def _write_records(path: pathlib.Path, records: list[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(records, separators=(",", ":")))
    tmp.replace(path)


def read_records(path: str | pathlib.Path) -> list[dict]:
    return json.loads(pathlib.Path(path).read_text())


def process_items(
    items: Frame,
    events: Frame,
    *,
    out_dir: pathlib.Path,
    overwrite: bool = False,
) -> list[dict]:
    """``items.json``: the items with an any(is_train) flag."""
    out = out_dir / "items.json"
    if out.exists() and not overwrite:
        return read_records(out)
    trained = set(events["item_id"][events["is_train"]].tolist())
    records = [
        {"item_id": i, "item_text": t, "is_train": i in trained, "is_val": True,
         "is_test": True, "is_predict": True}
        for i, t in zip(items["item_id"].tolist(), items["item_text"].tolist())
    ]
    _write_records(out, records)
    return records


def _grouped_lists(events: Frame, mask: np.ndarray, user_ids: list) -> list[dict]:
    """Per user of ``user_ids``, the activity lists of its events under
    ``mask`` in time order (ties in event order); empty lists for users
    without any."""
    rows = np.flatnonzero(mask)
    uid = events["user_id"][rows].astype(str)
    order = np.lexsort((events["datetime"][rows], uid))
    rows, uid = rows[order], uid[order]
    cols = {
        "datetime": events["datetime"][rows].astype(np.int64).tolist(),
        "event_name": events["event_name"][rows].tolist(),
        "event_value": events["event_value"][rows].astype(np.float64).tolist(),
        "label": events["label"][rows].astype(bool).tolist(),
        "item_id": events["item_id"][rows].tolist(),
        "item_text": events["item_text"][rows].tolist(),
    }
    starts = np.searchsorted(uid, np.asarray(user_ids, str), side="left") if len(user_ids) else []
    ends = np.searchsorted(uid, np.asarray(user_ids, str), side="right") if len(user_ids) else []
    return [{k: v[lo:hi] for k, v in cols.items()} for lo, hi in zip(starts, ends)]


def process_users(
    users: Frame,
    events: Frame,
    *,
    out_dir: pathlib.Path,
    overwrite: bool = False,
) -> list[dict]:
    """``users.json``: per user its ``history`` (train events) and
    ``target`` (the other events) activity lists, sorted by time, and
    any() of each split flag over its events."""
    out = out_dir / "users.json"
    if out.exists() and not overwrite:
        return read_records(out)
    user_ids = users["user_id"].tolist()
    train = events["is_train"].astype(bool)
    history = _grouped_lists(events, train, user_ids)
    target = _grouped_lists(events, ~train, user_ids)
    uid = events["user_id"].astype(str)
    flags = {f: set(uid[events[f].astype(bool)].tolist()) for f in SPLIT_FLAGS[:3]}
    records = [
        {"user_id": u, "user_text": text, "history": h, "target": t,
         **{f: u in flags[f] for f in SPLIT_FLAGS[:3]}, "is_predict": True}
        for u, text, h, t in zip(user_ids, users["user_text"].tolist(), history, target)
    ]
    _write_records(out, records)
    return records


def prepare_movielens(
    src_dir: str = DATA_DIR,
    dataset: str = "ml-1m",
    *,
    overwrite: bool = False,
    raw: tuple[Frame, Frame, Frame] | None = None,
) -> Frame:
    """Run the full ETL.  ``raw`` injects pre-built (items, users, events)
    frames (the synthetic generator's)."""
    out_dir = pathlib.Path(src_dir, dataset)
    if raw is not None:
        items, users, events = raw
    else:
        items = load_items(src_dir, dataset)
        users = load_users(src_dir, dataset)
        events = load_events(src_dir, dataset)
    events = train_test_split(events)
    events = process_events(events, items, users, out_dir=out_dir, overwrite=overwrite)
    process_items(items, events, out_dir=out_dir, overwrite=overwrite)
    process_users(users, events, out_dir=out_dir, overwrite=overwrite)
    return events
