"""The port's data layer against the JAX package's on the CPU.

Every comparison here is exact (strings, ints, bools and float64 values
equal; the hash embeddings and the batches equal bit for bit): both
packages compute the same values from the same inputs, the port on numpy
and the standard library, the JAX package on pandas and pyarrow.

- the YAML reader against ``yaml.safe_load`` on every ``configs/*.yaml``
  and on scalars;
- the synthetic generator's raw frames from one seed, the split and the
  processed artifacts (the port's JSON records against JAX's parquet,
  field by field), at sizes under and over the vectorized walk's 2M-event
  threshold (the latter only through ``_events_vectorized``, at a small
  size);
- MovieLens processing of small raw files in ML-1M's ``::`` format,
  ML-100K's tab and pipe format and ML-25M's CSV;
- ``SeqData`` batches from one seed, numpy backend and native backend
  (the latter skipped only without ``g++``, as JAX's native-sampler tests
  are);
- the data modules' embeddings, train rows, batches and ``EvalArrays``
  over each split, and the data CLI.
"""

import functools
import json
import pathlib
import shutil

import numpy as np
import pandas as pd
import pytest
import yaml

from transformer_recommenders_tpu.configs import SeqDataConfig as JaxSeqDataConfig
from transformer_recommenders_tpu.configs import SeqDataModuleConfig as JaxDataConfig
from transformer_recommenders_tpu.data import dataset as jax_dataset
from transformer_recommenders_tpu.data import module as jax_module
from transformer_recommenders_tpu.data import movielens as JM
from transformer_recommenders_tpu.data import synthetic as JS
from transformer_recommenders_tpu.data.embeddings import hash_embed_texts as jax_hash
from transformer_recommenders_tpu_torch import configs as TC
from transformer_recommenders_tpu_torch.data import cli as data_cli
from transformer_recommenders_tpu_torch.data import module as port_module
from transformer_recommenders_tpu_torch.data import movielens as TM
from transformer_recommenders_tpu_torch.data import synthetic as TS
from transformer_recommenders_tpu_torch.data.dataset import SeqData
from transformer_recommenders_tpu_torch.data.embeddings import embed_item_texts, hash_embed_texts
from transformer_recommenders_tpu_torch.data.module import SeqDataModule
from transformer_recommenders_tpu_torch.native import load_native_sampler

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


# -- the YAML reader -------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_matches_safe_load(path):
    text = path.read_text()
    parsed = TC.parse_yaml(text)
    assert parsed == yaml.safe_load(text)
    TC.TrainConfig.from_dict(parsed["model"])
    TC.SeqDataModuleConfig.from_dict(parsed["data"])


@pytest.mark.parametrize("text", [
    "3e-3", "0.003", "1.5e+3", "12", "-3", "+1", "1_000", "0", "true", "False", "yes", "off",
    "null", "~", ".inf", "-.inf", "abc", "'a''b'", '"x y"', "InfoNCELoss", "ml-1m",
])
def test_yaml_scalars_match_safe_load(text):
    assert TC.parse_yaml_scalar(text) == yaml.safe_load(text)
    assert TC.parse_yaml(f"k: {text}  # note\n") == yaml.safe_load(f"k: {text}  # note\n")


def test_yaml_reader_rejects_other_constructs():
    for text in ("a:\n  - 1\n", "a: [1, 2]\n", "a: {b: 1}\n", "a: &x 1\n"):
        with pytest.raises(ValueError, match="unsupported"):
            TC.parse_yaml(text)


def test_config_from_dict_coerces_as_pydantic():
    from transformer_recommenders_tpu.configs import TrainConfig as JaxTrainConfig

    payload = {"learning_rate": "3e-3", "max_epochs": "2", "weight_decay": 0,
               "use_mlflow": "false", "items_config": {"top_k": 5}, "mesh": {}}
    port, jax_cfg = TC.TrainConfig.from_dict(payload), JaxTrainConfig.model_validate(payload)
    for name in ("learning_rate", "max_epochs", "weight_decay", "use_mlflow"):
        assert getattr(port, name) == getattr(jax_cfg, name)
        assert type(getattr(port, name)) is type(getattr(jax_cfg, name))
    assert port.items_config.top_k == 5 and port.users_config.embedding_col is None
    with pytest.raises(ValueError):
        TC.SeqDataModuleConfig(dataset="ml-2m")


# -- raw frames, split and artifacts ------------------------------------------------


def assert_frame_equal(jax_frame: pd.DataFrame, port_frame: dict):
    assert list(jax_frame.columns) == list(port_frame)
    for col in jax_frame.columns:
        assert jax_frame[col].tolist() == port_frame[col].tolist(), col


def assert_artifacts_equal(jax_dir: pathlib.Path, port_dir: pathlib.Path):
    """JAX's parquet artifacts against the port's JSON records, field by
    field, and the split flags of every event."""
    jitems = pd.read_parquet(jax_dir / "items.parquet")
    assert jitems.to_dict("records") == TM.read_records(port_dir / "items.json")
    jusers = pd.read_parquet(jax_dir / "users.parquet")
    pusers = TM.read_records(port_dir / "users.json")
    assert len(jusers) == len(pusers)
    for (_, jrow), prow in zip(jusers.iterrows(), pusers):
        assert set(jrow.index) == set(prow)
        for key in ("user_id", "user_text", "is_train", "is_val", "is_test", "is_predict"):
            assert jrow[key] == prow[key], key
        for part in ("history", "target"):
            assert set(jrow[part]) == set(prow[part])
            for field, values in jrow[part].items():
                assert list(values) == prow[part][field], (part, field)
    jevents = pd.read_parquet(jax_dir / "events.parquet")
    with np.load(port_dir / "events.npz") as pevents:
        for col in ("user_id", "item_id", "event_value", "datetime", "is_train", "is_val",
                    "is_test", "is_predict"):
            assert jevents[col].tolist() == pevents[col].tolist(), col


@pytest.mark.parametrize("size", [(30, 50, 1500, 0), (200, 300, 20000, 3)])
def test_synthetic_frames_split_and_artifacts_equal(tmp_path, size):
    jraw, praw = JS.generate_raw(*size), TS.generate_raw(*size)
    for jframe, pframe in zip(jraw, praw):
        assert_frame_equal(jframe, pframe)
    JM.prepare_movielens(str(tmp_path / "jax"), "synthetic", raw=jraw)
    TM.prepare_movielens(str(tmp_path / "port"), "synthetic", raw=praw)
    assert_artifacts_equal(tmp_path / "jax" / "synthetic", tmp_path / "port" / "synthetic")


def test_vectorized_walk_equal():
    """The >= 2M-event walk, through its function at a small size."""
    rng_args = dict(num_items=40, events_per_user=np.asarray([5, 9, 7, 12]),
                    pop=np.full(40, 1 / 40))
    jframe = JS._events_vectorized(np.random.default_rng(4), **rng_args)
    pframe = TS._events_vectorized(np.random.default_rng(4), **rng_args)
    assert_frame_equal(jframe, pframe)


@pytest.mark.parametrize("train_prop,val_prop", [(0.8, 0.2), (0.6, 0.5), (0.5, 0.34)])
def test_split_with_ties_equal(train_prop, val_prop):
    rng = np.random.default_rng(11)
    n = 400
    users = rng.integers(1, 25, size=n).astype(str)
    times = rng.integers(0, 30, size=n)  # many ties within a user
    jevents = pd.DataFrame({"user_id": users, "item_id": np.arange(n).astype(str),
                            "datetime": times})
    pevents = {"user_id": users.astype(object), "item_id": np.arange(n).astype(str).astype(object),
               "datetime": times.astype(np.int64)}
    jout = JM.train_test_split(jevents, train_prop=train_prop, val_prop=val_prop)
    pout = TM.train_test_split(pevents, train_prop=train_prop, val_prop=val_prop)
    for flag in ("is_train", "is_val", "is_test", "is_predict"):
        assert jout[flag].tolist() == pout[flag].tolist(), flag
    assert pout["is_val"].any() and pout["is_test"].any()


def write_raw(root: pathlib.Path, dataset: str) -> None:
    """A few items, users and ratings in ``dataset``'s raw format."""
    d = root / dataset
    d.mkdir(parents=True)
    rng = np.random.default_rng(5)
    ratings = [(u, int(rng.integers(1, 6)), int(rng.integers(1, 6)),
                978300000 + int(rng.integers(0, 50)))
               for u in range(1, 8) for _ in range(3 + u)]
    if dataset == "ml-1m":
        (d / "movies.dat").write_bytes(
            "1::Toy Story (1995)::Animation|Children's|Comedy\n"
            "2::Jumanji (1995)::Adventure|Children's|Fantasy\n"
            "3::Les Misérables (1995)::Drama\n"
            "4::Heat (1995)::Action|Crime|Thriller\n"
            "5::Sabrina (1995)::Comedy|Romance\n".encode("iso-8859-1"))
        (d / "users.dat").write_text("".join(f"{u}::{'FM'[u % 2]}::{u * 7}::{u + 3}::4806{u}\n"
                                             for u in range(1, 8)))
        (d / "ratings.dat").write_text("".join(f"{u}::{i}::{v}::{t}\n" for u, i, v, t in ratings))
    elif dataset == "ml-100k":
        flags = ["0|0|0|1|1|1|0|0|0|0|0|0|0|0|0|0|0|0|0", "0|1|0|0|0|0|0|0|1|0|0|0|0|0|0|0|0|0|0",
                 "1|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0", "0|0|0|0|0|0|0|0|0|0|0|0|0|0|1|1|0|0|0",
                 "0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|0|1"]
        (d / "u.item").write_bytes("".join(
            f"{i}|Film {i} (199{i})|01-Jan-199{i}||http://example.org/{i}|{flags[i - 1]}\n"
            for i in range(1, 6)).encode("iso-8859-1"))
        (d / "u.user").write_text("".join(f"{u}|{20 + u}|{'FM'[u % 2]}|writer|5500{u}\n"
                                          for u in range(1, 8)))
        (d / "u.data").write_text("".join(f"{u}\t{i}\t{v}\t{t}\n" for u, i, v, t in ratings))
    else:
        (d / "movies.csv").write_text(
            'movieId,title,genres\n1,Toy Story (1995),Animation|Comedy\n'
            '2,"American President, The (1995)",Comedy|Drama|Romance\n3,Heat (1995),Action\n'
            '4,Sabrina (1995),Comedy\n5,Nixon (1995),Drama\n')
        (d / "ratings.csv").write_text("userId,movieId,rating,timestamp\n" + "".join(
            f"{u},{i},{v}.5,{t}\n" for u, i, v, t in ratings))


@pytest.mark.parametrize("dataset", ["ml-1m", "ml-100k", "ml-25m"])
def test_movielens_processing_equal(tmp_path, dataset):
    for side in ("jax", "port"):
        write_raw(tmp_path / side, dataset)
    for load in ("load_items", "load_users", "load_events"):
        assert_frame_equal(getattr(JM, load)(str(tmp_path / "jax"), dataset),
                           getattr(TM, load)(str(tmp_path / "port"), dataset))
    JM.prepare_movielens(str(tmp_path / "jax"), dataset)
    TM.prepare_movielens(str(tmp_path / "port"), dataset)
    assert_artifacts_equal(tmp_path / "jax" / dataset, tmp_path / "port" / dataset)
    # a second prepare reads the artifacts back: the same frame
    again = TM.prepare_movielens(str(tmp_path / "port"), dataset)
    first = TM.train_test_split(TM.load_events(str(tmp_path / "port"), dataset))
    for col in ("user_id", "item_id", "is_train", "is_val"):
        assert again[col].tolist() == first[col].tolist()


def test_hash_embeddings_equal():
    texts = ['{"title":"Star Wars (1977)","genres":["Sci-Fi"]}', "plain words here", "",
             '{"gender":"F","age":25}', "Les Misérables"]
    for dim in (32, 384):
        np.testing.assert_array_equal(hash_embed_texts(texts, dim), jax_hash(texts, dim))


def test_sentence_transformer_raises_without_the_model():
    with pytest.raises(RuntimeError, match="embedder='hash'"):
        embed_item_texts(["x"], embedder="sentence-transformer",
                         model_name="no-such-org/no-such-model")


# -- the sampler ------------------------------------------------------------------


def sampler_inputs(n_items=40, n_users=30, seed=2):
    rng = np.random.default_rng(seed)
    item_ids = [f"i{k}" for k in range(1, n_items + 1)]
    histories = []
    for _ in range(n_users):
        n = int(rng.integers(1, 3 * n_items // 2))
        ids = np.asarray([f"i{k}" for k in rng.integers(1, n_items + 6, size=n)])  # some unknown
        histories.append((ids, rng.random(n) < 0.8))
    return item_ids, histories


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("max_seq,lookahead,n_items", [(8, 0, 40), (4, 2, 40), (16, 0, 12)])
def test_seqdata_batches_equal(backend, max_seq, lookahead, n_items):
    if backend == "native" and load_native_sampler() is None:
        pytest.skip("no C++ toolchain for the native sampler")
    item_ids, histories = sampler_inputs(n_items)
    kw = dict(item_ids=item_ids, histories=histories, seed=7, backend=backend)
    jax_sd = jax_dataset.SeqData(JaxSeqDataConfig(max_seq_length=max_seq,
                                                  pos_lookahead=lookahead), **kw)
    port_sd = SeqData(TC.SeqDataConfig(max_seq_length=max_seq, pos_lookahead=lookahead), **kw)
    assert len(port_sd) == len(jax_sd) > 0
    for (ph, pl), (jh, jl) in zip(port_sd.rows, jax_sd.rows):
        np.testing.assert_array_equal(ph, jh)
        np.testing.assert_array_equal(pl, jl)
    for epoch in (0, 1):
        got = list(port_sd.epoch_batches(epoch, 8))
        want = list(jax_sd.epoch_batches(epoch, 8))
        assert len(got) == len(want) == port_sd.num_batches(8)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                assert g[key].dtype == np.int32
                np.testing.assert_array_equal(g[key], w[key])
        hist = got[0]["history_item_idx"]
        assert hist.shape == (8, max_seq) and (hist[:, 0] > 0).any()


# -- the data modules -----------------------------------------------------------------

DATA = dict(dataset="synthetic", embedder="hash", embedding_dim=32, max_seq_length=8,
            batch_size=4, synthetic_num_users=40, synthetic_num_items=60,
            synthetic_num_events=2500)


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    root = tmp_path_factory.mktemp("modules")
    jax_dm = jax_module.SeqDataModule(JaxDataConfig(data_dir=str(root / "jax"), **DATA))
    port_dm = SeqDataModule(TC.SeqDataModuleConfig(data_dir=str(root / "port"), **DATA))
    # the numpy sampler on both sides
    saved = jax_module.SeqData, port_module.SeqData
    jax_module.SeqData = functools.partial(jax_dataset.SeqData, backend="numpy")
    port_module.SeqData = functools.partial(SeqData, backend="numpy")
    try:
        for dm in (jax_dm, port_dm):
            dm.prepare_data()
            dm.setup()
    finally:
        jax_module.SeqData, port_module.SeqData = saved
    return jax_dm, port_dm


def test_module_setup_equal(modules):
    jax_dm, port_dm = modules
    assert port_dm.item_ids == jax_dm.item_ids
    np.testing.assert_array_equal(port_dm.item_embeddings, jax_dm.item_embeddings)
    assert len(port_dm.users) == len(jax_dm.users)
    assert [r["user_id"] for r in port_dm.users] == jax_dm.users["user_id"].tolist()
    for got, want in zip(port_dm.train_batches(0), jax_dm.train_batches(0)):
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("split", ["val", "test", "predict"])
def test_eval_arrays_equal(modules, split):
    jax_dm, port_dm = modules
    got, want = port_dm.eval_arrays(split), jax_dm.eval_arrays(split)
    assert len(got) == len(want) > 0
    assert got.user_ids == want.user_ids
    for a, b in zip(got.histories, want.histories):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.target_lists, want.target_lists):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.history_window, want.history_window)
    np.testing.assert_array_equal(got.n_targets, want.n_targets)
    for lo, hi in ((0, min(len(got), 7)), (1, min(len(got), 17))):
        for a, b in zip(got.batch(lo, hi, 16), want.batch(lo, hi, 16)):
            np.testing.assert_array_equal(a, b)
    assert got.head(5).user_ids == got.user_ids[:5]


def test_n_targets_counts_ids_outside_the_vocabulary(modules):
    _, port_dm = modules
    user = next(u for u in port_dm.users if u["is_val"])
    user["target"] = {**user["target"],
                      "item_id": [*user["target"]["item_id"], "unknown-item"],
                      "label": [*user["target"]["label"], True]}
    try:
        arrays = port_dm.eval_arrays("val")
        i = arrays.user_ids.index(user["user_id"])
        assert arrays.n_targets[i] == len(arrays.target_lists[i]) + 1
    finally:
        user["target"] = {k: v[:-1] for k, v in user["target"].items()}


def test_prepare_is_idempotent_and_cli_reports(modules, tmp_path, capsys):
    _, port_dm = modules
    users_json = port_dm.dataset_dir / "users.json"
    mtime = users_json.stat().st_mtime_ns
    port_dm.prepare_data()
    assert users_json.stat().st_mtime_ns == mtime
    shutil.copytree(port_dm.dataset_dir, tmp_path / "synthetic")
    data_cli.main(["--data_dir", str(tmp_path), "--dataset", "synthetic", "--embedder", "hash"])
    out = capsys.readouterr().out
    assert f"items={len(port_dm.items)} users={len(port_dm.users)}" in out
    assert json.loads((tmp_path / "synthetic" / "items.json").read_text())
