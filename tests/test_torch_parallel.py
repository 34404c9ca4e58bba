"""The port's parallel layer on the CPU: gloo worlds of spawned processes
against the port's single-device functions and the JAX package's sharded
functions on the same mesh shape (the conftest's virtual CPU devices).

Three worlds run at once, each a spawn of ``tests/test_torch_parallel_ranks.py``
(torch and the port only; JAX stays in this process): world 2 as meshes
2x1 and 1x2, world 4 as mesh 2x2.  Each rank runs every check of the
spec and returns its arrays through a pickle; a world that does not end
within ``SPAWN_TIMEOUT`` seconds is killed and its tests fail.  Inputs
come from numpy seeds, weights from JAX's init (``params_from_jax``), in
f32, dropout 0 (data ranks draw distinct dropout streams, as in JAX).

What is held, and how closely:

- ``create_mesh``: JAX's two ``ValueError``s (the model axis does not
  divide the world, the mesh exceeds it), and the port's third (a mesh
  that leaves ranks out), by message.
- The sharded lookup (duplicates, the padding row, rows the mesh padded,
  indices past the table and negative ones): bit for bit against the dense
  rows (zeros out of range) and JAX's ``sharded_table_lookup``.
- ``sharded_topk`` at k below and above the rows of a shard, with ties
  within and across shards and an all-zero query (every score tied), on
  exact-sum inputs (values k/8): dot scores and indices bit for bit
  against the port's dense ``topk_items`` and JAX's ``sharded_topk``;
  cosine indices equal and scores within 1e-6 relative of JAX's (their
  normalizations round alike to an ulp), bit for bit against the port's.
- The sharded loss and its flat gradient, the table branch (InfoNCE, a
  catalog within twice the pool), the pool branch (InfoNCE and
  PairwiseLogisticLoss through the kernels' plain versions, and the plain
  head with ``use_fused_loss=False``) and ``full_logs``: against the
  port's one-device ``make_loss_and_grad``, loss rtol 1e-6, gradients
  1e-5 of each leaf's max abs value (the ranks' partial sums add in
  another order), the 30 logs rtol 1e-5; against JAX's sharded loss with
  its loss kernels forced on and run in interpret mode (as
  ``test_torch_train_state.py``'s ``force_jax_kernels``; on its CPU
  backend JAX would run the plain f32 heads, and the kernels round their
  operands to bf16), or its plain head with ``use_fused_loss=False``: loss
  rtol 1e-5, gradients 1e-3 of the leaf max (the bounds of
  ``test_torch_train_state.py`` for f32: both score bf16-rounded operands
  with f32 sums in other orders), the logs rtol 1e-4 (atol 1e-5); JAX's
  sharded logging step logs its kernel objective under the train loss's
  two keys, where both packages' one-device steps and the port's sharded
  step log the plain head, so those are held to the plain case.
  Positive and negative items come from disjoint ranges, so the
  false-negative mask never meets a copy of the positive.
- Three scanned sharded steps (the eager loop under gloo) against three
  looped sharded train steps: bit for bit; against the port's one-device
  scanned steps, SGD at lr 1e-4 on both sides: parameters within 1e-7,
  losses rtol 1e-6.
- ``ShardedEvaluator`` against the port's ``Evaluator`` (every user's
  top-k indices equal, scores and metric means within 1e-6) and JAX's
  ``ShardedEvaluator`` (indices equal, scores and means within 1e-5, on
  inputs without near ties).
- A ``Trainer`` fit on the 2x2 mesh of ``configs/synthetic_smoke.yaml``'s
  shapes, 4 steps, the mask off, plain heads, SGD at lr 1e-4 (as
  ``test_torch_trainer.py``'s JAX parity test), against the port's
  one-device fit: parameters within 1e-6, val metrics within 1e-5; only
  rank 0 wrote logs and checkpoints.
"""

import dataclasses
import functools
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.configs import MeshConfig as JaxMeshConfig
from transformer_recommenders_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_recommenders_tpu.data.module import EvalArrays as JaxEvalArrays
from transformer_recommenders_tpu.models import transformer as JT
from transformer_recommenders_tpu.ops import fused_infonce as JFI
from transformer_recommenders_tpu.ops import fused_pairwise as JFP
from transformer_recommenders_tpu.ops import fused_table_infonce as JFT
from transformer_recommenders_tpu.parallel import embedding as JPE
from transformer_recommenders_tpu.parallel import mesh as JPM
from transformer_recommenders_tpu.parallel.topk_sharded import sharded_topk as jax_sharded_topk
from transformer_recommenders_tpu.parallel.train import make_sharded_loss as jax_sharded_loss
from transformer_recommenders_tpu.training import train_state as JTS
from transformer_recommenders_tpu.training.evaluator import (
    ShardedEvaluator as JaxShardedEvaluator,
)
from transformer_recommenders_tpu_torch.configs import (
    SeqDataModuleConfig,
    TrainConfig,
    parse_yaml,
)
from transformer_recommenders_tpu_torch.data import module as port_module
from transformer_recommenders_tpu_torch.data.dataset import SeqData
from transformer_recommenders_tpu_torch.data.module import EvalArrays, SeqDataModule
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel
from transformer_recommenders_tpu_torch.ops.topk import topk_items
from transformer_recommenders_tpu_torch.training import scan_steps as TSS
from transformer_recommenders_tpu_torch.training import train_state as TTS
from transformer_recommenders_tpu_torch.training.evaluator import Evaluator
from transformer_recommenders_tpu_torch.training.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
RANKS = pathlib.Path(__file__).with_name("test_torch_parallel_ranks.py")
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
SPAWN_TIMEOUT = 150
LAYERS = 2
SETTINGS = dict(input_dim=48, hidden_size=32, num_hidden_layers=LAYERS, num_attention_heads=4,
                intermediate_size=48, max_seq_length=8, hidden_dropout=0.0,
                attention_dropout=0.0, compute_dtype="float32", learning_rate=1e-3)
LOSS_CASES = {  # name: (config overrides, catalog size, full_logs)
    "table": ({}, 40, False),
    "pool": ({}, 150, False),
    "pairwise": ({"train_loss": "PairwiseLogisticLoss", "margin": 0.0}, 40, False),
    "plain": ({"use_fused_loss": False}, 40, False),
    "logs": ({}, 40, True),
}
LR = 1e-4


def configs(**overrides):
    kw = {**SETTINGS, **overrides}
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, JT.init_transformer_params(jax.random.key(seed), jcfg))


def catalog(n_items: int, dim: int, seed: int) -> np.ndarray:
    emb = np.random.default_rng(seed).normal(size=(n_items, dim))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    return np.concatenate([np.zeros((1, dim), np.float32), emb])


def make_batch(seed: int, n_items: int, b: int = 8, s: int = 8) -> dict:
    """(B, S) batches with trailing padding, some positions without a
    positive, positives and negatives from disjoint halves of the catalog."""
    rng = np.random.default_rng(seed)
    half = n_items // 2
    hist, pos, neg = (np.zeros((b, s), np.int32) for _ in range(3))
    lengths = rng.integers(2, s + 1, size=b)
    lengths[0] = s
    for row, length in enumerate(lengths):
        hist[row, :length] = rng.integers(1, n_items + 1, size=length)
        pos[row, :length] = rng.integers(1, half + 1, size=length) * (rng.random(length) > 0.2)
        neg[row, :length] = rng.integers(half + 1, n_items + 1, size=length)
    return {"history_item_idx": hist, "pos_item_idx": pos, "neg_item_idx": neg}


def jax_mesh(name: str):
    d, m = MESHES[name]
    return JPM.create_mesh(JaxMeshConfig(data_axis_size=d, model_axis_size=m),
                           devices=jax.devices()[:d * m])


def sgd(lr: float, array_module):
    def make(config):
        def update(p, g, opt_state):
            return p - lr * g, opt_state, array_module.sqrt(array_module.sum(g * g))

        return update

    return make


# -- the inputs every world gets ------------------------------------------------------------


def lookup_spec():
    table = np.random.default_rng(10).normal(size=(37, 6)).astype(np.float32)
    table[0] = 0
    idx = np.array([[0, 1, 1, 36, 37, 38, 100, -1, 5],
                    [18, 19, 18, 0, 0, 2, 36, 35, 17],
                    [3, 3, 3, 3, 3, 3, 3, 3, 3],
                    [20, 21, 22, 23, 24, 25, 26, 27, 28]], np.int64)
    return {"table": table, "idx": idx}


def topk_spec():
    rng = np.random.default_rng(11)
    items = (rng.integers(-8, 9, size=(23, 8)) / 8).astype(np.float32)
    items[20] = items[3]  # a tie across the shards of a model axis of 2
    items[5] = items[4]  # a tie within a shard
    queries = (rng.integers(-8, 9, size=(5, 8)) / 8).astype(np.float32)
    queries[2] = 0  # every score tied
    exclude = np.array([[4, 0, 0, 0], [21, 1, 0, 0], [0, 0, 0, 0], [23, 22, 7, 0],
                        [3, 0, 0, 0]], np.int64)
    return {"items": items, "queries": queries, "exclude": exclude, "ks": [5, 15]}


def loss_case(name: str) -> dict:
    overrides, n_items, full_logs = LOSS_CASES[name]
    jcfg, tcfg = configs(**overrides)
    return {"config": tcfg.to_json(), "params": jax_params(jcfg),
            "table": catalog(n_items, 48, 1), "batch": make_batch(2, n_items),
            "full_logs": full_logs}


def scan_spec() -> dict:
    case = loss_case("table")
    windows = [make_batch(20 + i, 40) for i in range(3)]
    case["windows"] = {k: np.stack([w[k] for w in windows]) for k in windows[0]}
    case["seeds"] = np.random.default_rng(3).integers(0, 2**32, size=(3, 1 + 3 * LAYERS))
    case["lr"] = LR
    return case


EVAL_USERS, EVAL_ITEMS = 13, 61


def eval_spec() -> dict:
    jcfg, tcfg = configs(top_k=8, eval_batch_size=8)
    rng = np.random.default_rng(12)
    hists = [rng.integers(1, EVAL_ITEMS + 1, size=int(rng.integers(1, 12))).astype(np.int32)
             for _ in range(EVAL_USERS)]
    targets = [rng.choice(np.arange(1, EVAL_ITEMS + 1), size=int(rng.integers(0, 5)),
                          replace=False).astype(np.int32) for _ in range(EVAL_USERS)]
    window = np.zeros((EVAL_USERS, 8), np.int32)
    for i, h in enumerate(hists):
        window[i, : len(h[-8:])] = h[-8:]
    arrays = dict(user_ids=[f"u{i}" for i in range(EVAL_USERS)], histories=hists,
                  history_window=window, target_lists=targets,
                  n_targets=np.asarray([len(t) for t in targets], np.int32))
    return {"config": tcfg.to_json(), "params": jax_params(jcfg, seed=4),
            "table": catalog(EVAL_ITEMS, 48, 5), "arrays": arrays}


SMOKE = parse_yaml((REPO / "configs" / "synthetic_smoke.yaml").read_text())
FIT_MODEL = {**SMOKE["model"], "max_epochs": 1, "limit_train_batches": 4, "hidden_dropout": 0.0,
             "attention_dropout": 0.0, "use_fused_loss": False, "log_every_n_steps": 1000,
             "use_mlflow": False, "mask_false_negatives": False}
FIT_DATA = {**SMOKE["data"], "synthetic_num_events": 6000}


def fit_spec(root: pathlib.Path) -> dict:
    jcfg = JaxTrainConfig(**{**FIT_MODEL, "input_dim": FIT_DATA["embedding_dim"]})
    return {"model": {**FIT_MODEL, "mesh": {"model_axis_size": 2}}, "data": FIT_DATA,
            "params": jax_params(jcfg), "root": str(root), "lr": LR}


# -- the worlds -----------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(workdir: pathlib.Path, mesh: str, spec: dict):
    workdir.mkdir(parents=True, exist_ok=True)
    d, m = MESHES[mesh]
    (workdir / "inputs.pkl").write_bytes(pickle.dumps({**spec, "mesh": {
        "data_axis_size": d, "model_axis_size": m}}))
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, str(RANKS), str(workdir), str(r), str(d * m),
                              str(port)], env=env, stdout=subprocess.DEVNULL,
                             stderr=open(workdir / f"rank{r}.log", "w"))
            for r in range(d * m)]


def join_world(workdir: pathlib.Path, procs, deadline: float) -> list:
    """Every rank's results; kills the world when it outlives ``deadline``."""
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            pytest.fail(f"the gloo world in {workdir} did not end within {SPAWN_TIMEOUT} s")
    errors = [f.read_text() for f in sorted(workdir.glob("rank*.err"))]
    if errors or any(p.returncode for p in procs):
        logs = [f.read_text()[-2000:] for f in sorted(workdir.glob("rank*.log"))]
        pytest.fail("a rank failed:\n" + "\n".join(errors + logs))
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes()) for r in range(len(procs))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds, run at once; each mesh's per-rank results, and,
    computed in this process while the ranks run, JAX's sharded losses
    (``jax_loss``) and the port's one-device fit (``fit_reference``)."""
    root = tmp_path_factory.mktemp("worlds")
    base = {"lookup": lookup_spec(), "topk": topk_spec(),
            "loss": {name: loss_case(name) for name in LOSS_CASES}, "scan": scan_spec(),
            "eval": eval_spec()}
    started = {}
    for mesh in MESHES:
        spec = {**base, "fit": fit_spec(root / "fit") if mesh == "2x2" else None}
        started[mesh] = (root / mesh, start_world(root / mesh, mesh, spec))
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        mp = pytest.MonkeyPatch()
        force_jax_loss_kernels(mp)
        try:
            jax_loss = {(mesh, name): jax_sharded(name, case, mesh)
                        for mesh in MESHES for name, case in base["loss"].items()}
        finally:
            mp.undo()
        fit = fit_reference(tmp_path_factory.mktemp("fit_ref"))
    finally:
        results = {mesh: join_world(workdir, procs, deadline)
                   for mesh, (workdir, procs) in started.items()}
    results |= {"fit_root": root / "fit", "jax_loss": jax_loss, "fit_reference": fit}
    return results


def fit_reference(root: pathlib.Path):
    """The port's one-device fit of the 2x2 world's spec."""
    spec = fit_spec(root)
    mp = pytest.MonkeyPatch()
    mp.setattr(port_module, "SeqData", functools.partial(SeqData, backend="numpy"))
    mp.setattr(TTS, "make_flat_update", sgd(LR, torch))
    try:
        model = {k: v for k, v in spec["model"].items() if k != "mesh"}
        cfg = TrainConfig(**model, ckpt_dir=str(root / "ckpt"))
        trainer = Trainer(cfg, SeqDataModule(SeqDataModuleConfig(
            **FIT_DATA, data_dir=str(root / "data"))), log_dir=str(root / "logs"), device="cpu")
        trainer.model = RecommenderModel(
            cfg, params=TT.params_from_jax(spec["params"], device="cpu"), device="cpu")
        val = trainer.fit()
        params = [p.numpy() for p in TT.tree_leaves(trainer.model.params)]
        trainer.close()
    finally:
        mp.undo()
    return val, params


def each_rank(worlds, mesh):
    """(rank, results) of every rank of ``mesh``."""
    return list(enumerate(worlds[mesh]))


# -- create_mesh ------------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_create_mesh_shape_and_errors(worlds, mesh):
    d, m = MESHES[mesh]
    world = d * m
    for _, out in each_rank(worlds, mesh):
        assert out["shape"] == {"data": d, "model": m}
        errors = out["errors"]
        assert errors["model_not_dividing"] == (
            f"{world} devices not divisible by model_axis_size={world + 1}")
        assert errors["too_large"] == f"mesh {2 * world}x1 exceeds {world} devices"
        assert errors["too_small"] == f"mesh 1x1 leaves {world - 1} of {world} ranks out"
    # JAX's own messages for the first two, on as many devices
    devices = jax.devices()[:world]
    for cfg, key in ((JaxMeshConfig(model_axis_size=world + 1), "model_not_dividing"),
                     (JaxMeshConfig(data_axis_size=2 * world), "too_large")):
        with pytest.raises(ValueError) as e:
            JPM.create_mesh(cfg, devices=devices)
        assert str(e.value) == worlds[mesh][0]["errors"][key]


# -- the sharded lookup ------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_lookup(worlds, mesh):
    spec = lookup_spec()
    table, idx = spec["table"], spec["idx"]
    n = table.shape[0]
    want = np.where(((idx >= 0) & (idx < n))[..., None], table[np.clip(idx, 0, n - 1)], 0)
    jm = jax_mesh(mesh)
    want_jax = np.asarray(JPE.sharded_table_lookup(JPE.place_table(table, jm), jnp.asarray(idx),
                                                   jm))
    for _, out in each_rank(worlds, mesh):
        np.testing.assert_array_equal(out["lookup"]["rows"], want)
        np.testing.assert_array_equal(out["lookup"]["rows"], want_jax)
        assert out["lookup"]["shard_rows"] == -(-n // MESHES[mesh][1])


# -- the sharded top-k -------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_topk(worlds, mesh):
    spec = topk_spec()
    jm = jax_mesh(mesh)
    items, queries, exclude = spec["items"], spec["queries"], spec["exclude"]
    for metric in ("dot", "cosine"):
        for k in spec["ks"]:
            want_s, want_i = topk_items(torch.from_numpy(queries), torch.from_numpy(items), k,
                                        exclude_idx=torch.from_numpy(exclude), metric=metric)
            topk = jax.jit(functools.partial(jax_sharded_topk, k=k, mesh=jm, metric=metric,
                                             num_items=items.shape[0]))
            js, ji = topk(jnp.asarray(queries), JPE.place_table(items, jm),
                          exclude_idx=jnp.asarray(exclude))
            for _, out in each_rank(worlds, mesh):
                s, i = out["topk"][(metric, k)]
                np.testing.assert_array_equal(i, want_i.numpy())
                np.testing.assert_array_equal(s, want_s.numpy())
                np.testing.assert_array_equal(i, np.asarray(ji))
                if metric == "dot":
                    np.testing.assert_array_equal(s, np.asarray(js))
                else:
                    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-6)
    assert spec["ks"][1] > -(-items.shape[0] // 2)  # k above a shard's rows at model 2


# -- the sharded loss and its gradient ----------------------------------------------------------


def port_one_device(case: dict):
    cfg = TrainConfig.from_json(case["config"])
    params = TT.params_from_jax(case["params"], device="cpu")
    loss, grads, logs = TTS.make_loss_and_grad(cfg, full_logs=case["full_logs"])(
        params, torch.from_numpy(case["table"]), case["batch"], None)
    return float(loss), TTS.flatten(grads).numpy(), {k: float(v) for k, v in logs.items()}


def jax_sharded(name: str, case: dict, mesh: str):
    overrides, _, full_logs = LOSS_CASES[name]
    jcfg, _ = configs(**overrides)
    jm = jax_mesh(mesh)
    loss_fn = jax_sharded_loss(jcfg, jm, full_logs=full_logs)
    table = JPE.place_table(case["table"], jm)
    batch = JPM.shard_batch({k: jnp.asarray(v) for k, v in case["batch"].items()}, jm)
    params = jax.tree.map(jnp.asarray, case["params"])
    (loss, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, table, batch, jax.random.key(0))
    flat = np.concatenate([np.asarray(g).reshape(-1) for g in jax.tree.leaves(grads)])
    return float(loss), flat, {k: float(v) for k, v in logs.items()}


def leaf_slices(params):
    out, start = [], 0
    for leaf in jax.tree.leaves(params):
        out.append(slice(start, start + leaf.size))
        start += leaf.size
    return out


def assert_flat_grads_close(got, want, params, rel):
    for sl in leaf_slices(params):
        scale = np.abs(want[sl]).max()
        assert scale > 0
        np.testing.assert_array_less(np.abs(got[sl] - want[sl]).max(), rel * scale + 1e-30)


@pytest.mark.parametrize("name", list(LOSS_CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_loss_matches_one_device(worlds, mesh, name):
    case = loss_case(name)
    loss, grad, logs = port_one_device(case)
    for _, out in each_rank(worlds, mesh):
        got = out["loss"][name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        assert_flat_grads_close(got["grad"], grad, case["params"], 1e-5)
        assert got["positives"] == float((case["batch"]["pos_item_idx"] != 0).sum())
        assert set(got["logs"]) == set(logs)
        for key in logs:
            np.testing.assert_allclose(got["logs"][key], logs[key], rtol=1e-5, err_msg=key)
    if LOSS_CASES[name][2]:
        assert len(logs) == 30


def force_jax_loss_kernels(monkeypatch: pytest.MonkeyPatch):
    """JAX's fused loss kernels on its CPU backend, in interpret mode."""
    monkeypatch.setattr(JTS, "_fused_loss_enabled",
                        lambda config: config.use_fused_loss and config.num_hard_negatives == 0)
    for module, name, extra in ((JFT, "fused_table_infonce_loss", {"tile_rows": 16}),
                                (JFI, "fused_infonce_loss", {}),
                                (JFP, "fused_pairwise_loss", {"tile_rows": 16,
                                                              "tile_cols": 128})):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, functools.partial(fn, interpret=True, **extra))


@pytest.mark.parametrize("name", list(LOSS_CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_loss_matches_jax_sharded(worlds, mesh, name):
    case = loss_case(name)
    jloss, jgrad, jlogs = worlds["jax_loss"][(mesh, name)]
    got = worlds[mesh][0]["loss"][name]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
    assert_flat_grads_close(got["grad"], jgrad, case["params"], 1e-3)
    if LOSS_CASES[name][2]:
        assert set(got["logs"]) == set(jlogs)
        # JAX's sharded logging step logs its kernel objective under the train
        # loss's keys; the port logs the plain head there, as both packages'
        # one-device steps do: the plain case's loss (held to JAX's above)
        train_keys = {"loss/InfoNCELoss": 1.0,
                      "loss/InfoNCELossMean": 1.0 / (got["positives"] + 1e-9)}
        plain = worlds[mesh][0]["loss"]["plain"]["loss"]
        for key in jlogs:
            want = plain * train_keys[key] if key in train_keys else jlogs[key]
            np.testing.assert_allclose(got["logs"][key], want, rtol=1e-4, atol=1e-5,
                                       err_msg=key)


# -- the scanned sharded steps -------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_scanned_sharded_steps(worlds, mesh, monkeypatch):
    spec = scan_spec()
    monkeypatch.setattr(TTS, "make_flat_update", sgd(LR, torch))
    cfg = TrainConfig.from_json(spec["config"])
    params = TT.params_from_jax(spec["params"], device="cpu")
    state, logs = TSS.make_scanned_train_steps(cfg)(
        TTS.init_train_state(cfg, params), torch.from_numpy(spec["table"]), spec["windows"],
        torch.from_numpy(spec["seeds"]))
    for _, out in each_rank(worlds, mesh):
        got = out["scan"]
        assert got["params_equal"] and got["losses_equal"]
        np.testing.assert_allclose(got["params"], TTS.flatten(state.params).numpy(), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(got["losses"], logs["loss/InfoNCELoss"].numpy(), rtol=1e-6)
        np.testing.assert_array_equal(got["positives"],
                                      logs["batch/positive_non_zero"].numpy())


# -- the sharded evaluator -----------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_evaluator_matches_evaluator(worlds, mesh):
    spec = eval_spec()
    cfg = TrainConfig.from_json(spec["config"])
    params = TT.params_from_jax(spec["params"], device="cpu")
    table = torch.from_numpy(spec["table"])
    arrays = EvalArrays(**spec["arrays"])
    evaluator = Evaluator(cfg)
    want = evaluator.run(params, table, arrays)
    want_idx, want_scores = evaluator.recommend_batch(params, table, arrays)
    assert len(want) == 7
    for _, out in each_rank(worlds, mesh):
        got = out["eval"]
        np.testing.assert_array_equal(got["idx"], want_idx)
        np.testing.assert_allclose(got["scores"], want_scores, rtol=0, atol=1e-6)
        assert set(got["metrics"]) == set(want)
        for key in want:
            np.testing.assert_allclose(got["metrics"][key], want[key], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_evaluator_matches_jax(worlds, mesh):
    spec = eval_spec()
    jcfg, _ = configs(top_k=8, eval_batch_size=8)
    jm = jax_mesh(mesh)
    table = spec["table"]
    params = jax.tree.map(jnp.asarray, spec["params"])
    arrays = JaxEvalArrays(**spec["arrays"])
    tables = (JPE.place_table(table, jm), JPE.place_table(table[1:], jm))
    evaluator = JaxShardedEvaluator(jcfg, jm, num_items=table.shape[0] - 1)
    want = evaluator.run(params, tables, arrays)
    want_idx, want_scores = evaluator.recommend_batch(params, tables, arrays)
    got = worlds[mesh][0]["eval"]
    # no near ties among each user's k + 1 best scores (1e-5, above both packages' noise)
    top = np.sort(got["scores"], axis=1)[:, ::-1]
    assert float(np.min(top[:, :-1] - top[:, 1:])) > 1e-5
    np.testing.assert_array_equal(got["idx"], want_idx)
    np.testing.assert_allclose(got["scores"], want_scores, rtol=0, atol=1e-5)
    for key in want:
        np.testing.assert_allclose(got["metrics"][key], want[key], rtol=0, atol=1e-5)


# -- a Trainer fit on the 2x2 mesh -----------------------------------------------------------------


def test_fit_on_a_2x2_mesh_matches_one_device(worlds):
    want_val, want_params = worlds["fit_reference"]
    for rank, out in each_rank(worlds, "2x2"):
        fit = out["fit"]
        assert fit["mesh"] == {"data": 2, "model": 2} and fit["step"] == 4, rank
        assert len(fit["params"]) == len(want_params)
        for g, w in zip(fit["params"], want_params):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        val_keys = [k for k in want_val if k.startswith("val/")]
        assert len(val_keys) == 7
        for key in val_keys:
            np.testing.assert_allclose(fit["val"][key], want_val[key], rtol=0, atol=1e-5,
                                       err_msg=key)


def test_fit_on_a_mesh_writes_from_rank_0_only(worlds):
    root = worlds["fit_root"]
    assert (root / "logs0" / "metrics.jsonl").stat().st_size > 0
    assert (root / "ckpt0" / "last" / "state.npz").exists()
    assert (root / "ckpt0" / "best" / "state.npz").exists()
    assert (root / "ckpt0" / "config.json").exists()
    for rank in (1, 2, 3):
        assert not (root / f"logs{rank}").exists(), rank
        assert not (root / f"ckpt{rank}").exists(), rank


def test_mesh_config_round_trips():
    cfg = TrainConfig.from_dict({"mesh": {"data_axis_size": "2", "model_axis_size": 2}})
    assert (cfg.mesh.data_axis_size, cfg.mesh.model_axis_size) == (2, 2)
    assert TrainConfig.from_json(cfg.to_json()).mesh == cfg.mesh
    jax_cfg = JaxTrainConfig.model_validate({"mesh": {"data_axis_size": 2, "model_axis_size": 2}})
    assert dataclasses.asdict(cfg.mesh) == jax_cfg.mesh.model_dump()
    assert dataclasses.asdict(TrainConfig().mesh) == JaxTrainConfig().mesh.model_dump()


def test_chip_smoke_parallel_phase_rehearsal():
    """chip_smoke.py's phase 16 (the sharded lookup, top-k, hot and logging
    steps against the one-device path bit for bit, the window against
    eager sharded steps, the sharded evaluator) at a small size on the
    CPU, over a gloo group of one rank in this process (bf16, dropout on:
    data coordinate 0 keeps the step's seeds)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    tiny = dict(input_dim=48, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                intermediate_size=48, max_seq_length=8, train_loss="InfoNCELoss")
    launches = chip_smoke.parallel_phase(device="cpu", config=tiny, num_items=60, batch_size=8,
                                         k=2, calls=1, users=16)
    assert set(launches) == {"parallel_hot", "parallel_logging", "parallel_scan"}
    assert all(not any(v.values()) for v in launches.values())  # the plain path runs no kernel


class _Coordinate:
    """A mesh stand-in: only its data coordinate."""

    def __init__(self, d: int) -> None:
        self.d = d

    def coordinate(self, axis: str) -> int:
        assert axis == "data"
        return self.d


def test_data_rank_seeds_differ_by_data_coordinate():
    from transformer_recommenders_tpu_torch.parallel.train import data_rank_seeds

    seeds = [0, 1, 2**32 - 1, 12345]
    assert data_rank_seeds(seeds, _Coordinate(0)) is seeds
    assert data_rank_seeds(None, _Coordinate(1)) is None
    streams = [data_rank_seeds(seeds, _Coordinate(d)) for d in range(4)]
    assert all(0 <= v < 2**32 for s in streams for v in s)
    for i in range(4):
        for j in range(i):
            assert all(a != b for a, b in zip(streams[i], streams[j]))
    as_tensor = data_rank_seeds(torch.tensor(seeds), _Coordinate(3))
    assert as_tensor.dtype == torch.int64 and as_tensor.tolist() == streams[3]
