"""The port's trainer, CLI and deploy on the CPU (``device="cpu"``), and a
short fit against the JAX package's trainer.

- Against JAX: ``configs/synthetic_smoke.yaml``'s shapes (d=64, 2 layers,
  4 heads, FFN 128, seq 16, batch 32, 300 synthetic items), f32, dropout 0,
  the numpy sampler on both sides (equal batches from one seed), the same
  initial parameters (JAX's init, through ``params_from_jax``), a 1-epoch
  fit of 4 steps, the JAX trainer on one device.  Both take the plain f32
  loss heads (``use_fused_loss=False``: the JAX package turns its fused
  losses off on its CPU backend, and the kernels' own parity is held in
  their test files), the false-negative mask off (it compares a pool
  logit with the positive's for ``<``, and a copy of the positive in the
  pool, an ulp apart in one package and not the other, would flip a whole
  pool term), and the update patched to SGD at lr 1e-4 on both sides (the
  first AdamW steps turn a gradient element's sign into +-lr, so last-ulp
  gradient differences near zero would become 2 lr; at the config's 3e-3
  SGD on the summed loss moves the parameters by more than their size,
  and the four steps amplify f32 noise).  Parameters within 1e-6 abs
  (measured 6e-8, with the largest move 0.13) and val metrics within 1e-5
  (the same ranks).
- The loop's bookkeeping, as JAX's ``tests/test_trainer.py`` has it:
  val metrics, learning the synthetic structure, test and predict, exact
  resume from the best checkpoint, ``checkpoint_every_epoch=False``, early
  stopping, the missing-monitor error, ``val_check_interval`` without
  re-validating the same parameters, logs (JSONL, CSV, the MLflow store),
  the profiler trace, and the artifact served by ``Service(device="cpu")``.
- The windowed loop (``steps_per_dispatch=2``) against the single-step
  loop: the same batches, seeds and logging steps, so the same parameters
  bit for bit.
- The CLI's four commands on ``configs/synthetic_smoke.yaml`` with
  ``--device cpu``, and without ``--device`` the error where no card is
  present; ``deploy.main`` from a checkpoint and from its one-batch fit.
"""

import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_recommenders_tpu.configs import SeqDataModuleConfig as JaxDataConfig
from transformer_recommenders_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_recommenders_tpu.data import dataset as jax_dataset
from transformer_recommenders_tpu.data import module as jax_module
from transformer_recommenders_tpu.training import train_state as JTS
from transformer_recommenders_tpu.training.trainer import Trainer as JaxTrainer
from transformer_recommenders_tpu_torch.configs import (
    SeqDataModuleConfig,
    TrainConfig,
    load_yaml_config,
    parse_yaml,
)
from transformer_recommenders_tpu_torch.data import module as port_module
from transformer_recommenders_tpu_torch.data.dataset import SeqData
from transformer_recommenders_tpu_torch.data.module import SeqDataModule
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel
from transformer_recommenders_tpu_torch.serving import deploy
from transformer_recommenders_tpu_torch.serving.service import Service
from transformer_recommenders_tpu_torch.training import cli
from transformer_recommenders_tpu_torch.training import train_state as TTS
from transformer_recommenders_tpu_torch.training.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
SMOKE = REPO / "configs" / "synthetic_smoke.yaml"
DATA = dict(dataset="synthetic", embedder="hash", embedding_dim=32, max_seq_length=8,
            batch_size=16, synthetic_num_users=60, synthetic_num_items=80,
            synthetic_num_events=6000)
MODEL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4, intermediate_size=32,
             max_seq_length=8, compute_dtype="float32", train_loss="InfoNCELoss",
             learning_rate=3e-3, max_epochs=2, eval_batch_size=32, top_k=10,
             log_every_n_steps=1000)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("data")
    dm = SeqDataModule(SeqDataModuleConfig(data_dir=str(path), **DATA))
    dm.prepare_data()
    return path


def make_trainer(root: pathlib.Path, data_dir, **overrides) -> Trainer:
    config = TrainConfig(**{**MODEL, "ckpt_dir": str(root / "ckpt"), **overrides})
    dm = SeqDataModule(SeqDataModuleConfig(data_dir=str(data_dir), **DATA))
    return Trainer(config, dm, log_dir=str(root / "logs"), device="cpu")


@pytest.fixture(scope="module")
def trainer(tmp_path_factory, data_dir):
    t = make_trainer(tmp_path_factory.mktemp("fit"), data_dir)
    t.result = t.fit()
    yield t
    t.close()


def test_fit_learns_the_synthetic_structure(trainer):
    ndcg = trainer.result["val/retrieval_normalized_dcg"]
    assert 0.0 <= ndcg <= 1.0
    # a ring random walk over 80 items: a random ranking hits far less often
    assert trainer.result["val/retrieval_hit_rate"] > 0.3
    assert trainer.result["train/examples_per_s"] > 0


def test_test_and_predict(trainer):
    assert "test/retrieval_normalized_dcg" in trainer.test()
    recs = trainer.predict()
    u = len(recs["user_ids"])
    assert recs["item_idx"].shape == recs["item_ids"].shape == (u, trainer.config.top_k)
    arrays = trainer.datamodule.eval_arrays("predict")
    for i in range(u):
        assert set(arrays.histories[i].tolist()).isdisjoint(recs["item_idx"][i].tolist())
    assert (np.diff(recs["scores"], axis=1) <= 0).all()
    assert recs["item_ids"][0, 0] == trainer.datamodule.item_ids[recs["item_idx"][0, 0] - 1]


def test_resume_from_best_is_exact(trainer, tmp_path):
    fresh = Trainer(trainer.config, trainer.datamodule, log_dir=str(tmp_path), device="cpu")
    meta = fresh.restore(str(pathlib.Path(trainer.config.ckpt_dir) / "best"))
    assert meta["step"] > 0 and fresh._host_step == meta["step"]
    for a, b in zip(TT.tree_leaves(trainer.model.params), TT.tree_leaves(fresh.model.params)):
        assert torch.equal(a, b)
    assert trainer.validate() == fresh.validate()
    assert fresh.validate() == {k: v for k, v in meta["metrics"].items()}
    fresh.close()


def test_artifact_saved_and_served(trainer, tmp_path):
    trainer.save(tmp_path / "artifact")
    manifest = json.loads((tmp_path / "artifact" / "manifest.json").read_text())
    assert manifest["step"] == trainer.state.step > 0
    service = Service(tmp_path / "artifact", device="cpu")
    deploy.test_queries(service)
    user = trainer.datamodule.users[0]
    recs = deploy.test_service(service, "recommend_with_user_id", {"user_id": user["user_id"]})
    # the service excludes the query's items: the last window of the activity
    window = (user["history"]["item_id"] + user["target"]["item_id"])[-MODEL["max_seq_length"]:]
    assert len(recs) == 20 and set(r["item_id"] for r in recs).isdisjoint(window)


def test_logs_written(trainer):
    lines = (trainer.log_dir / "metrics.jsonl").read_text().strip().splitlines()
    vals = [json.loads(line) for line in lines if "val/retrieval_normalized_dcg" in line]
    assert len(vals) == 2  # one per epoch
    assert (trainer.log_dir / "metrics.csv").exists()
    run_dir = trainer.mlflow_run.run_dir
    assert (run_dir / "metrics" / "val" / "retrieval_normalized_dcg").exists()
    assert (run_dir / "params" / "model.hidden_size").read_text() == "32"
    assert (run_dir / "artifacts" / "config.json").exists()
    configs = json.loads((pathlib.Path(trainer.config.ckpt_dir) / "config.json").read_text())
    assert configs["model"]["hidden_size"] == 32 and configs["data"]["dataset"] == "synthetic"


def test_checkpoint_every_epoch_false(tmp_path, data_dir):
    t = make_trainer(tmp_path, data_dir, checkpoint_every_epoch=False)
    result = t.fit()
    assert np.isfinite(result["val/retrieval_normalized_dcg"])
    assert (tmp_path / "ckpt" / "best" / "state.npz").exists()
    assert (tmp_path / "ckpt" / "last" / "state.npz").exists()
    fresh = make_trainer(tmp_path / "fresh", data_dir)
    fresh.restore(str(tmp_path / "ckpt" / "best"))
    for a, b in zip(TT.tree_leaves(t.model.params), TT.tree_leaves(fresh.model.params)):
        assert torch.equal(a, b)
    t.close()
    fresh.close()


def test_early_stopping_and_missing_monitor(tmp_path, data_dir):
    # lr 0: the parameters never move, so the second validation cannot improve
    t = make_trainer(tmp_path / "a", data_dir, learning_rate=0.0, weight_decay=0.0,
                     max_epochs=5, early_stopping_patience=1, limit_train_batches=3)
    t.fit()
    assert t._host_step == 6  # two epochs of 3 steps, then the stop
    t.close()
    t = make_trainer(tmp_path / "b", data_dir, monitor="val/no_such_metric",
                     limit_train_batches=2)
    with pytest.raises(KeyError, match="no_such_metric"):
        t.fit()
    t.close()


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_val_check_interval(tmp_path, data_dir, steps_per_dispatch):
    t = make_trainer(tmp_path, data_dir, val_check_interval=3, limit_train_batches=6,
                     max_epochs=1, steps_per_dispatch=steps_per_dispatch)
    t.fit()
    rows = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl").read_text()
            .strip().splitlines()]
    # validations where a step count crosses a multiple of 3 (steps 3 and 6,
    # or the windows' ends 4 and 6); the epoch's end re-validates nothing
    want = [3, 6] if steps_per_dispatch == 1 else [4, 6]
    assert [r["step"] for r in rows if "val/retrieval_hit_rate" in r] == want
    assert t.phase_seconds["validate"] > 0
    t.close()


def test_windowed_fit_equals_single_steps(tmp_path, data_dir):
    """K=2 windows (the last step of every other window the logging step,
    a ragged tail of one step) against single steps with the logging step
    at the same steps: the same parameters bit for bit."""
    kw = dict(max_epochs=1, limit_train_batches=7, log_every_n_steps=4, hidden_dropout=0.1,
              attention_dropout=0.1)
    single = make_trainer(tmp_path / "single", data_dir, **kw)
    windowed = make_trainer(tmp_path / "windowed", data_dir, steps_per_dispatch=2, **kw)
    single.fit()
    windowed.fit()
    for a, b in zip(TT.tree_leaves(single.state.params), TT.tree_leaves(windowed.state.params)):
        assert torch.equal(a, b)
    assert windowed.phase_counts == {"windows": 3, "log_events": 1, "tail_steps": 1,
                                     "log_flushes": 1}
    assert single.phase_counts == {"log_events": 1}  # both loops count their logging steps
    for key in ("host_sample", "queue_wait", "upload", "dispatch", "log", "tail_dispatch",
                "epoch_wall"):
        assert windowed.phase_seconds[key] > 0, key
    assert len(windowed.epoch_walls) == 1
    logged = [json.loads(line) for line in (tmp_path / "windowed" / "logs" / "metrics.jsonl")
              .read_text().strip().splitlines()]
    train_rows = [r for r in logged if "loss/InfoNCELoss" in r]
    assert [r["step"] for r in train_rows] == [4]
    assert {"loss/NCELoss", "logits/pos/mean", "batch/positive_density",
            "grad/global_norm"} <= set(train_rows[0])
    single.close()
    windowed.close()


def test_profile_dir_writes_a_trace(tmp_path, data_dir):
    t = make_trainer(tmp_path, data_dir, limit_train_batches=2, max_epochs=1,
                     profile_dir=str(tmp_path / "profile"))
    t.fit()
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0
    t.close()


# -- against the JAX trainer ----------------------------------------------------------


def sgd(lr: float, array_module):
    def make(config):
        def update(p, g, opt_state):
            return p - lr * g, opt_state, array_module.sqrt(array_module.sum(g * g))

        return update

    return make


def test_fit_matches_jax(tmp_path, monkeypatch):
    smoke = parse_yaml(SMOKE.read_text())
    data = {**smoke["data"], "synthetic_num_events": 6000}
    model = {**smoke["model"], "max_epochs": 1, "limit_train_batches": 4,
             "hidden_dropout": 0.0, "attention_dropout": 0.0, "use_fused_loss": False,
             "log_every_n_steps": 1000, "use_mlflow": False, "mask_false_negatives": False}
    lr = 1e-4

    # the JAX trainer on one device, the numpy sampler, SGD
    real_devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: real_devices(*a, **kw)[:1])
    monkeypatch.setattr(jax_module, "SeqData",
                        functools.partial(jax_dataset.SeqData, backend="numpy"))
    monkeypatch.setattr(port_module, "SeqData", functools.partial(SeqData, backend="numpy"))
    monkeypatch.setattr(JTS, "make_flat_update", sgd(lr, jnp))
    monkeypatch.setattr(TTS, "make_flat_update", sgd(lr, torch))

    jt = JaxTrainer(JaxTrainConfig(**model, ckpt_dir=str(tmp_path / "jck")),
                    jax_module.SeqDataModule(JaxDataConfig(**data,
                                                           data_dir=str(tmp_path / "jdata"))),
                    log_dir=str(tmp_path / "jlogs"))
    jt.configure()
    assert jt.mesh is None
    pt = Trainer(TrainConfig(**model, ckpt_dir=str(tmp_path / "pck")),
                 SeqDataModule(SeqDataModuleConfig(**data, data_dir=str(tmp_path / "pdata"))),
                 log_dir=str(tmp_path / "plogs"), device="cpu")
    pt.model = RecommenderModel(
        pt.config, params=TT.params_from_jax(jax.tree.map(np.asarray, jt.model.params),
                                             device="cpu"), device="cpu")
    initial = [np.asarray(x) for x in jax.tree.leaves(jt.model.params)]
    want_val = jt.fit()
    got_val = pt.fit()
    assert int(jt.state.step) == pt.state.step == 4

    want = [np.asarray(x) for x in jax.tree.leaves(jt.model.params)]
    got = [x.numpy() for x in TT.tree_leaves(pt.model.params)]
    assert len(got) == len(want) == len(initial)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert max(float(np.abs(w - w0).max()) for w, w0 in zip(want, initial)) > 0.05
    val_keys = [k for k in want_val if k.startswith("val/")]
    assert len(val_keys) == 7
    for key in val_keys:
        np.testing.assert_allclose(got_val[key], want_val[key], rtol=0, atol=1e-5, err_msg=key)
    jt.close()
    pt.close()


# -- the CLI and deploy -----------------------------------------------------------------


def cli_args(tmp_path, *extra):
    return ["--config", str(SMOKE), "--device", "cpu", "--log_dir", str(tmp_path / "logs"),
            "--data.data_dir", str(tmp_path / "data"), "--model.ckpt_dir", str(tmp_path / "ckpt"),
            "--model.max_epochs", "1", "--model.limit_train_batches", "3",
            "--data.synthetic_num_events", "4000", *extra]


def test_cli_commands(tmp_path, capsys):
    fit = cli.main(["fit", *cli_args(tmp_path, "--save_path", str(tmp_path / "art"))])
    assert "val/retrieval_normalized_dcg" in fit
    assert (tmp_path / "art" / "manifest.json").exists()
    best = str(tmp_path / "ckpt" / "best")
    val = cli.main(["validate", *cli_args(tmp_path, "--ckpt_path", best)])
    assert val == {k: v for k, v in fit.items() if k.startswith("val/")}
    assert "test/retrieval_hit_rate" in cli.main(["test", *cli_args(tmp_path, "--ckpt_path",
                                                                    best)])
    out = tmp_path / "recs.jsonl"
    result = cli.main(["predict", *cli_args(tmp_path, "--ckpt_path", best,
                                            "--predict_output", str(out))])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == result["num_users"] > 0
    assert set(rows[0]) == {"user_id", "item_ids", "scores"} and len(rows[0]["item_ids"]) == 10
    capsys.readouterr()
    with pytest.raises(SystemExit):
        cli.main(["fit", *cli_args(tmp_path, "--model.learning_rate", "3e-3"), "--print_config"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["model"]["learning_rate"] == 0.003 and printed["data"]["embedder"] == "hash"
    flat = tmp_path / "flat.yaml"
    flat.write_text("# a flat file\ntop_k: 7\nlearning_rate: 3e-3\n")
    loaded = load_yaml_config(str(flat), TrainConfig)
    assert loaded.top_k == 7 and loaded.learning_rate == 0.003


def test_cli_without_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error where no card is present")
    args = [a for a in cli_args(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["fit", *args])


def test_deploy_from_checkpoint_and_fast_dev(trainer, tmp_path):
    service = deploy.main(tmp_path / "from_ckpt", "cpu",
                          ckpt_path=str(pathlib.Path(trainer.config.ckpt_dir) / "best"))
    assert service.device.type == "cpu"
    service = deploy.main(device="cpu")
    assert service.model.model.config.hidden_size == 64
    # an artifact already there is served as it is
    deploy.main(tmp_path / "from_ckpt", "cpu")


def test_config_roundtrip_through_the_sidecar(trainer):
    payload = json.loads((pathlib.Path(trainer.config.ckpt_dir) / "config.json").read_text())
    again = TrainConfig.from_dict(payload["model"])
    assert dataclasses.asdict(again) == dataclasses.asdict(trainer.config)
    assert SeqDataModuleConfig.from_dict(payload["data"]) == trainer.datamodule.config
