"""The port's quality entry point (``tools/quality_run.py``) on the CPU,
against the JAX package.

- Fit parity with SGD: the seed-spread protocol at
  ``tests/test_quality_parity.py``'s tiny size (60 users, 80 items, 6,000
  events, d=64, 2 layers, 4 heads, FFN 128, seq 8, batch 16, 3 epochs, f32,
  dropout 0), both trainers from JAX's initial parameters
  (``params_from_jax``) over the numpy sampler's batches, the JAX trainer on
  one device.  As in ``tests/test_torch_trainer.py``'s
  ``test_fit_matches_jax``: both updates patched to SGD at lr 1e-4, the
  false-negative mask off, the plain f32 loss heads on both sides (the JAX
  package turns its fused losses off on its CPU backend).  Every epoch's val
  metrics within 1e-4 (measured: at most 2.4e-8).
- Fit parity with AdamW: the same fit as the protocol runs it (AdamW at lr
  1e-3, the mask on; the port's fused losses, here the table-scored InfoNCE
  on hot steps, whose plain versions score bf16-rounded rows, against JAX's
  plain f32 head over the pool), within the bounds of
  ``tests/test_quality_parity.py``: both NDCG above 0.05, |d NDCG| < 0.08,
  |d hit| < 0.15 (measured: 3.6e-8 and 0 at the last epoch, 0.013 and 0 at
  the second).
- The protocols' configurations field for field against the JAX
  ``TrainConfig`` and ``SeqDataModuleConfig`` built with the JAX scripts'
  values, the YAML ones through pyyaml and ``model_validate``.
- The CLI at a tiny size with ``--device cpu`` (the JSON record, the per-epoch
  metrics, the time to the target, the seed-spread gate's exit code); without
  it, the error where no card is present; ``--out`` refused at the root.
- The JAX records' values as the tool reads them.
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
import yaml

from transformer_recommenders_tpu.configs import SeqDataModuleConfig as JaxDataConfig
from transformer_recommenders_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_recommenders_tpu.data import dataset as jax_dataset
from transformer_recommenders_tpu.data import module as jax_module
from transformer_recommenders_tpu.training import train_state as JTS
from transformer_recommenders_tpu.training.trainer import Trainer as JaxTrainer
from transformer_recommenders_tpu_torch.data import module as port_module
from transformer_recommenders_tpu_torch.data.dataset import SeqData
from transformer_recommenders_tpu_torch.data.module import SeqDataModule
from transformer_recommenders_tpu_torch.models import transformer as TT
from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel
from transformer_recommenders_tpu_torch.tools import quality_run as Q
from transformer_recommenders_tpu_torch.training import train_state as TTS
from transformer_recommenders_tpu_torch.training import trainer as trainer_mod

REPO = pathlib.Path(__file__).resolve().parents[1]
# tests/test_quality_parity.py's size
TINY_MODEL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, max_seq_length=8, max_epochs=3, eval_batch_size=32)
TINY_DATA = dict(embedding_dim=64, max_seq_length=8, batch_size=16, synthetic_num_users=60,
                 synthetic_num_items=80, synthetic_num_events=6000)
VAL_KEYS = ("auroc", "average_precision", "hit_rate", "normalized_dcg", "precision", "recall",
            "reciprocal_rank")


def plain(value):
    """A config field as plain data: nested configs as dicts."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    return value.model_dump() if hasattr(value, "model_dump") else value


def assert_same_config(got, want) -> None:
    names = {f.name for f in dataclasses.fields(got)}
    assert names == set(type(want).model_fields)
    for name in names:
        assert plain(getattr(got, name)) == plain(getattr(want, name)), name


# -- the fits against the JAX trainer -----------------------------------------------------


def sgd(lr: float, array_module):
    def make(config):
        def update(p, g, opt_state):
            return p - lr * g, opt_state, array_module.sqrt(array_module.sum(g * g))

        return update

    return make


def tiny_protocol(root: pathlib.Path, **model):
    """The seed-spread protocol's configs at the tiny size."""
    train, data = Q.seed_spread_configs(0, str(root))
    return (train.replace(**TINY_MODEL, **model),
            data.replace(**TINY_DATA, data_dir=str(root / "data")))


def fit_both(root: pathlib.Path, monkeypatch, **model):
    """The tool's fit (``fit_run``) and the JAX trainer's over the same
    batches from JAX's initial parameters: (port run, JAX val metrics by
    epoch)."""
    real_devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: real_devices(*a, **kw)[:1])
    monkeypatch.setattr(jax_module, "SeqData",
                        functools.partial(jax_dataset.SeqData, backend="numpy"))
    monkeypatch.setattr(port_module, "SeqData", functools.partial(SeqData, backend="numpy"))
    train, data = tiny_protocol(root, **model)

    jt = JaxTrainer(JaxTrainConfig.model_validate(dataclasses.asdict(train) |
                                                  {"ckpt_dir": str(root / "jck")}),
                    jax_module.SeqDataModule(JaxDataConfig.model_validate(
                        dataclasses.asdict(data) | {"data_dir": str(root / "jdata")})),
                    log_dir=str(root / "jlogs"))
    jt.configure()
    assert jt.mesh is None
    params = TT.params_from_jax(jax.tree.map(np.asarray, jt.model.params), device="cpu")
    monkeypatch.setattr(trainer_mod, "RecommenderModel",
                        lambda cfg, **kw: RecommenderModel(cfg, params=params, device="cpu"))
    want = jt.fit()
    jt.close()
    rows = [json.loads(line) for line in (root / "jlogs" / "metrics.jsonl").read_text()
            .splitlines()]
    want_epochs = [r for r in rows if "val/retrieval_normalized_dcg" in r]
    assert want_epochs[-1]["val/retrieval_normalized_dcg"] == pytest.approx(
        want["val/retrieval_normalized_dcg"], abs=1e-6)

    run = Q.fit_run(train, SeqDataModule(data), device=torch.device("cpu"),
                    log_dir=str(root / "plogs"), target=0.5, test=False)
    return run, want_epochs


def test_fit_with_sgd_matches_jax_every_epoch(tmp_path, monkeypatch):
    monkeypatch.setattr(JTS, "make_flat_update", sgd(1e-4, jnp))
    monkeypatch.setattr(TTS, "make_flat_update", sgd(1e-4, torch))
    run, want = fit_both(tmp_path, monkeypatch, use_fused_loss=False,
                         mask_false_negatives=False)
    got = run["val_history"]
    assert [r["epoch"] for r in got] == [0, 1, 2]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert run["untrained"]["val/retrieval_normalized_dcg"] != got[-1][
        "val/retrieval_normalized_dcg"]  # the fit moved the ranks
    worst = max(abs(g[f"val/retrieval_{k}"] - w[f"val/retrieval_{k}"])
                for g, w in zip(got, want) for k in VAL_KEYS)
    print(f"max |val metric difference| over {len(got)} epochs: {worst:.3g}")
    for g, w in zip(got, want):
        for key in VAL_KEYS:
            name = f"val/retrieval_{key}"
            np.testing.assert_allclose(g[name], w[name], rtol=0, atol=1e-4, err_msg=name)


def test_fit_with_adamw_matches_jax_in_distribution(tmp_path, monkeypatch):
    run, want = fit_both(tmp_path, monkeypatch)
    ndcg, want_ndcg = run["ndcg"], want[-1]["val/retrieval_normalized_dcg"]
    hit, want_hit = run["hit_rate"], want[-1]["val/retrieval_hit_rate"]
    print(f"port ndcg {ndcg:.6f} hit {hit:.4f}; JAX ndcg {want_ndcg:.6f} hit {want_hit:.4f}; "
          f"|d ndcg| {abs(ndcg - want_ndcg):.3g}")
    assert ndcg > 0.05 and want_ndcg > 0.05
    assert abs(ndcg - want_ndcg) < 0.08
    assert abs(hit - want_hit) < 0.15


# -- the protocols' configurations ------------------------------------------------------------


def test_seed_spread_configs_are_the_jax_scripts(tmp_path):
    root = str(tmp_path)
    for seed in (0, 3):
        got, got_data = Q.seed_spread_configs(seed, root)
        # scripts/parity_seed_spread.py:49-71
        want_data = JaxDataConfig(
            data_dir=f"{root}/data", dataset="synthetic", embedder="hash", embedding_dim=384,
            max_seq_length=32, batch_size=32, synthetic_num_users=6040,
            synthetic_num_items=3706, synthetic_num_events=1_000_000)
        want = JaxTrainConfig(
            hidden_size=384, num_hidden_layers=1, num_attention_heads=12, intermediate_size=48,
            max_seq_length=32, compute_dtype="float32", hidden_dropout=0.0,
            attention_dropout=0.0, train_loss="InfoNCELoss", learning_rate=1e-3, max_epochs=2,
            early_stopping_patience=99, eval_batch_size=256, top_k=10,
            log_every_n_steps=100_000, use_mlflow=False, seed=seed,
            ckpt_dir=f"{root}/ckpt_s{seed}")
        assert_same_config(got, want)
        assert_same_config(got_data, want_data)


def test_quality_configs_are_the_jax_script(tmp_path):
    root = str(tmp_path)
    got, got_data = Q.quality_configs(2, root)
    # scripts/quality_run.py:53-80, the paths the tool's and the model seed 2
    want_data = JaxDataConfig(
        data_dir=f"{root}/data", dataset="synthetic", embedder="hash", embedding_dim=384,
        max_seq_length=32, batch_size=256, synthetic_num_users=6040, synthetic_num_items=3706,
        synthetic_num_events=1_000_000)
    want = JaxTrainConfig(
        hidden_size=384, num_hidden_layers=1, num_attention_heads=12, intermediate_size=48,
        max_seq_length=32, train_loss="InfoNCELoss", learning_rate=1e-3, max_epochs=8,
        early_stopping_patience=3, eval_batch_size=256, top_k=20, log_every_n_steps=50,
        steps_per_dispatch=8, checkpoint_every_epoch=False, ckpt_dir=f"{root}/ckpt_s2", seed=2)
    assert_same_config(got, want)
    assert_same_config(got_data, want_data)
    assert Q.quality_configs(0, root, epochs=3)[0].max_epochs == 3


@pytest.mark.parametrize("name", ["ml1m_reference", "ml1m_ssm", "ml100k_bpr"])
def test_config_configs_are_the_jax_script(tmp_path, name):
    root, path = str(tmp_path), REPO / "configs" / f"{name}.yaml"
    sizes = dict(users=943, items=1682, events=100_000, epochs=16)
    got, got_data, overrides = Q.config_configs(str(path), 1, root, **sizes)
    # scripts/quality_run_config.py:61-80, the paths the tool's
    model = dict(max_epochs=16, early_stopping_patience=4, log_every_n_steps=100,
                 steps_per_dispatch=8, checkpoint_every_epoch=False,
                 ckpt_dir=f"{root}/ckpt_s1", mesh={"data_axis_size": 1, "model_axis_size": 1})
    data = dict(dataset="synthetic", embedder="hash", data_dir=f"{root}/data",
                synthetic_num_users=943, synthetic_num_items=1682,
                synthetic_num_events=100_000)
    payload = yaml.safe_load(path.read_text())
    payload["model"].update(model)
    payload["data"].update(data)
    want = JaxTrainConfig.model_validate(payload["model"] | {"seed": 1})
    assert_same_config(got, want)
    assert_same_config(got_data, JaxDataConfig.model_validate(payload["data"]))
    assert overrides == {"model": model, "data": data}


# -- the CLI -------------------------------------------------------------------------------------


def test_cli_config_run_on_the_cpu(tmp_path):
    out = tmp_path / "run.json"
    rc = Q.main(["config", "--config", str(REPO / "configs" / "ml100k_bpr.yaml"), "--users", "60",
                 "--items", "80", "--events", "3000", "--epochs", "2", "--device", "cpu",
                 "--root", str(tmp_path / "work"), "--out", str(out)])
    assert rc == 0
    record = json.loads(out.read_text())
    assert record["protocol"] == "config" and record["device"] == {"device": "cpu", "card": None}
    assert record["jax"]["file"] == "QUALITY_RUN_100K.json"
    assert record["overrides"]["data"]["synthetic_num_events"] == 3000
    (run,) = record["runs"]
    history = run["val_history"]
    assert [r["epoch"] for r in history] == [0, 1]
    assert all(np.isfinite(r["val/retrieval_normalized_dcg"]) for r in history)
    walls = [r["wall_s"] for r in history]
    assert 0 < walls[0] < walls[1] <= run["fit_wall_s"]
    # 80 items: the first validation is already above the JAX record's 0.0194
    assert run["time_to_target_s"] == walls[0]
    assert run["val"]["val/retrieval_normalized_dcg"] == history[-1][
        "val/retrieval_normalized_dcg"]
    assert set(run["test"]) >= {"test/retrieval_normalized_dcg", "test/retrieval_hit_rate"}
    assert run["launches"] == {}  # the plain versions launch nothing
    assert run["steps"] > 0 and run["examples_per_s"] > 0 and run["ms_per_step"] > 0
    # what the launches add up from: no graph on the CPU, one validation
    # each epoch, a logging step every 100 of the windowed loop's steps
    assert run["validations"] == len(history) and run["validate_launches"] == {}
    assert run["warmup_steps"] == 0 and run["log_steps"] == run["steps"] // 100
    assert record["data"]["items"] == 80 and record["data"]["val_users"] > 0
    assert {"epoch_wall", "validate"} <= set(run["phase_seconds"])


def test_cli_seed_spread_gate_exits_nonzero_outside_the_range(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(Q.ML1M_SHAPE, "synthetic_num_users", 60)
    monkeypatch.setitem(Q.ML1M_SHAPE, "synthetic_num_items", 80)
    monkeypatch.setitem(Q.ML1M_SHAPE, "synthetic_num_events", 3000)
    monkeypatch.setitem(Q.REFERENCE, "hidden_size", 32)
    monkeypatch.setitem(Q.REFERENCE, "num_attention_heads", 4)
    out = tmp_path / "spread.json"
    rc = Q.main(["seed-spread", "--seeds", "2", "--device", "cpu", "--root", str(tmp_path / "w"),
                 "--out", str(out)])
    record = json.loads(out.read_text())
    lo, hi = record["gate"]
    # 80 items: every NDCG@10 lies far above JAX's ML-1M-shape range
    assert record["mean_ndcg"] > hi and record["passed"] is False and rc == 1
    assert [r["seed"] for r in record["runs"]] == [0, 1]
    assert record["mean_ndcg"] == pytest.approx(np.mean([r["ndcg"] for r in record["runs"]]))
    assert "FAIL" in capsys.readouterr().err


def test_cli_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Q.main(["seed-spread", "--root", str(tmp_path), "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_cli_never_writes_a_root_record(tmp_path):
    before = (REPO / "PARITY_SEED_SPREAD.json").read_bytes()
    with pytest.raises(SystemExit, match="root of the repository"):
        Q.main(["seed-spread", "--device", "cpu", "--root", str(tmp_path),
                "--out", str(REPO / "PARITY_SEED_SPREAD.json")])
    assert (REPO / "PARITY_SEED_SPREAD.json").read_bytes() == before


# -- the records ------------------------------------------------------------------------------


def test_the_jax_records_as_read():
    spread = Q.jax_record("PARITY_SEED_SPREAD.json")
    assert spread["val_ndcg"] == 0.02303 and spread["spread"] == 0.00562
    assert spread["ndcg10"] == [0.0266, 0.02287, 0.02371, 0.02098, 0.021]
    assert np.mean(spread["hit10"]) == pytest.approx(0.2556, abs=1e-4)
    lo, hi = Q.gate(spread)
    assert (lo, hi) == pytest.approx((0.02022, 0.02584), abs=1e-12)
    for name, val, test in (("QUALITY_RUN.json", 0.0389, 0.0389),
                            ("QUALITY_RUN_ML1M_REF.json", 0.028, 0.0329),
                            ("QUALITY_RUN_ML1M_SSM.json", 0.0214, 0.0204),
                            ("QUALITY_RUN_100K.json", 0.0194, 0.0174)):
        assert Q.jax_record(name) == {"file": name, "val_ndcg": val, "test_ndcg": test}
    assert Q.config_record("configs/ml1m_reference.yaml") == "QUALITY_RUN_ML1M_REF.json"
    assert Q.config_record("configs/ml100k_bpr.yaml") == "QUALITY_RUN_100K.json"
    for config in ("configs/synthetic_smoke.yaml", "configs/ml25m_ccl.yaml"):
        # QUALITY_RUN_25M.json comes from another protocol (scripts/quality_run_25m.py)
        with pytest.raises(ValueError, match="no JAX quality record"):
            Q.config_record(config)


def test_a_missing_record_fails_loudly(tmp_path, monkeypatch):
    monkeypatch.setattr(Q, "REPO", tmp_path)
    with pytest.raises(FileNotFoundError, match="QUALITY_RUN.json"):
        Q.jax_record("QUALITY_RUN.json")
