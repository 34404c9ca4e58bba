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


def tiny_protocol(root: pathlib.Path, data=None, **model):
    """The seed-spread protocol's configs at the tiny size."""
    train, data_cfg = Q.seed_spread_configs(0, str(root))
    return (train.replace(**TINY_MODEL, **model),
            data_cfg.replace(**TINY_DATA, **(data or {}), data_dir=str(root / "data")))


def fit_both(root: pathlib.Path, monkeypatch, data=None, **model):
    """The tool's fit (``fit_run``) and the JAX trainer's over the same
    batches from JAX's initial parameters: (port run, JAX val metrics by
    epoch)."""
    real_devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: real_devices(*a, **kw)[:1])
    monkeypatch.setattr(jax_module, "SeqData",
                        functools.partial(jax_dataset.SeqData, backend="numpy"))
    monkeypatch.setattr(port_module, "SeqData", functools.partial(SeqData, backend="numpy"))
    train, data = tiny_protocol(root, data, **model)

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


# the parity protocol's two loss paths at the tiny size: its 32 hard
# negatives of a 1,024-row pool as 4 of the tiny batch's 128 rows, and its
# positive from the next 8 events (the tiny seq is 8)
SGD_CASES = {
    "infonce": ({}, {}),
    "hard32": ({"num_hard_negatives": 4}, {}),
    "lookahead8": ({}, {"pos_lookahead": 8}),
}


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_fit_with_sgd_matches_jax_every_epoch(tmp_path, monkeypatch, case):
    monkeypatch.setattr(JTS, "make_flat_update", sgd(1e-4, jnp))
    monkeypatch.setattr(TTS, "make_flat_update", sgd(1e-4, torch))
    model, data = SGD_CASES[case]
    run, want = fit_both(tmp_path, monkeypatch, data, use_fused_loss=False,
                         mask_false_negatives=False, **model)
    got = run["val_history"]
    assert [r["epoch"] for r in got] == [0, 1, 2]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert run["untrained"]["val/retrieval_normalized_dcg"] != got[-1][
        "val/retrieval_normalized_dcg"]  # the fit moved the ranks
    worst = max(abs(g[f"val/retrieval_{k}"] - w[f"val/retrieval_{k}"])
                for g, w in zip(got, want) for k in VAL_KEYS)
    print(f"{case}: final val ndcg {run['ndcg']:.6f}; max |val metric difference| over "
          f"{len(got)} epochs: {worst:.3g}")
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


# scripts/parity_ml1m.py:54-78: (D, L, H, F, S), the batch, the loss configs
JAX_PARITY_SHAPES = {False: ((64, 2, 4, 128, 16), 64), True: ((384, 1, 12, 48, 32), 32)}
JAX_PARITY_CONFIGS = [
    {"name": "InfoNCE", "train_loss": "InfoNCELoss"},
    {"name": "BPR", "train_loss": "PairwiseLogisticLoss", "margin": 0.0},
    {"name": "CCL-cosine", "train_loss": "ContrastiveLoss", "margin": 0.5},
    {"name": "InfoNCE+lookahead8", "train_loss": "InfoNCELoss", "pos_lookahead": 8},
    {"name": "InfoNCE+hard32", "train_loss": "InfoNCELoss", "num_hard_negatives": 32},
]


@pytest.mark.parametrize("reference_shape", [False, True], ids=["ml1m", "refshape"])
def test_parity_configs_are_the_jax_script(tmp_path, reference_shape):
    root = str(tmp_path)
    specs = Q.parity_specs(reference_shape)
    assert list(specs) == JAX_PARITY_CONFIGS[:3 if reference_shape else 5]
    (d, layers, heads, ffn, s), batch = JAX_PARITY_SHAPES[reference_shape]
    for spec in specs:
        for seed in (0, 2):
            got, got_data = Q.parity_configs(spec, seed, root, reference_shape=reference_shape)
            # scripts/parity_ml1m.py:84-121, the paths the tool's and the model seed
            lookahead = spec.get("pos_lookahead", 0)
            want_data = JaxDataConfig(
                data_dir=f"{root}/data_la{lookahead}", dataset="synthetic", embedder="hash",
                embedding_dim=d, max_seq_length=s, pos_lookahead=lookahead, batch_size=batch,
                synthetic_num_users=6040, synthetic_num_items=3706,
                synthetic_num_events=1_000_000)
            want = JaxTrainConfig(
                hidden_size=d, num_hidden_layers=layers, num_attention_heads=heads,
                intermediate_size=ffn, max_seq_length=s, compute_dtype="float32",
                hidden_dropout=0.0, attention_dropout=0.0, train_loss=spec["train_loss"],
                margin=spec.get("margin", 0.5),
                num_hard_negatives=spec.get("num_hard_negatives", 0), learning_rate=1e-3,
                max_epochs=2, early_stopping_patience=99, eval_batch_size=256, top_k=10,
                log_every_n_steps=100_000, use_mlflow=False, seed=seed,
                ckpt_dir=f"{root}/ckpt_{spec['name']}_s{seed}")
            assert_same_config(got, want)
            assert_same_config(got_data, want_data)
            assert got.steps_per_dispatch == 1  # eager, as JAX's default


def test_the_parity_records_as_read():
    r = Q.relative_spread()
    assert r == pytest.approx(0.00562 / 0.02303)
    ml1m, ref = Q.parity_record(False), Q.parity_record(True)
    assert list(ml1m) == [c["name"] for c in JAX_PARITY_CONFIGS]
    assert list(ref) == [c["name"] for c in JAX_PARITY_CONFIGS[:3]]
    for name, ours, theirs in (("InfoNCE", 0.014044436431865474, 0.013612177222967148),
                               ("InfoNCE+hard32", 0.03834071337197131, 0.039407216012477875)):
        entry = ml1m[name]
        assert (entry["ndcg_ours"], entry["ndcg_torch"]) == (ours, theirs)
        assert entry["val_ndcg"] == ours and entry["file"] == "PARITY_ML1M.json"
        assert Q.parity_gate(entry, r) == pytest.approx((min(ours, theirs) * (1 - r),
                                                         max(ours, theirs) * (1 + r)))
    # the ranges to four places: hard32 [0.0290, 0.0490], InfoNCE [0.0103, 0.0175]
    assert Q.parity_gate(ml1m["InfoNCE+hard32"], r) == pytest.approx((0.0290, 0.0490), abs=1e-4)
    assert Q.parity_gate(ml1m["InfoNCE"], r) == pytest.approx((0.0103, 0.0175), abs=1e-4)
    assert ref["InfoNCE"]["ndcg_ours"] == 0.026601559745074825
    assert ref["CCL-cosine"]["file"] == "PARITY_REFSHAPE.json"
    # the ordering the gate holds the port to: hard32 above InfoNCE in both columns
    for key in ("ndcg_ours", "ndcg_torch"):
        assert ml1m["InfoNCE+hard32"][key] > ml1m["InfoNCE"][key]


def fake_fit(means: dict):
    """A stand-in for ``fit_seeds``: each config's seeds read its mean."""
    def fit(configs, seeds, *, device, root, record, test, log=print, datamodules=None):
        train, data = configs(0)
        name = pathlib.Path(root).name
        mean = means[name]
        runs = [{"seed": s, "ndcg": mean, "untrained": {Q.NDCG: 0.004},
                 "val_history": [{Q.NDCG: 0.03}, {Q.NDCG: mean}]} for s in range(seeds)]
        return {"jax": record, "runs": runs, "mean_ndcg": mean,
                "train_config": dataclasses.asdict(train), "data_config": dataclasses.asdict(data)}

    return fit


# each config's mean: in its range, one below it, the ordering lost, one above
PARITY_GATE_CASES = {
    "in_range": ({}, 0),
    "below": ({"BPR": 0.004}, 1),
    "ordering": ({"InfoNCE": 0.0310, "InfoNCE+hard32": 0.0300}, 1),
    "above_is_reported": ({"CCL-cosine": 0.05}, 0),
}


@pytest.mark.parametrize("case", sorted(PARITY_GATE_CASES))
def test_cli_parity_gate(tmp_path, monkeypatch, capsys, case):
    r = Q.relative_spread()
    records = Q.parity_record(False)
    means = {name: (e["ndcg_ours"] + e["ndcg_torch"]) / 2 for name, e in records.items()}
    change, want_rc = PARITY_GATE_CASES[case]
    means |= change
    monkeypatch.setattr(Q, "fit_seeds", fake_fit(means))
    out = tmp_path / "parity.json"
    rc = Q.main(["parity-ml1m", "--seeds", "2", "--device", "cpu", "--root",
                 str(tmp_path / "w"), "--out", str(out)])
    record = json.loads(out.read_text())
    assert rc == want_rc and record["passed"] is (want_rc == 0)
    assert record["protocol"] == "parity-ml1m" and record["reference_shape"] is False
    assert record["relative_spread"] == r and record["seeds"] == [0, 1]
    assert list(record["configs"]) == list(records)
    for name, got in record["configs"].items():
        assert got["gate"] == pytest.approx(Q.parity_gate(records[name], r))
        assert got["ndcgs"] == [means[name]] * 2 and got["untrained_ndcg"] == [0.004] * 2
    assert record["ordering"] is (case != "ordering")
    verdicts = {name: c["verdict"] for name, c in record["configs"].items()}
    assert verdicts["BPR"] == ("below its range" if case == "below" else "in range")
    assert verdicts["CCL-cosine"] == ("above its range" if case == "above_is_reported"
                                      else "in range")
    assert len(record["failures"]) == want_rc
    assert ("FAIL" if want_rc else "PASS") in capsys.readouterr().err


def test_parity_protocol_on_the_cpu(tmp_path, monkeypatch):
    """The two loss paths the card had never run, through the real fits at a
    tiny size: each reads the data keyed by its lookahead and writes a
    record with the keys the gate reads."""
    monkeypatch.setitem(Q.ML1M_SHAPE, "synthetic_num_users", 60)
    monkeypatch.setitem(Q.ML1M_SHAPE, "synthetic_num_items", 80)
    monkeypatch.setitem(Q.ML1M_SHAPE, "synthetic_num_events", 3000)
    monkeypatch.setitem(Q.PARITY_SHAPES, False, (dict(Q.PARITY_SHAPES[False][0],
                                                      max_seq_length=8), 16))
    names = ("InfoNCE+lookahead8", "InfoNCE+hard32")
    out = Q.parity_ml1m(1, device=torch.device("cpu"), root=str(tmp_path), names=names,
                        log=lambda m: None)
    assert list(out["configs"]) == list(names) and out["ordering"] is None
    la8, hard = (out["configs"][n] for n in names)
    assert la8["data_config"]["data_dir"] == f"{tmp_path}/data_la8"
    assert la8["data_config"]["pos_lookahead"] == 8
    assert hard["data_config"]["data_dir"] == f"{tmp_path}/data_la0"
    assert hard["train_config"]["num_hard_negatives"] == 32
    for summary in (la8, hard):
        (run,) = summary["runs"]
        assert np.isfinite(run["ndcg"]) and run["launches"] == {}
        assert summary["untrained_ndcg"] == [run["untrained"][Q.NDCG]]
        assert summary["verdict"] in ("below its range", "in range", "above its range")
    assert (tmp_path / "data_la8" / "synthetic" / "users.json").is_file()


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
