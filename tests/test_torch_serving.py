"""The port's serving slice end to end on the CPU.

A serving artifact is built by the JAX trainer (as tests/test_serving.py
does), once without and once with a learned input projection.  The JAX
``Service`` and the port's ``Service(device="cpu")`` load the same
artifact and answer the same requests on all nine APIs: the same item ids
in the same order, and scores and embeddings within 1e-4 (both f32
compute; sums in another order).  Also here: ``chip_smoke.py``'s serving
phase rehearsed on the CPU, the default device raising without a card,
and the port importing nothing of JAX.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import transformer_recommenders_tpu_torch as port_pkg
from transformer_recommenders_tpu.serving import deploy as jax_deploy
from transformer_recommenders_tpu.serving.asgi import TestClient as JaxClient
from transformer_recommenders_tpu.serving.service import Service as JaxService
from transformer_recommenders_tpu_torch.ops import cuda_build
from transformer_recommenders_tpu_torch.serving import deploy as port_deploy
from transformer_recommenders_tpu_torch.serving import asgi
from transformer_recommenders_tpu_torch.serving.service import Query, Service

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4


def _projection_trainer(work: pathlib.Path):
    from transformer_recommenders_tpu.configs import SeqDataModuleConfig, TrainConfig
    from transformer_recommenders_tpu.data.module import SeqDataModule
    from transformer_recommenders_tpu.training.trainer import Trainer

    data_config = SeqDataModuleConfig(
        data_dir=str(work / "data"), dataset="synthetic", embedder="hash", embedding_dim=48,
        max_seq_length=8, batch_size=8, synthetic_num_users=40, synthetic_num_items=60,
        synthetic_num_events=2000,
    )
    config = TrainConfig(
        input_dim=48, hidden_size=16, num_hidden_layers=1, num_attention_heads=4,
        intermediate_size=16, max_seq_length=8, compute_dtype="float32", max_epochs=1,
        limit_train_batches=2, eval_batch_size=16, log_every_n_steps=1000,
        ckpt_dir=str(work / "ckpt"),
    )
    trainer = Trainer(config, SeqDataModule(data_config), log_dir=str(work / "logs"))
    trainer.fit()
    return trainer


@pytest.fixture(scope="module", params=["plain", "projection"])
def services(request, tmp_path_factory):
    work = tmp_path_factory.mktemp(f"artifact_{request.param}")
    if request.param == "plain":
        trainer = jax_deploy._fast_dev_trainer(str(work))
    else:
        trainer = _projection_trainer(work)
    trainer.save(work / "artifact")
    trainer.close()
    return JaxService(work / "artifact"), Service(work / "artifact", device="cpu")


def _same(got, want, where="") -> None:
    """Equal structure and values; floats within TOL."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (where, got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), (where, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def test_nine_apis_match_jax_service(services):
    jax_svc, port_svc = services
    jax_client, client = JaxClient(jax_svc.to_asgi()), asgi.TestClient(port_svc.to_asgi())
    items = jax_svc.item_index.index.store.records["item_id"].tolist()
    users = jax_svc.user_index.index.store.records["user_id"].tolist()
    d = jax_svc.model.embed_dim
    embeds = np.random.default_rng(0).normal(size=(3, d)).round(4).tolist()
    requests = [
        ("item_id", {"item_id": items[0]}),
        ("user_id", {"user_id": users[0]}),
        ("recommend_with_item_id", {"item_id": items[1], "top_k": 10}),
        ("recommend_with_item_id", {"item_id": items[2], "exclude_item_ids": items[3:6]}),
        ("recommend_with_user_id", {"user_id": users[0]}),
        ("recommend_with_user_id", {"user_id": users[5], "top_k": 5}),
        ("recommend_with_query", {"query": {"item_ids": items[:3], "top_k": 7}}),
        ("recommend_with_query", {"query": {"input_embeds": embeds}}),
        ("recommend_with_query", {"query": {}}),
        ("embed_query", {"query": {"item_ids": [items[0], "does-not-exist", items[4]]}}),
        ("search_item_text", {"text": jax_svc.item_index.get_id(items[0]).item_text}),
        ("search_item_text", {"text": "movie", "top_k": 5, "exclude_item_ids": items[:2]}),
        ("model_name", {}),
        ("model_version", {}),
        ("item_id", {"item_id": "missing"}),
        ("user_id", {"user_id": "missing"}),
        ("recommend_with_item_id", {}),
    ]
    routes = set()
    for name, payload in requests:
        want = jax_client.post(name, payload)
        got = client.post(name, payload)
        assert got.status_code == want.status_code, (name, payload, got.json())
        if want.ok:
            _same(got.json(), want.json(), name)
            routes.add(name)
    assert len(routes) == 9


def test_deploy_smoke_on_jax_artifact(services):
    port_deploy.test_queries(services[1])


def test_batched_embed_matches_jax(services):
    jax_svc, port_svc = services
    d = jax_svc.model.embed_dim
    rng = np.random.default_rng(1)
    payloads = [rng.normal(size=(n, d)).tolist() for n in (5, 2, 9)] + [None]
    from transformer_recommenders_tpu.serving.service import Query as JaxQuery

    want = jax_svc.model.embed([JaxQuery(input_embeds=p) for p in payloads])
    got = port_svc.model.embed([Query(input_embeds=p) for p in payloads])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.embedding, w.embedding, rtol=TOL, atol=TOL)


def test_query_validation_rejects_malformed_fields(services):
    client = asgi.TestClient(services[1].to_asgi())
    for payload in ({"query": {"item_ids": [1, 2]}}, {"query": {"top_k": "many"}},
                    {"query": {"input_embeds": [[0.1, "x"]]}}):
        assert client.post("recommend_with_query", payload).status_code == 400


def test_chip_smoke_serving_phase_rehearsal():
    """chip_smoke.py's serving phase (artifact writer, nine APIs, a burst of
    concurrent requests, embeddings held against the CPU path) at a small
    size on the CPU."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    launches = chip_smoke.serving_phase(device="cpu", num_items=120, num_users=50, requests=24)
    assert launches == dict.fromkeys(cuda_build.KERNELS, 0)  # the plain path runs no kernel


def test_chip_smoke_training_phase_rehearsal():
    """chip_smoke.py's training phase (one step against the CPU's plain path,
    the launch counts, a fixed batch's loss falling, the step time) at a
    small size on the CPU."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    tiny = dict(input_dim=48, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_seq_length=8, learning_rate=1e-2)
    launches = chip_smoke.training_phase(device="cpu", config=tiny, num_items=60, batch_size=8,
                                         steps=12, timed_steps=2)
    assert launches == dict.fromkeys(cuda_build.KERNELS, 0)


@pytest.mark.parametrize(("config", "num_items", "full_logs", "steps"), [
    # path A at a small size: the logging step over a catalog the hot
    # step's table gate admits
    (dict(input_dim=48, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
          intermediate_size=64, max_seq_length=8, learning_rate=1e-2), 60, True, 0),
    # path B at a small size: no projection, a catalog of more than twice
    # the pool, the hot step
    (dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4, intermediate_size=8,
          max_seq_length=8, learning_rate=1e-2), 200, False, 12),
], ids=["logging-step", "reference-hot-step"])
def test_chip_smoke_pool_training_rehearsal(config, num_items, full_logs, steps):
    """chip_smoke.py's phase 7 (the step and, for the logging step, every
    log against the CPU's plain path, the launch counts, the fixed-batch
    loss, the step time) at a small size on the CPU."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    launches = chip_smoke.training_phase(device="cpu", config=config, num_items=num_items,
                                         batch_size=4, steps=steps, timed_steps=1,
                                         full_logs=full_logs)
    assert launches == dict.fromkeys(cuda_build.KERNELS, 0)


def test_chip_smoke_expects_each_paths_kernels():
    """The launch counts chip_smoke.py holds each card path to."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from transformer_recommenders_tpu_torch.configs import TrainConfig

    flagship, reference = TrainConfig(**chip_smoke.TRAIN), TrainConfig(**chip_smoke.REFERENCE)
    ml100k = TrainConfig(**chip_smoke.ML100K)
    # the fused paths: #16 forward and backward at the embedding site alone
    common = {"gather_rows": 1, "table_infonce_fwd": 0, "table_infonce_bwd": 0,
              "pool_infonce_fwd": 1, "pool_infonce_dq": 1, "pairwise_fwd": 0, "pairwise_dq": 0,
              "pairwise_dn": 0, "vpu_chain": 0, "fused_layer_stage_fwd": 0,
              "fused_layer_stage_bwd": 0, "hash_dropout": 2, "attn_core_fwd": 0,
              "attn_core_bwd": 0, "dense_fwd": 0, "dense_dgrad": 0, "dense_wgrad": 0,
              "dense_plain": 0}
    # #19 under bf16: the catalog's projection, forward and wgrad (its
    # frozen rows take no dgrad), and each stack layer's four denses
    projection = {"dense_fwd": 1, "dense_wgrad": 1}
    assert chip_smoke.expected_launches(flagship, 3707, 4096, full_logs=False) == {
        **common, "gather_rows_bwd": 1, "fused_layer": 4, "fused_layer_bwd": 4,
        "table_infonce_fwd": 1, "table_infonce_bwd": 1, "pool_infonce_fwd": 0,
        "pool_infonce_dq": 0, "pool_infonce_dn": 0, **projection}
    assert chip_smoke.expected_launches(flagship, 3707, 4096, full_logs=True) == {
        **common, "gather_rows_bwd": 1, "fused_layer": 4, "fused_layer_bwd": 4,
        "pool_infonce_dn": 1, **projection}
    assert chip_smoke.expected_launches(reference, 3707, 1024, full_logs=False) == {
        **common, "gather_rows_bwd": 0, "fused_layer": 1, "fused_layer_bwd": 1,
        "pool_infonce_dn": 0}
    # path C: the 1,683-row catalog is projected whole, then gathered; its
    # d=64 layers fail the fused-layer gate and run the layer stack: #16 at
    # the embedding site and at each layer's masked f32 probs and two hidden
    # sites, forward and backward (2 + 2 * 3 * 2)
    for full_logs in (False, True):
        assert chip_smoke.expected_launches(ml100k, 1683, 4096, full_logs) == {
            **common, "gather_rows_bwd": 1, "fused_layer": 0, "fused_layer_bwd": 0,
            "pool_infonce_fwd": 0, "pool_infonce_dq": 0, "pool_infonce_dn": 0,
            "pairwise_fwd": 1, "pairwise_dq": 1, "pairwise_dn": 1, "hash_dropout": 14,
            "dense_fwd": 1 + 2 * 4, "dense_dgrad": 2 * 4, "dense_wgrad": 1 + 2 * 4}
    # configs/ml25m_ccl.yaml: seq 128, the split bf16 core at dh 32, so #17
    # and #18 once a layer, #16 at the embedding and the hidden sites (2 + 6
    # * 2 * 2); with remat_layers each layer's forward runs twice
    scale = TrainConfig.from_dict(chip_smoke.scale_sections()[0])
    assert chip_smoke.expected_launches(scale, 62001, 32768, full_logs=False) == {
        **common, "gather_rows_bwd": 1, "fused_layer": 0, "fused_layer_bwd": 0,
        "pool_infonce_fwd": 0, "pool_infonce_dq": 0, "pool_infonce_dn": 0,
        "pairwise_fwd": 1, "pairwise_dq": 1, "pairwise_dn": 1, "hash_dropout": 26,
        "attn_core_fwd": 6, "attn_core_bwd": 6,
        "dense_fwd": 1 + 6 * 4, "dense_dgrad": 6 * 4, "dense_wgrad": 1 + 6 * 4}
    remat = TrainConfig.from_dict({**chip_smoke.scale_sections()[0], "remat_layers": True})
    got = chip_smoke.expected_launches(remat, 62001, 32768, full_logs=False)
    assert (got["hash_dropout"], got["attn_core_fwd"], got["attn_core_bwd"]) == (2 + 6 * 6, 12, 6)
    assert (got["dense_fwd"], got["dense_dgrad"], got["dense_wgrad"]) == (1 + 2 * 24, 24, 25)
    assert set(chip_smoke.expected_launches(reference, 3707, 1024, False)) == \
        set(cuda_build.KERNELS)
    # hard negatives turn the fused losses off: the plain objective, no #5-#12
    # (the parity protocol's hard32 at d=64: the layer stack, f32, dropout 0)
    from transformer_recommenders_tpu_torch.tools import quality_run as Q

    hard32 = Q.parity_configs(Q.PARITY_CONFIGS[4], 0, "/unused")[0]
    assert chip_smoke.expected_launches(hard32, 3707, 1024, full_logs=False) == {
        **common, "gather_rows_bwd": 0, "fused_layer": 0, "fused_layer_bwd": 0,
        "pool_infonce_fwd": 0, "pool_infonce_dq": 0, "pool_infonce_dn": 0, "hash_dropout": 0}
    assert chip_smoke.expected_eval_launches(hard32, 600) == dict.fromkeys(
        cuda_build.KERNELS, 0) | {"gather_rows": 3}


@pytest.mark.parametrize("train_loss", ["PairwiseLogisticLoss", "ContrastiveLoss", "NCELoss",
                                        "AlignmentContrastiveLoss"])
def test_chip_smoke_pairwise_training_rehearsal(train_loss):
    """chip_smoke.py's phase 9 (path C's step and the other pairwise
    heads: one step against the CPU's plain path, the launch counts, the
    fixed-batch loss) at a small size on the CPU."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    config = {**chip_smoke.ML100K, "input_dim": 48, "hidden_size": 32, "intermediate_size": 64,
              "max_seq_length": 8, "learning_rate": 1e-2, "train_loss": train_loss,
              "margin": 0.0 if train_loss == "PairwiseLogisticLoss" else 1.0}
    steps = 12 if train_loss == "PairwiseLogisticLoss" else 0
    launches = chip_smoke.training_phase(device="cpu", config=config, num_items=60, batch_size=4,
                                         steps=steps, timed_steps=1 if steps else 0)
    assert launches == dict.fromkeys(cuda_build.KERNELS, 0)


def test_chip_smoke_accumulation_rehearsal():
    """chip_smoke.py's accumulation check at a small size on the CPU."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    tiny = dict(input_dim=48, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_seq_length=8)
    chip_smoke.accumulation_phase(device="cpu", config=tiny, num_items=60, batch_size=4)


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from transformer_recommenders_tpu_torch.configs import ModelConfig
    from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel

    cfg = ModelConfig(hidden_size=16, num_attention_heads=2, intermediate_size=16,
                      max_seq_length=8)
    model = RecommenderModel(cfg, device="cpu")
    model.configure_embeddings(["a", "b"], np.eye(2, 16, dtype=np.float32))
    port_deploy.save_artifact(
        model, [{"item_id": "a", "item_text": "x"}, {"item_id": "b", "item_text": "y"}],
        [{"user_id": "u", "user_text": "", "history": {"item_id": ["a"], "item_text": ["x"]}}],
        tmp_path,
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pkg.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RecommenderModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Service(tmp_path)
    assert Service(tmp_path, device="cpu").device == torch.device("cpu")


def _port_files():
    pkg = pathlib.Path(port_pkg.__file__).parent
    return sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    """No import statement anywhere in the port or chip_smoke.py (module
    level or inside a function) names jax or the JAX package."""
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "transformer_recommenders_tpu"), (path, name)


def test_importing_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import transformer_recommenders_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'transformer_recommenders_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
