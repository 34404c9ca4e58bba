"""The rank program of ``tests/test_torch_parallel.py``: one process of a
gloo world on the CPU.  It imports torch and the port only, never JAX, and
holds no test of its own (pytest collects nothing here).

    python tests/test_torch_parallel_ranks.py <workdir> <rank> <world> <port>

It reads ``<workdir>/inputs.pkl`` (written by the test: the mesh shape,
configs, weights and inputs, all numpy), joins the group at
``tcp://127.0.0.1:<port>``, runs every check of the spec on the mesh and
writes what it got to ``<workdir>/rank<rank>.pkl``; on an exception, the
traceback to ``<workdir>/rank<rank>.err`` and exit code 1.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import sys
import traceback

REPO = pathlib.Path(__file__).resolve().parents[1]


def sgd_update(lr: float):
    """``make_flat_update``'s stand-in: plain SGD (what the parity tests
    patch in on both sides)."""
    import torch

    def make(config):
        def update(p, g, opt_state):
            return p - lr * g, opt_state, torch.sqrt(torch.sum(g * g))

        return update

    return make


def mesh_errors(world: int) -> dict[str, str]:
    """``create_mesh``'s refusals, by the shape asked for."""
    from transformer_recommenders_tpu_torch.configs import MeshConfig
    from transformer_recommenders_tpu_torch.parallel.mesh import create_mesh

    out = {}
    for name, cfg in (("model_not_dividing", MeshConfig(model_axis_size=world + 1)),
                      ("too_large", MeshConfig(data_axis_size=2 * world)),
                      ("too_small", MeshConfig(data_axis_size=1, model_axis_size=1))):
        try:
            create_mesh(cfg, "cpu")
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def run_lookup(spec, mesh) -> dict:
    import torch

    from transformer_recommenders_tpu_torch.parallel.embedding import (
        place_table,
        sharded_table_lookup,
    )

    shard = place_table(torch.from_numpy(spec["table"]), mesh)
    idx = torch.from_numpy(spec["idx"])
    return {"rows": sharded_table_lookup(shard, idx, mesh).numpy(),
            "shard_rows": shard.shape[0]}


def run_topk(spec, mesh) -> dict:
    import torch

    from transformer_recommenders_tpu_torch.parallel.embedding import place_table
    from transformer_recommenders_tpu_torch.parallel.topk_sharded import sharded_topk

    shard = place_table(torch.from_numpy(spec["items"]), mesh)
    out = {}
    for metric in ("dot", "cosine"):
        for k in spec["ks"]:
            s, i = sharded_topk(torch.from_numpy(spec["queries"]), shard, k, mesh,
                                exclude_idx=torch.from_numpy(spec["exclude"]), metric=metric,
                                num_items=spec["items"].shape[0])
            out[(metric, k)] = (s.numpy(), i.numpy())
    return out


def _case(case, mesh):
    import torch

    from transformer_recommenders_tpu_torch.configs import TrainConfig
    from transformer_recommenders_tpu_torch.models.transformer import params_from_jax
    from transformer_recommenders_tpu_torch.parallel.embedding import place_table
    from transformer_recommenders_tpu_torch.parallel.mesh import shard_batch

    cfg = TrainConfig.from_json(case["config"])
    params = params_from_jax(case["params"], device="cpu")
    shard = place_table(torch.from_numpy(case["table"]), mesh)
    return cfg, params, shard, shard_batch(case["batch"], mesh)


def run_loss(case, mesh) -> dict:
    from transformer_recommenders_tpu_torch.parallel.train import make_sharded_loss_and_grad

    cfg, params, shard, batch = _case(case, mesh)
    fn = make_sharded_loss_and_grad(cfg, mesh, full_logs=case["full_logs"])
    loss, flat, logs, positives = fn(params, shard, batch, None)
    return {"loss": float(loss), "grad": flat.numpy(), "positives": float(positives),
            "logs": {k: float(v) for k, v in logs.items()}}


def run_scan(case, mesh) -> dict:
    """K scanned sharded steps (the eager loop under gloo) against K looped
    sharded train steps, with the same batches and seeds."""
    import numpy as np
    import torch

    from transformer_recommenders_tpu_torch.parallel import train as ptrain
    from transformer_recommenders_tpu_torch.training import scan_steps
    from transformer_recommenders_tpu_torch.training import train_state as ts

    ts.make_flat_update = sgd_update(case["lr"])
    cfg, params, shard, _ = _case(case, mesh)
    from transformer_recommenders_tpu_torch.parallel.mesh import shard_rows

    windows = {k: torch.from_numpy(np.ascontiguousarray(
        shard_rows(v.swapaxes(0, 1), mesh).swapaxes(0, 1))) for k, v in case["windows"].items()}
    seeds = torch.from_numpy(case["seeds"])
    state0 = ptrain.place_state(ts.init_train_state(cfg, params), mesh)
    scanned, logs = scan_steps.make_scanned_train_steps(cfg, mesh=mesh)(state0, shard, windows,
                                                                        seeds)
    step = ptrain.make_sharded_train_step(cfg, mesh, full_logs=False)
    state, losses = state0, []
    for i in range(seeds.shape[0]):
        state, step_logs = step(state, shard, {k: v[i] for k, v in windows.items()}, seeds[i])
        losses.append(step_logs[f"loss/{cfg.train_loss}"])
    return {
        "params_equal": torch.equal(ts.flatten(scanned.params), ts.flatten(state.params)),
        "losses_equal": torch.equal(logs[f"loss/{cfg.train_loss}"], torch.stack(losses)),
        "params": ts.flatten(scanned.params).numpy(),
        "losses": logs[f"loss/{cfg.train_loss}"].numpy(),
        "positives": logs["batch/positive_non_zero"].numpy(),
    }


def run_eval(case, mesh) -> dict:
    import torch

    from transformer_recommenders_tpu_torch.configs import TrainConfig
    from transformer_recommenders_tpu_torch.data.module import EvalArrays
    from transformer_recommenders_tpu_torch.models.transformer import params_from_jax
    from transformer_recommenders_tpu_torch.parallel.embedding import place_table
    from transformer_recommenders_tpu_torch.training.evaluator import ShardedEvaluator

    cfg = TrainConfig.from_json(case["config"])
    params = params_from_jax(case["params"], device="cpu")
    table = torch.from_numpy(case["table"])
    tables = (place_table(table, mesh), place_table(table[1:], mesh))
    arrays = EvalArrays(**case["arrays"])
    evaluator = ShardedEvaluator(cfg, mesh, num_items=table.shape[0] - 1)
    idx, scores = evaluator.recommend_batch(params, tables, arrays)
    return {"metrics": evaluator.run(params, tables, arrays), "idx": idx, "scores": scores}


def run_fit(case, rank: int) -> dict:
    """A Trainer fit on the mesh that ``case["model"]["mesh"]`` asks for;
    each rank logs and checkpoints to its own directory, so the test sees
    which ranks wrote."""
    import functools

    from transformer_recommenders_tpu_torch.configs import SeqDataModuleConfig, TrainConfig
    from transformer_recommenders_tpu_torch.data import module as port_module
    from transformer_recommenders_tpu_torch.data.dataset import SeqData
    from transformer_recommenders_tpu_torch.data.module import SeqDataModule
    from transformer_recommenders_tpu_torch.models.recommender import RecommenderModel
    from transformer_recommenders_tpu_torch.models.transformer import (
        params_from_jax,
        tree_leaves,
    )
    from transformer_recommenders_tpu_torch.training import train_state as ts
    from transformer_recommenders_tpu_torch.training.trainer import Trainer

    ts.make_flat_update = sgd_update(case["lr"])
    port_module.SeqData = functools.partial(SeqData, backend="numpy")
    root = pathlib.Path(case["root"])
    cfg = TrainConfig.from_dict({**case["model"], "ckpt_dir": str(root / f"ckpt{rank}")})
    dm = SeqDataModule(SeqDataModuleConfig.from_dict({**case["data"],
                                                      "data_dir": str(root / "data")}))
    trainer = Trainer(cfg, dm, log_dir=str(root / f"logs{rank}"), device="cpu")
    trainer.model = RecommenderModel(cfg, params=params_from_jax(case["params"], device="cpu"),
                                     device="cpu")
    val = trainer.fit()
    out = {"val": val, "step": trainer.state.step,
           "params": [p.numpy() for p in tree_leaves(trainer.model.params)],
           "mesh": trainer.mesh.shape}
    trainer.close()
    return out


def main(argv: list[str]) -> int:
    workdir, rank, world, port = pathlib.Path(argv[0]), int(argv[1]), int(argv[2]), int(argv[3])
    sys.path.insert(0, str(REPO))
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        spec = pickle.loads((workdir / "inputs.pkl").read_bytes())
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        from transformer_recommenders_tpu_torch.configs import MeshConfig
        from transformer_recommenders_tpu_torch.parallel.mesh import create_mesh

        out = {"errors": mesh_errors(world)}
        mesh = create_mesh(MeshConfig(**spec["mesh"]), "cpu")
        out["shape"] = mesh.shape
        out["lookup"] = run_lookup(spec["lookup"], mesh)
        out["topk"] = run_topk(spec["topk"], mesh)
        out["loss"] = {name: run_loss(case, mesh) for name, case in spec["loss"].items()}
        out["scan"] = run_scan(spec["scan"], mesh)
        out["eval"] = run_eval(spec["eval"], mesh)
        if spec.get("fit"):
            out["fit"] = run_fit(spec["fit"], rank)
        (workdir / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
        dist.destroy_process_group()
        return 0
    except BaseException:  # noqa: BLE001 - the test reads the traceback
        (workdir / f"rank{rank}.err").write_text(traceback.format_exc())
        return 1


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main(sys.argv[1:]))
