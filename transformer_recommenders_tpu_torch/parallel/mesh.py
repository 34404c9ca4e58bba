"""Process-mesh runtime on ``torch.distributed`` (JAX ``parallel/mesh.py``).

One process per device.  The ranks form a 2-D ``(data, model)`` mesh:

- ``data``: data parallel over the batch; the gradient is all-reduced;
- ``model``: the item table row-sharded, its lookups and the retrieval
  top-k combined over this axis.

JAX runs one controller over every device of the mesh; here every rank
runs the same program on its own shard (SPMD), and the collectives of
``parallel/collectives.py`` stand where JAX's ``shard_map`` puts its own.
A JAX step over N devices sees one global batch; so does an N-rank step
here: each rank draws the same global batch from the same seed and keeps
its rows (:func:`shard_batch`).

``torchrun`` sets the environment that :func:`maybe_initialize_distributed`
reads; the backend is NCCL on the card and gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from transformer_recommenders_tpu_torch import resolve_device
from transformer_recommenders_tpu_torch.configs import MeshConfig
from transformer_recommenders_tpu_torch.params import DATA_AXIS, MODEL_AXIS

_LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def maybe_initialize_distributed(device=None) -> None:
    """Join the process group that ``torchrun`` describes (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment); a
    no-op where they are absent.  NCCL for ``cuda`` (each rank on card
    ``LOCAL_RANK``), gloo for ``cpu``.  Decided from the environment alone,
    as JAX's ``JAX_COORDINATOR_ADDRESS`` gate.  A group already joined is
    kept (re-entry is tolerated); any other failure raises."""
    if not all(os.environ.get(k) for k in _LAUNCHER_ENV):
        return
    if dist.is_initialized():
        return
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo")


def process_rank() -> int:
    """This process's global rank: the group's where one is joined, else
    the launcher's ``RANK`` (0 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def world_size() -> int:
    """Ranks in the joined process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_primary() -> bool:
    """Rank 0: the one process that writes logs, checkpoints and artifacts."""
    return process_rank() == 0


def barrier() -> None:
    """Wait for every rank, where a group of more than one is joined."""
    if world_size() > 1:
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(data, model)`` mesh of the joined process group, as this rank
    sees it: ``shape`` maps each axis to its size (JAX's ``mesh.shape``),
    ``coordinate(axis)`` is this rank's index along it, ``group(axis)`` the
    process group of the ranks that share every other coordinate, and
    ``device`` this rank's device."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.device_mesh.mesh_dim_names, self.device_mesh.shape))

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def coordinate(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


def create_mesh(config: MeshConfig | None = None, device=None) -> Mesh:
    """The 2-D ``(data, model)`` mesh over the joined process group.

    ``data_axis_size=-1`` takes every rank the model axis leaves.  Ranks
    are laid out as JAX lays out devices: rank ``d * model + m`` at
    ``(d, m)``, so a model group is adjacent ranks.  The mesh must cover
    every rank (a rank outside it would have no part in the collectives)."""
    from torch.distributed.device_mesh import init_device_mesh

    config = MeshConfig.from_dict(config or MeshConfig())
    world = world_size()
    model = max(config.model_axis_size, 1)
    if world % model != 0:
        msg = f"{world} devices not divisible by model_axis_size={model}"
        raise ValueError(msg)
    data = config.data_axis_size
    if data < 0:
        data = world // model
    if data * model > world:
        msg = f"mesh {data}x{model} exceeds {world} devices"
        raise ValueError(msg)
    if data * model < world:
        msg = f"mesh {data}x{model} leaves {world - data * model} of {world} ranks out"
        raise ValueError(msg)
    if not dist.is_initialized():
        msg = ("create_mesh needs a process group: call maybe_initialize_distributed or "
               "init_process_group first")
        raise RuntimeError(msg)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device_mesh = init_device_mesh(device.type, (data, model),
                                   mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(device_mesh, device)


def shard_rows(x, mesh: Mesh, axis: str = DATA_AXIS):
    """This rank's contiguous block of ``x``'s leading dimension, by its
    coordinate along ``axis`` (the size must divide evenly)."""
    n, i = mesh.shape[axis], mesh.coordinate(axis)
    rows = x.shape[0]
    if rows % n != 0:
        msg = f"leading dimension {rows} not divisible by the {axis} axis ({n})"
        raise ValueError(msg)
    per = rows // n
    return x[i * per:(i + 1) * per]


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch (numpy or tensors), by its data
    coordinate, as int64 tensors on the mesh's device (JAX's
    ``device_put`` onto the batch sharding)."""
    return {k: torch.as_tensor(shard_rows(v, mesh)).to(device=mesh.device, dtype=torch.int64)
            for k, v in batch.items()}

