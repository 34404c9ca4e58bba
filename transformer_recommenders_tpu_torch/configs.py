"""Standard-library config surface: ``ModelConfig``, ``LossConfig``,
``TrainConfig`` and ``IndexConfig``.

Counterpart of ``transformer_recommenders_tpu/configs.py`` (pydantic there).
Same fields and defaults; ``from_dict`` reads the JSON the pydantic models
write (``config.json`` of a serving artifact, a ``TrainConfig`` dump) and
ignores keys it does not know.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, get_args, Literal

from transformer_recommenders_tpu_torch.params import ITEMS_TABLE_NAME, PRETRAINED_MODEL_NAME, TOP_K

PoolingMode = Literal["mean", "max", "cls", "lasttoken"]
Similarity = Literal["dot", "cosine"]
ComputeDtype = Literal["bfloat16", "float32"]
AttentionImpl = Literal["auto", "split", "masked"]
IndexBackend = Literal["device", "host"]
TargetPosition = Literal["first", "diagonal"]
LossType = Literal[
    "AlignmentLoss", "AlignmentContrastiveLoss", "ContrastiveLoss", "InfoNCELoss",
    "NCELoss", "PairwiseHingeLoss", "PairwiseLogisticLoss",
]
MonitorMode = Literal["max", "min"]
CheckpointBackend = Literal["npz", "orbax"]


def _check_choice(name: str, value: Any, choices) -> None:
    allowed = get_args(choices)
    if value not in allowed:
        msg = f"{name} must be one of {allowed}, got {value!r}"
        raise ValueError(msg)


class _JSONConfig:
    """``from_dict`` / ``to_json`` / ``replace`` shared by both configs."""

    @classmethod
    def from_dict(cls, payload: dict[str, Any] | Any):
        if isinstance(payload, cls):
            return payload
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(payload).items() if k in names})

    @classmethod
    def from_json(cls, text: str):
        return cls.from_dict(json.loads(text))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class ModelConfig(_JSONConfig):
    """Transformer encoder topology (see the JAX ``ModelConfig`` for the
    meaning of each field; the TPU-only knobs are kept so a saved config
    round-trips, and the port ignores them)."""

    input_dim: int | None = None  # None -> same as hidden_size
    hidden_size: int = 384
    num_hidden_layers: int = 1
    num_attention_heads: int = 12
    intermediate_size: int = 48
    max_seq_length: int = 32
    is_decoder: bool = True
    pooling_mode: PoolingMode = "mean"
    is_normalized: bool = False

    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    compute_dtype: ComputeDtype = "bfloat16"
    use_fused_layer: bool = True
    attention_impl: AttentionImpl = "auto"
    remat_layers: bool = False

    pretrained_model_name: str = PRETRAINED_MODEL_NAME

    @property
    def resolved_input_dim(self) -> int:
        return self.input_dim if self.input_dim is not None else self.hidden_size

    def __post_init__(self) -> None:
        if self.hidden_size % self.num_attention_heads != 0:
            msg = (
                f"hidden_size={self.hidden_size} not divisible by "
                f"num_attention_heads={self.num_attention_heads}"
            )
            raise ValueError(msg)
        _check_choice("pooling_mode", self.pooling_mode, PoolingMode)
        _check_choice("compute_dtype", self.compute_dtype, ComputeDtype)
        _check_choice("attention_impl", self.attention_impl, AttentionImpl)


@dataclasses.dataclass
class LossConfig(_JSONConfig):
    """In-batch loss pipeline config (JAX ``LossConfig``)."""

    target_position: TargetPosition | None = "first"
    mask_false_negatives: bool = True
    num_hard_negatives: int = 0
    scale: float = 1.0
    margin: float = 0.5

    def __post_init__(self) -> None:
        if self.target_position is not None:
            _check_choice("target_position", self.target_position, TargetPosition)


@dataclasses.dataclass
class TrainConfig(ModelConfig, LossConfig):
    """Flattened training config (JAX ``TrainConfig``): the model and loss
    fields plus the trainer's.  The nested index and mesh sections of a
    JAX dump are not carried; ``from_dict`` drops them with the other keys
    it does not know."""

    train_loss: LossType = "InfoNCELoss"
    use_fused_loss: bool = True
    use_table_scored_loss: bool = True
    learning_rate: float = 0.001
    weight_decay: float = 0.01
    gradient_clip_val: float | None = None
    accumulate_grad_batches: int = 1
    max_epochs: int = 1
    max_steps: int = -1
    max_time_seconds: float = 4 * 3600.0
    early_stopping_patience: int = 3
    monitor: str = "val/retrieval_normalized_dcg"
    monitor_mode: MonitorMode = "max"
    seed: int = 0
    log_every_n_steps: int = 50
    val_check_interval: int = -1
    limit_train_batches: int = -1
    limit_val_batches: int = -1
    limit_test_batches: int = -1
    limit_predict_batches: int = -1
    eval_batch_size: int = 256
    ckpt_dir: str = "checkpoints"
    checkpoint_backend: CheckpointBackend = "npz"
    use_mlflow: bool = True
    mlflow_dir: str | None = None
    mlflow_experiment: str = "transformer-recommenders-tpu"
    profile_dir: str | None = None
    steps_per_dispatch: int = 1
    checkpoint_every_epoch: bool = True

    def __post_init__(self) -> None:
        ModelConfig.__post_init__(self)
        LossConfig.__post_init__(self)
        _check_choice("train_loss", self.train_loss, LossType)
        _check_choice("monitor_mode", self.monitor_mode, MonitorMode)
        _check_choice("checkpoint_backend", self.checkpoint_backend, CheckpointBackend)


@dataclasses.dataclass
class IndexConfig(_JSONConfig):
    """Retrieval index config (JAX ``IndexConfig``)."""

    index_path: str = "index_store"
    table_name: str = ITEMS_TABLE_NAME
    id_col: str = "item_id"
    text_col: str = "item_text"
    embedding_col: str | None = "embedding"
    metric: Similarity = "cosine"
    backend: IndexBackend = "device"
    top_k: int = TOP_K
    persist_fts: bool = False

    def __post_init__(self) -> None:
        _check_choice("metric", self.metric, Similarity)
        _check_choice("backend", self.backend, IndexBackend)


def flagship_config(**overrides) -> TrainConfig:
    """The benchmark's flagship: ``__graft_entry__._flagship_config`` of the
    JAX repository (``configs/ml1m_ssm.yaml``'s model: 384-d inputs
    projected to d=128, 4 causal layers, 8 heads, FFN 512, seq 32, mean
    pooling, InfoNCE; bf16 and dropout 0.1 by default), copied here."""
    base = dict(
        input_dim=384, hidden_size=128, num_hidden_layers=4, num_attention_heads=8,
        intermediate_size=512, max_seq_length=32, is_decoder=True, pooling_mode="mean",
        train_loss="InfoNCELoss",
    )
    base.update(overrides)
    return TrainConfig(**base)
