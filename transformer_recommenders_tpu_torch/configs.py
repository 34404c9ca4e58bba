"""Standard-library config surface: ``ModelConfig``, ``LossConfig``,
``TrainConfig``, ``IndexConfig``, ``MeshConfig``, ``SeqDataConfig`` and
``SeqDataModuleConfig``, and :func:`load_yaml_config`.

Counterpart of ``transformer_recommenders_tpu/configs.py`` (pydantic there).
Same fields and defaults; ``from_dict`` reads the JSON the pydantic models
write (``config.json`` of a serving artifact or a checkpoint, a
``TrainConfig`` dump), ignores keys it does not know and coerces scalars
to the field's type as pydantic does (``"3e-3"`` to a float field, ``1``
to ``1.0``).  :func:`parse_yaml` reads the YAML the repository's
``configs/*.yaml`` are written in without PyYAML.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, get_args, Literal

from transformer_recommenders_tpu_torch.params import (
    DATA_DIR,
    ITEMS_PARQUET,
    ITEMS_TABLE_NAME,
    PRETRAINED_MODEL_NAME,
    TOP_K,
    USERS_PARQUET,
    USERS_TABLE_NAME,
)

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
Dataset = Literal["ml-1m", "ml-100k", "ml-25m", "synthetic"]
Embedder = Literal["sentence-transformer", "hash"]


def _coerce_field(annotation: str, value: Any) -> Any:
    """``value`` converted to a field annotated ``annotation`` where
    pydantic's lax mode would convert it: numeric strings and ints to
    floats, numeric strings to ints, ``"true"``/``"false"`` to bools, a
    mapping to the nested config it names."""
    annotation = str(annotation)
    if isinstance(value, dict) and "IndexConfig" in annotation:
        return IndexConfig.from_dict(value)
    if isinstance(value, dict) and "MeshConfig" in annotation:
        return MeshConfig.from_dict(value)
    if isinstance(value, bool) or value is None:
        return value
    if "float" in annotation and isinstance(value, (int, str)):
        try:
            return float(value)
        except ValueError:
            return value
    if annotation.startswith("int") and isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            return value
    if annotation.startswith("bool") and isinstance(value, str) and value.lower() in (
            "true", "false"):
        return value.lower() == "true"
    return value


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
        if dataclasses.is_dataclass(payload):
            payload = dataclasses.asdict(payload)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        return cls(**{k: _coerce_field(fields[k].type, v)
                      for k, v in dict(payload).items() if k in fields})

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


@dataclasses.dataclass
class MeshConfig(_JSONConfig):
    """The (data, model) process mesh (JAX ``MeshConfig``): data parallel
    over the batch, the item table row-sharded over ``model``.
    ``data_axis_size=-1`` takes every rank the model axis leaves."""

    data_axis_size: int = -1
    model_axis_size: int = 1


@dataclasses.dataclass
class TrainConfig(ModelConfig, LossConfig):
    """Flattened training config (JAX ``TrainConfig``): the model and loss
    fields plus the trainer's and the nested index and mesh sections."""

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

    items_config: IndexConfig = dataclasses.field(default_factory=lambda: IndexConfig(
        table_name=ITEMS_TABLE_NAME, id_col="item_id", text_col="item_text",
        embedding_col="embedding"))
    users_config: IndexConfig = dataclasses.field(default_factory=lambda: IndexConfig(
        table_name=USERS_TABLE_NAME, id_col="user_id", text_col="user_text",
        embedding_col=None))
    top_k: int = TOP_K
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def __post_init__(self) -> None:
        ModelConfig.__post_init__(self)
        LossConfig.__post_init__(self)
        _check_choice("train_loss", self.train_loss, LossType)
        _check_choice("monitor_mode", self.monitor_mode, MonitorMode)
        _check_choice("checkpoint_backend", self.checkpoint_backend, CheckpointBackend)


@dataclasses.dataclass
class SeqDataConfig(_JSONConfig):
    """Sequence sampling config (JAX ``SeqDataConfig``)."""

    max_seq_length: int = 32
    pos_lookahead: int = 0


@dataclasses.dataclass
class SeqDataModuleConfig(SeqDataConfig):
    """Data module config (JAX ``SeqDataModuleConfig``).  The port writes
    its processed artifacts as JSON records (``items.json``,
    ``users.json``); ``items_parquet``/``users_parquet`` are kept so a
    JAX dump round-trips."""

    data_dir: str = DATA_DIR
    dataset: Dataset = "ml-1m"
    items_parquet: str = ITEMS_PARQUET
    users_parquet: str = USERS_PARQUET

    pretrained_model_name: str = PRETRAINED_MODEL_NAME
    embedder: Embedder = "sentence-transformer"
    embedding_dim: int = 384  # used by the hash embedder

    batch_size: int = 32
    seed: int = 0

    # synthetic generator knobs (tests and runs without the MovieLens files)
    synthetic_num_users: int = 200
    synthetic_num_items: int = 500
    synthetic_num_events: int = 20_000

    def __post_init__(self) -> None:
        _check_choice("dataset", self.dataset, Dataset)
        _check_choice("embedder", self.embedder, Embedder)


# -- YAML: the subset configs/*.yaml use ----------------------------------------

_YAML_BOOLS = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_YAML_NULLS = ("", "~", "null", "Null", "NULL")
# PyYAML's (YAML 1.1) implicit resolvers: a float needs a dot ("3e-3" is a
# string there, and pydantic then reads it as a float)
_YAML_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$|[-+]?\.(inf|Inf|INF)$|\.(nan|NaN|NAN)$")


def parse_yaml_scalar(text: str) -> Any:
    """One plain or quoted YAML scalar, resolved as ``yaml.safe_load``
    resolves it: null, bool (YAML 1.1's yes/no/on/off too), int, float,
    else a string."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else json.loads(text)
    if text in _YAML_NULLS:
        return None
    if text in _YAML_BOOLS:
        return _YAML_BOOLS[text]
    if _YAML_INT.match(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.match(text):
        low = text.lower()
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith(".nan"):
            return float("nan")
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> dict[str, Any]:
    """Block mappings nested by indentation, of plain or quoted scalars,
    with comments and blank lines: the YAML of ``configs/*.yaml``.  Any
    other construct (sequences, flow collections, anchors, multi-line
    scalars) raises ``ValueError``."""
    root: dict[str, Any] = {}
    opened: list[tuple[dict, str]] = []  # keys written as ``key:``
    stack: list[tuple[int, dict]] = [(-1, root)]  # (indent of the opening key, mapping)
    for number, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        body = line.strip()
        if not body or body in ("---", "..."):
            continue
        key, sep, value = body.partition(":")
        if (not sep or (value and not value.startswith(" "))
                or body.startswith(("-", "[", "{", "&", "*", "|", ">", "?"))
                or value.strip().startswith(("[", "{", "&", "*", "|", ">"))):
            msg = f"line {number}: unsupported YAML: {raw!r}"
            raise ValueError(msg)
        indent = len(line) - len(line.lstrip(" "))
        while stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        key = parse_yaml_scalar(key)
        if value.strip():
            parent[key] = parse_yaml_scalar(value)
        else:
            parent[key] = child = {}
            opened.append((parent, key))
            stack.append((indent, child))
    for parent, key in opened:  # ``key:`` with nothing under it is null
        if parent[key] == {}:
            parent[key] = None
    return root


def load_yaml_config(path: str, cls):
    """A YAML file into a config (JAX ``load_yaml_config``)."""
    with open(path) as f:
        return cls.from_dict(parse_yaml(f.read()) or {})


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
