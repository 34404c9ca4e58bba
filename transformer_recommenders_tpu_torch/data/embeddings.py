"""Frozen item-text embeddings (JAX ``data/embeddings.py``).

Two backends:

- ``hash``: deterministic feature-hashed embeddings of the JSON text (token
  hashing -> signed buckets -> L2 norm), bit for bit the JAX package's;
- ``sentence-transformer``: the pretrained encoder, only where the
  ``sentence_transformers`` package and the model's files are already on
  the machine.  Nothing is downloaded: without them it raises.
"""

from __future__ import annotations

import hashlib
import json
import re

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def _tokens(text: str) -> list[str]:
    try:
        payload = json.loads(text)
        flat: list[str] = []
        for v in payload.values():
            if isinstance(v, list):
                flat += [str(x) for x in v]
            else:
                flat.append(str(v))
        text = " ".join(flat)
    except (json.JSONDecodeError, AttributeError):
        pass
    return _TOKEN_RE.findall(text.lower())


def hash_embed_texts(texts: list[str], dim: int = 384) -> np.ndarray:
    """Deterministic feature-hashing embedder (L2-normalized float32)."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, text in enumerate(texts):
        toks = _tokens(text)
        for tok in toks:
            digest = hashlib.blake2b(tok.encode(), digest_size=8).digest()
            val = int.from_bytes(digest, "little")
            bucket = val % dim
            sign = 1.0 if (val >> 32) & 1 else -1.0
            out[i, bucket] += sign
        if not toks:
            out[i, 0] = 1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-12)


def sentence_transformer_embed_texts(
    texts: list[str], model_name: str, batch_size: int = 256
) -> np.ndarray:
    """The pretrained encoder's embeddings, from files already on the
    machine (``local_files_only``); raises ``RuntimeError`` otherwise."""
    try:
        from sentence_transformers import SentenceTransformer
    except ImportError as e:
        msg = (
            "embedder='sentence-transformer' needs the sentence_transformers "
            f"package and the files of {model_name!r} on this machine; use "
            "embedder='hash' where they are missing"
        )
        raise RuntimeError(msg) from e
    try:
        model = SentenceTransformer(model_name, local_files_only=True)
    except Exception as e:  # noqa: BLE001 - any load failure means the files are missing
        msg = (
            f"the sentence-transformer model {model_name!r} is not on this machine "
            "(nothing is downloaded); use embedder='hash' or place the model's files "
            "in the Hugging Face cache"
        )
        raise RuntimeError(msg) from e
    return np.asarray(
        model.encode(texts, batch_size=batch_size, show_progress_bar=False), np.float32
    )


def embed_item_texts(
    texts: list[str],
    *,
    embedder: str = "hash",
    dim: int = 384,
    model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
) -> np.ndarray:
    if embedder == "hash":
        return hash_embed_texts(texts, dim)
    if embedder == "sentence-transformer":
        return sentence_transformer_embed_texts(texts, model_name)
    msg = f"unknown embedder: {embedder}"
    raise ValueError(msg)
