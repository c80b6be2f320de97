"""Byte-level tokenizer (vocab = 256 bytes + specials), fully vectorized.

A copy of the JAX package's tokenizer (numpy only); the serving path
builds its synthetic prompts with it.
"""
from __future__ import annotations

from typing import List

import numpy as np

PAD = 256
BOS = 257
EOS = 258
VOCAB = 259


def encode(text: str) -> np.ndarray:
    raw = np.frombuffer(text.encode("utf-8", errors="replace"),
                        dtype=np.uint8).astype(np.int32)
    return np.concatenate([[BOS], raw, [EOS]]).astype(np.int32)


def encode_batch(texts: List[str]) -> List[np.ndarray]:
    return [encode(t) for t in texts]


def decode(ids: np.ndarray) -> str:
    ids = np.asarray(ids)
    ids = ids[(ids >= 0) & (ids < 256)]
    return ids.astype(np.uint8).tobytes().decode("utf-8", errors="replace")


def pack_stream(docs: List[np.ndarray]) -> np.ndarray:
    """Concatenate tokenized documents into one training stream."""
    if not docs:
        return np.zeros(0, np.int32)
    return np.concatenate(docs).astype(np.int32)
