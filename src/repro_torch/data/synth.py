"""Synthetic text corpus with Zipfian token statistics.

Gives the end-to-end training example a corpus with realistic rank-
frequency structure (so loss curves are non-trivial) without external
data.  Documents carry metadata (length, language id, quality score) so
the Flare relational front-end has something real to filter on.

A copy of the JAX package's module (numpy only).  The word list is drawn
once per process and cached in ``_WORDS`` from the ``rng`` of the FIRST
call, so the vocabulary of later calls depends on that first seed, as in
the reference; two processes (or the two packages) give the same
documents when their first calls share a seed.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_WORDS = None


def _vocab(rng: np.random.Generator, size: int = 2000) -> List[str]:
    global _WORDS
    if _WORDS is None:
        letters = "abcdefghijklmnopqrstuvwxyz"
        words = set()
        while len(words) < size:
            n = rng.integers(2, 9)
            words.add("".join(rng.choice(list(letters), n)))
        _WORDS = sorted(words)
    return _WORDS


def generate_documents(n_docs: int = 500, seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    """Returns a columnar document table: text, length, lang, quality."""
    rng = np.random.default_rng(seed)
    words = _vocab(rng)
    ranks = np.arange(1, len(words) + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    texts, lengths, langs, quality = [], [], [], []
    for _ in range(n_docs):
        n = int(rng.integers(20, 400))
        ws = rng.choice(words, n, p=probs)
        texts.append(" ".join(ws) + ".")
        lengths.append(n)
        langs.append(rng.choice(["en", "fr", "de", "code"]))
        quality.append(float(np.round(rng.uniform(0, 1), 3)))
    return {"doc_id": np.arange(n_docs, dtype=np.int32),
            "text": np.asarray(texts, object),
            "length": np.asarray(lengths, np.int32),
            "lang": np.asarray(langs, object),
            "quality": np.asarray(quality, np.float64)}
