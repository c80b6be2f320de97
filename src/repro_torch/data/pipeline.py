"""LM input pipeline, built on the Flare engine (the paper's technique as
a first-class feature of the training framework).

The JAX package's ``data/pipeline.py``.  The document-processing stage is
a *deferred relational plan* -- filter by quality/language, project the
text column -- run by the port's whole-query ``compiled`` engine on the
context's device; tokenization is a host function over the surviving
documents.  The packing/batching stage is a deterministic, checkpointable
cursor over the packed token stream: its full state is three integers,
stored in every checkpoint (exact-resume guarantee).

``collect()`` hands the dict-encoded ``text`` column back decoded, in
row order, so the packed stream and every batch equal the reference's
element for element.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import FlareContext, col
from repro_torch.data import synth, tokenizer
from repro_torch.relational.table import Table


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    cursor: int = 0          # batch index within the epoch
    seed: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "PipelineState":
        return PipelineState(**d)


class LMDataPipeline:
    """Deterministic packed-LM batches from a document table.

    ``tokens`` batches are [B, S] int32 numpy arrays; ``labels`` are the
    next tokens (the stream shifted by one)."""

    def __init__(self, stream: np.ndarray, seq_len: int,
                 global_batch: int, seed: int = 0,
                 state: Optional[PipelineState] = None):
        if stream.ndim != 1:
            raise ValueError(f"a token stream is 1-D, got {stream.shape}")
        self.seq_len = seq_len
        self.global_batch = global_batch
        n_rows = len(stream) // (seq_len + 1)
        if n_rows < 1:
            reps = int(np.ceil((seq_len + 1) / max(len(stream), 1)))
            stream = np.tile(stream, reps + 1)
            n_rows = len(stream) // (seq_len + 1)
        self.rows = stream[: n_rows * (seq_len + 1)].reshape(
            n_rows, seq_len + 1)
        self.state = state or PipelineState(seed=seed)

    # -- construction from raw documents via the Flare engine -------------------

    @staticmethod
    def from_documents(docs: Dict[str, np.ndarray], seq_len: int,
                       global_batch: int, min_quality: float = 0.2,
                       langs: Optional[List[str]] = None,
                       seed: int = 0,
                       device: Union[str, torch.device] = "cuda"
                       ) -> "LMDataPipeline":
        """The ETL runs on ``device`` (the card unless the caller asks
        for the CPU)."""
        ctx = FlareContext(device=device)
        ctx.register("docs", Table.from_arrays(docs))
        q = ctx.table("docs").filter(col("quality") >= min_quality)
        if langs:
            q = q.filter(col("lang").isin(langs))
        q = q.select("doc_id", "text")
        kept = q.lower(engine="compiled").compile().collect()  # compiled ETL
        toks = tokenizer.encode_batch(list(kept["text"]))
        stream = tokenizer.pack_stream(toks)
        return LMDataPipeline(stream, seq_len, global_batch, seed)

    @staticmethod
    def synthetic(seq_len: int, global_batch: int, n_docs: int = 500,
                  seed: int = 0,
                  device: Union[str, torch.device] = "cuda"
                  ) -> "LMDataPipeline":
        return LMDataPipeline.from_documents(
            synth.generate_documents(n_docs, seed), seq_len, global_batch,
            seed=seed, device=device)

    # -- iteration ------------------------------------------------------------------

    @property
    def batches_per_epoch(self) -> int:
        return max(len(self.rows) // self.global_batch, 1)

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.state.seed + epoch)
        return rng.permutation(len(self.rows))

    def next_batch(self) -> Dict[str, np.ndarray]:
        st = self.state
        perm = self._perm(st.epoch)
        b = self.global_batch
        start = st.cursor * b
        idx = perm[start:start + b]
        if len(idx) < b:  # wrap into next epoch
            idx = np.concatenate([idx, self._perm(st.epoch + 1)
                                  [: b - len(idx)]])
        rows = self.rows[idx]
        batch = {"tokens": rows[:, :-1].astype(np.int32),
                 "labels": rows[:, 1:].astype(np.int32)}
        st.cursor += 1
        if st.cursor >= self.batches_per_epoch:
            st.cursor = 0
            st.epoch += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- checkpoint integration -----------------------------------------------------

    def state_dict(self) -> Dict:
        return self.state.to_dict()

    def load_state(self, d: Dict) -> None:
        self.state = PipelineState.from_dict(d)
