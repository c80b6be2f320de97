"""Step builders for serving: prefill and decode.

The JAX package compiles each step into one XLA program; PyTorch runs
the same function eagerly, so a step is the model call itself.  The
train step (forward, backward, AdamW) is not yet ported.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.distributed.shardings import ShardingCtx
from repro_torch.models.modeling import Model


def make_prefill_step(model: Model, sc: ShardingCtx,
                      cache_len: int) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, sc, cache_len)

    return prefill_step


def make_decode_step(model: Model, sc: ShardingCtx) -> Callable:
    def decode_step(params, tokens, caches, length):
        return model.decode_step(params, tokens, caches, length, sc)

    return decode_step
