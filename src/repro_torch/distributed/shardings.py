"""Sharding context for one card.

The JAX package threads a mesh and logical-axis rules through the model
code (``constrain`` pins an activation's layout).  On one card there is
no mesh: :class:`ShardingCtx` keeps the same call sites and
``constrain`` returns its input.  A ``torch.distributed`` version waits
for the multi-GPU port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class ShardingCtx:
    """The model code's sharding hook; one card has no mesh, so
    ``constrain`` returns its input."""

    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "repro_torch runs on one card: a sharding mesh is not yet "
                "ported")

    def constrain(self, x, *logical_axes: Optional[str]):
        return x


def null_ctx() -> ShardingCtx:
    return ShardingCtx(None)
