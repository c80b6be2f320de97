"""Data meshes for the sharded ``parallel`` engine.

The JAX package's ``repro.launch.mesh`` builds ``jax.sharding.Mesh``
objects over devices; its tests force several host devices
(``--xla_force_host_platform_device_count``) to run the sharded engine
on one machine.  The port's counterpart of those forced devices is a
mesh whose shards are contiguous row ranges of the spine on ONE torch
device: :class:`Mesh` keeps the reading surface the engine needs
(``axis_names``, ``shape``, the shards' ``device``), and the engine
(:mod:`repro_torch.core.parallel`) runs the shards one after another on
that device, merging their partials with torch ops.  No
``torch.distributed`` is involved.

A mesh whose shards would sit on more than one distinct card raises
``ValueError``: a multi-card mesh needs a machine with more than one
card, and none of that path exists yet.

``make_production_mesh`` (the LM's 256/512-chip meshes) belongs to the LM
training path and is not ported here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]


def canonical_device(device: DeviceLike) -> torch.device:
    """``device`` with its index made explicit (``cuda`` -> ``cuda:N`` of
    the current card), so that two spellings of one card compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named mesh of shards on one torch device.

    ``axis_names`` and ``sizes`` give the mesh's axes and their shard
    counts (``shape`` maps one to the other, as ``jax.sharding.Mesh.
    shape`` does); every shard lives on ``device``."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The device of each shard (all the same one), flattened."""
        return (self.device,) * self.size


def _one_device(device: Optional[Union[DeviceLike, Sequence[DeviceLike]]]
                ) -> torch.device:
    """The single device a mesh's shards live on: the card unless the
    caller names another; a sequence of devices must name one device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_data_mesh(): no CUDA device is available; pass "
                "device='cpu' to shard on the CPU")
        return canonical_device("cuda")
    if isinstance(device, (str, torch.device)):
        return canonical_device(device)
    devs = {canonical_device(d) for d in device}
    if len(devs) != 1:
        raise ValueError(
            f"a mesh over {len(devs)} distinct devices "
            f"({sorted(map(str, devs))}) needs shards on several cards; "
            "the port shards row ranges on one device only")
    return devs.pop()


def _visible(device: torch.device) -> int:
    """Shard count of a default mesh: the visible cards on a CUDA
    device (the JAX package's "every device"), one on the CPU (the JAX
    package's CPU platform has one device unless forced)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def make_data_mesh(n_shards: Optional[int] = None, axis: str = "data",
                   device: Optional[Union[DeviceLike,
                                          Sequence[DeviceLike]]] = None
                   ) -> Mesh:
    """1-D mesh of ``n_shards`` row-range shards on one named axis, the
    default mesh of the ``parallel`` engine.

    ``device`` defaults to the card; pass ``"cpu"`` for the plain PyTorch
    path.  ``n_shards`` defaults to the number of visible cards (1 on a
    one-card machine, 1 on the CPU) and may be any count >= 1: unlike the
    JAX package's mesh, whose shards are devices, these shards are row
    ranges of the spine on that one device."""
    dev = _one_device(device)
    if n_shards is None:
        n_shards = _visible(dev)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return Mesh((axis,), (int(n_shards),), dev)


def make_host_mesh(model: int = 1,
                   device: Optional[DeviceLike] = None) -> Mesh:
    """2-D ``("data", "model")`` mesh over the visible cards (tests and
    local runs), with ``model`` shards on the second axis."""
    dev = _one_device(device)
    n = _visible(dev)
    if model < 1 or n % model:
        raise ValueError(f"{n} shard(s) do not split into model={model}")
    return Mesh(("data", "model"), (n // model, model), dev)
