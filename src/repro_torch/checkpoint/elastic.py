"""Elastic re-meshing: resume a checkpoint on a different device count.

Checkpoints store full (unsharded) host arrays, so re-meshing is placing
each leaf.  The JAX package recomputes ``PartitionSpec``s from the
model's logical axes and ``device_put``s each leaf onto its mesh.  The
port runs on one device: its :class:`repro_torch.launch.mesh.Mesh` holds
every shard on one ``device``, so :func:`remesh` and :func:`replicate`
put each leaf there whole, keeping its dtype.  A mesh over more than one
device raises ``ValueError`` (as ``launch.mesh.make_data_mesh`` does):
the sharded placement waits for the multi-card port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, _one_device
from repro_torch.models.param import tree_items, tree_map

MeshLike = Union[Mesh, str, torch.device, Sequence]


def _device_of(mesh: MeshLike) -> torch.device:
    """The one device of a mesh, a device, or a sequence of devices."""
    if isinstance(mesh, Mesh):
        return mesh.device
    return _one_device(mesh)


def _put(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    return torch.as_tensor(np.ascontiguousarray(x)).to(device)


def remesh(state: Dict[str, Any], spec_tree, mesh: MeshLike,
           rules: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Place a host-array tree (``state['params']``-style) onto ``mesh``.

    ``spec_tree`` and ``rules`` are the JAX package's arguments; with one
    device every leaf is whole, so they only pin the signature:
    ``spec_tree``'s leaves must have the state's shapes."""
    device = _device_of(mesh)
    if spec_tree is not None:
        want = {p: tuple(s.shape) for p, s in tree_items(spec_tree)}
        got = {p: tuple(np.shape(x)) for p, x in tree_items(state)}
        if want != got:
            raise ValueError("remesh: the state's leaves do not match the "
                             "spec tree's")
    return tree_map(lambda x: _put(x, device), state)


def replicate(state, mesh: MeshLike):
    """Every leaf whole on the mesh's device."""
    device = _device_of(mesh)
    return tree_map(lambda x: _put(x, device), state)
