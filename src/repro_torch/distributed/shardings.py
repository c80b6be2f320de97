"""Logical-axis sharding rules and the sharding context.

The JAX package threads a mesh and logical-axis rules through the model
code (``constrain`` pins an activation's layout) and maps every
parameter, batch input and cache onto a mesh's axes.  The rules are data,
and are ported as they are: :func:`rules_tp_fsdp` and :func:`rules_dp_only`
(:data:`PROFILES`), :meth:`ShardingCtx.pspec` and
``models.param.param_pspecs`` give each dimension's mesh axes as a tuple
of entries (``None``, an axis name, or a tuple of names) -- what a
``jax.sharding.PartitionSpec`` holds.

Mesh axes: ``("pod", "data", "model")`` multi-pod or ``("data",
"model")`` single-pod.  DP: activation ``batch`` -> the data axes; FSDP:
parameter ``embed`` -> the data axes; TP: ``vocab`` / ``mlp`` / ``heads``
/ ``kv`` -> ``model``; EP: ``expert`` -> ``model``; SP: ``kv_seq`` ->
``model``.  An axis whose size its mesh extent does not divide falls back
to replication.

On one card nothing is placed: ``constrain`` returns its input without a
mesh and raises ``NotImplementedError`` with one (a layout over several
cards waits for the multi-GPU port).  ``mesh`` is anything with
``axis_names`` and either ``devices.shape`` (a ``jax.sharding.Mesh``) or a
``shape`` dict (``launch.mesh.Mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

#: One dimension's placement: replicated, one mesh axis, or several.
Part = Any


def rules_tp_fsdp(multi_pod: bool) -> Dict[str, Any]:
    data_axes = ("pod", "data") if multi_pod else ("data",)
    return {
        # parameters
        "embed": data_axes,          # FSDP shard dim
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv": "model",
        "expert": "model",
        "rnn": "model",              # RG-LRU / SSM channel dims
        "state": None,
        "layers": None,
        # activations
        "batch": data_axes,
        "seq": None,
        "kv_seq": "model",           # long KV caches: sequence-sharded
        # the residual stream stays replicated over `model` (Megatron
        # layout); TP runs through the mlp / vocab columns
        "act_embed": None,
        "act_mlp": "model",
        "act_heads": "model",
        "act_expert": "model",
        # MoE capacity dim over data, or every data shard computes the
        # whole expert workload again
        "act_cap": data_axes,
    }


def rules_dp_only(multi_pod: bool) -> Dict[str, Any]:
    """For small models (mamba2-130m): pure DP over every mesh axis; the
    model axis folds into batch so all chips contribute to throughput."""
    batch_axes = ("data", "model")  # pod replicated (grad all-reduce)
    rules = {k: None for k in rules_tp_fsdp(multi_pod)}
    rules.update({"batch": batch_axes, "embed": ("data",),
                  "kv_seq": None})
    return rules


PROFILES = {"tp_fsdp": rules_tp_fsdp, "dp_only": rules_dp_only}


def mesh_shape_of(mesh) -> Dict[str, int]:
    """``{axis name: extent}`` of a mesh (``{}`` for none)."""
    if mesh is None:
        return {}
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def place(dims: Sequence[Tuple[Optional[str], Optional[int]]],
          rules: Dict[str, Any], mesh_shape: Dict[str, int],
          skip_absent: bool) -> Tuple[Tuple[Part, ...], set]:
    """Each ``(logical name, size)``'s mesh axes under ``rules``: a mesh
    axis serves one dimension at most, and a dimension whose size the
    axes' extent does not divide (a size of ``None`` is never checked) is
    replicated.  ``skip_absent`` drops rule axes the mesh lacks (a
    ``pspec``); otherwise each must be in ``mesh_shape`` (a parameter's
    placement).  Returns the parts and the fallbacks ``(name, size,
    axes)``."""
    parts, used, fallbacks = [], set(), set()
    for name, size in dims:
        mesh_axes = rules.get(name) if name else None
        if mesh_axes is None:
            parts.append(None)
            continue
        axes_t = ((mesh_axes,) if isinstance(mesh_axes, str)
                  else tuple(mesh_axes))
        axes_t = tuple(a for a in axes_t if a not in used
                       and (a in mesh_shape or not skip_absent))
        extent = int(np.prod([mesh_shape[a] for a in axes_t])) \
            if axes_t else 1
        if not axes_t or (size is not None and size % max(extent, 1)):
            fallbacks.add((name, size, axes_t))
            parts.append(None)
            continue
        used.update(axes_t)
        parts.append(axes_t[0] if len(axes_t) == 1 else axes_t)
    return tuple(parts), fallbacks


@dataclasses.dataclass
class ShardingCtx:
    """Threads the mesh and rules through the model code."""

    mesh: Optional[Any]
    rules: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: rules_tp_fsdp(False))

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return mesh_shape_of(self.mesh)

    def pspec(self, *logical_axes: Optional[str],
              shape: Optional[Sequence[int]] = None) -> Tuple[Part, ...]:
        """The mesh axes of each logical axis (a ``PartitionSpec``'s
        entries), replicated where ``shape``'s size is not divisible."""
        sizes = shape if shape is not None else [None] * len(logical_axes)
        return place(list(zip(logical_axes, sizes)), self.rules,
                     self.mesh_shape, skip_absent=True)[0]

    def constrain(self, x, *logical_axes: Optional[str]):
        if self.mesh is None:
            return x
        raise NotImplementedError(
            "repro_torch runs on one card: placing an activation on a "
            "sharding mesh is not yet ported")


def null_ctx() -> ShardingCtx:
    return ShardingCtx(None, rules_tp_fsdp(False))


def make_ctx(mesh, profile: str = "tp_fsdp") -> ShardingCtx:
    multi_pod = mesh is not None and "pod" in mesh.axis_names
    return ShardingCtx(mesh, PROFILES[profile](multi_pod))
