"""Parameter trees: nested dicts of :class:`ArraySpec` leaves.

Models declare parameters as nested dicts whose leaves are
:class:`ArraySpec` (shape + dtype + logical axis names, kept for parity
with the JAX package's sharding rules).  The consumers here:

* ``init_params``       -- concrete initialisation from an explicit
  ``torch.Generator`` on an explicit device,
* ``params_from_numpy`` -- the weight carry-over: the JAX package's
  parameter tree as numpy arrays (stacked layer axis included), checked
  leaf by leaf against the spec,
* ``abstract_params``   -- the same tree on the ``meta`` device (shapes
  and dtypes, no storage): the counterpart of ``ShapeDtypeStruct``s,
* ``cast_compute``      -- the working-precision copy,
* ``param_pspecs``      -- logical axes -> mesh axes under sharding rules
  (``repro_torch.distributed.shardings``), each leaf a tuple of
  ``PartitionSpec`` entries, with the divisibility fallback,
* ``count_params``, ``tree_bytes``.

Tree order is sorted dict keys, as ``jax.tree`` flattens dicts, and
:func:`flatten_with_paths` names a leaf by its ``"/"``-joined keys, as
the JAX package's checkpoint manager does (``params/layers/attn/wq``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.shardings import place


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    shape: Tuple[int, ...]
    dtype: Any
    axes: Tuple[Optional[str], ...]  # logical axis name per dim
    init: str = "normal"             # normal | zeros | ones | fan_in
    scale: float = 1.0

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"ArraySpec: {len(self.axes)} axis names for "
                             f"shape {self.shape}")


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted-key order; a leaf is anything that is
    not a dict."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_unflatten(items) -> Any:
    """The nested dict of ``(path, leaf)`` pairs (the inverse of
    :func:`tree_items`); a single pair with the empty path is a leaf."""
    items = list(items)
    if len(items) == 1 and items[0][0] == ():
        return items[0][1]
    out: Dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in tree order; a name is the leaf's keys
    joined by ``"/"``."""
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in tree_items(tree)]


def _init_one(spec: ArraySpec, gen: torch.Generator,
              device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    z = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    if spec.init == "fan_in":
        fan_in = spec.shape[0] if len(spec.shape) == 1 else \
            int(np.prod(spec.shape[:-1]))
        return (z * (spec.scale / math.sqrt(max(fan_in, 1)))).to(spec.dtype)
    if spec.init == "normal":
        return (z * (0.02 * spec.scale)).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(tree, gen: torch.Generator, device) -> Dict:
    """Concrete parameters for the spec ``tree``, drawn from ``gen`` (a
    generator on ``device``) leaf by leaf in tree order."""
    return tree_map(lambda s: _init_one(s, gen, device), tree)


def params_from_numpy(tree, spec, *, device="cuda") -> Dict:
    """The port's parameters from the JAX package's tree as numpy arrays.

    ``tree`` must have exactly the leaves of ``spec`` (the same nested
    keys, stacked layer axis included) with the spec's shapes; a missing
    or left-over leaf, or a wrong shape, raises ``ValueError``.  Values
    are cast to the spec's dtype on ``device``."""
    want = dict(tree_items(spec))
    got = dict(tree_items(tree))
    missing = sorted("/".join(p) for p in set(want) - set(got))
    extra = sorted("/".join(p) for p in set(got) - set(want))
    if missing or extra:
        raise ValueError(f"params_from_numpy: missing leaves {missing}, "
                         f"left-over leaves {extra}")
    for path, s in want.items():
        shape = tuple(np.shape(got[path]))
        if shape != tuple(s.shape):
            raise ValueError(f"params_from_numpy: {'/'.join(path)} has shape "
                             f"{shape}, the spec wants {tuple(s.shape)}")

    def one(path, s):
        a = np.asarray(got[path])
        if a.dtype.kind not in "biuf":
            a = a.astype(np.float32)      # bf16 (ml_dtypes) has no torch twin
        return torch.tensor(a, device=device).to(s.dtype)

    out: Dict = {}
    for path, s in want.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = one(path, s)
    return out


def cast_compute(tree, dtype):
    """Working-precision copy: floating leaves with ndim >= 2 (the matmul
    weights) cast to ``dtype``; scales/biases/decay vectors stay f32.
    A leaf already in ``dtype`` is returned as it is (no copy)."""

    def one(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point() \
                and x.dim() >= 2:
            return x.to(dtype)
        return x

    return tree_map(one, tree)


def abstract_params(tree) -> Dict:
    """Tensors of the spec's shapes and dtypes on the ``meta`` device:
    no storage is allocated."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def param_pspecs(tree, rules: Dict[str, Any], mesh_shape: Dict[str, int]):
    """Each spec leaf's mesh axes under ``rules`` (``rules[name]`` is a
    mesh axis name, a tuple of names, or None), as a tuple of entries.  A
    dimension whose size its mesh extent does not divide falls back to
    replication (recorded once per (axis, size, mesh axes) in
    ``param_pspecs.fallbacks``)."""
    fallbacks = set()

    def one(spec: ArraySpec):
        parts, fb = place(list(zip(spec.axes, spec.shape)), rules,
                          mesh_shape, skip_absent=False)
        fallbacks.update(fb)
        return parts

    out = tree_map(one, tree)
    param_pspecs.fallbacks = fallbacks
    return out


def count_params(tree) -> int:
    return sum(int(np.prod(leaf.shape)) for _, leaf in tree_items(tree))


def tree_bytes(tree) -> int:
    """Bytes of a tree of specs or tensors."""
    return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for _, leaf in tree_items(tree))
