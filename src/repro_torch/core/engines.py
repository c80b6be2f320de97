"""Device-resident columns, join indexes and compile telemetry.

The whole-query ``compiled`` engine itself lives in
``repro_torch.core.stages``; this module holds what it binds at run time:
:class:`DeviceCache` (table columns moved to the device once) and its
:class:`IndexCache` (build-side join indexes: the sorted permutation and
sorted int32 keys of a base table's key columns, built once per table and
key set -- the Flare lesson that the join's hash table belongs to the
data, not to the query).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import expr as E
from repro_torch.core import plan as P
from repro_torch.core.lower import TORCH_OF
from repro_torch.relational import table as T


_HOST_OF = {torch.int32: np.int32, torch.float32: np.float32,
            torch.bool: np.bool_}


class UnindexableKeyError(ValueError):
    """Key column(s) cannot back a cached join index (values outside
    the engine's int32 key range).  ``preload`` skips such columns;
    joins over them keep their in-program lowering."""


@dataclasses.dataclass
class JoinIndex:
    """A build-side join index: the stable sort permutation and the
    sorted combined keys of a base table's key columns, on the device."""

    perm: torch.Tensor    # int32 [n]: stable argsort of the combined keys
    keys: torch.Tensor    # int32 [n]: combined keys, sorted
    unique: bool          # verified at build: no duplicate combined keys


class IndexCache:
    """Caches :class:`JoinIndex` entries per (table, key columns).

    Entries are keyed by the table object and hold it, so a key can
    never be reused by another table while its entry lives.
    Declared-unique key columns (``Field.unique``) are verified against
    the data when the index is built: a false declaration fails loudly
    instead of silently mis-validating filtered build sides.
    """

    kind = "index"

    def __init__(self, device: torch.device):
        self.device = device
        self._entries: Dict[Tuple, Tuple[T.Table, JoinIndex]] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(tbl: T.Table, key_cols: Tuple[str, ...],
             doms: Tuple[int, ...]) -> Tuple:
        # single-column keys combine to the raw column values, so the
        # domain bounds are not part of the index identity there
        return (id(tbl), tuple(key_cols),
                tuple(doms) if len(key_cols) > 1 else ())

    def get(self, tbl: T.Table, key_cols: Tuple[str, ...],
            doms: Tuple[int, ...] = ()) -> JoinIndex:
        key = self._key(tbl, key_cols, doms)
        hit = self._entries.get(key)
        if hit is not None:
            self.hits += 1
            return hit[1]
        self.misses += 1
        entry = self._build(tbl, tuple(key_cols), tuple(doms))
        self._entries[key] = (tbl, entry)
        return entry

    def _build(self, tbl: T.Table, key_cols: Tuple[str, ...],
               doms: Tuple[int, ...]) -> JoinIndex:
        # combine in int64 on the host first: the cast to the engine's
        # int32 keys must be exact, and the uniqueness check must see the
        # TRUE values
        kb = np.asarray(tbl[key_cols[0]]).astype(np.int64)
        for c, d in zip(key_cols[1:], doms[1:]):
            kb = kb * np.int64(d) + np.asarray(tbl[c]).astype(np.int64)
        if len(kb) and (kb.min() < -(2 ** 31) or kb.max() >= 2 ** 31):
            raise UnindexableKeyError(
                f"combined join key over {list(key_cols)} exceeds the "
                f"engine's int32 key range")
        kb_dev = torch.from_numpy(kb.astype(np.int32)).to(self.device)
        # stable, as in the in-program join: cached and in-program probes
        # resolve duplicate keys to the SAME row
        keys, perm = torch.sort(kb_dev, stable=True)
        unique = bool((keys[1:] != keys[:-1]).all()) if len(keys) else True
        declared = any(tbl.schema[c].unique for c in key_cols)
        if declared and not unique:
            raise ValueError(
                f"column(s) {list(key_cols)} are declared unique "
                f"(Field.unique) but hold duplicate keys")
        return JoinIndex(perm.to(torch.int32), keys, unique)

    def __len__(self) -> int:
        return len(self._entries)


class DeviceCache:
    """Caches device-resident columns per (table, column name), in the
    engine's 32-bit device dtypes.  ``indexes`` is the companion
    :class:`IndexCache` with the same lifetime."""

    kind = "device"

    def __init__(self, device: torch.device):
        self.device = device
        self._cache: Dict[Tuple, Tuple[T.Table, torch.Tensor]] = {}
        self.indexes = IndexCache(device)

    def __len__(self) -> int:
        return len(self._cache)

    def get(self, tbl: T.Table, name: str) -> torch.Tensor:
        key = (id(tbl), name)
        hit = self._cache.get(key)
        if hit is not None:
            return hit[1]
        col = tbl.column(name)
        host = col.data.astype(_HOST_OF[TORCH_OF[col.dtype]], copy=False)
        arr = torch.from_numpy(np.ascontiguousarray(host)).to(self.device)
        self._cache[key] = (tbl, arr)
        return arr

    def get_index(self, tbl: T.Table, key_cols: Tuple[str, ...],
                  doms: Tuple[int, ...] = ()) -> JoinIndex:
        """The build-side join index for ``key_cols`` of ``tbl``."""
        return self.indexes.get(tbl, key_cols, doms)


@dataclasses.dataclass
class CompileStats:
    """Telemetry for one lower/compile/execute pipeline.

    ``lower_s`` covers plan -> function, ``compile_s`` building the
    template's native kernels (nvcc on a CUDA device; nothing on the
    CPU), ``run_s`` the last execution including the copy of the result
    to the host.  ``cache_hit`` is True when the
    :class:`repro_torch.core.stages.CompileCache` already held the
    template.  ``dispatch`` is the native dispatch report
    (:class:`repro_torch.native.registry.DispatchReport`).
    """

    trace_compile_s: float = 0.0
    cache_hit: bool = False
    lower_s: float = 0.0
    compile_s: float = 0.0
    run_s: float = 0.0
    engine: str = ""
    cache_key: Optional[Tuple] = None
    dispatch: Optional[Any] = None


def require_param(params: Optional[Dict[str, Any]], spec: E.Param):
    """Fetch ``spec``'s binding or raise a clear prepared-query error."""
    if params is None or spec.name not in params:
        raise KeyError(
            f"unbound query parameter {spec.name!r} ({spec.dtype}); "
            f"bound: {sorted(params) if params else []}")
    return params[spec.name]


def scan_tables(p: P.Plan) -> List[str]:
    """Names of all tables scanned by ``p`` (with duplicates)."""
    out = []

    def rec(n):
        if isinstance(n, P.Scan):
            out.append(n.table)
        for c in n.children():
            rec(c)

    rec(p)
    return out


def scan_map(p: P.Plan) -> Dict[int, str]:
    """id(Scan node) -> table name, for argument binding."""
    out = {}

    def rec(n):
        if isinstance(n, P.Scan):
            out[id(n)] = n.table
        for c in n.children():
            rec(c)

    rec(p)
    return out
