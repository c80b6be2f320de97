"""Device-resident columns, join indexes, and the interpreted and
stage-granular engines.

The whole-query ``compiled`` engine itself lives in
``repro_torch.core.stages``; this module holds what it binds at run time:
:class:`DeviceCache` (table columns moved to the device once) and its
:class:`IndexCache` (build-side join indexes: the sorted permutation and
sorted int32 keys of a base table's key columns, built once per table and
key set -- the Flare lesson that the join's hash table belongs to the
data, not to the query).

It also holds the paper's comparison points, registered beside
``compiled`` by ``repro_torch.core.stages``:

``volcano`` -- operator-at-a-time numpy interpreter over compacted arrays,
               in float64: the correctness oracle of every other engine;
``stage``   -- stage-granular execution (the Spark/Tungsten analogue):
               operator pipelines fuse into their parent pipeline breaker
               (join, aggregate, sort, limit), each stage runs the generic
               lowering on the device, and every stage output round-trips
               through the host (paper section 3.1).

The row-at-a-time ``tuple`` engine is ``repro_torch.core.tuple_engine``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import expr as E
from repro_torch.core import lower as L
from repro_torch.core import ml as ML
from repro_torch.core import plan as P
from repro_torch.core.lower import TORCH_OF
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.persist import store as PS
from repro_torch.relational import table as T
from repro_torch.resilience import faults as FZ

# Pipeline breakers.  MapBatches breaks on the stage engine by design:
# Spark treats UDFs as black boxes and materialises around them (paper
# section 5.1).
_BREAKERS = (P.Join, P.Aggregate, P.Sort, P.Limit, P.MapBatches)


_HOST_OF = {torch.int32: np.int32, torch.float32: np.float32,
            torch.bool: np.bool_}


# ---------------------------------------------------------------------------
# process-wide cache telemetry (one aggregate view over every live cache)
# ---------------------------------------------------------------------------


def register_cache(cache: Any) -> Any:
    """Track ``cache`` in the process-wide telemetry registry.  The
    cache's class must define a ``kind`` attribute ("compile", "index",
    "device") and ``__len__``; hit/miss counters are optional.  Shim over
    :data:`repro_torch.obs.metrics.REGISTRY` ("cache" domain)."""
    return OM.REGISTRY.register("cache", cache)


def cache_stats() -> Dict[str, Dict[str, Any]]:
    """One aggregate snapshot over every live cache in the process:
    per cache ``kind`` -- ``compile`` (query templates and their batched
    programs), ``index`` (build-side join indexes), ``device`` (resident
    columns) -- the keys ``caches``, ``entries``, ``hits``, ``misses``,
    ``hit_rate``; ``compile`` and ``index`` also carry a nested ``disk``
    dict (the summed :class:`repro_torch.persist.TierStats` of every live
    :class:`repro_torch.persist.ArtifactStore`, zeros when none), so a
    memory miss served from disk can be told from a build.  Exactly
    ``repro_torch.obs.snapshot()["caches"]``."""
    return OM.cache_section()


# ---------------------------------------------------------------------------
# batch-bucket policy for vmap-coalesced prepared-query execution
# ---------------------------------------------------------------------------


def batch_bucket(n: int) -> int:
    """The bucket serving a batch of ``n`` parameter bindings.

    A batched program is built per binding-stack length, so one per
    observed batch size would turn a busy server's ragged queues into a
    build storm.  Buckets are the powers of two: a batch of ``n`` runs on
    the next-power-of-two program with the tail padded by repeating the
    last binding (padding results are discarded).  The bucket is part of
    the CompileCache key (``repro_torch.core.stages.Compiled.batch``),
    giving exactly one build per (template, bucket).
    """
    if n < 1:
        raise ValueError(f"batch of {n} bindings")
    return 1 << (n - 1).bit_length()


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor over host array ``a``, in its dtype: what the
    interpreters hand a UDF (``repro_torch.core.staging``)."""
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def host_array(v) -> np.ndarray:
    """A UDF's output back as a host array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class UnindexableKeyError(ValueError):
    """Key column(s) cannot back a cached join index (values outside
    the engine's int32 key range).  ``preload`` skips such columns;
    joins over them keep their in-program lowering."""


#: Largest |key| of a dense index: the probe kernel compares keys in f32,
#: which holds every integer up to 2^24 exactly.
DENSE_KEY_LIMIT = 1 << 24


def index_meta(kb: np.ndarray, unique: bool) -> Tuple[int, int, int]:
    """``(dense, base, identity)`` of combined int64 keys ``kb`` in table
    order.  *dense*: the keys are unique and fill ``[base, base + n)``
    (within the f32-exact range), so a probe's position is computed, not
    searched; *identity*: the keys are already sorted, so the index's
    permutation is ``arange(n)``."""
    if not len(kb):
        return 0, 0, 1
    lo, hi = int(kb.min()), int(kb.max())
    dense = (unique and hi - lo == len(kb) - 1
             and -DENSE_KEY_LIMIT <= lo and hi <= DENSE_KEY_LIMIT)
    identity = bool((kb[1:] >= kb[:-1]).all())
    return int(dense), lo if dense else 0, int(identity)


@dataclasses.dataclass
class JoinIndex:
    """A build-side join index: the stable sort permutation and the
    sorted combined keys of a base table's key columns, on the device,
    and what the build learned about them (:func:`index_meta`)."""

    perm: torch.Tensor    # int32 [n]: stable argsort of the combined keys
    keys: torch.Tensor    # int32 [n]: combined keys, sorted
    unique: bool          # verified at build: no duplicate combined keys
    meta: torch.Tensor    # int32 [3]: dense, base, identity


class IndexCache:
    """Caches :class:`JoinIndex` entries per (table, key columns).

    Entries are keyed by the table object and hold it, so a key can
    never be reused by another table while its entry lives.
    Declared-unique key columns (``Field.unique``) are verified against
    the data when the index is built: a false declaration fails loudly
    instead of silently mis-validating filtered build sides.

    ``store`` (or, when None, the ambient ``$FLARE_CACHE_DIR`` store) is
    the disk tier: a memory miss first tries the store's ``index``
    artifact, whose digest covers the raw key-column bytes (changed data
    can never hit a stale index), and a fresh build writes through.  The
    artifact carries ``perm``, ``keys`` and ``meta``: a loaded index
    takes the same probe route as a fresh one.  ``disk_hits`` counts the
    builds this cache skipped by loading.
    """

    kind = "index"

    def __init__(self, device: torch.device,
                 store: Optional["PS.ArtifactStore"] = None):
        self.device = device
        self._entries: Dict[Tuple, Tuple[T.Table, JoinIndex]] = {}
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.store = store
        register_cache(self)

    def _store(self) -> Optional["PS.ArtifactStore"]:
        return self.store if self.store is not None else PS.default_store()

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
            with OT.span("index_lookup", keys=",".join(key_cols),
                         outcome="hit"):
                pass
            return hit[1]
        self.misses += 1
        key_cols, doms = tuple(key_cols), tuple(doms)
        with OT.span("index_lookup", keys=",".join(key_cols),
                     rows=tbl.num_rows) as sp:
            store = self._store()
            entry = None
            if store is not None:
                digest = PS.index_digest(tbl, key_cols, doms)
                entry = self._load_persisted(store, digest, tbl, key_cols)
                if entry is not None:
                    self.disk_hits += 1
                    sp.set(outcome="disk_hit")
            if entry is None:
                with OT.span("index_build", keys=",".join(key_cols),
                             rows=tbl.num_rows):
                    FZ.fault_point("index.build", keys=",".join(key_cols))
                    entry = self._build(tbl, key_cols, doms)
                sp.set(outcome="built")
                if store is not None:
                    self._save_persisted(store, digest, entry)
        self._entries[key] = (tbl, entry)
        return entry

    def _load_persisted(self, store: "PS.ArtifactStore", digest: str,
                        tbl: T.Table, key_cols: Tuple[str, ...]
                        ) -> Optional[JoinIndex]:
        loaded = store.load("index", digest)
        if loaded is None:
            return None
        header, sections = loaded
        meta = header.get("meta", {})
        try:
            n = int(meta["n"])
            unique = bool(meta["unique"])
            if len(sections) != 3:
                raise ValueError("expected perm + keys + meta sections")
            perm = np.frombuffer(sections[0], np.int32)
            keys = np.frombuffer(sections[1], np.int32)
            facts = np.frombuffer(sections[2], np.int32)
            if len(perm) != n or len(keys) != n or n != tbl.num_rows \
                    or len(facts) != 3:
                raise ValueError("length mismatch")
        except (KeyError, TypeError, ValueError):
            store.demote_hit("index", "corrupt")
            return None
        # the declared-unique contract is verified against the data at
        # build time; the digest pins the data, so replaying the saved
        # verdict keeps a false declaration failing loudly here too
        declared = any(tbl.schema[c].unique for c in key_cols)
        if declared and not unique:
            raise ValueError(
                f"column(s) {list(key_cols)} are declared unique "
                f"(Field.unique) but hold duplicate keys")
        dev = self.device
        return JoinIndex(torch.from_numpy(perm.copy()).to(dev),
                         torch.from_numpy(keys.copy()).to(dev), unique,
                         torch.from_numpy(facts.copy()).to(dev))

    @staticmethod
    def _save_persisted(store: "PS.ArtifactStore", digest: str,
                        entry: JoinIndex) -> None:
        host = [t.cpu().numpy().astype(np.int32, copy=False)
                for t in (entry.perm, entry.keys, entry.meta)]
        store.save("index", digest,
                   {"n": int(len(host[0])), "unique": bool(entry.unique)},
                   [a.tobytes() for a in host])

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
        meta = torch.tensor(index_meta(kb, unique), dtype=torch.int32,
                            device=self.device)
        return JoinIndex(perm.to(torch.int32), keys, unique, meta)

    def __len__(self) -> int:
        return len(self._entries)


class DeviceCache:
    """Caches device-resident columns per (table, column name), in the
    engine's 32-bit device dtypes.  ``indexes`` is the companion
    :class:`IndexCache` with the same lifetime, over ``store``."""

    kind = "device"

    def __init__(self, device: torch.device,
                 store: Optional["PS.ArtifactStore"] = None):
        self.device = device
        self._cache: Dict[Tuple, Tuple[T.Table, torch.Tensor]] = {}
        self.indexes = IndexCache(device, store=store)
        register_cache(self)

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
    CPU) or loading them from the store, ``run_s`` the last execution
    including the copy of the result to the host.  ``cache_hit`` is True
    when the :class:`repro_torch.core.stages.CompileCache` already held
    the template.  ``dispatch`` is the native dispatch report
    (:class:`repro_torch.native.registry.DispatchReport`).

    ``disk_hit`` is True when the template came off the persistent store
    tier; ``persist`` is the disk tier's disposition for this compile:
    "hit:native" (its kernel units loaded from the stored libraries, no
    nvcc), "hit:portable" (the units rebuilt from the stored sources),
    "hit:layout" (a compile that needs no unit reused the stored layout
    and nothing else), "written", "unsupported: ...", or "" when no store
    was in play.

    ``degraded`` is the degradation-ladder provenance: one dict per
    recorded hop (:class:`repro_torch.resilience.degrade.DegradeEvent`)
    when a recoverable failure re-lowered this template on a weaker rung
    -- empty on the happy path.
    """

    trace_compile_s: float = 0.0
    cache_hit: bool = False
    lower_s: float = 0.0
    compile_s: float = 0.0
    run_s: float = 0.0
    engine: str = ""
    cache_key: Optional[Tuple] = None
    dispatch: Optional[Any] = None
    disk_hit: bool = False
    persist: str = ""
    degraded: Tuple[Dict[str, Any], ...] = ()


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


# ---------------------------------------------------------------------------
# stage-granular engine (Spark/Tungsten analogue)
# ---------------------------------------------------------------------------


class StageEngine:
    """Pipelines fuse into their parent breaker; each breaker is a stage.

    A stage runs the generic lowering (:func:`repro_torch.core.lower.
    lower_node`) eagerly on the device cache's device.  Its output goes
    to the host and back before the next stage reads it, modelling
    Spark's exchange/iterator boundaries (paper section 3.1: 80% of Q6
    time was spent in exactly this glue).  ``stages_run`` counts the
    stages of the last execution.
    """

    def __init__(self):
        self.stages_run = 0

    def execute(self, p: P.Plan, catalog: P.Catalog, cache: DeviceCache,
                params: Optional[Dict[str, Any]] = None):
        self.stages_run = 0
        self._param_env = {
            s.name: torch.tensor(require_param(params, s),
                                 dtype=TORCH_OF[s.dtype], device=cache.device)
            for s in P.params_of(p)}
        if isinstance(p, P.IterativeKernel):
            # heterogeneous pipeline, Spark-style: the relational half
            # materialises through the host, then the training kernel
            # runs as its OWN stage on the device -- the staged baseline
            # the fused whole-query engine is measured against
            cols, mask, info = self._run_stage(p.child, catalog, cache)
            return self._run_kernel_stage(p, cols, mask, info, cache)
        cols, mask, info = self._run_stage(p, catalog, cache)
        schema = p.schema(catalog)
        dicts = {n: sc.dictionary for n, sc in info.cols.items()}
        cols = {n: cols[n] for n in schema.names}
        return L.Result(cols, mask, schema, dicts)

    def _run_kernel_stage(self, p: P.IterativeKernel,
                          cols: Dict[str, np.ndarray], mask: np.ndarray,
                          info: L.StaticInfo,
                          cache: DeviceCache) -> L.ValueResult:
        """The training kernel as a stage of its own: the relational
        half's host columns back to the device, the kernel, its result
        to the host."""
        self.stages_run += 1
        dev = cache.device
        names = list(p.required_columns())
        stream = L.Stream(
            {m: torch.from_numpy(cols[m]).to(dev) for m in names},
            torch.from_numpy(mask).to(dev),
            L.StaticInfo({m: info.cols[m] for m in names}, info.n_rows), dev)
        env = {v.name: self._param_env[v.name] for _, v in p.hyper
               if isinstance(v, E.Param)}
        out = L.apply_kernel(p, stream, env or None)
        return L.ValueResult(ML.to_host(out))

    def _run_stage(self, root: P.Plan, catalog: P.Catalog,
                   cache: DeviceCache):
        """Execute the stage rooted at ``root``; returns host arrays."""
        self.stages_run += 1
        dev = cache.device
        leaves: Dict[int, Tuple[str, Any]] = {}

        def gather(n: P.Plan, is_root: bool):
            if isinstance(n, P.Scan):
                leaves[id(n)] = ("scan", n)
                return
            if isinstance(n, _BREAKERS) and not is_root:
                leaves[id(n)] = ("mat", self._run_stage(n, catalog, cache))
                return
            for c in n.children():
                gather(c, False)

        gather(root, True)

        needed = L.required_scan_columns(root, catalog)
        scans: Dict[int, L.Stream] = {}
        for lid, (kind, payload) in leaves.items():
            if kind == "scan":
                tbl = catalog.table(payload.table)
                names = needed.get(lid) or tbl.schema.names[:1]
                static = L._static_of_scan(tbl)
                info = L.StaticInfo({n: static.cols[n] for n in names},
                                    tbl.num_rows)
                scans[lid] = L.Stream({n: cache.get(tbl, n) for n in names},
                                      None, info, dev)
            else:
                # the host-to-device half of the round trip
                mcols, mmask, minfo = payload
                scans[lid] = L.Stream(
                    {n: torch.from_numpy(v).to(dev) for n, v in mcols.items()},
                    torch.from_numpy(mmask).to(dev), minfo, dev)
        env = {s.name: self._param_env[s.name] for s in P.params_of(root)}
        stream = L.lower_node(root, catalog, scans, env or None)
        # device to host: the runtime-boundary overhead being modelled
        out_cols = {k: L.as_column(v, stream).cpu().numpy()
                    for k, v in stream.cols.items()}
        return (out_cols, stream.the_mask().cpu().numpy(),
                L.static_info(root, catalog))


# ---------------------------------------------------------------------------
# volcano engine (numpy oracle)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _VStream:
    cols: Dict[str, np.ndarray]
    dicts: Dict[str, Optional[Tuple[str, ...]]]
    domains: Dict[str, Optional[int]]


class VolcanoEngine:
    """Operator-at-a-time interpreter over compacted numpy arrays.

    Semantics deliberately mirror the compiled engine (left-join zero fill,
    group-code output order, N:1 joins) so results are comparable
    element-for-element.  Arithmetic runs in float64: this is the
    high-precision oracle, and it runs on the host whatever the context's
    device.
    """

    def execute(self, p: P.Plan, catalog: P.Catalog,
                cache: Optional[DeviceCache] = None,
                params: Optional[Dict[str, Any]] = None):
        self._params = {
            s.name: np.asarray(require_param(params, s),
                               T.numpy_dtype(s.dtype))[()]
            for s in P.params_of(p)}
        if isinstance(p, P.IterativeKernel):
            return self._train(p, catalog)
        vs = self._run(p, catalog)
        schema = p.schema(catalog)
        cols = {n: vs.cols[n] for n in schema.names}
        return L.Result(cols, None, schema,
                        {n: vs.dicts.get(n) for n in schema.names})

    def _train(self, p: P.IterativeKernel,
               catalog: P.Catalog) -> L.ValueResult:
        """Interpreted heterogeneous pipeline: child rows are compacted
        exact-size, so the kernel sees all-ones weights -- the same math
        as the fused engine's masked padded batch.  The kernel runs on
        CPU float32 tensors."""
        vs = self._run(p.child, catalog)
        n = len(next(iter(vs.cols.values())))
        x = (np.stack([vs.cols[c].astype(np.float32) for c in p.features],
                      axis=1) if n else
             np.zeros((0, len(p.features)), np.float32))
        y = (torch.from_numpy(vs.cols[p.label].astype(np.float32))
             if p.label is not None else None)
        w = torch.ones((n,), dtype=torch.float32)
        hyper = {}
        for k, v in p.hyper:
            hyper[k] = (self._params[v.name].item() if isinstance(v, E.Param)
                        else v)
        out = p.kernel(torch.from_numpy(x), y, weights=w, **hyper)
        return L.ValueResult(ML.to_host(out))

    # -- operators -----------------------------------------------------------

    def _run(self, p: P.Plan, catalog: P.Catalog) -> _VStream:
        if isinstance(p, P.Scan):
            tbl = catalog.table(p.table)
            return _VStream(
                {f.name: tbl[f.name] for f in tbl.schema},
                {f.name: tbl.dictionary(f.name) for f in tbl.schema},
                {f.name: f.domain for f in tbl.schema})
        if isinstance(p, P.Filter):
            c = self._run(p.child, catalog)
            m = np.asarray(self._eval(p.pred, c), dtype=bool)
            return _VStream({n: v[m] for n, v in c.cols.items()},
                            c.dicts, c.domains)
        if isinstance(p, P.Project):
            c = self._run(p.child, catalog)
            cols, dicts, doms = {}, {}, {}
            for name, e in p.outputs:
                cols[name] = np.asarray(self._eval(e, c))
                dicts[name] = (c.dicts.get(e.name) if isinstance(e, E.Col)
                               else None)
                if isinstance(e, E.Col):
                    doms[name] = c.domains.get(e.name)
                elif isinstance(e, E.WithDomain):
                    doms[name] = e.domain
                    if isinstance(e.arg, E.Col):
                        dicts[name] = c.dicts.get(e.arg.name)
                else:
                    doms[name] = None
            return _VStream(cols, dicts, doms)
        if isinstance(p, P.MapBatches):
            c = self._run(p.child, catalog)
            outs = p.fn({k: host_tensor(c.cols[k]) for k in p.columns})
            if set(outs) != set(p.out_names):
                raise TypeError(
                    f"map_batches {p.name!r} returned {sorted(outs)}, "
                    f"declared {sorted(p.out_names)}")
            produced = set(p.out_names)
            n_in = len(next(iter(c.cols.values())))
            cols = {n: v for n, v in c.cols.items() if n not in produced}
            dicts = {n: d for n, d in c.dicts.items() if n not in produced}
            doms = {n: d for n, d in c.domains.items() if n not in produced}
            for f in p.out_fields:
                v = host_array(outs[f.name])
                if v.shape != (n_in,):
                    raise TypeError(
                        f"map_batches {p.name!r} output {f.name!r} has "
                        f"shape {v.shape}; expected ({n_in},) -- batch "
                        "UDFs must be length-preserving 1-D columns")
                cols[f.name] = v.astype(T.numpy_dtype(f.dtype))
                dicts[f.name] = None
                doms[f.name] = f.domain
            return _VStream(cols, dicts, doms)
        if isinstance(p, P.Join):
            return self._join(p, catalog)
        if isinstance(p, P.Aggregate):
            return self._aggregate(p, catalog)
        if isinstance(p, P.Sort):
            c = self._run(p.child, catalog)
            keys = []
            for name, asc in reversed(p.by):
                v = c.cols[name]
                if not asc:
                    v = -v.astype(np.float64) if v.dtype.kind in "fiu" else v
                keys.append(v)
            order = np.lexsort(tuple(keys)) if keys else np.arange(
                len(next(iter(c.cols.values()))))
            return _VStream({n: v[order] for n, v in c.cols.items()},
                            c.dicts, c.domains)
        if isinstance(p, P.Limit):
            c = self._run(p.child, catalog)
            return _VStream({n: v[: p.n] for n, v in c.cols.items()},
                            c.dicts, c.domains)
        raise TypeError(p)

    def _join(self, p: P.Join, catalog: P.Catalog) -> _VStream:
        left = self._run(p.left, catalog)
        right = self._run(p.right, catalog)
        doms = []
        for lk, rk in zip(p.left_on, p.right_on):
            dl = left.dicts.get(lk)
            gl = len(dl) if dl is not None else left.domains.get(lk)
            dr = right.dicts.get(rk)
            gr = len(dr) if dr is not None else right.domains.get(rk)
            doms.append(max(gl or 0, gr or 0) or (1 << 31))
        kp = self._combine([left.cols[k] for k in p.left_on], doms)
        kb = self._combine([right.cols[k] for k in p.right_on], doms)
        perm = np.argsort(kb, kind="stable")
        kb_s = kb[perm]
        idx = np.searchsorted(kb_s, kp)
        idx_c = np.clip(idx, 0, max(len(kb_s) - 1, 0))
        if len(kb_s):
            matched = kb_s[idx_c] == kp
        else:
            matched = np.zeros(len(kp), bool)
        if p.how == "semi":
            return _VStream({n: v[matched] for n, v in left.cols.items()},
                            left.dicts, left.domains)
        if p.how == "anti":
            keep = ~matched
            return _VStream({n: v[keep] for n, v in left.cols.items()},
                            left.dicts, left.domains)
        cols, dicts = dict(left.cols), dict(left.dicts)
        domsout = dict(left.domains)
        for name, v in right.cols.items():
            if name in p.right_on:
                continue
            g = v[perm][idx_c] if len(kb_s) else np.zeros(len(kp), v.dtype)
            if p.how == "left":
                g = np.where(matched, g, np.zeros((), v.dtype))
            cols[name] = g
            dicts[name] = right.dicts.get(name)
            domsout[name] = right.domains.get(name)
        if p.how == "inner":
            cols = {n: v[matched] for n, v in cols.items()}
        return _VStream(cols, dicts, domsout)

    @staticmethod
    def _combine(keys, doms):
        out = keys[0].astype(np.int64)
        for k, d in zip(keys[1:], doms[1:]):
            out = out * np.int64(d) + k.astype(np.int64)
        return out

    def _aggregate(self, p: P.Aggregate, catalog: P.Catalog) -> _VStream:
        c = self._run(p.child, catalog)
        n = len(next(iter(c.cols.values())))
        if not p.keys:
            cols = {}
            for a in p.aggs:
                raw = None if a.arg is None else np.asarray(
                    self._eval(a.arg, c))
                v = None if raw is None else raw.astype(np.float64)
                cols[a.name] = np.asarray(
                    [self._agg_all(a.op, v, n,
                                   raw.dtype if raw is not None
                                   else None)])
            return _VStream(cols, {k: None for k in cols},
                            {k: None for k in cols})
        doms = []
        for k in p.keys:
            d = c.dicts.get(k)
            doms.append(len(d) if d is not None else c.domains[k])
        strides = []
        acc = 1
        for d in reversed(doms):
            strides.append(acc)
            acc *= d
        strides.reverse()
        code = np.zeros(n, np.int64)
        for k, s in zip(p.keys, strides):
            code += c.cols[k].astype(np.int64) * s
        # sorted: matches the compiled engine's group-code order
        groups, inv = np.unique(code, return_inverse=True)
        g = len(groups)
        cols, dicts, domsout = {}, {}, {}
        for k, s, d in zip(p.keys, strides, doms):
            cols[k] = ((groups // s) % d).astype(c.cols[k].dtype)
            dicts[k] = c.dicts.get(k)
            domsout[k] = c.domains.get(k)
        cnt = np.bincount(inv, minlength=g)
        for a in p.aggs:
            if a.op == "count":
                cols[a.name] = cnt.astype(np.int64)
                continue
            v = np.asarray(self._eval(a.arg, c))
            vf = v.astype(np.float64)
            if a.op == "sum":
                cols[a.name] = np.bincount(inv, weights=vf, minlength=g)
            elif a.op == "avg":
                s_ = np.bincount(inv, weights=vf, minlength=g)
                cols[a.name] = s_ / np.maximum(cnt, 1)
            elif a.op in ("min", "max", "any"):
                fill = np.inf if a.op == "min" else -np.inf
                out = np.full(g, fill)
                ufn = np.minimum if a.op == "min" else np.maximum
                ufn.at(out, inv, vf)
                cols[a.name] = out.astype(v.dtype) if a.op == "any" else out
            if a.op == "any" and isinstance(a.arg, E.Col):
                dicts[a.name] = c.dicts.get(a.arg.name)
                domsout[a.name] = c.domains.get(a.arg.name)
            else:
                dicts[a.name] = None
                domsout[a.name] = None
        return _VStream(cols, dicts, domsout)

    @staticmethod
    def _agg_all(op, v, n, dtype=None):
        # empty-input sentinels match the compiled engine's masked fills
        # (f32 finfo.max / int32 iinfo.max, NOT inf)
        def hi():
            return (float(np.finfo(np.float32).max)
                    if dtype is None or dtype.kind == "f"
                    else float(np.iinfo(np.int32).max))

        if op == "count":
            return np.int64(n)
        if op == "sum":
            return v.sum() if len(v) else 0.0
        if op == "avg":
            return v.mean() if len(v) else 0.0
        if op == "min":
            return v.min() if len(v) else hi()
        if op == "max":
            return v.max() if len(v) else -hi()
        raise ValueError(op)

    # -- expressions over numpy ----------------------------------------------

    def _eval(self, e: E.Expr, s: _VStream):
        if isinstance(e, E.Col):
            return s.cols[e.name]
        if isinstance(e, E.Lit):
            return e.value
        if isinstance(e, E.Param):
            return self._params[e.name]
        if isinstance(e, E.BinOp):
            l, r = self._eval(e.left, s), self._eval(e.right, s)
            if e.op == "/":
                return np.asarray(l, np.float64) / np.asarray(r, np.float64)
            return {"+": np.add, "-": np.subtract,
                    "*": np.multiply}[e.op](l, r)
        if isinstance(e, E.Cmp):
            ld = (s.dicts.get(e.left.name) if isinstance(e.left, E.Col)
                  else None)
            rd = (s.dicts.get(e.right.name) if isinstance(e.right, E.Col)
                  else None)
            if ld is not None and isinstance(e.right, E.Lit):
                return self._cmp_code(e.op, s.cols[e.left.name], ld,
                                      e.right.value)
            if rd is not None and isinstance(e.left, E.Lit):
                flipped = {"<": ">", ">": "<", "<=": ">=", ">=": "<=",
                           "==": "==", "!=": "!="}[e.op]
                return self._cmp_code(flipped, s.cols[e.right.name], rd,
                                      e.left.value)
            l, r = self._eval(e.left, s), self._eval(e.right, s)
            return {"<": np.less, "<=": np.less_equal, ">": np.greater,
                    ">=": np.greater_equal, "==": np.equal,
                    "!=": np.not_equal}[e.op](l, r)
        if isinstance(e, E.BoolOp):
            vals = [np.asarray(self._eval(a, s), bool) for a in e.args]
            out = vals[0]
            for v in vals[1:]:
                out = (out & v) if e.op == "and" else (out | v)
            return out
        if isinstance(e, E.Not):
            return ~np.asarray(self._eval(e.arg, s), bool)
        if isinstance(e, E.InSet):
            d = s.dicts.get(e.arg.name) if isinstance(e.arg, E.Col) else None
            v = self._eval(e.arg, s)
            if d is not None:
                codes = [d.index(x) for x in e.values if x in d]
                return np.isin(v, codes)
            return np.isin(v, e.values)
        if isinstance(e, E.StrPred):
            d = s.dicts[e.arg.name]
            lut = np.asarray([E.match_str(e.kind, x, e.params) for x in d],
                             bool)
            return lut[self._eval(e.arg, s)]
        if isinstance(e, E.IfThenElse):
            return np.where(np.asarray(self._eval(e.cond, s), bool),
                            self._eval(e.then, s), self._eval(e.other, s))
        if isinstance(e, E.Cast):
            return np.asarray(self._eval(e.arg, s)).astype(
                T.numpy_dtype(e.dtype))
        if isinstance(e, E.WithDomain):
            return self._eval(e.arg, s)
        if isinstance(e, E.Udf):
            return host_array(e.fn(*[host_tensor(self._eval(a, s))
                                     for a in e.args]))
        raise TypeError(e)

    @staticmethod
    def _cmp_code(op, codes, dictionary, value):
        try:
            code = dictionary.index(value)
        except ValueError:
            if op == "==":
                return np.zeros(codes.shape, bool)
            if op == "!=":
                return np.ones(codes.shape, bool)
            code = int(np.searchsorted(np.asarray(dictionary, object), value))
            if op in ("<", "<="):
                return codes < code
            return codes >= code
        return {"<": np.less, "<=": np.less_equal, ">": np.greater,
                ">=": np.greater_equal, "==": np.equal,
                "!=": np.not_equal}[op](codes, code)
