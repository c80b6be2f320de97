"""Explicit compilation stages: ``Query -> Lowered -> Compiled``.

    lowered  = df.lower(engine="compiled", native=True)  # optimized + lowered
    lowered.plan()                   # inspect the optimized plan
    lowered.dispatch_report()        # which kernel patterns fired
    compiled = lowered.compile()     # builds the native kernels (nvcc),
                                     # or loads them from the store
    compiled(**params)               # execute (many times, cheap)
    compiled.submit(**params)        # dispatch only: an AsyncResult
    compiled.batch([b1, b2, ...])    # many bindings as ONE vmapped call

Compile time and run time are measured apart (``CompileStats``), one
compiled template is reused across executions and, with
:func:`repro_torch.core.expr.param` placeholders, across parameter
bindings: a binding is a 0-d tensor argument of the query function and a
runtime scalar of the kernels, never part of their source.

PyTorch runs eagerly, so "compiling" a template means building its
lowered function and, for native templates on a CUDA device, every
kernel unit its fragments need (``repro_torch.kernels.cuda_build``).

Two runtime services sit under ``compile`` and the executors:

* the persistent store tier (:mod:`repro_torch.persist`): a memory miss
  first tries the template's ``exec`` artifact, whose native tier loads
  the kernel units' libraries without nvcc; a fresh compile writes
  through (``Lowered.compile(persist=...)``, ``FLARE_CACHE_DIR``);
* the degradation ladder (:mod:`repro_torch.resilience.degrade`): a
  failure on its closed allowlist re-lowers the template on the next
  rung, recorded on ``CompileStats.degraded``.

Besides ``compiled`` (and ``compiled-native``), the registry holds the
paper's comparison points: ``stage`` (stage-granular execution with host
round-trips between stages), ``volcano`` (the numpy f64 oracle) and
``tuple`` (row-at-a-time).  ``native=True`` applies to ``compiled``
only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import engines as ENG
from repro_torch.core import expr as E
from repro_torch.core import lower as L
from repro_torch.core import ml as ML
from repro_torch.core import plan as P
from repro_torch.obs import export as OX
from repro_torch.obs import trace as OT
from repro_torch.persist import executable as PX
from repro_torch.persist import store as PSTORE
from repro_torch.relational import table as T
from repro_torch.resilience import degrade as DG
from repro_torch.resilience import faults as FZ

CompileStats = ENG.CompileStats

# An executor is catalog-free: it is bound to a catalog + device cache at
# every call, so a CompileCache entry can serve any catalog whose table
# metadata matches the template key.
Executor = Callable[[P.Catalog, ENG.DeviceCache, Optional[Dict[str, Any]]],
                    L.Result]


def template_key(engine: str, p: P.Plan, catalog: P.Catalog,
                 index_specs: Optional[Dict[int, Any]] = None) -> Tuple:
    """Structural cache key of a (engine, plan, table-metadata) template.

    Param placeholders fingerprint structurally (``p:name:dtype``), so two
    bindings of one template share a key; literals are part of the key.
    Dictionary CONTENTS are baked into compiled programs (string-predicate
    code ranges, comparison codes), so the key covers them by digest.
    Which joins lower against a cached build-side index changes the
    function's argument layout, so that is part of the key too.
    """
    parts: List[Any] = [engine, p.fingerprint()]
    for name in sorted(set(ENG.scan_tables(p))):
        tbl = catalog.table(name)
        parts.append((name, tbl.num_rows,
                      tuple((f.name, f.dtype, f.domain, f.unique,
                             T.dict_token(tbl.dictionary(f.name)))
                            for f in tbl.schema)))
    if getattr(p, "_join_index_disabled", False):
        parts.append(("joinidx", "disabled"))
    else:
        if index_specs is None:
            index_specs, _ = L.join_index_plan(p, catalog)
        parts.append(("joinidx", tuple(
            (s.table, s.key_cols, s.doms, s.masked)
            for s in index_specs.values())))
    return tuple(parts)


class CompileCache:
    """Explicit handle on compiled query templates: one entry per
    :func:`template_key`.  ``hits``/``misses`` are its telemetry."""

    kind = "compile"

    def __init__(self):
        self._entries: Dict[Tuple, Executor] = {}
        self.hits = 0
        self.misses = 0
        ENG.register_cache(self)

    def lookup(self, key: Tuple) -> Optional[Executor]:
        exe = self._entries.get(key)
        if exe is None:
            self.misses += 1
        else:
            self.hits += 1
        return exe

    def insert(self, key: Tuple, exe: Executor) -> None:
        self._entries[key] = exe

    def __len__(self) -> int:
        return len(self._entries)


def bind_params(p: P.Plan, params: Dict[str, Any]) -> P.Plan:
    """Substitute Param placeholders with literal values (plan rewrite),
    e.g. to explain() a template at a concrete binding."""

    def sub(e: E.Expr) -> Optional[E.Expr]:
        if isinstance(e, E.Param):
            return E.Lit(ENG.require_param(params, e))
        return None

    def rule(n: P.Plan) -> Optional[P.Plan]:
        if isinstance(n, P.Filter):
            return P.Filter(n.child, E.map_expr(n.pred, sub))
        if isinstance(n, P.Project):
            return P.Project(n.child, tuple(
                (name, E.map_expr(e, sub)) for name, e in n.outputs))
        if isinstance(n, P.Aggregate):
            return P.Aggregate(n.child, n.keys, tuple(
                dataclasses.replace(a, arg=E.map_expr(a.arg, sub))
                if a.arg is not None else a for a in n.aggs))
        if isinstance(n, P.IterativeKernel):
            return P.IterativeKernel(n.child, n.kernel, n.features, n.label,
                                     tuple((k, ENG.require_param(params, v)
                                            if isinstance(v, E.Param) else v)
                                           for k, v in n.hyper))
        return None

    return P.transform(p, rule)


# ---------------------------------------------------------------------------
# the whole-query engine (Flare Level 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _WholeQueryArtifact:
    fn: Callable
    # (table_name, column_names) per scan, in argument order
    layout: Tuple[Tuple[str, Tuple[str, ...]], ...]
    # cached build-side join indexes: (perm, keys, meta) arguments each
    index_layout: Tuple[L.JoinIndexSpec, ...]
    param_specs: Tuple[E.Param, ...]
    # both None for an IterativeKernel root: the function returns the
    # kernel's result (the "value" kind), not columns
    out_info: Optional[L.StaticInfo]
    schema: Optional[T.Schema]
    # kernel units the plan's native fragments launch (built by compile)
    kernel_sources: Tuple[str, ...]
    # patterns of the plan's native fragments (plan-walk order)
    patterns: Tuple[str, ...] = ()
    # morsel sizes of the plan's MorselMerge nodes (plan-walk order)
    morsels: Tuple[int, ...] = ()


def _marshal_args(layout, index_layout, catalog: P.Catalog,
                  device_cache: ENG.DeviceCache) -> List[torch.Tensor]:
    """The binding-independent arguments: device-resident scan columns
    (layout order), then each join index's (perm, keys, meta)."""
    args: List[torch.Tensor] = []
    for tname, names in layout:
        tbl = catalog.table(tname)
        for n in names:
            args.append(device_cache.get(tbl, n))
    for spec in index_layout:
        idx = device_cache.get_index(catalog.table(spec.table),
                                     spec.key_cols, spec.doms)
        args += [idx.perm, idx.keys, idx.meta]
    return args


def _native_ops(p: P.Plan) -> List[P.Plan]:
    """Every native fragment in ``p`` (plan-walk order)."""
    out: List[P.Plan] = []

    def rec(n: P.Plan):
        if getattr(n, "kernel_sources", None) is not None:
            out.append(n)
        for c in n.children():
            rec(c)

    rec(p)
    return out


def kernel_sources(p: P.Plan) -> Tuple[str, ...]:
    """Kernel units of every native fragment in ``p`` (plan-walk order)."""
    return tuple(src for op in _native_ops(p) for src in op.kernel_sources())


def morsel_sizes(p: P.Plan) -> Tuple[int, ...]:
    """``morsel_rows`` of every :class:`repro_torch.core.morsel.
    MorselMerge` in ``p`` (plan-walk order)."""
    out: List[int] = []

    def rec(n: P.Plan):
        rows = getattr(n, "morsel_rows", None)
        if rows is not None:
            out.append(rows)
        for c in n.children():
            rec(c)

    rec(p)
    return tuple(out)


def fire_morsel_sites(morsels: Sequence[int]) -> None:
    """The fault site ``morsel.loop``, once per morsel loop of a template,
    where its program is built.  The JAX package fires it while tracing
    the loop, inside the compile; the port runs the loop on every call,
    so the site sits where the template compiles, ahead of the
    fragments' ``native.kernel`` and of ``compile.xla`` -- the JAX
    package's trace order."""
    for rows in morsels:
        FZ.fault_point("morsel.loop", morsel_rows=rows)


class WholeQueryEngine:
    """Whole-query compilation: plan -> one function over device tensors.

    ``lower`` builds the function from the catalog's static metadata, so
    it needs no data; ``compile`` builds the native kernels the plan's
    fragments launch (on a CUDA device) and wraps the function into an
    executor."""

    name = "compiled"

    def lower(self, p: P.Plan, catalog: P.Catalog,
              param_specs: Tuple[E.Param, ...]) -> _WholeQueryArtifact:
        fn, id_layout, index_layout, out_info = L.build_callable(
            p, catalog, param_specs)
        smap = ENG.scan_map(p)
        layout = tuple((smap[sid], tuple(names)) for sid, names in id_layout)
        schema = (None if isinstance(p, P.IterativeKernel)
                  else p.schema(catalog))
        ops = _native_ops(p)
        return _WholeQueryArtifact(
            fn, layout, tuple(index_layout), param_specs, out_info, schema,
            tuple(src for op in ops for src in op.kernel_sources()),
            tuple(op.pattern for op in ops), morsel_sizes(p))

    def prepare_fragments(self, artifact: _WholeQueryArtifact) -> None:
        """Hook between the morsel and program fault sites: the native
        engine checks its fragments' kernels here."""

    def compile(self, artifact: _WholeQueryArtifact,
                device: torch.device) -> Executor:
        fire_morsel_sites(artifact.morsels)
        self.prepare_fragments(artifact)
        FZ.fault_point("compile.xla")
        if device.type == "cuda" and artifact.kernel_sources:
            from repro_torch.kernels import cuda_build
            cuda_build.build_all(artifact.kernel_sources)
        return whole_query_executor(artifact)


def whole_query_executor(artifact: _WholeQueryArtifact) -> Executor:
    """Wrap a lowered function into an executor: ``run`` binds the
    catalog and a binding and returns the host result; ``run.raw``
    dispatches and returns the device outputs, ``run.finalize`` copies
    them to the host (the deferred path behind ``Compiled.submit``).  A
    param binding may be a scalar or, for a batched function, a list."""
    layout, specs = artifact.layout, artifact.param_specs
    index_layout = artifact.index_layout
    out_info, schema = artifact.out_info, artifact.schema
    dicts = ({} if out_info is None else
             {n: sc.dictionary for n, sc in out_info.cols.items()})
    fn = artifact.fn

    def raw(catalog: P.Catalog, device_cache: ENG.DeviceCache,
            params: Optional[Dict[str, Any]]):
        dev = device_cache.device
        args = _marshal_args(layout, index_layout, catalog, device_cache)
        for s in specs:
            args.append(L.upload(ENG.require_param(params, s),
                                 L.TORCH_OF[s.dtype], dev))
        return fn(dev, *args)

    def finalize(out):
        if schema is None:  # value kind: the kernel's result
            return L.ValueResult(ML.to_host(out))
        out_cols, mask = out
        out_np = {k: v.cpu().numpy() for k, v in out_cols.items()}
        return L.Result(out_np, mask.cpu().numpy(), schema, dicts)

    def run(catalog: P.Catalog, device_cache: ENG.DeviceCache,
            params: Optional[Dict[str, Any]]) -> L.Result:
        return finalize(raw(catalog, device_cache, params))

    run.raw = raw            # deferred-sync protocol (AsyncResult)
    run.finalize = finalize
    return run


# ---------------------------------------------------------------------------
# the persistent store tier under the CompileCache
# ---------------------------------------------------------------------------


def _resolve_store(persist: Any, device_cache: ENG.DeviceCache
                   ) -> Optional["PSTORE.ArtifactStore"]:
    """The store governing one compile: ``persist=False`` disables, an
    :class:`repro_torch.persist.ArtifactStore` selects explicitly, None
    defers to the device cache's store and then ``$FLARE_CACHE_DIR``."""
    if persist is False:
        return None
    if persist is not None:
        return persist
    return device_cache.indexes._store()


def _exec_digest(key: Tuple, bucket: Optional[int] = None) -> str:
    """Content address of one template artifact: the (process-
    independent) template key, extended for a batched program with its
    bucket -- mirroring the in-memory CompileCache keying."""
    if bucket is None:
        return PSTORE.stable_digest("exec", key)
    return PSTORE.stable_digest("exec", key, ("batch", bucket))


def _persistable(engine_name: str, p: P.Plan) -> Tuple[bool, str]:
    if engine_name not in PX.PERSISTABLE_ENGINES:
        return False, (f"engine {engine_name!r} has no compiled "
                       f"whole-query template")
    return PX.plan_persistable(p)


def _artifact_meta(artifact: _WholeQueryArtifact, engine_name: str,
                   bucket: Optional[int]) -> Dict[str, Any]:
    """The layout an artifact must agree with: engine, bucket, param
    specs, argument and output counts, result kind."""
    n_args = (sum(len(names) for _, names in artifact.layout)
              + 3 * len(artifact.index_layout) + len(artifact.param_specs))
    schema = artifact.schema
    return {"engine": engine_name, "bucket": bucket,
            "params": [[s.name, s.dtype] for s in artifact.param_specs],
            "n_args": n_args,
            "n_out": None if schema is None else len(schema.names) + 1,
            "kind": "value" if schema is None else "relational"}


def _units(artifact: _WholeQueryArtifact, device: torch.device) -> List[str]:
    """The kernel units a compile on ``device`` needs: none on the CPU,
    where every fragment runs its plain version."""
    if device.type != "cuda":
        return []
    return PX.unit_list(artifact.kernel_sources)


def _load_persisted_exec(store: "PSTORE.ArtifactStore", digest: str,
                         artifact: _WholeQueryArtifact, engine_name: str,
                         device: torch.device,
                         bucket: Optional[int] = None) -> str:
    """Ready the lowered ``artifact`` from its store artifact; returns the
    disposition ("hit:native" / "hit:portable" / "hit:layout"), or "" on
    a miss.

    The stored layout must equal the artifact's (else ``corrupt``) and
    the stored unit sources the ones the plan generates now (else the
    artifact is stale: ``version_miss``).  A compile that needs no unit
    (plain ``compiled``, its batch programs, a native plan where no
    fragment fired, any compile on the CPU) reuses only the layout:
    "hit:layout", whatever the envelope.  Otherwise, on a full envelope
    match the native tier loads each unit's library from the artifact's
    bytes (no nvcc); on any drift the portable tier builds the units
    from the sources.  Failures fall back to a fresh compile; an nvcc
    failure raises.
    """
    loaded = store.load("exec", digest, envelope_keys=("format",))
    if loaded is None:
        return ""
    header, sections = loaded
    meta = header.get("meta") or {}
    try:
        sources, libraries = PX.unpack_units(meta, sections)
    except ValueError:
        store.demote_hit("exec", "corrupt")
        return ""
    expect = _artifact_meta(artifact, engine_name, bucket)
    if any(meta.get(k) != v for k, v in expect.items()):
        store.demote_hit("exec", "corrupt")
        return ""
    units = _units(artifact, device)
    if sources != PX.unit_list(artifact.kernel_sources):
        store.demote_hit("exec", "version_miss")
        return ""
    if not units:
        return "hit:layout"
    native = header.get("envelope") == store.current_envelope()
    from repro_torch.kernels import cuda_build
    if native and len(libraries) == len(units):
        try:
            for src, lib in zip(units, libraries):
                cuda_build.load_library(src, lib)
            return "hit:native"
        except OSError:
            pass  # unloadable bytes: the portable tier rebuilds them
    cuda_build.build_all(units)
    return "hit:portable"


def _save_persisted_exec(store: "PSTORE.ArtifactStore", digest: str,
                         artifact: _WholeQueryArtifact, engine_name: str,
                         device: torch.device,
                         bucket: Optional[int] = None) -> str:
    """Write-through after a fresh compile: the layout metadata, the
    units' sources and, on a CUDA device, their libraries.  Never
    raises: a failure is counted and the compile result stands."""
    units = _units(artifact, device)
    libraries = []
    if units:
        from repro_torch.kernels import cuda_build
        for src in units:
            data = cuda_build.library_bytes(src)
            if data is None:
                store.tier("exec").errors += 1
                return "error: unit library missing"
            libraries.append(data)
    meta = _artifact_meta(artifact, engine_name, bucket)
    unit_meta, sections = PX.pack_units(
        PX.unit_list(artifact.kernel_sources), libraries)
    meta.update(unit_meta)
    path = store.save("exec", digest, meta, sections)
    return "written" if path else "error: write failed"


# ---------------------------------------------------------------------------
# stage-granular engine (Spark/Tungsten analogue)
# ---------------------------------------------------------------------------


def stage_decomposition(p: P.Plan) -> List[P.Plan]:
    """Stage roots in bottom-up execution order (the Lowered IR of the
    ``stage`` engine): every pipeline breaker below another stage root
    starts its own stage, mirroring ``engines.StageEngine``."""
    out: List[P.Plan] = []

    def gather(root: P.Plan):
        def rec(n: P.Plan, is_root: bool):
            if isinstance(n, ENG._BREAKERS) and not is_root:
                gather(n)
                return
            for c in n.children():
                rec(c, False)

        rec(root, True)
        out.append(root)

    gather(p)
    return out


@dataclasses.dataclass
class _StageArtifact:
    plan: P.Plan
    stages: List[P.Plan]
    param_specs: Tuple[E.Param, ...]


class StagePipelineEngine:
    """Stage-granular execution: one generic lowering per pipeline
    breaker, run eagerly on the device, with a host round-trip between
    stages -- the Spark-runtime behaviour the paper's Fig. 5/6 measures.
    There is nothing to compile ahead (PyTorch runs eagerly): ``compile``
    only wraps the engine."""

    name = "stage"

    def lower(self, p: P.Plan, catalog: P.Catalog,
              param_specs: Tuple[E.Param, ...]) -> _StageArtifact:
        return _StageArtifact(p, stage_decomposition(p), param_specs)

    def compiler_ir(self, artifact: _StageArtifact,
                    dialect: Optional[str] = None) -> Any:
        if dialect in (None, "stages"):
            return [s.explain() for s in artifact.stages]
        raise ValueError(f"unknown dialect {dialect!r} for stage engine "
                         "(use 'stages')")

    def compile(self, artifact: _StageArtifact,
                device: torch.device) -> Executor:
        eng = ENG.StageEngine()

        def run(catalog: P.Catalog, device_cache: ENG.DeviceCache,
                params: Optional[Dict[str, Any]]) -> L.Result:
            return eng.execute(artifact.plan, catalog, device_cache, params)

        return run


# ---------------------------------------------------------------------------
# interpreted engines (volcano oracle + tuple-at-a-time baseline)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _InterpArtifact:
    plan: P.Plan
    param_specs: Tuple[E.Param, ...]


class VolcanoStageEngine:
    """Vectorised interpreter (the correctness oracle).  ``lower`` is the
    identity on the optimized plan and ``compile`` wraps an interpreter
    -- the stages API still applies, compile just measures ~0."""

    name = "volcano"

    def lower(self, p: P.Plan, catalog: P.Catalog,
              param_specs: Tuple[E.Param, ...]) -> _InterpArtifact:
        return _InterpArtifact(p, param_specs)

    def compiler_ir(self, artifact: _InterpArtifact,
                    dialect: Optional[str] = None) -> Any:
        return artifact.plan.explain()

    def compile(self, artifact: _InterpArtifact,
                device: torch.device) -> Executor:
        def run(catalog: P.Catalog, device_cache: ENG.DeviceCache,
                params: Optional[Dict[str, Any]]) -> L.Result:
            return ENG.VolcanoEngine().execute(artifact.plan, catalog,
                                               None, params)

        return run


class TupleStageEngine:
    """Row-at-a-time Volcano baseline.  Params are bound by plan rewrite
    (Param -> Lit) per execution: with no compiled artifact there is
    nothing to share, so substitution IS prepared-statement execution."""

    name = "tuple"

    def lower(self, p: P.Plan, catalog: P.Catalog,
              param_specs: Tuple[E.Param, ...]) -> _InterpArtifact:
        return _InterpArtifact(p, param_specs)

    def compiler_ir(self, artifact: _InterpArtifact,
                    dialect: Optional[str] = None) -> Any:
        return artifact.plan.explain()

    def compile(self, artifact: _InterpArtifact,
                device: torch.device) -> Executor:
        from repro_torch.core.tuple_engine import TupleEngine

        def run(catalog: P.Catalog, device_cache: ENG.DeviceCache,
                params: Optional[Dict[str, Any]]) -> L.Result:
            p = artifact.plan
            if artifact.param_specs:
                p = bind_params(p, params)
            return TupleEngine().execute(p, catalog)

        return run


class Engine(Protocol):
    """A pluggable execution back-end behind the stages API.

    ``lower`` turns an optimized plan into an engine-specific artifact
    (the whole-query function, a stage decomposition, ...); ``compile``
    turns that artifact into a reusable catalog-free :data:`Executor` on
    a device; ``compiler_ir``, where an engine has one, exposes the
    artifact for inspection.
    """

    name: str

    def lower(self, p: P.Plan, catalog: P.Catalog,
              param_specs: Tuple[E.Param, ...]) -> Any:
        """Lower ``p``; returns the engine's lowering artifact."""
        ...

    def compile(self, artifact: Any, device: torch.device) -> Executor:
        """Compile the artifact into an executor."""
        ...


ENGINES: Dict[str, Engine] = {}


def register_engine(engine: Engine) -> Engine:
    """Register a back-end under ``engine.name`` (last wins)."""
    ENGINES[engine.name] = engine
    return engine


def get_engine(name: str) -> Engine:
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; available: "
                         f"{available_engines()}") from None


def available_engines() -> List[str]:
    """Names of the registered engines, sorted; ``compiled-native`` is
    registered by :mod:`repro_torch.native`, imported here for it."""
    import repro_torch.native  # noqa: F401
    return sorted(ENGINES)


for _cls in (WholeQueryEngine, StagePipelineEngine, VolcanoStageEngine,
             TupleStageEngine):
    register_engine(_cls())


# ---------------------------------------------------------------------------
# the stage objects
# ---------------------------------------------------------------------------


class Lowered:
    """An optimized plan lowered for one engine, awaiting compilation.

    Lowering is forced lazily: ``compile()`` on a cache hit never builds
    the function again, which is what makes prepared-query reuse cheap.
    """

    def __init__(self, p: P.Plan, catalog: P.Catalog, engine,
                 param_specs: Tuple[E.Param, ...], key: Tuple,
                 device_cache: ENG.DeviceCache,
                 compile_cache: CompileCache,
                 dispatch_report: Optional[Any] = None):
        self._plan = p
        self._catalog = catalog
        self._engine = engine
        self._param_specs = param_specs
        self._key = key
        self._device_cache = device_cache
        self._compile_cache = compile_cache
        self._dispatch_report = dispatch_report
        self._artifact: Any = None
        self._lower_s = 0.0
        # re-lower source for the degradation ladder: the pre-rewrite plan
        # and lowering kwargs, stashed by lower_plan().  None for directly
        # constructed Lowered objects (no ladder).
        self._degrade_src: Optional[Dict[str, Any]] = None

    @property
    def engine_name(self) -> str:
        return self._engine.name

    @property
    def cache_key(self) -> Tuple:
        return self._key

    def plan(self) -> P.Plan:
        """The optimized (and, with ``native=True``, annotated) plan."""
        return self._plan

    def explain(self) -> str:
        return "== Physical Plan ==\n" + self._plan.explain()

    def params(self) -> Tuple[E.Param, ...]:
        """Param placeholders (sorted by name = binding order)."""
        return self._param_specs

    def dispatch_report(self) -> Optional[Any]:
        """Native kernel dispatch report: which patterns fired, which
        fragments fell back and why, and per join whether the build side
        probes the cached index."""
        return self._dispatch_report

    def kernel_sources(self) -> Tuple[str, ...]:
        """The kernel units this template's native fragments launch."""
        return kernel_sources(self._plan)

    def compiler_ir(self, dialect: Optional[str] = None) -> Any:
        """Engine IR: the stage list (stage), plan text (interpreters).
        The compiled engines have none: their generated code is
        :meth:`kernel_sources`."""
        ir = getattr(self._engine, "compiler_ir", None)
        if ir is None:
            raise ValueError(f"the {self._engine.name!r} engine has no "
                             "compiler IR; see Lowered.kernel_sources()")
        return ir(self._force(), dialect)

    def _force(self) -> Any:
        if self._artifact is None:
            with OT.span("lower", engine=self._engine.name):
                t0 = time.perf_counter()
                self._artifact = self._engine.lower(
                    self._plan, self._catalog, self._param_specs)
                self._lower_s = time.perf_counter() - t0
        return self._artifact

    def compile(self, cache: Optional[CompileCache] = None,
                persist: Any = None) -> "Compiled":
        """Compile (or fetch) the executor of this template.

        Lookup order: memory (``cache``), then the persistent store tier
        -- ``persist`` names an :class:`repro_torch.persist.ArtifactStore`,
        ``False`` disables the disk tier, None (the default) uses the
        context's store and then the ambient ``$FLARE_CACHE_DIR``.  A
        disk hit loads the template's kernel units (no nvcc on the native
        tier), promotes the template to memory and sets
        ``stats.disk_hit``; a fresh compile writes through.

        Failures on the recoverable allowlist (:func:`repro_torch.
        resilience.degrade.recoverable`) re-lower on the next rung of the
        degradation ladder instead of raising, recording the hop on
        ``stats.degraded``; ``FLARE_DEGRADE=off`` disables this.  An nvcc
        failure is not on the list: it raises.
        """
        try:
            return self._compile_inner(cache, persist)
        except Exception as err:
            low, event = DG.next_lowered(self._degrade_src,
                                         self._engine.name, err, "compile")
            if low is None:
                raise
            compiled = low.compile(persist=persist)
            compiled.stats.degraded = ((event.to_dict(),)
                                       + tuple(compiled.stats.degraded))
            return compiled

    def _compile_inner(self, cache: Optional[CompileCache],
                       persist: Any) -> "Compiled":
        cache = cache if cache is not None else self._compile_cache
        stats = CompileStats(engine=self._engine.name, cache_key=self._key,
                             dispatch=self._dispatch_report)
        store = _resolve_store(persist, self._device_cache)
        device = self._device_cache.device
        with OT.span("compile", engine=self._engine.name) as csp:
            exe = cache.lookup(self._key)
            if exe is None:
                can_persist = False
                if store is not None:
                    can_persist, reason = _persistable(self._engine.name,
                                                       self._plan)
                    if not can_persist:
                        store.tier("exec").unsupported += 1
                        stats.persist = f"unsupported: {reason}"
                artifact = self._force()
                stats.lower_s = self._lower_s
                if can_persist:
                    with OT.span("persist", op="load") as psp:
                        t0 = time.perf_counter()
                        disposition = _load_persisted_exec(
                            store, _exec_digest(self._key), artifact,
                            self._engine.name, device)
                        psp.set(outcome=disposition or "miss")
                    if disposition:
                        exe = whole_query_executor(artifact)
                        stats.compile_s = time.perf_counter() - t0
                        stats.disk_hit = True
                        stats.persist = disposition
                        cache.insert(self._key, exe)
                if exe is None:
                    t0 = time.perf_counter()
                    exe = self._engine.compile(artifact, device)
                    stats.compile_s = time.perf_counter() - t0
                    cache.insert(self._key, exe)
                    if can_persist:
                        with OT.span("persist", op="save") as psp:
                            stats.persist = _save_persisted_exec(
                                store, _exec_digest(self._key), artifact,
                                self._engine.name, device)
                            psp.set(outcome=stats.persist)
            else:
                stats.cache_hit = True
            stats.trace_compile_s = stats.lower_s + stats.compile_s
            csp.set(cache="hit" if stats.cache_hit else "miss",
                    disk="hit" if stats.disk_hit else "miss",
                    compile_s=round(stats.compile_s, 6),
                    lower_s=round(stats.lower_s, 6))
            if stats.persist:
                csp.set(persist=stats.persist)
        return Compiled(exe, self._plan, self._catalog, self._engine.name,
                        self._param_specs, self._key, self._device_cache,
                        stats, compile_cache=cache, store=store,
                        degrade_src=self._degrade_src)


def _ready_event(device: torch.device) -> Optional[Any]:
    """A CUDA event recorded on the current stream behind the work just
    dispatched to ``device``; None on the CPU, where PyTorch runs each
    operator to its end before it returns."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


class AsyncResult:
    """A dispatched execution whose device outputs have not been copied
    to the host.

    Returned by ``Compiled.submit`` / ``Compiled(..., block=False)`` and
    by ``Compiled.batch(block=False)``: the device work is queued, and a
    CUDA event recorded behind it marks its end; nothing waits for it
    until the caller asks for the value.  Every request of a coalesced
    batch holds its own handle onto the shared device outputs and pays
    the copy of its own slice only when its client reads.

    ``ready()`` probes the event (non-blocking), ``block_until_ready()``
    waits on it without a copy, and ``result()`` materialises (once, and
    caches) the host-side :class:`repro_torch.core.lower.Result` and
    drops the device reference.  On the CPU there is no event: the work
    has run by the time the handle exists.
    """

    def __init__(self, out: Any, finalize: Callable[[Any], Any],
                 event: Optional[Any] = None):
        self._out = out
        self._finalize = finalize
        self._event = event
        self._result: Any = None
        self._done = False

    def ready(self) -> bool:
        """True once the device computation has finished."""
        return self._done or self._event is None or self._event.query()

    def block_until_ready(self) -> "AsyncResult":
        if not self._done and self._event is not None:
            self._event.synchronize()
        return self

    def result(self) -> Any:
        """The host-side Result (blocks until ready, cached)."""
        if not self._done:
            self._result = self._finalize(self._out)
            self._done = True
            self._out = self._event = None  # free the device references
        return self._result

    def compact(self) -> Dict[str, np.ndarray]:
        return self.result().compact()

    collect = compact

    def __repr__(self):
        state = "ready" if self.ready() else "pending"
        return f"AsyncResult<{state}>"


@dataclasses.dataclass
class BatchExecutor:
    """A vmap-coalesced template: ONE call serving a ``bucket``-sized
    stack of parameter bindings.

    Lives in the :class:`CompileCache` under the template's key extended
    with ``("batch", bucket)``.  ``raw`` dispatches the whole batch
    (stacked ``[bucket]`` param tensors, shared scan/index arguments) and
    returns the device outputs, each with a leading ``[bucket]`` axis;
    ``finalize_one(out, i)`` copies request ``i``'s slice to the host.
    """

    raw: Callable[[P.Catalog, ENG.DeviceCache, Dict[str, List[Any]]], Any]
    finalize_one: Callable[[Any, int], Any]
    bucket: int


def _stack(values: List[Any]) -> Any:
    """Stack per-binding results into one with a leading batch axis
    (NamedTuples, tuples, lists and dicts keep their shape)."""
    first = values[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(values)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(v)) for v in zip(*values)))
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(v)) for v in zip(*values))
    if isinstance(first, dict):
        return {k: _stack([v[k] for v in values]) for k in first}
    return torch.as_tensor(values)


def _slice(value: Any, i: int) -> Any:
    """Row ``i`` of every tensor in a (nested) batched result."""
    if isinstance(value, torch.Tensor):
        return value[i]
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_slice(v, i) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_slice(v, i) for v in value)
    if isinstance(value, dict):
        return {k: _slice(v, i) for k, v in value.items()}
    return value


def batch_artifact(p: P.Plan, catalog: P.Catalog,
                   param_specs: Tuple[E.Param, ...],
                   bucket: int) -> _WholeQueryArtifact:
    """Lower the ``bucket``-wide batched program of a template.

    The single-binding function is vmapped over the param axis
    (:func:`repro_torch.core.lower.build_batch_callable`): scan columns
    and join-index arguments broadcast, each ``param()`` placeholder
    becomes one stacked ``[bucket]`` tensor.

    A ``train()`` root cannot go through vmap: the port's
    ``until_converged`` reads one diff an iteration on the host.  Its
    batched program runs the single-binding function once per row of the
    stack and stacks the outputs -- the same result, one dispatch per
    binding (the JAX package vmaps its ``lax.while_loop``).
    """
    if isinstance(p, P.IterativeKernel):
        fn, id_layout, index_layout, out_info = L.build_callable(
            p, catalog, param_specs)
        n_params = len(param_specs)

        def bfn(dev, *flat):
            shared, stacked = flat[:-n_params], flat[-n_params:]
            return _stack([fn(dev, *shared, *(t[i] for t in stacked))
                           for i in range(bucket)])
    else:
        bfn, id_layout, index_layout, out_info = L.build_batch_callable(
            p, catalog, param_specs)
    smap = ENG.scan_map(p)
    layout = tuple((smap[sid], tuple(names)) for sid, names in id_layout)
    schema = None if out_info is None else p.schema(catalog)
    return _WholeQueryArtifact(bfn, layout, tuple(index_layout),
                               param_specs, out_info, schema, ())


def batch_executor(artifact: _WholeQueryArtifact,
                   bucket: int) -> BatchExecutor:
    """Wrap a lowered batched program into a :class:`BatchExecutor`."""
    executor = whole_query_executor(artifact)

    def finalize_one(out, i: int):
        return executor.finalize(_slice(out, i))

    return BatchExecutor(executor.raw, finalize_one, bucket)


def compile_batch_executor(p: P.Plan, catalog: P.Catalog,
                           param_specs: Tuple[E.Param, ...], bucket: int,
                           artifact: Optional[_WholeQueryArtifact] = None
                           ) -> BatchExecutor:
    """Build the ``bucket``-wide batched program of a template
    (:func:`batch_artifact`, unless already lowered as ``artifact``).
    The fault sites ``morsel.loop`` (per morsel loop) and ``compile.xla``
    fire here, where the program is built
    (:mod:`repro_torch.resilience.faults`)."""
    fire_morsel_sites(morsel_sizes(p))
    FZ.fault_point("compile.xla", bucket=bucket)
    if artifact is None:
        artifact = batch_artifact(p, catalog, param_specs, bucket)
    return batch_executor(artifact, bucket)


#: Engines whose Compiled objects support vmap-coalesced batching.  The
#: native variant keeps per-binding dispatch: its fragments are ctypes
#: launches of nvcc-built kernels, which ``torch.func.vmap`` cannot
#: batch (the JAX package's Pallas kernels carry no vmap rule either).
_BATCHABLE_ENGINES = ("compiled",)


class Compiled:
    """An executable query template: call it with parameter bindings.

    ``compiled(**params)`` returns compacted host columns;
    ``compiled.result(**params)`` the padded :class:`repro_torch.core.
    lower.Result`; ``compiled(block=False, **params)`` /
    ``compiled.submit(**params)`` an :class:`AsyncResult` whose device
    outputs stay on the device until read; ``compiled.batch([...])``
    coalesces many bindings into ONE vmapped call.  One Compiled serves
    any number of bindings.
    """

    def __init__(self, exe: Executor, p: P.Plan, catalog: P.Catalog,
                 engine_name: str, param_specs: Tuple[E.Param, ...],
                 key: Tuple, device_cache: ENG.DeviceCache,
                 stats: CompileStats,
                 compile_cache: Optional[CompileCache] = None,
                 store: Optional["PSTORE.ArtifactStore"] = None,
                 degrade_src: Optional[Dict[str, Any]] = None):
        self._exe = exe
        self._plan = p
        self._catalog = catalog
        self.engine_name = engine_name
        self._param_specs = param_specs
        self.cache_key = key
        self._device_cache = device_cache
        self.stats = stats
        self._compile_cache = compile_cache
        self._store = store
        self._last_trace: Optional[OT.Trace] = None
        self._degrade_src = degrade_src
        # sticky execution-time fallback: set by the first recoverable
        # execution failure, every later call routes straight to it
        self._degraded_to: Optional["Compiled"] = None

    def params(self) -> Tuple[E.Param, ...]:
        return self._param_specs

    def last_trace(self) -> Optional[OT.Trace]:
        """The :class:`repro_torch.obs.trace.Trace` of this template's
        most recent execution (the execute span and everything inside
        it); None until an execution runs with tracing enabled
        (``FLARE_TRACE=1`` or ``repro_torch.obs.capture()``)."""
        return self._last_trace

    def _check_bindings(self, params: Dict[str, Any]) -> None:
        known = {s.name for s in self._param_specs}
        extra = sorted(set(params) - known)
        if extra:
            raise TypeError(f"unknown parameter(s) {extra}; this template "
                            f"takes {sorted(known)}")

    def _degrade_for(self, err: BaseException,
                     phase: str = "execute") -> Optional["Compiled"]:
        """Build (and pin) the fallback Compiled for a recoverable
        failure at ``phase``; None when the ladder must not engage."""
        low, event = DG.next_lowered(self._degrade_src, self.engine_name,
                                     err, phase)
        if low is None:
            return None
        fb = low.compile()
        self.stats.degraded = (tuple(self.stats.degraded)
                               + (event.to_dict(),)
                               + tuple(fb.stats.degraded))
        self._degraded_to = fb
        return fb

    def result(self, **params: Any) -> L.Result:
        """The padded :class:`repro_torch.core.lower.Result`, or a
        :class:`repro_torch.core.lower.ValueResult` for a ``train()``
        plan.  A recoverable failure answers from the next rung of the
        degradation ladder (and every later call goes there)."""
        if self._degraded_to is not None:
            return self._degraded_to.result(**params)
        try:
            return self._result_inner(**params)
        except Exception as err:
            fb = self._degrade_for(err)
            if fb is None:
                raise
            return fb.result(**params)

    def _result_inner(self, **params: Any) -> L.Result:
        self._check_bindings(params)
        if not OT.TRACER.on:  # hot path: no tracing machinery
            t0 = time.perf_counter()
            out = self._exe(self._catalog, self._device_cache, params or None)
            self.stats.run_s = time.perf_counter() - t0
            return out
        mark = OT.TRACER.watermark()
        with OT.span("execute", engine=self.engine_name, mode="sync") as sp, \
                OX.device_annotation(f"flare:execute:{self.engine_name}"):
            t0 = time.perf_counter()
            out = self._exe(self._catalog, self._device_cache, params or None)
            self.stats.run_s = time.perf_counter() - t0
        sp.set(run_s=round(self.stats.run_s, 6))
        try:
            sp.set(rows=out.num_rows())
        except Exception:
            pass
        self._last_trace = OT.Trace(OT.TRACER.since(mark))
        return out

    def submit(self, **params: Any) -> AsyncResult:
        """Dispatch without a host copy: returns an :class:`AsyncResult`
        whose device outputs are copied only at ``.result()`` /
        ``.compact()``.  ``stats.run_s`` then measures dispatch only.
        Engines without a deferred path (stage, volcano, tuple) run
        eagerly behind an already-ready handle, so the API is uniform
        across engines."""
        if self._degraded_to is not None:
            return self._degraded_to.submit(**params)
        try:
            return self._submit_inner(**params)
        except Exception as err:
            fb = self._degrade_for(err)
            if fb is None:
                raise
            return fb.submit(**params)

    def _submit_inner(self, **params: Any) -> AsyncResult:
        self._check_bindings(params)
        raw = getattr(self._exe, "raw", None)
        tracing = OT.TRACER.on
        mark = OT.TRACER.watermark() if tracing else 0
        with OT.span("execute", engine=self.engine_name,
                     mode="dispatch") as sp:
            t0 = time.perf_counter()
            if raw is None:  # no deferred path: eager, trivially ready
                out = self._exe(self._catalog, self._device_cache,
                                params or None)
                handle = AsyncResult(None, lambda _: out)
                handle.result()
            else:
                out = raw(self._catalog, self._device_cache, params or None)
                handle = AsyncResult(out, self._exe.finalize,
                                     _ready_event(self._device_cache.device))
            self.stats.run_s = time.perf_counter() - t0
        if tracing:
            sp.set(run_s=round(self.stats.run_s, 6), deferred=raw is not None)
            self._last_trace = OT.Trace(OT.TRACER.since(mark))
        return handle

    def __call__(self, block: bool = True, **params: Any):
        """Execute one binding.  ``block=True`` (default) returns
        compacted host columns (the kernel's result, with host arrays,
        for a ``train()`` plan); ``block=False`` returns the
        :class:`AsyncResult` handle.  ``block`` is reserved: name a query
        parameter something else, or bind through ``result()`` /
        ``submit()``."""
        if not block:
            return self.submit(**params)
        return self.result(**params).compact()

    collect = __call__

    # -- vmap-coalesced multi-binding execution ------------------------------

    def batch(self, bindings: Sequence[Dict[str, Any]],
              block: bool = True) -> List[Any]:
        """Execute many bindings of this template as ONE call.

        The bindings stack into one ``[bucket]`` tensor per ``param()``
        spec (scan columns and join indexes shared), the vmapped function
        runs once, and each binding gets its own slice of the shared
        outputs: ``block=True`` returns one
        :class:`repro_torch.core.lower.Result` per binding,
        ``block=False`` one :class:`AsyncResult` per binding (the
        server's deferred per-request copy).

        Batched programs are bucketed (:func:`repro_torch.core.engines.
        batch_bucket`: next power of two) and cached in the template's
        CompileCache under ``cache_key + (("batch", bucket),)`` --
        exactly one build per (template, bucket); ragged batches pad by
        repeating the last binding and the padding is discarded.

        A param-free template degenerates to perfect coalescing: every
        request is the same execution, run once and shared.  Engines
        other than ``compiled`` raise ``TypeError``.  A recoverable
        failure answers from the next rung of the degradation ladder,
        per binding where that rung cannot batch.
        """
        bindings = [dict(b) for b in bindings]
        if not bindings:
            return []
        if self._degraded_to is not None:
            return self._batch_on(self._degraded_to, bindings, block)
        try:
            return self._batch_inner(bindings, block)
        except Exception as err:
            fb = self._degrade_for(err)
            if fb is None:
                raise
            return self._batch_on(fb, bindings, block)

    @staticmethod
    def _batch_on(fb: "Compiled", bindings: List[Dict[str, Any]],
                  block: bool) -> List[Any]:
        """Run a batch on the fallback rung: vmap-coalesced when the rung
        supports it, per-binding dispatch otherwise (the answer is the
        same)."""
        if fb.engine_name in _BATCHABLE_ENGINES:
            return fb.batch(bindings, block=block)
        handles = [fb.submit(**b) for b in bindings]
        return [h.result() for h in handles] if block else handles

    def _batch_inner(self, bindings: List[Dict[str, Any]],
                     block: bool) -> List[Any]:
        if self.engine_name not in _BATCHABLE_ENGINES:
            raise TypeError(
                f"batched execution requires one of {_BATCHABLE_ENGINES} "
                f"(vmap over the whole-query function); engine "
                f"{self.engine_name!r} keeps per-binding dispatch")
        for b in bindings:
            self._check_bindings(b)
        if not self._param_specs:
            handle = self.submit()
            handles = [handle] * len(bindings)
            return [h.result() for h in handles] if block else handles
        bucket = ENG.batch_bucket(len(bindings))
        tracing = OT.TRACER.on
        mark = OT.TRACER.watermark() if tracing else 0
        with OT.span("execute", engine=self.engine_name, mode="batch",
                     bindings=len(bindings), bucket=bucket) as sp:
            try:
                exe = self._batch_executor(bucket)
            except Exception as err:
                # building the batched program is a compile: its
                # failures meet the ladder's compile-phase allowlist
                fb = self._degrade_for(err, "compile")
                if fb is None:
                    raise
                return self._batch_on(fb, bindings, block)
            padded = bindings + [bindings[-1]] * (bucket - len(bindings))
            stacked = {s.name: [ENG.require_param(b, s) for b in padded]
                       for s in self._param_specs}
            t0 = time.perf_counter()
            out = exe.raw(self._catalog, self._device_cache, stacked)
            event = _ready_event(self._device_cache.device)
            self.stats.run_s = time.perf_counter() - t0
        if tracing:
            sp.set(run_s=round(self.stats.run_s, 6))
            self._last_trace = OT.Trace(OT.TRACER.since(mark))
        handles = [AsyncResult(out, lambda o, i=i: exe.finalize_one(o, i),
                               event)
                   for i in range(len(bindings))]
        return [h.result() for h in handles] if block else handles

    def _batch_executor(self, bucket: int) -> BatchExecutor:
        key = self.cache_key + (("batch", bucket),)
        cache = self._compile_cache
        exe = cache.lookup(key) if cache is not None else None
        if exe is not None:
            return exe
        with OT.span("compile", engine=self.engine_name, kind="batch",
                     bucket=bucket) as csp:
            store = self._store
            can_persist = False
            artifact = None
            if store is not None:
                can_persist, _ = _persistable(self.engine_name, self._plan)
            if can_persist:
                with OT.span("persist", op="load", bucket=bucket) as psp:
                    t0 = time.perf_counter()
                    artifact = batch_artifact(self._plan, self._catalog,
                                              self._param_specs, bucket)
                    disposition = _load_persisted_exec(
                        store, _exec_digest(self.cache_key, bucket),
                        artifact, self.engine_name,
                        self._device_cache.device, bucket=bucket)
                    psp.set(outcome=disposition or "miss")
                if disposition:
                    exe = batch_executor(artifact, bucket)
                    self.stats.compile_s += time.perf_counter() - t0
                    self.stats.disk_hit = True
                    if not self.stats.persist.startswith("hit"):
                        self.stats.persist = disposition
                    if cache is not None:
                        cache.insert(key, exe)
                    csp.set(cache="miss", disk="hit")
                    return exe
            t0 = time.perf_counter()
            exe = compile_batch_executor(self._plan, self._catalog,
                                         self._param_specs, bucket,
                                         artifact=artifact)
            self.stats.compile_s += time.perf_counter() - t0
            csp.set(cache="miss", disk="miss",
                    compile_s=round(time.perf_counter() - t0, 6))
            if cache is not None:
                cache.insert(key, exe)
            if can_persist:
                with OT.span("persist", op="save", bucket=bucket):
                    _save_persisted_exec(
                        store, _exec_digest(self.cache_key, bucket),
                        artifact, self.engine_name,
                        self._device_cache.device, bucket=bucket)
        return exe

    def count(self, **params: Any) -> int:
        return self.result(**params).num_rows()

    def scalar(self, name: Optional[str] = None, **params: Any):
        return self.result(**params).scalar(name)

    def __repr__(self):
        names = ", ".join(s.name for s in self._param_specs)
        return f"Compiled<{self.engine_name}>({names})"


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _add_index_decisions(report: Optional[Any], decisions: List
                         ) -> Optional[Any]:
    """Record, per join, whether the build side probes the cached index
    or sorts in the program, on the template's dispatch report (created
    when absent)."""
    if not decisions:
        return report
    from repro_torch.native import registry as NR  # telemetry types only
    if report is None:
        report = NR.DispatchReport()
    for join, spec, reason in decisions:
        report.index_decisions.append(NR.Decision(
            pattern="join-index", node=join.describe(),
            fired=spec is not None, mode="cached" if spec else "",
            reason="ok" if spec else reason))
    return report


def _joins_of(p: P.Plan) -> List[P.Plan]:
    out: List[P.Plan] = []

    def rec(n: P.Plan):
        if isinstance(n, P.Join):
            out.append(n)
        for c in n.children():
            rec(c)

    rec(p)
    return out


def lower_plan(p: P.Plan, catalog: P.Catalog,
               device_cache: ENG.DeviceCache,
               compile_cache: CompileCache,
               engine: str = "compiled", native: bool = False,
               join_index: bool = True,
               memory_budget: Optional[int] = None,
               morsel_rows: Optional[int] = None) -> Lowered:
    """Lower an (already optimized) plan for ``engine``.

    ``native=True`` (or ``engine="compiled-native"``) first runs the
    :mod:`repro_torch.native` dispatch pass: fragments the kernel-pattern
    registry matches launch the CUDA kernels (their plain versions on a
    CPU device), everything else keeps the generic lowering, and the
    dispatch report lands on ``Lowered.dispatch_report()``.

    ``join_index=False`` disables the build-side join index cache: every
    join sorts its build keys in the program (and ``join-probe``, which
    needs the index, cannot fire).

    ``memory_budget`` (bytes) declares how much device memory the spine
    stream's working set may take: a plan that needs more is rewritten
    for out-of-core morsel execution (:func:`repro_torch.core.morsel.
    plan_morsels`: the spine streams in fixed-size row ranges and the
    partial aggregates merge).  ``morsel_rows`` forces a morsel size
    instead.  Both apply to ``compiled`` and ``compiled-native`` only
    (``ValueError`` elsewhere); the morsel wrap runs before the native
    dispatch pass, which then annotates the partial aggregate the loop
    computes, and the morsel size is part of the template key.

    The returned ``Lowered`` carries the pre-rewrite plan and these
    arguments as its degradation-ladder source
    (:mod:`repro_torch.resilience.degrade` re-lowers from there on a
    weaker rung).
    """
    dispatch_report = None
    degrade_src = dict(plan=p, catalog=catalog, engine=engine,
                       device_cache=device_cache,
                       compile_cache=compile_cache, native=native,
                       join_index=join_index, memory_budget=memory_budget,
                       morsel_rows=morsel_rows)
    if native and engine == "compiled":
        engine = "compiled-native"
    elif native and engine != "compiled-native":
        raise ValueError(f"native=True requires the 'compiled' engine, got "
                         f"{engine!r}")
    if memory_budget is not None or morsel_rows is not None:
        if engine not in ("compiled", "compiled-native"):
            raise ValueError(
                "memory_budget/morsel_rows apply to the compiled and "
                f"compiled-native engines, got {engine!r}")
        # the morsel wrap BEFORE native annotation: the dispatch pass must
        # see (and annotate) the partial aggregate the loop computes
        from repro_torch.core import morsel as MO
        with OT.span("morsel_plan", budget=memory_budget or 0,
                     morsel_rows=morsel_rows or 0):
            p = MO.plan_morsels(p, catalog, memory_budget=memory_budget,
                                morsel_rows=morsel_rows)
    if engine == "compiled-native":
        from repro_torch.native import dispatch as ND
        p, dispatch_report = ND.rewrite_plan(p, catalog, device_cache.device,
                                             join_index=join_index)
    eng = get_engine(engine)
    if engine not in ("compiled", "compiled-native"):
        # the stage and interpreted engines probe no cached join index
        key = template_key(engine, p, catalog)
        lowered = Lowered(p, catalog, eng, P.params_of(p), key,
                          device_cache, compile_cache)
        lowered._degrade_src = degrade_src
        return lowered
    if join_index:
        with OT.span("index_plan"):
            index_specs, decisions = L.join_index_plan(p, catalog)
    else:
        index_specs = {}
        decisions = [(j, None, "join index cache disabled "
                      "(join_index=False)") for j in _joins_of(p)]
        if decisions:
            # disable on a PRIVATE root copy: the marker must not leak
            # onto a plan the caller may lower again with the cache on
            p = p.with_children(p.children())
            p._join_index_disabled = True
    dispatch_report = _add_index_decisions(dispatch_report, decisions)
    specs = P.params_of(p)
    key = template_key(engine, p, catalog, index_specs=index_specs)
    lowered = Lowered(p, catalog, eng, specs, key, device_cache,
                      compile_cache, dispatch_report=dispatch_report)
    lowered._degrade_src = degrade_src
    return lowered
