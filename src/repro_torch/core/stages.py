"""Explicit compilation stages: ``Query -> Lowered -> Compiled``.

    lowered  = df.lower(engine="compiled", native=True)  # optimized + lowered
    lowered.plan()                   # inspect the optimized plan
    lowered.dispatch_report()        # which kernel patterns fired
    compiled = lowered.compile()     # builds the native kernels (nvcc)
    compiled(**params)               # execute (many times, cheap)

Compile time and run time are measured apart (``CompileStats``), one
compiled template is reused across executions and, with
:func:`repro_torch.core.expr.param` placeholders, across parameter
bindings: a binding is a 0-d tensor argument of the query function and a
runtime scalar of the kernels, never part of their source.

PyTorch runs eagerly, so "compiling" a template means building its
lowered function and, for native templates on a CUDA device, every
kernel unit its fragments need (``repro_torch.kernels.cuda_build``).

Besides ``compiled`` (and ``compiled-native``), the registry holds the
paper's comparison points: ``stage`` (stage-granular execution with host
round-trips between stages), ``volcano`` (the numpy f64 oracle) and
``tuple`` (row-at-a-time).  ``native=True`` applies to ``compiled``
only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engines as ENG
from repro_torch.core import expr as E
from repro_torch.core import lower as L
from repro_torch.core import ml as ML
from repro_torch.core import plan as P
from repro_torch.relational import table as T

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


def kernel_sources(p: P.Plan) -> Tuple[str, ...]:
    """Kernel units of every native fragment in ``p`` (plan-walk order)."""
    out: List[str] = []

    def rec(n: P.Plan):
        sources = getattr(n, "kernel_sources", None)
        if sources is not None:
            out.extend(sources())
        for c in n.children():
            rec(c)

    rec(p)
    return tuple(out)


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
        return _WholeQueryArtifact(fn, layout, tuple(index_layout),
                                   param_specs, out_info, schema,
                                   kernel_sources(p))

    def compile(self, artifact: _WholeQueryArtifact,
                device: torch.device) -> Executor:
        if device.type == "cuda" and artifact.kernel_sources:
            from repro_torch.kernels import cuda_build
            cuda_build.build_all(artifact.kernel_sources)
        layout, specs = artifact.layout, artifact.param_specs
        index_layout = artifact.index_layout
        out_info, schema = artifact.out_info, artifact.schema
        dicts = ({} if out_info is None else
                 {n: sc.dictionary for n, sc in out_info.cols.items()})
        fn = artifact.fn

        def run(catalog: P.Catalog, device_cache: ENG.DeviceCache,
                params: Optional[Dict[str, Any]]) -> L.Result:
            dev = device_cache.device
            args = _marshal_args(layout, index_layout, catalog, device_cache)
            for s in specs:
                args.append(torch.tensor(
                    ENG.require_param(params, s),
                    dtype=L.TORCH_OF[s.dtype], device=dev))
            out = fn(dev, *args)
            if schema is None:  # value kind: the kernel's result
                return L.ValueResult(ML.to_host(out))
            out_cols, mask = out
            out_np = {k: v.cpu().numpy() for k, v in out_cols.items()}
            return L.Result(out_np, mask.cpu().numpy(), schema, dicts)

        return run


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


ENGINES: Dict[str, Any] = {}


def register_engine(engine) -> Any:
    """Register a back-end under ``engine.name`` (last wins)."""
    ENGINES[engine.name] = engine
    return engine


def get_engine(name: str):
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; available: "
                         f"{sorted(ENGINES)}") from None


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
            t0 = time.perf_counter()
            self._artifact = self._engine.lower(self._plan, self._catalog,
                                                self._param_specs)
            self._lower_s = time.perf_counter() - t0
        return self._artifact

    def compile(self, cache: Optional[CompileCache] = None) -> "Compiled":
        """Compile (or fetch) the executor of this template."""
        cache = cache if cache is not None else self._compile_cache
        stats = CompileStats(engine=self._engine.name, cache_key=self._key,
                             dispatch=self._dispatch_report)
        exe = cache.lookup(self._key)
        if exe is None:
            artifact = self._force()
            t0 = time.perf_counter()
            exe = self._engine.compile(artifact, self._device_cache.device)
            stats.compile_s = time.perf_counter() - t0
            stats.lower_s = self._lower_s
            cache.insert(self._key, exe)
        else:
            stats.cache_hit = True
        stats.trace_compile_s = stats.lower_s + stats.compile_s
        return Compiled(exe, self._plan, self._catalog, self._engine.name,
                        self._param_specs, self._key, self._device_cache,
                        stats)


class Compiled:
    """An executable query template: call it with parameter bindings.

    ``compiled(**params)`` returns compacted host columns;
    ``compiled.result(**params)`` the padded :class:`repro_torch.core.
    lower.Result`.  One Compiled serves any number of bindings.
    """

    def __init__(self, exe: Executor, p: P.Plan, catalog: P.Catalog,
                 engine_name: str, param_specs: Tuple[E.Param, ...],
                 key: Tuple, device_cache: ENG.DeviceCache,
                 stats: CompileStats):
        self._exe = exe
        self._plan = p
        self._catalog = catalog
        self.engine_name = engine_name
        self._param_specs = param_specs
        self.cache_key = key
        self._device_cache = device_cache
        self.stats = stats

    def params(self) -> Tuple[E.Param, ...]:
        return self._param_specs

    def _check_bindings(self, params: Dict[str, Any]) -> None:
        known = {s.name for s in self._param_specs}
        extra = sorted(set(params) - known)
        if extra:
            raise TypeError(f"unknown parameter(s) {extra}; this template "
                            f"takes {sorted(known)}")

    def result(self, **params: Any) -> L.Result:
        """The padded :class:`repro_torch.core.lower.Result`, or a
        :class:`repro_torch.core.lower.ValueResult` for a ``train()``
        plan."""
        self._check_bindings(params)
        t0 = time.perf_counter()
        out = self._exe(self._catalog, self._device_cache, params or None)
        self.stats.run_s = time.perf_counter() - t0
        return out

    def __call__(self, **params: Any) -> Dict[str, np.ndarray]:
        """Execute one binding; returns compacted host columns (the
        kernel's result, with host arrays, for a ``train()`` plan)."""
        return self.result(**params).compact()

    collect = __call__

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
               join_index: bool = True) -> Lowered:
    """Lower an (already optimized) plan for ``engine``.

    ``native=True`` (or ``engine="compiled-native"``) first runs the
    :mod:`repro_torch.native` dispatch pass: fragments the kernel-pattern
    registry matches launch the CUDA kernels (their plain versions on a
    CPU device), everything else keeps the generic lowering, and the
    dispatch report lands on ``Lowered.dispatch_report()``.

    ``join_index=False`` disables the build-side join index cache: every
    join sorts its build keys in the program (and ``join-probe``, which
    needs the index, cannot fire).
    """
    dispatch_report = None
    if native and engine == "compiled":
        engine = "compiled-native"
    elif native and engine != "compiled-native":
        raise ValueError(f"native=True requires the 'compiled' engine, got "
                         f"{engine!r}")
    if engine == "compiled-native":
        from repro_torch.native import dispatch as ND
        p, dispatch_report = ND.rewrite_plan(p, catalog, device_cache.device,
                                             join_index=join_index)
    eng = get_engine(engine)
    if engine not in ("compiled", "compiled-native"):
        # the stage and interpreted engines probe no cached join index
        key = template_key(engine, p, catalog)
        return Lowered(p, catalog, eng, P.params_of(p), key, device_cache,
                       compile_cache)
    if join_index:
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
    return Lowered(p, catalog, eng, specs, key, device_cache, compile_cache,
                   dispatch_report=dispatch_report)
