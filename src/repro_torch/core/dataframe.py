"""Deferred DataFrame API over the explicit compilation stages::

    ctx = FlareContext()                       # the CUDA device by default
    ctx.register("lineitem", table)
    df = ctx.table("lineitem").filter(
        col("l_discount").between(E.param("lo"), E.param("hi")))
    compiled = df.lower(engine="compiled", native=True).compile()
    compiled(lo=0.05, hi=0.07)                 # prepared-query execution
    compiled(lo=0.02, hi=0.04)                 # same template, new binding

``df.collect()`` runs lower + compile + execute in one step, on the
``stage`` engine unless ``engine=`` names another (``compiled``,
``volcano``, ``tuple``), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engines as ENG
from repro_torch.core import expr as E
from repro_torch.core import ml as ML
from repro_torch.core import optimizer as OPT
from repro_torch.core import plan as P
from repro_torch.core import stages as S
from repro_torch.obs import trace as OT
from repro_torch.relational import table as T


class FlareContext:
    """Session object: catalog + device cache + compile cache, on one
    device.  ``device="cuda"`` (the default) raises when no CUDA device
    is available: the context never carries on on the CPU unless asked
    to with ``device="cpu"``.

    ``store`` attaches a persistent artifact store
    (:class:`repro_torch.persist.ArtifactStore`) as the disk tier under
    this context's compile and index caches; when None, the ambient
    ``$FLARE_CACHE_DIR`` store (if set) is used.  Either way a fresh
    process loads the kernel units and join indexes that an earlier
    process built.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 optimize: bool = True, join_reorder: bool = False,
                 store: Optional[Any] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FlareContext(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.catalog = P.Catalog()
        self.store = store
        self.cache = ENG.DeviceCache(device, store=store)
        self.compile_cache = S.CompileCache()
        self.optimize = optimize
        self.join_reorder = join_reorder

    # -- catalog ---------------------------------------------------------------

    def register(self, name: str, tbl: T.Table) -> None:
        self.catalog.register(name, tbl)

    def table(self, name: str) -> "DataFrame":
        if name not in self.catalog:
            raise KeyError(f"unknown table {name!r}")
        return DataFrame(self, P.Scan(name))

    def from_arrays(self, name: str, data, dtypes=None, domains=None,
                    uniques=None) -> "DataFrame":
        self.register(name, T.Table.from_arrays(data, dtypes, domains,
                                                uniques))
        return self.table(name)

    # -- execution ---------------------------------------------------------------

    def optimized(self, plan: P.Plan) -> P.Plan:
        if not self.optimize:
            return plan
        with OT.span("optimize", join_reorder=self.join_reorder):
            return OPT.optimize(plan, self.catalog,
                                join_reorder=self.join_reorder)

    def execute(self, plan: P.Plan, engine: str,
                stats: Optional[ENG.CompileStats] = None,
                params: Optional[Dict[str, Any]] = None,
                native: bool = False):
        """Optimize, lower, compile and run ``plan`` once on ``engine``;
        the padded :class:`repro_torch.core.lower.Result`.  ``stats``,
        when given, receives the run's :class:`CompileStats`."""
        compiled = self.lower(plan, engine, native=native).compile()
        out = compiled.result(**(params or {}))
        if stats is not None:
            for f in dataclasses.fields(stats):
                setattr(stats, f.name, getattr(compiled.stats, f.name))
        return out

    def lower(self, plan: P.Plan, engine: str = "compiled",
              native: bool = False, mesh: Optional[Any] = None,
              axis: str = "data", join_index: bool = True,
              memory_budget: Optional[int] = None,
              morsel_rows: Optional[int] = None) -> S.Lowered:
        """Optimize + lower a plan (stages entry point)."""
        return S.lower_plan(self.optimized(plan), self.catalog, self.cache,
                            self.compile_cache, engine=engine,
                            native=native, join_index=join_index,
                            memory_budget=memory_budget,
                            morsel_rows=morsel_rows, mesh=mesh, axis=axis)

    def preload(self, *names: str, indexes: bool = True) -> None:
        """Paper's ``persist()``: move table columns to the device up
        front, and build the join index of every declared-unique integer
        key column (loading is when indexing happens, paper section 4)."""
        for name in names or self.catalog.names():
            tbl = self.catalog.table(name)
            for f in tbl.schema:
                self.cache.get(tbl, f.name)
                if indexes and f.unique and f.dtype in (
                        T.INT32, T.INT64, T.DATE):
                    try:
                        self.cache.get_index(tbl, (f.name,))
                    except ENG.UnindexableKeyError:
                        pass  # int32-overflowing key: joins stay inline


class DataFrame:
    """A deferred query: context + logical plan (paper section 2.2)."""

    def __init__(self, ctx: FlareContext, plan: P.Plan):
        self.ctx = ctx
        self.plan = plan

    # -- transformations (all deferred) ------------------------------------------

    def filter(self, pred: E.Expr) -> "DataFrame":
        return DataFrame(self.ctx, P.Filter(self.plan, pred))

    where = filter

    def select(self, *exprs: Union[str, Tuple[str, E.Expr]]) -> "DataFrame":
        outputs: List[Tuple[str, E.Expr]] = []
        for item in exprs:
            if isinstance(item, str):
                outputs.append((item, E.col(item)))
            elif isinstance(item, tuple):
                outputs.append(item)
            elif isinstance(item, E.Col):
                outputs.append((item.name, item))
            else:
                raise TypeError("select() takes column names or "
                                "expr.alias(name) tuples")
        return DataFrame(self.ctx, P.Project(self.plan, tuple(outputs)))

    def with_column(self, name: str, e: E.Expr) -> "DataFrame":
        schema = self.plan.schema(self.ctx.catalog)
        outputs = [(n, E.col(n)) for n in schema.names if n != name]
        outputs.append((name, e))
        return DataFrame(self.ctx, P.Project(self.plan, tuple(outputs)))

    def join(self, other: "DataFrame", on: Union[str, Sequence[str]],
             right_on: Union[str, Sequence[str], None] = None,
             how: str = "inner", strategy: Optional[str] = None
             ) -> "DataFrame":
        left_on = (on,) if isinstance(on, str) else tuple(on)
        if right_on is None:
            r_on = left_on
        else:
            r_on = (right_on,) if isinstance(right_on, str) else tuple(right_on)
        return DataFrame(self.ctx, P.Join(self.plan, other.plan,
                                          left_on, r_on, how, strategy))

    def group_by(self, *keys: str) -> "GroupedData":
        return GroupedData(self, keys)

    def agg(self, *specs: P.AggSpec) -> "DataFrame":
        return DataFrame(self.ctx, P.Aggregate(self.plan, (), tuple(specs)))

    def sort(self, *by: Union[str, Tuple[str, bool]]) -> "DataFrame":
        norm = tuple((b, True) if isinstance(b, str) else b for b in by)
        return DataFrame(self.ctx, P.Sort(self.plan, norm))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.ctx, P.Limit(self.plan, n))

    # -- heterogeneous pipelines (Flare Level 3, paper Fig. 8) -------------------

    def map_batches(self, fn, columns: Union[str, Sequence[str]],
                    schema, name: Optional[str] = None) -> "DataFrame":
        """Apply a batch UDF over torch tensors as a plan node.

        ``fn`` receives ``{column: tensor}`` for the declared ``columns``
        (on the engine's device) and must return ``{name: tensor}``
        matching ``schema`` (a dict ``{name: dtype}``, a sequence of
        ``(name, dtype[, domain])``, or :class:`repro_torch.relational.
        table.Field` objects).  It must be row-wise and
        length-preserving; under the ``compiled`` engine it runs inside
        the whole-query function, while the ``stage`` engine
        materialises around it (Spark's black-box UDF behaviour).
        Declared columns let the optimizer push filters across the node
        and prune unused child columns.
        """
        cols = (columns,) if isinstance(columns, str) else tuple(columns)
        fields = _out_fields(schema)
        node = P.MapBatches(self.plan, fn, cols, fields,
                            name or getattr(fn, "__name__", "map_batches"))
        node.schema(self.ctx.catalog)  # validate declared inputs eagerly
        return DataFrame(self.ctx, node)

    def to_matrix(self, *columns: str) -> "MatrixView":
        """The relational -> linear-algebra handoff (paper Fig. 8
        ``toMatrix``): name the feature columns (default: every numeric
        column) and get a :class:`MatrixView` to ``.train()`` on."""
        schema = self.plan.schema(self.ctx.catalog)
        if columns:
            missing = [c for c in columns if c not in schema]
            if missing:
                raise KeyError(f"to_matrix: unknown column(s) {missing}")
        else:
            columns = tuple(f.name for f in schema
                            if T.is_numeric(f.dtype))
            if not columns:
                raise ValueError("to_matrix: no numeric columns")
        for c in columns:
            if not T.is_numeric(schema[c].dtype):
                raise TypeError(f"to_matrix: column {c!r} has dtype "
                                f"{schema[c].dtype}; features must be "
                                "numeric")
        return MatrixView(self, tuple(columns))

    def train(self, kernel, columns: Optional[Sequence[str]] = None,
              label: Optional[str] = None, **hyper) -> "DataFrame":
        """Train an ML kernel on this query's output -- as a plan node.

        ``kernel`` is a registered name (``"kmeans"``, ``"logreg"``,
        ``"gda"``), a :class:`repro_torch.core.ml.TrainKernel`, or a bare
        callable over tensors.  Feature ``columns`` default to every
        numeric column except ``label``.  Hyper-parameter values may be
        :func:`repro_torch.core.expr.param` placeholders (runtime-bound,
        one compiled pipeline per template).  Returns a terminal
        DataFrame: ``.lower(engine=...)`` / ``.compile()`` / call yields
        the kernel's result with host arrays.
        """
        if columns is None:
            schema = self.plan.schema(self.ctx.catalog)
            columns = [f.name for f in schema
                       if T.is_numeric(f.dtype) and f.name != label]
            if not columns:
                raise ValueError(
                    "train: no numeric feature columns besides the label; "
                    "pass columns=[...] explicitly")
        return self.to_matrix(*columns).train(kernel, label=label, **hyper)

    # -- compilation stages ------------------------------------------------------

    def lower(self, engine: str = "compiled", native: bool = False,
              mesh: Optional[Any] = None, axis: str = "data",
              join_index: bool = True, memory_budget: Optional[int] = None,
              morsel_rows: Optional[int] = None) -> S.Lowered:
        """Optimize + lower this query.  ``native=True`` runs the kernel
        dispatch pass (``lowered.dispatch_report()`` says what fired);
        ``join_index=False`` makes every join sort its build side in the
        program instead of probing the cached index.

        ``engine="parallel"`` splits the query into row-range shards of
        its spine table along ``axis`` of ``mesh`` (default: the
        context's device, :func:`repro_torch.launch.mesh.make_data_mesh`),
        runs the row-parallel section once per shard and merges the
        partial aggregates (or concatenates the shards' rows) after it
        (:mod:`repro_torch.core.parallel`); one template per mesh shape
        serves every binding.

        ``memory_budget`` (bytes) declares how much device memory the
        spine stream's working set may take: an over-budget query is
        rewritten for out-of-core morsel execution -- the scan streams
        through the plan in fixed-size row ranges and the partial
        aggregates merge (:mod:`repro_torch.core.morsel`).
        ``morsel_rows`` pins the range size.  Both compose with
        ``native`` and ``parallel``."""
        return self.ctx.lower(self.plan, engine, native=native, mesh=mesh,
                              axis=axis, join_index=join_index,
                              memory_budget=memory_budget,
                              morsel_rows=morsel_rows)

    def params(self) -> Tuple[E.Param, ...]:
        """Param placeholders of this query (binding order)."""
        return P.params_of(self.plan)

    def collect(self, engine: str = "stage",
                params: Optional[Dict[str, Any]] = None,
                native: bool = False) -> Dict[str, np.ndarray]:
        """Lower, compile and run once; compacted host columns.
        ``native=True`` applies to the ``compiled`` engine only."""
        return self.ctx.execute(self.plan, engine, params=params,
                                native=native).compact()

    def count(self, engine: str = "stage",
              params: Optional[Dict[str, Any]] = None) -> int:
        return self.ctx.execute(self.plan, engine, params=params).num_rows()

    def explain(self, optimized: bool = True, analyze: bool = False,
                engine: str = "compiled", native: bool = False,
                params: Optional[Dict[str, Any]] = None,
                join_index: bool = True) -> str:
        """The optimized plan tree -- or, with ``analyze=True``, EXPLAIN
        ANALYZE: the query executes once for ``engine`` under the tracer
        (:mod:`repro_torch.obs`) and the report annotates the plan with
        rows/columns/bytes per scan, per-phase wall times
        (optimize/dispatch/lower/compile/persist/execute), compile and
        disk-tier provenance, and -- with ``native=True`` -- which kernel
        patterns fired or fell back and why, and per join where its index
        came from.  Prepared templates need their bindings via
        ``params=``."""
        if analyze:
            from repro_torch.obs import analyze as OA
            return OA.explain_analyze(self, engine=engine, native=native,
                                      params=params, join_index=join_index)
        plan = self.ctx.optimized(self.plan) if optimized else self.plan
        return "== Physical Plan ==\n" + plan.explain()

    def schema(self) -> T.Schema:
        return self.plan.schema(self.ctx.catalog)

    def show(self, n: int = 20, engine: str = "stage",
             params: Optional[Dict[str, Any]] = None) -> None:
        print(format_rows(self.collect(engine, params=params), n))


def _out_fields(schema) -> Tuple[T.Field, ...]:
    """Normalise a map_batches output-schema spec into Field tuples."""
    if isinstance(schema, T.Schema):
        return schema.fields
    items = schema.items() if isinstance(schema, dict) else schema
    fields = []
    for item in items:
        if isinstance(item, T.Field):
            fields.append(item)
        else:
            name, dtype, *rest = item
            fields.append(T.Field(name, dtype, rest[0] if rest else None))
    if not fields:
        raise ValueError("map_batches needs at least one output column")
    return tuple(fields)


class MatrixView:
    """A deferred [n, d] feature matrix over named query columns.

    Not itself executable -- it exists to make the relational/ML
    boundary explicit: ``df.to_matrix("f0", "f1").train("kmeans", k=4)``
    builds an :class:`repro_torch.core.plan.IterativeKernel` plan whose
    lowering fuses the ETL and the training loop (compiled engine) or
    stages them (the other engines).
    """

    def __init__(self, df: DataFrame, columns: Tuple[str, ...]):
        self.df = df
        self.columns = columns

    def train(self, kernel, label: Optional[str] = None,
              **hyper) -> DataFrame:
        k = ML.train_kernel(kernel)
        schema = self.df.plan.schema(self.df.ctx.catalog)
        if label is not None:
            if label not in schema:
                raise KeyError(f"train: unknown label column {label!r}")
            if not T.is_numeric(schema[label].dtype):
                raise TypeError(
                    f"train: label column {label!r} has dtype "
                    f"{schema[label].dtype}; labels must be numeric "
                    "(dictionary-encode categories to codes explicitly)")
        if k.needs_labels and label is None:
            raise TypeError(f"kernel {k.name!r} needs labels; pass "
                            "label=...")
        node = P.IterativeKernel(self.df.plan, k, self.columns, label,
                                 tuple(sorted(hyper.items())))
        return DataFrame(self.df.ctx, node)

    def __repr__(self):
        return f"MatrixView(columns={list(self.columns)})"


class GroupedData:
    def __init__(self, df: DataFrame, keys: Tuple[str, ...]):
        self.df = df
        self.keys = keys

    def agg(self, *specs: P.AggSpec) -> DataFrame:
        return DataFrame(self.df.ctx,
                         P.Aggregate(self.df.plan, self.keys, tuple(specs)))

    def count(self, name: str = "count") -> DataFrame:
        return self.agg(P.AggSpec(name, "count", None))


# -- aggregate constructors ---------------------------------------------------


def sum_(e: E.Expr, name: str = "sum") -> P.AggSpec:
    return P.AggSpec(name, "sum", e)


def avg(e: E.Expr, name: str = "avg") -> P.AggSpec:
    return P.AggSpec(name, "avg", e)


def min_(e: E.Expr, name: str = "min") -> P.AggSpec:
    return P.AggSpec(name, "min", e)


def max_(e: E.Expr, name: str = "max") -> P.AggSpec:
    return P.AggSpec(name, "max", e)


def count(name: str = "count") -> P.AggSpec:
    return P.AggSpec(name, "count", None)


def any_(e: E.Expr, name: str = "any") -> P.AggSpec:
    """Carry a functionally-dependent column through a group-by."""
    return P.AggSpec(name, "any", e)


# -- the accelerator entry point (paper section 4.1), now a shim ---------------


class FlareDataFrame:
    """``flare(df)``: route this DataFrame through whole-query compilation.

    .. deprecated:: thin shim over ``df.lower("compiled").compile()``;
       prefer the stages API, which separates compile from run and
       supports parameter bindings.
    """

    def __init__(self, df: DataFrame):
        self.df = df
        self.stats = ENG.CompileStats()

    def _compiled(self) -> S.Compiled:
        compiled = self.df.lower("compiled").compile()
        self.stats = compiled.stats
        return compiled

    def collect(self, params: Optional[Dict[str, Any]] = None
                ) -> Dict[str, np.ndarray]:
        return self._compiled().collect(**(params or {}))

    def result(self, params: Optional[Dict[str, Any]] = None):
        return self._compiled().result(**(params or {}))

    def count(self, params: Optional[Dict[str, Any]] = None) -> int:
        return self.result(params).num_rows()

    def show(self, n: int = 20) -> None:
        print(format_rows(self.collect(), n))

    def explain(self) -> str:
        return self.df.explain()

    def to_matrix(self, dtype=np.float32) -> np.ndarray:
        """Hand off to an ML kernel (paper Fig. 8 ``flare(q).toMatrix``)."""
        cols = self.collect()
        return np.stack([np.asarray(v, dtype) for v in cols.values()],
                        axis=1)


def flare(df: DataFrame) -> FlareDataFrame:
    """Deprecated: use ``df.lower(engine="compiled").compile()``."""
    warnings.warn(
        "flare(df) is deprecated; use df.lower(engine='compiled')"
        ".compile() (repro_torch.core.stages)", DeprecationWarning,
        stacklevel=2)
    return FlareDataFrame(df)


def format_rows(cols: Dict[str, np.ndarray], n: int = 20) -> str:
    """The first ``n`` rows of compacted columns as a text table."""
    names = list(cols)
    widths = {k: max(len(k), *(len(str(v)) for v in cols[k][:n]))
              if len(cols[k]) else len(k) for k in names}
    header = "|" + "|".join(k.rjust(widths[k]) for k in names) + "|"
    sep = "+" + "+".join("-" * widths[k] for k in names) + "+"
    lines = [sep, header, sep]
    m = len(next(iter(cols.values()))) if names else 0
    for i in range(min(n, m)):
        lines.append("|" + "|".join(
            str(cols[k][i]).rjust(widths[k]) for k in names) + "|")
    lines.append(sep)
    if m > n:
        lines.append(f"only showing top {n} of {m} rows")
    return "\n".join(lines)
