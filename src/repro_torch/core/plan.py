"""Logical plan IR -- the analogue of Catalyst plan trees.

A plan is a tree of operators over a catalog of columnar tables.  Plans are
built by the DataFrame API, rewritten by ``repro_torch.core.optimizer`` and
executed by the whole-query ``compiled`` engine (``repro_torch.core.stages``,
Flare Level 2), optionally with native kernel dispatch
(``repro_torch.native``).

``MapBatches`` and ``IterativeKernel`` are plan nodes the optimizer knows
how to rewrite; this package does not lower them yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import expr as E
from repro_torch.core import fnhash as FH
from repro_torch.relational import table as T

# ---------------------------------------------------------------------------
# aggregate spec
# ---------------------------------------------------------------------------

AGG_OPS = ("sum", "count", "min", "max", "avg", "any")
# "any": arbitrary member of the group -- used for columns functionally
# dependent on the group key (e.g. TPC-H Q3 groups by l_orderkey and
# carries o_orderdate along).  Classic FD-aware grouping.


@dataclasses.dataclass(frozen=True)
class AggSpec:
    name: str          # output column name
    op: str            # one of AGG_OPS
    arg: Optional[E.Expr]  # None for count(*)

    def __post_init__(self):
        if self.op not in AGG_OPS:
            raise ValueError(f"unknown aggregate {self.op}")
        if self.op != "count" and self.arg is None:
            raise ValueError(f"{self.op} needs an argument")


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------


class Plan:
    """Base plan node.  Subclasses define ``children`` and ``schema``."""

    _schema: Optional[T.Schema] = None

    def children(self) -> Tuple["Plan", ...]:
        return ()

    def with_children(self, kids: Sequence["Plan"]) -> "Plan":
        assert not kids
        return self

    def infer_schema(self, catalog: "Catalog") -> T.Schema:
        raise NotImplementedError

    def schema(self, catalog: "Catalog") -> T.Schema:
        if self._schema is None:
            self._schema = self.infer_schema(catalog)
        return self._schema

    # pretty printing ----------------------------------------------------------
    def explain(self, catalog: Optional["Catalog"] = None) -> str:
        lines: List[str] = []

        def rec(p: Plan, depth: int):
            lines.append("  " * depth + ("*" if depth == 0 else "+- ")
                         + p.describe())
            for c in p.children():
                rec(c, depth + 1)

        rec(self, 0)
        return "\n".join(lines)

    def describe(self) -> str:
        return type(self).__name__

    def fingerprint(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class Scan(Plan):
    table: str

    def infer_schema(self, catalog):
        return catalog.schema(self.table)

    def describe(self):
        return f"Scan {self.table}"

    def fingerprint(self):
        return f"scan:{self.table}"


@dataclasses.dataclass(eq=False)
class Filter(Plan):
    child: Plan
    pred: E.Expr

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return Filter(kids[0], self.pred)

    def infer_schema(self, catalog):
        return self.child.schema(catalog)

    def describe(self):
        return f"Filter {self.pred}"

    def fingerprint(self):
        return f"filter({self.child.fingerprint()},{E.fingerprint(self.pred)})"


@dataclasses.dataclass(eq=False)
class Project(Plan):
    child: Plan
    outputs: Tuple[Tuple[str, E.Expr], ...]  # (name, expr)

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return Project(kids[0], self.outputs)

    def infer_schema(self, catalog):
        cs = self.child.schema(catalog)
        fields = []
        for name, e in self.outputs:
            dtype = E.infer_dtype(e, cs)
            domain = cs[e.name].domain if isinstance(e, E.Col) else None
            fields.append(T.Field(name, dtype, domain))
        return T.Schema(fields)

    def describe(self):
        return "Project [" + ", ".join(
            f"{n}={e}" for n, e in self.outputs) + "]"

    def fingerprint(self):
        body = ",".join(f"{n}={E.fingerprint(e)}" for n, e in self.outputs)
        return f"project({self.child.fingerprint()},[{body}])"


@dataclasses.dataclass(eq=False)
class Join(Plan):
    """Equi-join.  ``right`` is the build side and must be N:1 w.r.t. the
    probe (``left``) side -- i.e. right keys are unique (PK--FK join).

    Lowered to a *sorted-array join*
    (sort build keys once, vectorised ``searchsorted`` probe + gather)
    instead of a pointer-chasing hash table.  ``how`` in {inner, left,
    semi, anti}.  ``strategy`` in {sorted, sortmerge} is picked by the
    optimizer (paper Fig. 6 compares strategies).
    """

    left: Plan
    right: Plan
    left_on: Tuple[str, ...]
    right_on: Tuple[str, ...]
    how: str = "inner"
    strategy: Optional[str] = None

    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return Join(kids[0], kids[1], self.left_on, self.right_on,
                    self.how, self.strategy)

    def infer_schema(self, catalog):
        ls = self.left.schema(catalog)
        if self.how in ("semi", "anti"):
            return ls
        rs = self.right.schema(catalog)
        fields = list(ls.fields)
        seen = set(ls.names)
        for f in rs.fields:
            if f.name in self.right_on:
                continue  # key columns deduplicated (equal to left keys)
            if f.name in seen:
                raise ValueError(f"ambiguous column {f.name} in join; "
                                 "rename before joining")
            fields.append(f)
        return T.Schema(fields)

    def describe(self):
        return (f"Join[{self.how}/{self.strategy or 'auto'}] "
                f"{list(self.left_on)} = {list(self.right_on)}")

    def fingerprint(self):
        return (f"join({self.left.fingerprint()},{self.right.fingerprint()},"
                f"{self.left_on},{self.right_on},{self.how},{self.strategy})")


@dataclasses.dataclass(eq=False)
class Aggregate(Plan):
    """Group-by aggregate.

    Keys must be dictionary-encoded strings or dense-domain ints so the
    compiled engine can aggregate by direct indexing (segment-sum onto the
    statically-bounded group domain).
    """

    child: Plan
    keys: Tuple[str, ...]
    aggs: Tuple[AggSpec, ...]

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return Aggregate(kids[0], self.keys, self.aggs)

    def infer_schema(self, catalog):
        cs = self.child.schema(catalog)
        fields = [cs[k] for k in self.keys]
        for a in self.aggs:
            if a.op == "count":
                fields.append(T.Field(a.name, T.INT64))
            elif a.op == "avg":
                fields.append(T.Field(a.name, T.FLOAT64))
            elif a.op == "any" and isinstance(a.arg, E.Col):
                fields.append(cs[a.arg.name].with_name(a.name))
            else:
                fields.append(T.Field(a.name, E.infer_dtype(a.arg, cs)))
        return T.Schema(fields)

    def describe(self):
        aggs = ", ".join(f"{a.name}={a.op}({a.arg})" for a in self.aggs)
        return f"Aggregate keys={list(self.keys)} [{aggs}]"

    def fingerprint(self):
        aggs = ",".join(
            f"{a.name}:{a.op}:{E.fingerprint(a.arg) if a.arg is not None else ''}"
            for a in self.aggs)
        return f"agg({self.child.fingerprint()},{self.keys},[{aggs}])"


@dataclasses.dataclass(eq=False)
class Sort(Plan):
    child: Plan
    by: Tuple[Tuple[str, bool], ...]  # (column, ascending)

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return Sort(kids[0], self.by)

    def infer_schema(self, catalog):
        return self.child.schema(catalog)

    def describe(self):
        return "Sort " + ", ".join(
            f"{c}{'' if a else ' desc'}" for c, a in self.by)

    def fingerprint(self):
        return f"sort({self.child.fingerprint()},{self.by})"


@dataclasses.dataclass(eq=False)
class Limit(Plan):
    child: Plan
    n: int

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return Limit(kids[0], self.n)

    def infer_schema(self, catalog):
        return self.child.schema(catalog)

    def describe(self):
        return f"Limit {self.n}"

    def fingerprint(self):
        return f"limit({self.child.fingerprint()},{self.n})"


@dataclasses.dataclass(eq=False)
class MapBatches(Plan):
    """A JAX-traceable batch UDF as a first-class plan node (Flare Level 3).

    ``fn`` maps a dict of column arrays (the declared ``columns``) to a
    dict of new column arrays matching ``out_fields``.  It must be
    length-preserving and act row-wise (vectorised per row): under the
    compiled engine every row of the padded batch reaches ``fn`` --
    including mask-invalid rows -- and the optimizer is allowed to move
    filters across this node, so per-row purity is part of the contract.

    All child columns pass through; ``out_fields`` are appended (a
    same-named output replaces the pass-through column).  The declared
    ``columns`` are the node's only data dependencies, which is what lets
    the optimizer push filters below the UDF and prune unused columns
    out of the child (DESIGN.md section 7).
    """

    child: Plan
    fn: Callable[[Dict[str, Any]], Dict[str, Any]]
    columns: Tuple[str, ...]
    out_fields: Tuple[T.Field, ...]
    name: str = "map_batches"

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return MapBatches(kids[0], self.fn, self.columns, self.out_fields,
                          self.name)

    @property
    def out_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.out_fields)

    def infer_schema(self, catalog):
        cs = self.child.schema(catalog)
        missing = [c for c in self.columns if c not in cs]
        if missing:
            raise ValueError(
                f"map_batches {self.name!r} declares input column(s) "
                f"{missing} absent from the child schema {cs.names}")
        produced = set(self.out_names)
        fields = [f for f in cs.fields if f.name not in produced]
        fields.extend(self.out_fields)
        return T.Schema(fields)

    def describe(self):
        outs = ", ".join(f"{f.name}:{f.dtype}" for f in self.out_fields)
        return (f"MapBatches {self.name}({list(self.columns)}) "
                f"-> [{outs}]")

    def fingerprint(self):
        outs = ",".join(f"{f.name}:{f.dtype}:{f.domain}"
                        for f in self.out_fields)
        return (f"mapbatches({self.child.fingerprint()},"
                f"{self.name}#{FH.fn_token(self.fn)},"
                f"{self.columns},[{outs}])")


@dataclasses.dataclass(eq=False)
class IterativeKernel(Plan):
    """A matrix-shaped training kernel as a terminal plan node.

    The relational child feeds ``features`` (and optionally ``label``)
    into a training kernel; the node's output is the
    kernel's result pytree, not a relational table, so this node only
    appears as a plan root (``df.train(...)``).  Hyper-parameter values
    may be :class:`repro_torch.core.expr.Param` placeholders, which lower to
    runtime jit arguments exactly like relational params -- one compiled
    pipeline serves every binding (DESIGN.md section 7).
    """

    child: Plan
    kernel: Any  # a training kernel with ``name`` and ``fn``
    features: Tuple[str, ...]
    label: Optional[str]
    hyper: Tuple[Tuple[str, Any], ...]  # sorted (name, literal-or-Param)

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return IterativeKernel(kids[0], self.kernel, self.features,
                               self.label, self.hyper)

    def infer_schema(self, catalog):
        raise TypeError(
            f"train({self.kernel.name}) produces a kernel result pytree, "
            "not a relational table; it has no schema")

    def required_columns(self) -> Tuple[str, ...]:
        return self.features + ((self.label,) if self.label else ())

    def describe(self):
        hyp = ", ".join(f"{k}={v}" for k, v in self.hyper)
        lab = f", label={self.label}" if self.label else ""
        return (f"Train {self.kernel.name}({list(self.features)}{lab}"
                f"{'; ' + hyp if hyp else ''})")

    def fingerprint(self):
        hyp = ",".join(
            f"{k}={E.fingerprint(v) if isinstance(v, E.Expr) else repr(v)}"
            for k, v in self.hyper)
        # name alone is not identity: two ad-hoc kernels can share
        # __name__ (lambdas!), so the function *content* disambiguates --
        # same convention as MapBatches / expr.Udf.  A content hash (not
        # id()) keeps the key stable across processes and immune to
        # address reuse after GC.
        kid = f"{self.kernel.name}#{FH.fn_token(self.kernel.fn)}"
        return (f"train({self.child.fingerprint()},{kid},"
                f"{self.features},{self.label},[{hyp}])")


# ---------------------------------------------------------------------------
# catalog
# ---------------------------------------------------------------------------


class Catalog:
    """Named table registry (SparkSession analogue)."""

    def __init__(self):
        self._tables: Dict[str, T.Table] = {}

    def register(self, name: str, tbl: T.Table) -> None:
        self._tables[name] = tbl

    def table(self, name: str) -> T.Table:
        return self._tables[name]

    def schema(self, name: str) -> T.Schema:
        return self._tables[name].schema

    def names(self) -> List[str]:
        return sorted(self._tables)

    def __contains__(self, name: str) -> bool:
        return name in self._tables


def node_exprs(p: Plan) -> Tuple[E.Expr, ...]:
    """The expressions carried directly by ``p`` (not its children)."""
    if isinstance(p, Filter):
        return (p.pred,)
    if isinstance(p, Project):
        return tuple(e for _, e in p.outputs)
    if isinstance(p, Aggregate):
        return tuple(a.arg for a in p.aggs if a.arg is not None)
    if isinstance(p, IterativeKernel):
        return tuple(v for _, v in p.hyper if isinstance(v, E.Expr))
    return ()


def params_of(p: Plan) -> Tuple[E.Param, ...]:
    """Distinct Param placeholders in the plan, sorted by name.

    The sorted order is the canonical binding/argument order used by the
    stages API (``repro_torch.core.stages``) and the engines, so that one
    compiled program's signature is the same in every process.
    """
    seen: Dict[str, E.Param] = {}

    def rec(n: Plan):
        for e in node_exprs(n):
            for prm in E.params_of(e):
                prior = seen.get(prm.name)
                if prior is not None and prior.dtype != prm.dtype:
                    raise TypeError(
                        f"param {prm.name!r} used with conflicting dtypes "
                        f"{prior.dtype!r} and {prm.dtype!r}")
                seen.setdefault(prm.name, prm)
        for c in n.children():
            rec(c)

    rec(p)
    return tuple(seen[k] for k in sorted(seen))


def transform(p: Plan, fn) -> Plan:
    """Bottom-up plan rewrite; ``fn`` returns replacement or None."""
    kids = tuple(transform(c, fn) for c in p.children())
    if any(k is not c for k, c in zip(kids, p.children())):
        p = p.with_children(kids)
    out = fn(p)
    return p if out is None else out
