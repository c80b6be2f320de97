"""Built-in kernel patterns: plan fragments the CUDA kernels can serve.

Four patterns register at import:

* ``filter-scalar-agg``    -- keyless Aggregate over a Filter/Project
  prologue rooted at a Scan (the paper's Fig. 3 Q6 loop, generalized):
  ``filter_agg_general``.
* ``grouped-agg``          -- keyed Aggregate over the same prologue:
  ``segmented_multi_sum`` over the dense group layout the generic
  lowering computes; the FD ``any_`` carry-along is a "max" slot.
* ``join-probe``           -- Aggregate whose boundary is an inner N:1
  join served by the cached build-side index: probe + gather + residual
  predicate + aggregate in one ``join_probe_agg`` pass.
* ``masked-filter-project`` -- the keyless/keyed shapes sitting
  mid-pipeline (the boundary stream carries a validity mask, e.g. below
  a semi, anti or left join): the mask streams into the same kernels.

Per fragment, :class:`ExprCompiler` turns the predicate, the aggregate
values and the group keys into one C function (``flare_row``) that the
kernel skeleton inlines -- Flare's per-query code generation, compiled
by nvcc -- and into the same computation over whole torch columns for
the kernels' plain versions.  Dictionary contents resolve at dispatch
time to integer code tests and code ranges, emitted as constants;
query parameters are read from the ``scal`` vector, so every binding of
a template shares one kernel unit.  Anything the body cannot express
(staged UDFs, truncating float->int casts, ...) makes the fragment
ineligible: it keeps its generic lowering and the report says why.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import expr as E
from repro_torch.core import lower as L
from repro_torch.core import plan as P
from repro_torch.kernels import (MAX_COLS, MAX_OUT, Body, KernelBudgetError,
                                 f32_literal)
from repro_torch.kernels.filter_agg import kernel as FA
from repro_torch.kernels.join_probe import kernel as JP
from repro_torch.kernels.segmented_reduce import kernel as SR
from repro_torch.native import registry as R
from repro_torch.relational import table as T

#: Largest f32-exactly-representable integer: int columns stream into a
#: kernel as f32, so their domain must stay below this.
F32_EXACT = 1 << 24

#: A string predicate whose dictionary LUT fragments into more code
#: ranges than this is cheaper as the generic LUT gather -- fall back.
MAX_STRPRED_RANGES = 16


class UnsupportedExpr(TypeError):
    """Expression form the kernel body cannot express; the fragment keeps
    its generic lowering (recorded in the dispatch report)."""


class _NoMatch(Exception):
    """Structural mismatch while walking a fragment (not an error)."""


# ---------------------------------------------------------------------------
# expression tree -> C source + torch closure
# ---------------------------------------------------------------------------

_FLIP = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "==": "==", "!=": "!="}
_TORCH_CMP = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
              "==": torch.eq, "!=": torch.ne}
_LOADER = {torch.float32: "flare_ld_f32", torch.int32: "flare_ld_i32",
           torch.bool: "flare_ld_u8"}


@dataclasses.dataclass(frozen=True)
class Code:
    """One compiled subexpression: C text, its kind ("f" float or "b"
    bool) and the torch function computing it from ``(cols, scal)``
    dicts of f32 columns and 0-d f32 parameters."""

    c: str
    kind: str
    fn: Callable[[Dict[str, Any], Dict[str, Any]], Any]


def _tensor_op(op, a, b):
    """Comparison ``a op b`` where either side may be a Python scalar
    (torch's comparison functions need a tensor first)."""
    if not isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return _TORCH_CMP[_FLIP[op]](b, a)
    if not isinstance(a, torch.Tensor):
        return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
                "==": a == b, "!=": a != b}[op]
    return _TORCH_CMP[op](a, b)


def as_bool(x: Code) -> Code:
    """Bool columns stream as 0/1 floats and test with ``> 0.5``."""
    if x.kind == "b":
        return x
    f = x.fn
    return Code(f"({x.c} > 0.5f)", "b",
                lambda cols, scal: _tensor_op(">", f(cols, scal), 0.5))


def as_float(x: Code) -> Code:
    if x.kind == "f":
        return x
    f = x.fn

    def run(cols, scal):
        v = f(cols, scal)
        return v.to(torch.float32) if isinstance(v, torch.Tensor) \
            else float(v)

    return Code(f"({x.c} ? 1.0f : 0.0f)", "f", run)


def _const_bool(value: bool) -> Code:
    return Code("true" if value else "false", "b",
                lambda cols, scal: value)


class ExprCompiler:
    """Compile expression trees (in boundary-column terms) into
    :class:`Code`.  Dictionary contents come from the boundary's phase-A
    static info, so string comparisons become integer code tests at
    dispatch time.  Referenced columns and params are collected on
    ``self.cols`` / ``self.params``; their C locals are ``x<k>`` and
    ``p<k>``, bound to column and parameter slots by :meth:`loads`."""

    def __init__(self, binfo: L.StaticInfo):
        self.binfo = binfo
        self.schema = T.Schema([T.Field(n, sc.dtype, sc.domain)
                                for n, sc in binfo.cols.items()])
        self.cols: Dict[str, str] = {}    # column name -> C local
        self.params: Dict[str, str] = {}  # param name -> C local

    def _dict_of(self, e: E.Expr):
        if isinstance(e, E.Col):
            return self.binfo.cols[e.name].dictionary
        return None

    def dtype(self, name: str) -> torch.dtype:
        return L.TORCH_OF[self.binfo.cols[name].dtype]

    def compile(self, e: E.Expr) -> Code:
        if isinstance(e, E.Col):
            name = e.name
            local = self.cols.setdefault(name, f"x{len(self.cols)}")
            return Code(local, "f", lambda cols, scal: cols[name])
        if isinstance(e, E.Lit):
            if isinstance(e.value, str):
                raise UnsupportedExpr("string literal outside comparison")
            v = float(np.float32(float(e.value)))
            return Code(f"({f32_literal(v)})", "f", lambda cols, scal: v)
        if isinstance(e, E.Param):
            name = e.name
            local = self.params.setdefault(name, f"p{len(self.params)}")
            return Code(local, "f", lambda cols, scal: scal[name])
        if isinstance(e, E.BinOp):
            if e.op not in "+-*/" or len(e.op) != 1:
                raise UnsupportedExpr(f"binop {e.op!r}")
            l = as_float(self.compile(e.left))
            r = as_float(self.compile(e.right))
            lf, rf, op = l.fn, r.fn, e.op
            pyop = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
                    "*": lambda a, b: a * b, "/": lambda a, b: a / b}[op]
            # everything is f32: "/" is true division, as in the generic
            # lowering's float-promoting division
            return Code(f"({l.c} {op} {r.c})", "f",
                        lambda cols, scal: pyop(lf(cols, scal),
                                                rf(cols, scal)))
        if isinstance(e, E.Cmp):
            return self._compile_cmp(e)
        if isinstance(e, E.BoolOp):
            parts = [as_bool(self.compile(a)) for a in e.args]
            is_and = e.op == "and"
            fns = [p.fn for p in parts]

            def run_bool(cols, scal):
                out = fns[0](cols, scal)
                for fn in fns[1:]:
                    v = fn(cols, scal)
                    out = (out & v) if is_and else (out | v)
                return out

            sep = " && " if is_and else " || "
            return Code("(" + sep.join(p.c for p in parts) + ")", "b",
                        run_bool)
        if isinstance(e, E.Not):
            x = as_bool(self.compile(e.arg))
            f = x.fn

            def run_not(cols, scal):
                v = f(cols, scal)
                return ~v if isinstance(v, torch.Tensor) else (not v)

            return Code(f"(!{x.c})", "b", run_not)
        if isinstance(e, E.InSet):
            return self._compile_inset(e)
        if isinstance(e, E.StrPred):
            return self._compile_strpred(e)
        if isinstance(e, E.IfThenElse):
            c = as_bool(self.compile(e.cond))
            t, o = self.compile(e.then), self.compile(e.other)
            if not (t.kind == o.kind == "b"):
                t, o = as_float(t), as_float(o)
            cf, tf, of = c.fn, t.fn, o.fn

            def run_if(cols, scal):
                cond = cf(cols, scal)
                a, b = tf(cols, scal), of(cols, scal)
                if not isinstance(cond, torch.Tensor):
                    return a if cond else b
                return torch.where(cond, a, b)

            return Code(f"({c.c} ? {t.c} : {o.c})", t.kind, run_if)
        if isinstance(e, E.Cast):
            src = E.infer_dtype(e.arg, self.schema)
            if e.dtype in (T.INT32, T.INT64, T.DATE) and \
                    src in (T.FLOAT32, T.FLOAT64):
                raise UnsupportedExpr("truncating float->int cast")
            x = self.compile(e.arg)
            if e.dtype == T.BOOL and src != T.BOOL:
                # astype(bool) is `!= 0`, NOT the 0/1-column `> 0.5` test
                xf = as_float(x)
                f = xf.fn
                return Code(f"({xf.c} != 0.0f)", "b",
                            lambda cols, scal: _tensor_op("!=",
                                                          f(cols, scal), 0.0))
            return x  # numeric casts are identities: all values are f32
        if isinstance(e, E.WithDomain):
            return self.compile(e.arg)
        raise UnsupportedExpr(type(e).__name__)

    def _compile_cmp(self, e: E.Cmp) -> Code:
        ldict, rdict = self._dict_of(e.left), self._dict_of(e.right)
        if ldict is not None and isinstance(e.right, E.Lit) \
                and isinstance(e.right.value, str):
            return self._code_cmp(e.op, self.compile(e.left), ldict,
                                  e.right.value)
        if rdict is not None and isinstance(e.left, E.Lit) \
                and isinstance(e.left.value, str):
            return self._code_cmp(_FLIP[e.op], self.compile(e.right), rdict,
                                  e.left.value)
        if ldict is not None and rdict is not None and ldict != rdict:
            raise UnsupportedExpr("cross-dictionary string comparison")
        return self._cmp(e.op, as_float(self.compile(e.left)),
                         as_float(self.compile(e.right)))

    @staticmethod
    def _cmp(op: str, l: Code, r: Code) -> Code:
        lf, rf = l.fn, r.fn
        return Code(f"({l.c} {op} {r.c})", "b",
                    lambda cols, scal: _tensor_op(op, lf(cols, scal),
                                                  rf(cols, scal)))

    def _code_cmp(self, op: str, codes: Code, dictionary, value: str) -> Code:
        """String-literal comparison as an integer code test (codes are
        in sorted-dictionary == lexical order); an absent literal is
        all-false for ==, all-true for != and compares by its insertion
        point otherwise."""
        code = L.str_code(dictionary, value)
        if code < 0:
            if op in ("==", "!="):
                return _const_bool(op == "!=")
            ins = float(np.searchsorted(np.asarray(dictionary, dtype=object),
                                        value))
            lit = Code(f"({f32_literal(ins)})", "f", lambda cols, scal: ins)
            return self._cmp("<" if op in ("<", "<=") else ">=", codes, lit)
        c = float(code)
        lit = Code(f"({f32_literal(c)})", "f", lambda cols, scal: c)
        return self._cmp(op, codes, lit)

    def _eq_any(self, arg: Code, values: List[float]) -> Code:
        if not values:
            return _const_bool(False)
        f = arg.fn
        c = " || ".join(f"({arg.c} == {f32_literal(v)})" for v in values)

        def run(cols, scal):
            a = f(cols, scal)
            out = a == values[0]
            for v in values[1:]:
                out = out | (a == v)
            return out

        return Code(f"({c})", "b", run)

    def _compile_inset(self, e: E.InSet) -> Code:
        d = self._dict_of(e.arg)
        arg = as_float(self.compile(e.arg))
        if d is not None:
            vals = [float(c) for c in (L.str_code(d, v) for v in e.values)
                    if c >= 0]
        else:
            if any(isinstance(v, str) for v in e.values):
                raise UnsupportedExpr("isin(strings) on non-dict column")
            vals = [float(np.float32(float(v))) for v in e.values]
        return self._eq_any(arg, vals)

    def _compile_strpred(self, e: E.StrPred) -> Code:
        d = self._dict_of(e.arg)
        if d is None:
            raise UnsupportedExpr(f"{e.kind} on non-string column")
        ranges = _lut_ranges([E.match_str(e.kind, s, e.params) for s in d])
        if len(ranges) > MAX_STRPRED_RANGES:
            raise UnsupportedExpr(
                f"{e.kind} LUT fragments into {len(ranges)} code ranges")
        arg = as_float(self.compile(e.arg))
        if not ranges:
            return _const_bool(False)
        f = arg.fn
        terms = []
        for lo, hi in ranges:
            if hi == lo + 1:
                terms.append(f"({arg.c} == {f32_literal(lo)})")
            else:
                terms.append(f"({arg.c} >= {f32_literal(lo)} && "
                             f"{arg.c} < {f32_literal(hi)})")

        def run(cols, scal):
            a = f(cols, scal)
            out = None
            for lo, hi in ranges:
                t = (a == float(lo)) if hi == lo + 1 else \
                    ((a >= float(lo)) & (a < float(hi)))
                out = t if out is None else (out | t)
            return out

        return Code("(" + " || ".join(terms) + ")", "b", run)

    def loads(self, names: List[str], base: str, index: str,
              layout: List[str]) -> List[str]:
        """C lines binding the locals of ``names`` to slots of ``layout``
        in column struct ``base`` at row ``index``."""
        out = []
        for name in names:
            k = layout.index(name)
            out.append(f"  const float {self.cols[name]} = "
                       f"{_LOADER[self.dtype(name)]}({base}.p[{k}], "
                       f"{index});  // {_ident(name)}")
        return out

    def param_loads(self, layout: List[str]) -> List[str]:
        return [f"  const float {self.params[n]} = s[{layout.index(n)}];"
                f"  // :{_ident(n)}" for n in sorted(self.params)]


def _ident(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


def _lut_ranges(lut: List[bool]) -> List[Tuple[int, int]]:
    """Maximal [lo, hi) runs of True in a boolean dictionary LUT.  The
    dictionary is sorted, so prefix predicates compress to ONE range."""
    ranges: List[Tuple[int, int]] = []
    i, n = 0, len(lut)
    while i < n:
        if lut[i]:
            j = i
            while j < n and lut[j]:
                j += 1
            ranges.append((i, j))
            i = j
        else:
            i += 1
    return ranges


# ---------------------------------------------------------------------------
# fragment matching
# ---------------------------------------------------------------------------

_PROLOGUE = (P.Filter, P.Project)


def boundary_of(root: P.Plan) -> P.Plan:
    """First non-Filter/Project descendant below an Aggregate root: the
    node whose stream the kernel consumes."""
    node = root.child if isinstance(root, P.Aggregate) else root
    while isinstance(node, _PROLOGUE):
        node = node.child
    return node


def match_fragment(node: P.Plan, catalog: P.Catalog) -> Optional[R.Fragment]:
    """Walk the Filter/Project prologue under an Aggregate and rebase
    every expression (filter conjuncts, aggregate args, group keys) onto
    boundary-column terms.  Returns None on structural mismatch."""
    if not isinstance(node, P.Aggregate):
        return None
    chain: List[P.Plan] = []
    cur = node.child
    while isinstance(cur, _PROLOGUE):
        chain.append(cur)
        cur = cur.child
    boundary = cur
    try:
        binfo = L.static_info(boundary, catalog)
    except TypeError:
        return None
    mapping: Dict[str, E.Expr] = {n: E.col(n) for n in binfo.cols}

    def sub(e: E.Expr) -> E.Expr:
        def repl(x: E.Expr) -> Optional[E.Expr]:
            if isinstance(x, E.Col):
                if x.name not in mapping:
                    raise _NoMatch()
                return mapping[x.name]
            return None

        return E.map_expr(e, repl)

    preds: List[E.Expr] = []
    try:
        for nd in reversed(chain):
            if isinstance(nd, P.Filter):
                preds.append(sub(nd.pred))
            else:
                mapping = {name: sub(expr) for name, expr in nd.outputs}
        agg_args = tuple(sub(a.arg) if a.arg is not None else None
                         for a in node.aggs)
        for k in node.keys:
            if k not in mapping:
                raise _NoMatch()
        key_exprs = tuple(mapping[k] for k in node.keys)
    except _NoMatch:
        return None
    return R.Fragment(root=node, boundary=boundary, preds=tuple(preds),
                      agg_args=agg_args, key_exprs=key_exprs,
                      masked=not isinstance(boundary, P.Scan), binfo=binfo)


#: Distinguishes "caller did not pre-compute the walk" from "the walk ran
#: and found no fragment".
_UNSET = object()


def _match_scalar(node, catalog, frag=_UNSET):
    if frag is _UNSET:
        frag = match_fragment(node, catalog)
    if frag is None or frag.root.keys or frag.masked:
        return None
    return frag


def _match_grouped(node, catalog, frag=_UNSET):
    if frag is _UNSET:
        frag = match_fragment(node, catalog)
    if frag is None or not frag.root.keys or frag.masked:
        return None
    return frag


def _match_masked(node, catalog, frag=_UNSET):
    if frag is _UNSET:
        frag = match_fragment(node, catalog)
    if frag is None or not frag.masked:
        return None
    return frag


# ---------------------------------------------------------------------------
# eligibility and body generation
# ---------------------------------------------------------------------------

_SUPPORTED_AGGS = ("sum", "count", "avg")
#: ``any`` (the FD carry-along: all group members share the value) is
#: grouped-only, accumulated as a per-group max.
_SUPPORTED_GROUPED_AGGS = _SUPPORTED_AGGS + ("any",)

#: ``any`` max-slot neutral element, by value class.  INT32_MIN is
#: f32-exact AND converts back to int32 exactly; the float fill mirrors
#: the generic lowering's finfo.min.
_INT_ANY_FILL = float(np.iinfo(np.int32).min)
_FLOAT_ANY_FILL = float(np.finfo(np.float32).min)


def _any_fill(dtype: str) -> float:
    return (_FLOAT_ANY_FILL if dtype in (T.FLOAT32, T.FLOAT64)
            else _INT_ANY_FILL)


def _col_f32_safe(sc: L.StaticCol) -> bool:
    """Can this column stream into the kernel as exact f32?  Floats and
    bools trivially; dates are bounded days-since-1970 (< 2^24 by
    construction); other ints need a dictionary or declared domain."""
    if sc.dtype in (T.FLOAT32, T.FLOAT64, T.BOOL, T.DATE):
        return True
    bound = sc.group_domain
    return bound is not None and bound <= F32_EXACT


def _acc_plan(aggs: Tuple[P.AggSpec, ...], force_count: bool
              ) -> Tuple[List[Tuple[str, Optional[int]]], Optional[int],
                         Tuple[str, ...]]:
    """Accumulator layout: one slot per sum/avg/any argument plus ONE
    shared count slot (grouped fragments always count: the group mask
    needs it).  Returns (per-agg plan, count slot, per-slot op)."""
    plan: List[Tuple[str, Optional[int]]] = []
    ops: List[str] = []
    for a in aggs:
        if a.op in ("sum", "avg"):
            plan.append((a.op, len(ops)))
            ops.append("sum")
        elif a.op == "any":
            plan.append(("any", len(ops)))
            ops.append("max")
        else:
            plan.append(("count", None))
    need_count = force_count or any(a.op in ("count", "avg") for a in aggs)
    cnt_slot = len(ops) if need_count else None
    if need_count:
        ops.append("sum")
    return plan, cnt_slot, tuple(ops)


def _slot_fills(aggs: Tuple[P.AggSpec, ...], schema: T.Schema,
                cnt_slot: Optional[int]) -> Tuple[float, ...]:
    fills: List[float] = []
    for a in aggs:
        if a.op in ("sum", "avg"):
            fills.append(0.0)
        elif a.op == "any":
            fills.append(_any_fill(E.infer_dtype(a.arg, schema)))
    if cnt_slot is not None:
        fills.append(0.0)
    return tuple(fills)


def _value_lines(pred_c: str, val_codes: List[Code],
                 fills: Tuple[float, ...], has_count: bool) -> List[str]:
    """C lines: ``pred``, then each slot selected by it (select, never
    multiply: an excluded row's value may be inf or nan)."""
    lines = [f"  const bool pred = {pred_c};"]
    for j, v in enumerate(val_codes):
        lines.append(f"  v[{j}] = pred ? {as_float(v).c} : "
                     f"{f32_literal(fills[j])};")
    if has_count:
        lines.append(f"  v[{len(val_codes)}] = pred ? 1.0f : 0.0f;")
    return lines


def _select_values(pred, val_fns, fills, has_count, cols, scal, n, dev):
    """torch side of :func:`_value_lines`."""
    vals = []
    for j, fn in enumerate(val_fns):
        v = fn(cols, scal)
        v = v.to(torch.float32) if isinstance(v, torch.Tensor) else float(v)
        vals.append(torch.where(pred, v, fills[j]).to(torch.float32)
                    .expand(n))
    if has_count:
        vals.append(pred.to(torch.float32))
    return vals


def _bool_rows(x, n: int, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.expand(n) if x.dim() == 0 else x
    return torch.full((n,), bool(x), dtype=torch.bool, device=dev)


@dataclasses.dataclass
class _Analysis:
    """What the emitter needs, computed ONCE per fragment (memoized on
    ``Fragment.analysis``), or the reason the fragment is ineligible."""

    reason: Optional[str] = None  # None = eligible
    plan_: Any = None
    cnt_slot: Optional[int] = None
    body: Optional[Body] = None
    col_names: Any = None
    param_names: Any = None
    strides: Any = None
    domain: Optional[int] = None
    key_doms: Any = None


def _analyze(frag: R.Fragment, catalog: P.Catalog) -> _Analysis:
    if frag.analysis is None:
        frag.analysis = _analyze_uncached(frag, catalog)
    return frag.analysis


def _common_checks(frag: R.Fragment, grouped: bool,
                   stream: str) -> Optional[str]:
    supported = _SUPPORTED_GROUPED_AGGS if grouped else _SUPPORTED_AGGS
    bad = sorted({a.op for a in frag.root.aggs if a.op not in supported})
    if bad:
        return f"unsupported aggregate op(s) {bad}"
    if frag.binfo.n_rows <= 0:
        return f"empty {stream} stream"
    return None


def _unsafe_column(comp: ExprCompiler, binfo: L.StaticInfo) -> Optional[str]:
    for name in sorted(comp.cols):
        if not _col_f32_safe(binfo.cols[name]):
            return (f"column {name!r} has no f32-exact encoding "
                    "(int without dictionary/domain <= 2^24)")
    return None


def _analyze_uncached(frag: R.Fragment, catalog: P.Catalog) -> _Analysis:
    grouped = bool(frag.root.keys)
    why = _common_checks(frag, grouped, "input")
    if why:
        return _Analysis(reason=why)
    plan_, cnt_slot, ops = _acc_plan(frag.root.aggs, force_count=grouped)
    if not grouped and len(ops) > MAX_OUT:
        return _Analysis(reason=f"{len(ops)} accumulators > {MAX_OUT}")
    comp = ExprCompiler(frag.binfo)
    try:
        preds = [as_bool(comp.compile(pr)) for pr in frag.preds]
        vals = [comp.compile(a.arg) for a in frag.root.aggs
                if a.op in ("sum", "avg", "any")]
    except UnsupportedExpr as ex:
        return _Analysis(reason=f"unsupported expression: {ex}")
    why = _unsafe_column(comp, frag.binfo)
    if why:
        return _Analysis(reason=why)
    col_names = sorted(comp.cols)
    if len(col_names) > MAX_COLS:
        return _Analysis(reason=f"{len(col_names)} columns > {MAX_COLS}")
    out = _Analysis(plan_=plan_, cnt_slot=cnt_slot, col_names=col_names,
                    param_names=sorted(comp.params))
    if grouped:
        try:
            child_info = L.static_info(frag.root.child, catalog)
            out.strides, out.domain = L.group_layout(frag.root, child_info)
        except (TypeError, ValueError) as ex:
            return _Analysis(reason=f"no dense group layout: {ex}")
        if out.domain > SR.MAX_GROUPS:
            return _Analysis(reason=(f"group domain {out.domain} > "
                                     f"MAX_GROUPS {SR.MAX_GROUPS}"))
        if not SR.fits_shared(len(ops), out.domain):
            return _Analysis(reason=(
                f"[{len(ops)}, {out.domain}] accumulator exceeds the "
                "shared-memory budget"))
        out.key_doms = [child_info.cols[k].group_domain
                        for k in frag.root.keys]
    fills = _slot_fills(frag.root.aggs, comp.schema, cnt_slot)
    out.body = _scan_body(comp, preds, vals, ops, fills, col_names,
                          out.param_names, cnt_slot is not None)
    return out


def _scan_body(comp: ExprCompiler, preds: List[Code], vals: List[Code],
               ops, fills, col_names, param_names, has_count) -> Body:
    """The ``flare_row`` of filter_agg_general / segmented_multi_sum."""
    pred_c = " && ".join(["ok"] + [p.c for p in preds])
    src = "\n".join(
        ["__device__ __forceinline__ bool flare_row(",
         "    const FlareCols& c, long long i, bool ok,",
         "    const float* __restrict__ s, float (&v)[FLARE_N_OUT]) {"]
        + comp.loads(col_names, "c", "i", col_names)
        + comp.param_loads(param_names)
        + _value_lines(pred_c, vals, fills, has_count)
        + ["  return pred;", "}"])
    pred_fns = [p.fn for p in preds]
    val_fns = [v.fn for v in vals]

    def rows(cols, ok, scal):
        n = ok.shape[0]
        env = dict(zip(col_names, cols))
        penv = {name: scal[k] for k, name in enumerate(param_names)}
        pred = ok
        for fn in pred_fns:
            pred = pred & _bool_rows(fn(env, penv), n, ok.device)
        return pred, _select_values(pred, val_fns, fills, has_count, env,
                                    penv, n, ok.device)

    return Body(src=src, rows=rows, ops=ops, fills=fills,
                col_dtypes=tuple(comp.dtype(c) for c in col_names))


def _eligibility(frag: R.Fragment, catalog: P.Catalog) -> Tuple[bool, str]:
    a = _analyze(frag, catalog)
    return (a.reason is None), (a.reason or "ok")


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------


def _scal(param_names, params, dev) -> torch.Tensor:
    """The f32 vector of query parameters in the body's order."""
    if not param_names:
        return torch.zeros(1, dtype=torch.float32, device=dev)
    vals = []
    for name in param_names:
        if params is None or name not in params:
            raise KeyError(
                f"unbound query parameter {name!r}; pass a binding, "
                f"e.g. lowered.compile()({name}=...)")
        vals.append(torch.as_tensor(params[name], device=dev)
                    .to(torch.float32).reshape(()))
    return torch.stack(vals)


def _columns(stream: L.Stream, names, dtypes) -> List[torch.Tensor]:
    return [stream.cols[c].to(dt).contiguous()
            for c, dt in zip(names, dtypes)]


def _mask(stream: L.Stream) -> Optional[torch.Tensor]:
    return None if stream.mask is None else stream.mask.contiguous()


def _grouped_outputs(frag: R.Fragment, plan_, cnt_slot, out, strides,
                     key_doms, out_info: L.StaticInfo, domain: int,
                     dev) -> L.Stream:
    """Map the [n_out, G] accumulator rows onto output columns: sums
    verbatim, avg from sum/count, count from the count slot, any_ cast
    back to its output dtype (the kernels run f32)."""
    cnt = out[cnt_slot]
    cols: Dict[str, torch.Tensor] = {}
    gidx = torch.arange(domain, dtype=torch.int32, device=dev)
    for k, s, dk in zip(frag.root.keys, strides, key_doms):
        cols[k] = torch.div(gidx, s, rounding_mode="floor") % dk
    for a, (kind, slot) in zip(frag.root.aggs, plan_):
        if kind == "sum":
            cols[a.name] = out[slot]
        elif kind == "avg":
            cols[a.name] = out[slot] / torch.clamp(cnt, min=1.0)
        elif kind == "any":
            cols[a.name] = out[slot].to(L.TORCH_OF[out_info.cols[a.name]
                                                   .dtype])
        else:
            cols[a.name] = cnt.to(torch.int32)
    return L.Stream(cols, cnt > 0, out_info, dev)


def _keyless_outputs(frag: R.Fragment, plan_, cnt_slot, sums,
                     out_info: L.StaticInfo, dev) -> L.Stream:
    cnt = sums[cnt_slot] if cnt_slot is not None else None
    cols: Dict[str, torch.Tensor] = {}
    for a, (kind, slot) in zip(frag.root.aggs, plan_):
        if kind == "sum":
            cols[a.name] = sums[slot][None]
        elif kind == "avg":
            cols[a.name] = (sums[slot] / torch.clamp(cnt, min=1.0))[None]
        else:
            cols[a.name] = cnt.to(torch.int32)[None]
    return L.Stream(cols, None, out_info, dev)


class _AggEmitter:
    """filter_agg_general (keyless) or segmented_multi_sum (grouped) over
    the fragment's boundary stream."""

    def __init__(self, frag: R.Fragment, catalog: P.Catalog):
        self.frag = frag
        self.ana = _analyze(frag, catalog)
        if self.ana.reason is not None:
            raise KernelBudgetError(self.ana.reason)
        self.grouped = bool(frag.root.keys)
        self.out_info = L.static_info(frag.root, catalog)

    def sources(self) -> List[str]:
        mod = SR if self.grouped else FA
        return [mod.unit_source(self.ana.body)]

    def __call__(self, bstream: L.Stream,
                 params: Optional[Dict[str, Any]]) -> L.Stream:
        ana, frag, dev = self.ana, self.frag, bstream.device
        n = bstream.n
        scal = _scal(ana.param_names, params, dev)
        cols = _columns(bstream, ana.col_names, ana.body.col_dtypes)
        valid = _mask(bstream)
        if not self.grouped:
            sums = FA.filter_agg_general(ana.body, cols, valid, n, scal)
            return _keyless_outputs(frag, ana.plan_, ana.cnt_slot, sums,
                                    self.out_info, dev)
        code = torch.zeros((n,), dtype=torch.int32, device=dev)
        for ke, s in zip(frag.key_exprs, ana.strides):
            kv = L.as_column(L.eval_expr(ke, bstream, params), bstream)
            code = code + kv.to(torch.int32) * s
        out = SR.segmented_multi_sum(ana.body, cols, valid,
                                     code.contiguous(), n, ana.domain, scal)
        return _grouped_outputs(frag, ana.plan_, ana.cnt_slot, out,
                                ana.strides, ana.key_doms, self.out_info,
                                ana.domain, dev)


# ---------------------------------------------------------------------------
# the join-probe pattern: fused probe + gather + filter + aggregate
# ---------------------------------------------------------------------------


def _match_join_probe(node, catalog, frag=_UNSET):
    """Aggregate whose boundary is an inner N:1 join served by the
    cached build-side index."""
    if frag is _UNSET:
        frag = match_fragment(node, catalog)
    if frag is None or not isinstance(frag.boundary, P.Join):
        return None
    if frag.boundary.how != "inner":
        return None
    spec, _ = L.resolve_build_index(frag.boundary, catalog)
    if spec is None:
        return None
    return frag


@dataclasses.dataclass
class _ProbeAnalysis:
    reason: Optional[str] = None  # None = eligible
    spec: Any = None              # L.JoinIndexSpec of the boundary join
    plan_: Any = None
    cnt_slot: Optional[int] = None
    body: Optional[Body] = None
    probe_cols: Any = None        # streamed probe-side columns
    build_cols: Any = None        # build payload columns read at perm[pos]
    param_names: Any = None
    strides: Any = None
    domain: Optional[int] = None
    key_doms: Any = None


def _analyze_probe(frag: R.Fragment, catalog: P.Catalog) -> _ProbeAnalysis:
    if frag.probe_analysis is None:
        frag.probe_analysis = _analyze_probe_uncached(frag, catalog)
    return frag.probe_analysis


def _analyze_probe_uncached(frag: R.Fragment,
                            catalog: P.Catalog) -> _ProbeAnalysis:
    join = frag.boundary
    spec, reason = L.resolve_build_index(join, catalog)
    if spec is None:
        return _ProbeAnalysis(reason=reason)
    grouped = bool(frag.root.keys)
    why = _common_checks(frag, grouped, "probe")
    if why:
        return _ProbeAnalysis(reason=why)
    # the combined join key streams through the kernel as f32: its
    # domain must stay exactly representable
    combined = 1
    for d in spec.doms:
        combined *= d
    if combined > F32_EXACT:
        return _ProbeAnalysis(reason=(
            f"combined join-key domain {combined} has no f32-exact "
            "encoding (> 2^24)"))
    plan_, cnt_slot, ops = _acc_plan(frag.root.aggs, force_count=grouped)
    if not grouped and len(ops) > MAX_OUT:
        return _ProbeAnalysis(reason=f"{len(ops)} accumulators > {MAX_OUT}")
    comp = ExprCompiler(frag.binfo)
    try:
        preds = [as_bool(comp.compile(pr)) for pr in frag.preds]
        vals = [comp.compile(a.arg) for a in frag.root.aggs
                if a.op in ("sum", "avg", "any")]
        keys = [as_float(comp.compile(ke)) for ke in frag.key_exprs]
        lkeys = [as_float(comp.compile(E.col(k))) for k in join.left_on]
    except UnsupportedExpr as ex:
        return _ProbeAnalysis(reason=f"unsupported expression: {ex}")
    why = _unsafe_column(comp, frag.binfo)
    if why:
        return _ProbeAnalysis(reason=why)
    lnames = set(join.left.schema(catalog).names)
    probe_cols = sorted(set(comp.cols) & lnames)
    build_cols = sorted(set(comp.cols) - lnames)
    if max(len(probe_cols), len(build_cols)) > MAX_COLS:
        return _ProbeAnalysis(reason=f"more than {MAX_COLS} columns a side")
    out = _ProbeAnalysis(spec=spec, plan_=plan_, cnt_slot=cnt_slot,
                         probe_cols=probe_cols, build_cols=build_cols,
                         param_names=sorted(comp.params))
    num_groups = None
    if grouped:
        try:
            child_info = L.static_info(frag.root.child, catalog)
            out.strides, out.domain = L.group_layout(frag.root, child_info)
        except (TypeError, ValueError) as ex:
            return _ProbeAnalysis(reason=f"no dense group layout: {ex}")
        out.key_doms = [child_info.cols[k].group_domain
                        for k in frag.root.keys]
        num_groups = out.domain
    try:
        JP.accum_mode(len(ops), num_groups)
    except KernelBudgetError as ex:
        return _ProbeAnalysis(reason=str(ex))
    fills = _slot_fills(frag.root.aggs, comp.schema, cnt_slot)
    out.body = _probe_body(comp, preds, vals, keys, lkeys,
                           sorted(set(join.left_on)), list(spec.doms), ops,
                           fills, probe_cols, build_cols, out.param_names,
                           cnt_slot is not None, out.strides)
    return out


def _probe_body(comp: ExprCompiler, preds, vals, keys, lkeys, key_names,
                doms, ops, fills, probe_cols, build_cols, param_names,
                has_count, strides) -> Body:
    """``flare_probe_key`` + ``flare_row`` of join_probe_agg."""
    # combined probe key, as the reference builds it in f32 (exact: the
    # key domain was checked against 2^24)
    kc, kfn = lkeys[0].c, [lkeys[0].fn]
    for lk, d in zip(lkeys[1:], doms[1:]):
        kc = f"(({kc} * {f32_literal(d)}) + {lk.c})"
    src = ["__device__ __forceinline__ float flare_probe_key(",
           "    const FlareCols& pc, long long i) {"]
    src += comp.loads(key_names, "pc", "i", probe_cols)
    src += [f"  return {kc};", "}", "",
            "__device__ __forceinline__ bool flare_row(",
            "    const FlareCols& pc, const FlareCols& bc, long long i,",
            "    long long row, bool matched, const float* __restrict__ s,",
            "    float (&v)[FLARE_N_OUT], int* code) {"]
    src += comp.loads(probe_cols, "pc", "i", probe_cols)
    src += comp.loads(build_cols, "bc", "row", build_cols)
    src += comp.param_loads(param_names)
    src += _value_lines(" && ".join(["matched"] + [p.c for p in preds]),
                        vals, fills, has_count)
    if keys:
        code_c = "0.0f"
        for k, s in zip(keys, strides):
            code_c = f"({code_c} + ({k.c} * {f32_literal(s)}))"
        src.append(f"  *code = pred ? (int){code_c} : 0;")
    src += ["  return pred;", "}"]

    pred_fns = [p.fn for p in preds]
    val_fns = [v.fn for v in vals]
    key_fns = [k.fn for k in keys]
    lkey_fns = [k.fn for k in lkeys]

    def probe_key(pcols):
        env = dict(zip(probe_cols, pcols))
        kp = lkey_fns[0](env, {})
        for fn, d in zip(lkey_fns[1:], doms[1:]):
            kp = kp * float(d) + fn(env, {})
        return kp

    def rows(pcols, bvals, matched, scal):
        n = matched.shape[0]
        env = dict(zip(probe_cols, pcols))
        env.update(zip(build_cols, bvals))
        penv = {name: scal[k] for k, name in enumerate(param_names)}
        pred = matched
        for fn in pred_fns:
            pred = pred & _bool_rows(fn(env, penv), n, matched.device)
        out = _select_values(pred, val_fns, fills, has_count, env, penv, n,
                             matched.device)
        code = None
        if key_fns:
            c = torch.zeros(n, dtype=torch.float32, device=matched.device)
            for fn, s in zip(key_fns, strides):
                c = c + fn(env, penv) * float(s)
            code = torch.where(pred, c, 0.0).to(torch.int32)
        return pred, out, code

    return Body(src="\n".join(src), rows=rows, ops=ops, fills=fills,
                col_dtypes=tuple(comp.dtype(c) for c in probe_cols),
                build_dtypes=tuple(comp.dtype(c) for c in build_cols),
                probe_key=probe_key,
                key_cols=tuple(probe_cols.index(k) for k in key_names))


def _probe_eligibility(frag: R.Fragment,
                       catalog: P.Catalog) -> Tuple[bool, str]:
    a = _analyze_probe(frag, catalog)
    return (a.reason is None), (a.reason or "ok")


class _ProbeEmitter:
    """join_probe_agg over the fragment's boundary join.  A custom-lowering
    emitter: it lowers the probe and build sides itself and takes the
    cached index from the ``scans`` environment."""

    def __init__(self, frag: R.Fragment, catalog: P.Catalog):
        self.frag = frag
        self.ana = _analyze_probe(frag, catalog)
        if self.ana.reason is not None:
            raise KernelBudgetError(self.ana.reason)
        self.out_info = L.static_info(frag.root, catalog)

    def sources(self) -> List[str]:
        return [JP.unit_source(self.ana.body, self.ana.domain)]

    def __call__(self, catalog: P.Catalog, scans: Dict[Any, Any],
                 params: Optional[Dict[str, Any]]) -> L.Stream:
        ana, frag = self.ana, self.frag
        join = frag.boundary
        left = L.lower_node(join.left, catalog, scans, params)
        right = L.lower_node(join.right, catalog, scans, params)
        jidx = scans.get(L.index_stream_key(join))
        if jidx is None:
            raise RuntimeError(
                "join-probe fragment lowered without its cached index; "
                "the engine must run lower.build_callable")
        perm, keys, meta = jidx
        dev = left.device
        scal = _scal(ana.param_names, params, dev)
        out = JP.join_probe_agg(
            ana.body, _columns(left, ana.probe_cols, ana.body.col_dtypes),
            _mask(left), left.n, keys, perm, _mask(right),
            _columns(right, ana.build_cols, ana.body.build_dtypes), scal,
            num_groups=ana.domain, meta=meta)
        if ana.domain is None:
            return _keyless_outputs(frag, ana.plan_, ana.cnt_slot, out,
                                    self.out_info, dev)
        return _grouped_outputs(frag, ana.plan_, ana.cnt_slot, out,
                                ana.strides, ana.key_doms, self.out_info,
                                ana.domain, dev)


R.register_pattern(R.KernelPattern(
    name="filter-scalar-agg", matcher=_match_scalar,
    eligibility=_eligibility, emitter=_AggEmitter))
R.register_pattern(R.KernelPattern(
    name="grouped-agg", matcher=_match_grouped,
    eligibility=_eligibility, emitter=_AggEmitter))
# join-probe outranks masked-filter-project: where both match (an inner
# index-served join under the aggregate), fusing the probe wins
R.register_pattern(R.KernelPattern(
    name="join-probe", matcher=_match_join_probe,
    eligibility=_probe_eligibility, emitter=_ProbeEmitter,
    requires_index=True, custom_lower=True))
R.register_pattern(R.KernelPattern(
    name="masked-filter-project", matcher=_match_masked,
    eligibility=_eligibility, emitter=_AggEmitter))
