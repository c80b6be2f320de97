"""Expression IR.

The analogue of Catalyst expression trees.  Expressions are built by the
DataFrame API (``col("l_discount") >= lit(0.05)``) and by staged UDFs
(DESIGN.md section 2, Flare Level 3): a UDF is an ordinary Python function
over expression values that gets *traced into the same program* as the
relational operators -- the LMS ``Rep[T]`` correspondence.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.relational import table as T

# ---------------------------------------------------------------------------
# nodes
# ---------------------------------------------------------------------------


class Expr:
    """Base expression.  Operator overloads build trees, Spark-column style."""

    # arithmetic ------------------------------------------------------------
    def __add__(self, other):  return BinOp("+", self, wrap(other))
    def __radd__(self, other): return BinOp("+", wrap(other), self)
    def __sub__(self, other):  return BinOp("-", self, wrap(other))
    def __rsub__(self, other): return BinOp("-", wrap(other), self)
    def __mul__(self, other):  return BinOp("*", self, wrap(other))
    def __rmul__(self, other): return BinOp("*", wrap(other), self)
    def __truediv__(self, other):  return BinOp("/", self, wrap(other))
    def __rtruediv__(self, other): return BinOp("/", wrap(other), self)
    def __neg__(self): return BinOp("-", Lit(0), self)

    # comparisons -----------------------------------------------------------
    def __lt__(self, other):  return Cmp("<", self, wrap(other))
    def __le__(self, other):  return Cmp("<=", self, wrap(other))
    def __gt__(self, other):  return Cmp(">", self, wrap(other))
    def __ge__(self, other):  return Cmp(">=", self, wrap(other))
    def __eq__(self, other):  return Cmp("==", self, wrap(other))  # type: ignore
    def __ne__(self, other):  return Cmp("!=", self, wrap(other))  # type: ignore

    # boolean ---------------------------------------------------------------
    def __and__(self, other): return BoolOp("and", (self, wrap(other)))
    def __or__(self, other):  return BoolOp("or", (self, wrap(other)))
    def __invert__(self):     return Not(self)

    # sugar -----------------------------------------------------------------
    def between(self, lo, hi):
        return (self >= wrap(lo)) & (self <= wrap(hi))

    def isin(self, values: Sequence[Any]):
        return InSet(self, tuple(values))

    def startswith(self, prefix: str):
        return StrPred("startswith", self, (prefix,))

    def endswith(self, suffix: str):
        return StrPred("endswith", self, (suffix,))

    def contains(self, needle: str):
        return StrPred("contains", self, (needle,))

    def like(self, pattern: str):
        """SQL LIKE with ``%`` wildcards (evaluated on the dictionary)."""
        return StrPred("like", self, (pattern,))

    def alias(self, name: str) -> Tuple[str, "Expr"]:
        return (name, self)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise TypeError(
            "Expr has no truth value; use & | ~ instead of and/or/not")

    # traversal ---------------------------------------------------------------
    def children(self) -> Tuple["Expr", ...]:
        return ()

    def with_children(self, kids: Sequence["Expr"]) -> "Expr":
        assert not kids
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Expr):
    name: str

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: Any

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True, eq=False)
class Param(Expr):
    """A named runtime parameter (prepared-statement placeholder).

    Unlike :class:`Lit`, the value is NOT baked into the compiled program:
    it lowers to an extra scalar argument of the jitted query function, so
    one compiled program serves every binding of the parameter
    (``repro_torch.core.stages``: ``lowered.compile()(name=value)``).

    Only numeric dtypes are allowed -- string predicates are evaluated on
    the dictionary at lowering time and therefore cannot be deferred.
    """

    name: str
    dtype: str

    def __post_init__(self):
        if self.dtype not in T.NUMERIC_DTYPES:
            raise TypeError(
                f"param {self.name!r}: dtype must be numeric "
                f"(one of {T.NUMERIC_DTYPES}), got {self.dtype!r}")

    def __repr__(self):
        return f":{self.name}"


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return BinOp(self.op, *kids)

    def __repr__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclasses.dataclass(frozen=True, eq=False)
class Cmp(Expr):
    op: str
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return Cmp(self.op, *kids)

    def __repr__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclasses.dataclass(frozen=True, eq=False)
class BoolOp(Expr):
    op: str  # "and" | "or"
    args: Tuple[Expr, ...]

    def children(self):
        return self.args

    def with_children(self, kids):
        return BoolOp(self.op, tuple(kids))

    def __repr__(self):
        sep = f" {self.op} "
        return "(" + sep.join(map(repr, self.args)) + ")"


@dataclasses.dataclass(frozen=True, eq=False)
class Not(Expr):
    arg: Expr

    def children(self):
        return (self.arg,)

    def with_children(self, kids):
        return Not(kids[0])

    def __repr__(self):
        return f"(not {self.arg})"


@dataclasses.dataclass(frozen=True, eq=False)
class InSet(Expr):
    arg: Expr
    values: Tuple[Any, ...]

    def children(self):
        return (self.arg,)

    def with_children(self, kids):
        return InSet(kids[0], self.values)

    def __repr__(self):
        return f"({self.arg} in {list(self.values)})"


@dataclasses.dataclass(frozen=True, eq=False)
class StrPred(Expr):
    """String predicate, evaluated over the (small) dictionary and pushed
    down as an int32 code-set test over the dictionary codes."""

    kind: str
    arg: Expr
    params: Tuple[str, ...]

    def children(self):
        return (self.arg,)

    def with_children(self, kids):
        return StrPred(self.kind, kids[0], self.params)

    def __repr__(self):
        return f"{self.kind}({self.arg}, {self.params})"


@dataclasses.dataclass(frozen=True, eq=False)
class IfThenElse(Expr):
    cond: Expr
    then: Expr
    other: Expr

    def children(self):
        return (self.cond, self.then, self.other)

    def with_children(self, kids):
        return IfThenElse(*kids)

    def __repr__(self):
        return f"if({self.cond}, {self.then}, {self.other})"


@dataclasses.dataclass(frozen=True, eq=False)
class Cast(Expr):
    arg: Expr
    dtype: str

    def children(self):
        return (self.arg,)

    def with_children(self, kids):
        return Cast(kids[0], self.dtype)

    def __repr__(self):
        return f"cast({self.arg} as {self.dtype})"


@dataclasses.dataclass(frozen=True, eq=False)
class WithDomain(Expr):
    """Annotate an integer expression with a dense domain bound so it can
    be used as a group/join key (e.g. a count known to be < 64)."""

    arg: Expr
    domain: int

    def children(self):
        return (self.arg,)

    def with_children(self, kids):
        return WithDomain(kids[0], self.domain)

    def __repr__(self):
        return f"{self.arg}:domain[{self.domain}]"


@dataclasses.dataclass(frozen=True, eq=False)
class Udf(Expr):
    """A staged user-defined function (Flare Level 3).

    ``fn`` is written against whole-column tensors; it is called once
    per column batch, not per row, like the paper's ``Rep[A] => Rep[B]``
    UDFs (section 5.1).
    """

    fn: Callable[..., Any]
    args: Tuple[Expr, ...]
    dtype: str
    name: str = "udf"

    def children(self):
        return self.args

    def with_children(self, kids):
        return Udf(self.fn, tuple(kids), self.dtype, self.name)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def wrap(v: Any) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


def col(name: str) -> Col:
    return Col(name)


def lit(v: Any) -> Lit:
    return Lit(v)


def param(name: str, dtype: str = T.FLOAT64) -> Param:
    """A prepared-query placeholder bound at execution time."""
    return Param(name, dtype)


def params_of(e: Expr) -> List[Param]:
    """All Param placeholders in ``e`` (document order, with duplicates)."""
    out: List[Param] = []

    def rec(x: Expr):
        if isinstance(x, Param):
            out.append(x)
        for c in x.children():
            rec(c)

    rec(e)
    return out


def when(cond: Expr, then: Any, otherwise: Any) -> IfThenElse:
    return IfThenElse(cond, wrap(then), wrap(otherwise))


def cast(e: Expr, dtype: str) -> Cast:
    return Cast(e, dtype)


def columns_of(e: Expr) -> List[str]:
    out: List[str] = []

    def rec(x: Expr):
        if isinstance(x, Col):
            out.append(x.name)
        for c in x.children():
            rec(c)

    rec(e)
    return out


def map_expr(e: Expr, fn: Callable[[Expr], Optional[Expr]]) -> Expr:
    """Bottom-up rewrite: ``fn`` may return a replacement or None."""
    kids = tuple(map_expr(c, fn) for c in e.children())
    if any(k is not c for k, c in zip(kids, e.children())):
        e = e.with_children(kids)
    repl = fn(e)
    return e if repl is None else repl


# -- dtype inference ---------------------------------------------------------

_RANK = {T.BOOL: 0, T.INT32: 1, T.DATE: 1, T.INT64: 2, T.FLOAT32: 3,
         T.FLOAT64: 4}


def _promote(a: str, b: str) -> str:
    if a == b:
        return a
    if T.STRING in (a, b):
        raise TypeError("no arithmetic on strings")
    return a if _RANK[a] >= _RANK[b] else b


def lit_dtype(v: Any) -> str:
    if isinstance(v, bool):
        return T.BOOL
    if isinstance(v, int):
        return T.INT32 if -(2 ** 31) <= v < 2 ** 31 else T.INT64
    if isinstance(v, float):
        return T.FLOAT64
    if isinstance(v, str):
        return T.STRING
    raise TypeError(f"unsupported literal {v!r}")


def infer_dtype(e: Expr, schema: T.Schema) -> str:
    if isinstance(e, Col):
        return schema[e.name].dtype
    if isinstance(e, Lit):
        return lit_dtype(e.value)
    if isinstance(e, Param):
        return e.dtype
    if isinstance(e, BinOp):
        l = infer_dtype(e.left, schema)
        r = infer_dtype(e.right, schema)
        out = _promote(l, r)
        if e.op == "/":
            out = T.FLOAT64 if out == T.FLOAT64 else (
                T.FLOAT32 if out == T.FLOAT32 else T.FLOAT64)
        return out
    if isinstance(e, (Cmp, BoolOp, Not, InSet, StrPred)):
        return T.BOOL
    if isinstance(e, IfThenElse):
        return _promote(infer_dtype(e.then, schema),
                        infer_dtype(e.other, schema))
    if isinstance(e, Cast):
        return e.dtype
    if isinstance(e, WithDomain):
        return infer_dtype(e.arg, schema)
    if isinstance(e, Udf):
        return e.dtype
    raise TypeError(f"cannot infer dtype of {e!r}")


def fingerprint(e: Expr) -> str:
    """Structural fingerprint used for compile-cache keys."""
    if isinstance(e, Col):
        return f"c:{e.name}"
    if isinstance(e, Lit):
        return f"l:{e.value!r}"
    if isinstance(e, Param):
        # structural only -- two bindings of one template share a cache key
        return f"p:{e.name}:{e.dtype}"
    if isinstance(e, BinOp):
        return f"({fingerprint(e.left)}{e.op}{fingerprint(e.right)})"
    if isinstance(e, Cmp):
        return f"({fingerprint(e.left)}{e.op}{fingerprint(e.right)})"
    if isinstance(e, BoolOp):
        return f"({e.op}:" + ",".join(map(fingerprint, e.args)) + ")"
    if isinstance(e, Not):
        return f"(!{fingerprint(e.arg)})"
    if isinstance(e, InSet):
        return f"(in:{fingerprint(e.arg)}:{self_vals(e)})"
    if isinstance(e, StrPred):
        return f"(sp:{e.kind}:{fingerprint(e.arg)}:{e.params})"
    if isinstance(e, IfThenElse):
        return ("(if:" + fingerprint(e.cond) + ":" + fingerprint(e.then)
                + ":" + fingerprint(e.other) + ")")
    if isinstance(e, Cast):
        return f"(cast:{e.dtype}:{fingerprint(e.arg)})"
    if isinstance(e, WithDomain):
        return f"(dom:{e.domain}:{fingerprint(e.arg)})"
    if isinstance(e, Udf):
        from repro_torch.core import fnhash as FH
        return f"(udf:{e.name}#{FH.fn_token(e.fn)}:" + ",".join(
            map(fingerprint, e.args)) + ")"
    raise TypeError(f"cannot fingerprint {e!r}")


def self_vals(e: InSet) -> str:
    return ",".join(map(repr, e.values))


def match_str(kind: str, s: str, params: Tuple[str, ...]) -> bool:
    """Evaluate a :class:`StrPred` on one dictionary string.  String
    predicates run over the (small) dictionary at lowering time, never
    per row; the optimizer's selectivity estimate uses the same test."""
    if kind == "startswith":
        return s.startswith(params[0])
    if kind == "endswith":
        return s.endswith(params[0])
    if kind == "contains":
        return params[0] in s
    if kind == "like":
        return fnmatch.fnmatchcase(
            s, params[0].replace("%", "*").replace("_", "?"))
    raise ValueError(kind)
