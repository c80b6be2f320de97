"""Whole-query lowering: logical plan -> ONE function over device tensors.

This is the Flare Level 2 analogue (paper section 4): the entire optimized
plan becomes one function over the scan columns, run eagerly by PyTorch on
the context's device::

    Filter      -> boolean selection mask (predication, never compacts)
    Hash join   -> sorted-array join: sort build keys once (or take the
                   cached index), probe with torch.searchsorted + gather
    Hash agg    -> index_add / scatter_reduce onto the dense, statically
                   bounded group domain from dictionaries / key domains
    Strings     -> int32 dictionary codes; string predicates evaluated on
                   the dictionary at lowering time as lookup tables

Lowering runs in two phases.  Phase A (host) propagates static
information: dictionaries, key domains, join key-combination constants.
Phase B is the function over device tensors.  Device columns are 32-bit:
int32 codes, dates and keys, f32 values, bool masks.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import expr as E
from repro_torch.core import plan as P
from repro_torch.relational import table as T

_I32_MAX = 2 ** 31 - 1

# ---------------------------------------------------------------------------
# static (phase A) column info
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StaticCol:
    dtype: str
    dictionary: Optional[Tuple[str, ...]] = None
    domain: Optional[int] = None  # dense-int key domain (exclusive bound)

    @property
    def group_domain(self) -> Optional[int]:
        if self.dictionary is not None:
            return len(self.dictionary)
        return self.domain


@dataclasses.dataclass
class StaticInfo:
    """Phase-A result for one plan node's output stream."""

    cols: Dict[str, StaticCol]
    n_rows: int  # static row bound of the stream


def _static_of_scan(tbl: T.Table) -> StaticInfo:
    cols = {}
    for f in tbl.schema:
        cols[f.name] = StaticCol(f.dtype, tbl.dictionary(f.name), f.domain)
    return StaticInfo(cols, tbl.num_rows)


# ---------------------------------------------------------------------------
# stream: the value flowing between operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stream:
    cols: Dict[str, torch.Tensor]
    mask: Optional[torch.Tensor]  # bool [n] or None (= all valid)
    info: StaticInfo
    device: torch.device

    @property
    def n(self) -> int:
        return self.info.n_rows

    def the_mask(self) -> torch.Tensor:
        if self.mask is None:
            return torch.ones((self.n,), dtype=torch.bool, device=self.device)
        return self.mask


# ---------------------------------------------------------------------------
# expression evaluation (phase B)
# ---------------------------------------------------------------------------

#: Device dtype of each logical dtype: 32-bit throughout, as the JAX
#: package runs with x64 off.
TORCH_OF = {
    T.INT32: torch.int32, T.INT64: torch.int32,
    T.FLOAT32: torch.float32, T.FLOAT64: torch.float32,
    T.BOOL: torch.bool, T.DATE: torch.int32, T.STRING: torch.int32,
}


def _dict_of(e: E.Expr, info: StaticInfo) -> Optional[Tuple[str, ...]]:
    if isinstance(e, E.Col):
        return info.cols[e.name].dictionary
    return None


def str_code(dictionary: Tuple[str, ...], value: str) -> int:
    """Code of ``value`` in a sorted dictionary, or -1 if absent."""
    try:
        return dictionary.index(value)
    except ValueError:
        return -1


def upload(values: Any, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """Host values (a scalar or a list) as a tensor on ``device``, with no
    host sync: on a CUDA device through pinned memory and a non-blocking
    copy, ordered on the current stream before the work that reads it."""
    host = torch.tensor(values, dtype=dtype)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def as_column(x, stream: Stream) -> torch.Tensor:
    """Broadcast a scalar (Python or 0-d) result to a column.  A Python
    scalar becomes a device fill, not a copy from the host (no sync)."""
    t = (x if isinstance(x, torch.Tensor)
         else torch.full((), x, device=stream.device))
    return t.expand(stream.n) if t.dim() == 0 else t


def eval_expr(e: E.Expr, stream: Stream,
              params: Optional[Dict[str, Any]] = None):
    """Evaluate ``e`` over ``stream``: a tensor, or a Python/0-d scalar
    for column-free subexpressions (kept weak, as literals are in JAX)."""
    info = stream.info
    if isinstance(e, E.Col):
        return stream.cols[e.name]
    if isinstance(e, E.Lit):
        if isinstance(e.value, str):
            raise TypeError("string literal outside comparison")
        return e.value
    if isinstance(e, E.Param):
        if params is None or e.name not in params:
            raise KeyError(
                f"unbound query parameter {e.name!r}; pass a binding, e.g. "
                f"lowered.compile()({e.name}=...)")
        return params[e.name]
    if isinstance(e, E.BinOp):
        l = eval_expr(e.left, stream, params)
        r = eval_expr(e.right, stream, params)
        if e.op == "+":
            return l + r
        if e.op == "-":
            return l - r
        if e.op == "*":
            return l * r
        if e.op == "/":
            return _to_float(l) / _to_float(r)
        raise ValueError(e.op)
    if isinstance(e, E.Cmp):
        # string comparison -> dictionary code comparison (codes are in
        # dictionary == lexical order, so <,> are order-preserving too).
        ldict = _dict_of(e.left, info)
        rdict = _dict_of(e.right, info)
        if ldict is not None and isinstance(e.right, E.Lit):
            code = str_code(ldict, e.right.value)
            l = eval_expr(e.left, stream, params)
            return _cmp_with_code(e.op, l, code, ldict, e.right.value)
        if rdict is not None and isinstance(e.left, E.Lit):
            flipped = {"<": ">", ">": "<", "<=": ">=", ">=": "<=",
                       "==": "==", "!=": "!="}[e.op]
            code = str_code(rdict, e.left.value)
            r = eval_expr(e.right, stream, params)
            return _cmp_with_code(flipped, r, code, rdict, e.left.value)
        if ldict is not None and rdict is not None and ldict != rdict:
            raise TypeError("cross-dictionary string comparison "
                            "unsupported in compiled engine")
        return _apply_cmp(e.op, eval_expr(e.left, stream, params),
                          eval_expr(e.right, stream, params))
    if isinstance(e, E.BoolOp):
        vals = [as_column(eval_expr(a, stream, params), stream) for a in e.args]
        out = vals[0]
        for v in vals[1:]:
            out = (out & v) if e.op == "and" else (out | v)
        return out
    if isinstance(e, E.Not):
        return ~as_column(eval_expr(e.arg, stream, params), stream)
    if isinstance(e, E.InSet):
        d = _dict_of(e.arg, info)
        arg = as_column(eval_expr(e.arg, stream, params), stream)
        if d is not None:
            codes = [c for c in (str_code(d, v) for v in e.values) if c >= 0]
            if not codes:
                return torch.zeros(arg.shape, dtype=torch.bool,
                                   device=stream.device)
            out = arg == codes[0]
            for c in codes[1:]:
                out = out | (arg == c)
            return out
        out = arg == e.values[0]
        for v in e.values[1:]:
            out = out | (arg == v)
        return out
    if isinstance(e, E.StrPred):
        d = _dict_of(e.arg, info)
        if d is None:
            raise TypeError(f"{e.kind} on non-string column")
        lut = upload([E.match_str(e.kind, s, e.params) for s in d],
                     torch.bool, stream.device)
        codes = eval_expr(e.arg, stream, params)
        return lut[codes]
    if isinstance(e, E.IfThenElse):
        cond = as_column(eval_expr(e.cond, stream, params), stream)
        return torch.where(cond, eval_expr(e.then, stream, params),
                           eval_expr(e.other, stream, params))
    if isinstance(e, E.Cast):
        return as_column(eval_expr(e.arg, stream, params),
                     stream).to(TORCH_OF[e.dtype])
    if isinstance(e, E.WithDomain):
        return eval_expr(e.arg, stream, params)
    if isinstance(e, E.Udf):
        args = [eval_expr(a, stream, params) for a in e.args]
        return e.fn(*args)
    raise TypeError(f"cannot lower {e!r}")


def _to_float(x):
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float32)
    return float(x)


def _cmp_with_code(op, codes, code, dictionary, value):
    if code < 0:
        # literal absent from dictionary: == is all-false, != all-true;
        # for ordering, fall back to position where it would be inserted.
        if op == "==":
            return torch.zeros(codes.shape, dtype=torch.bool,
                               device=codes.device)
        if op == "!=":
            return torch.ones(codes.shape, dtype=torch.bool,
                              device=codes.device)
        code = int(np.searchsorted(np.asarray(dictionary, dtype=object),
                                   value))
        if op in ("<", "<="):
            return codes < code
        return codes >= code
    return _apply_cmp(op, codes, code)


def _apply_cmp(op, l, r):
    # the operator module, not torch.lt & co.: either side may be a
    # Python scalar
    return {"<": operator.lt, "<=": operator.le, ">": operator.gt,
            ">=": operator.ge, "==": operator.eq, "!=": operator.ne}[op](l, r)


# ---------------------------------------------------------------------------
# phase A: static info propagation
# ---------------------------------------------------------------------------


def static_info(p: P.Plan, catalog: P.Catalog) -> StaticInfo:
    hook = getattr(p, "static_info_hook", None)
    if hook is not None:  # custom-lowering nodes (see lower_node)
        return hook(catalog)
    if isinstance(p, P.Scan):
        return _static_of_scan(catalog.table(p.table))
    if isinstance(p, P.Filter):
        return static_info(p.child, catalog)
    if isinstance(p, P.MapBatches):
        child = static_info(p.child, catalog)
        produced = set(p.out_names)
        cols = {n: sc for n, sc in child.cols.items() if n not in produced}
        for f in p.out_fields:
            cols[f.name] = StaticCol(f.dtype, None, f.domain)
        return StaticInfo(cols, child.n_rows)
    if isinstance(p, P.Project):
        child = static_info(p.child, catalog)
        schema = p.child.schema(catalog)
        cols = {}
        for name, e in p.outputs:
            if isinstance(e, E.Col):
                cols[name] = child.cols[e.name]
            elif isinstance(e, E.WithDomain):
                inner = (child.cols[e.arg.name] if isinstance(e.arg, E.Col)
                         else StaticCol(E.infer_dtype(e.arg, schema)))
                cols[name] = StaticCol(inner.dtype, inner.dictionary,
                                       e.domain)
            else:
                cols[name] = StaticCol(E.infer_dtype(e, schema))
        return StaticInfo(cols, child.n_rows)
    if isinstance(p, P.Join):
        left = static_info(p.left, catalog)
        right = static_info(p.right, catalog)
        if p.how in ("semi", "anti"):
            return left
        cols = dict(left.cols)
        for name, sc in right.cols.items():
            if name in p.right_on:
                continue
            cols[name] = sc
        return StaticInfo(cols, left.n_rows)
    if isinstance(p, P.Aggregate):
        child = static_info(p.child, catalog)
        strides, domain = group_layout(p, child)
        cols = {}
        for k in p.keys:
            cols[k] = child.cols[k]
        schema = p.schema(catalog)
        for a in p.aggs:
            if a.op == "any" and isinstance(a.arg, E.Col):
                cols[a.name] = child.cols[a.arg.name]  # keeps dict/domain
            else:
                cols[a.name] = StaticCol(schema[a.name].dtype)
        n = domain if p.keys else 1
        return StaticInfo(cols, n)
    if isinstance(p, P.Sort):
        return static_info(p.child, catalog)
    if isinstance(p, P.Limit):
        child = static_info(p.child, catalog)
        return StaticInfo(child.cols, min(child.n_rows, p.n))
    raise TypeError(f"no static info for {p!r}")


def group_layout(p: P.Aggregate, child: StaticInfo) -> Tuple[List[int], int]:
    """Strides and total size of the dense group-code domain."""
    doms = []
    for k in p.keys:
        g = child.cols[k].group_domain
        if g is None:
            raise TypeError(
                f"aggregate key '{k}' needs a dictionary or a dense integer "
                f"domain (Field.domain) for direct-indexed aggregation")
        doms.append(g)
    total = 1
    for d in doms:
        total *= d
    if total > (1 << 26):
        raise ValueError(f"group domain {total} too large for direct "
                         f"aggregation; add a coarser key encoding")
    strides = []
    acc = 1
    for d in reversed(doms):
        strides.append(acc)
        acc *= d
    strides.reverse()
    return strides, max(total, 1)


def combine_keys(keys: Sequence[torch.Tensor],
                 doms: Sequence[int]) -> torch.Tensor:
    total = 1
    for d in doms:
        total *= d
    if total > _I32_MAX:
        raise ValueError("combined key domain exceeds int32; enable a "
                         "wider key encoding")
    out = keys[0].to(torch.int32)
    for k, d in zip(keys[1:], doms[1:]):
        out = out * d + k.to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# phase A: build-side join index resolution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JoinIndexSpec:
    """A join whose build side resolves to a cached base-table index.

    ``table``/``key_cols`` name the scan-level key columns the index is
    built over (after mapping the join's ``right_on`` names back through
    any Project renames); ``doms`` are the per-key combine domains.
    ``masked`` marks a filtered build side: the cached index covers the
    UNFILTERED table and the probe validates the matched row's filter
    mask afterwards -- exact because the keys are unique (declared via
    ``Field.unique``, verified when the index is built).
    """

    table: str
    key_cols: Tuple[str, ...]
    doms: Tuple[int, ...]
    masked: bool


def resolve_build_index(p: P.Join, catalog: P.Catalog
                        ) -> Tuple[Optional[JoinIndexSpec], str]:
    """Can this join's build side be served by a cached base-table
    index?  Returns ``(spec, reason)`` -- spec None when the join must
    sort its build keys in the program, with the reason for the report."""
    node = p.right
    mapping = {k: k for k in p.right_on}  # right_on name -> current name
    masked = False
    while not isinstance(node, P.Scan):
        if isinstance(node, P.Filter):
            masked = True
            node = node.child
            continue
        if isinstance(node, P.Project):
            outs = dict(node.outputs)
            new = {}
            for orig, cur in mapping.items():
                e = outs.get(cur)
                if isinstance(e, E.WithDomain):
                    e = e.arg  # domain annotations pass values through
                if not isinstance(e, E.Col):
                    return None, (f"build key {orig!r} is computed, not a "
                                  "base-table column")
                new[orig] = e.name
            mapping = new
            node = node.child
            continue
        return None, (f"build side is {node.describe()}, not a base-table "
                      "scan")
    tbl = catalog.table(node.table)
    if tbl.num_rows == 0:
        return None, "empty build table"
    key_cols = tuple(mapping[k] for k in p.right_on)
    left_i = static_info(p.left, catalog)
    right_i = static_info(p.right, catalog)
    ldoms = [left_i.cols[k].group_domain or _I32_MAX for k in p.left_on]
    rdoms = [right_i.cols[k].group_domain or _I32_MAX for k in p.right_on]
    doms = tuple(max(a, b) for a, b in zip(ldoms, rdoms))
    if len(key_cols) > 1 and any(d >= _I32_MAX for d in doms):
        return None, "composite join keys need Field.domain bounds"
    if masked and not any(tbl.schema[c].unique for c in key_cols):
        return None, ("filtered build side without a declared-unique key "
                      "(Field.unique): post-probe mask validation would "
                      "be inexact under duplicate keys")
    return JoinIndexSpec(node.table, key_cols, doms, masked), "ok"


def join_index_plan(p: P.Plan, catalog: P.Catalog
                    ) -> Tuple[Dict[int, JoinIndexSpec],
                               List[Tuple[P.Join, Optional[JoinIndexSpec],
                                          str]]]:
    """Resolve every Join in ``p`` against the index cache.  Returns
    (id(join) -> spec for cache-served joins, per-join decisions in plan
    walk order for the dispatch report)."""
    specs: Dict[int, JoinIndexSpec] = {}
    decisions: List[Tuple[P.Join, Optional[JoinIndexSpec], str]] = []

    def rec(node: P.Plan):
        if isinstance(node, P.Join):
            spec, reason = resolve_build_index(node, catalog)
            if spec is not None:
                specs[id(node)] = spec
            decisions.append((node, spec, reason))
        for c in node.children():
            rec(c)

    rec(p)
    return specs, decisions


def index_stream_key(p: P.Join) -> Tuple[str, int]:
    """The ``scans``-dict key under which a join's cached index
    (perm, sorted keys, meta) rides into the program."""
    return ("joinidx", id(p))


# ---------------------------------------------------------------------------
# phase B: operators
# ---------------------------------------------------------------------------


def _join_info(p: P.Join, left: StaticInfo, right: StaticInfo
               ) -> StaticInfo:
    if p.how in ("semi", "anti"):
        return left
    cols = dict(left.cols)
    for name, sc in right.cols.items():
        if name not in p.right_on:
            cols[name] = sc
    return StaticInfo(cols, left.n_rows)


def _lower_join(p: P.Join, left: Stream, right: Stream,
                catalog: P.Catalog,
                jindex: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> Stream:
    strategy = p.strategy or "sorted"
    ldoms = [left.info.cols[k].group_domain or _I32_MAX for k in p.left_on]
    rdoms = [right.info.cols[k].group_domain or _I32_MAX
             for k in p.right_on]
    doms = [max(a, b) for a, b in zip(ldoms, rdoms)]
    if len(p.left_on) > 1:
        for d in doms:
            if d >= _I32_MAX:
                raise TypeError("composite join keys need Field.domain bounds")
    kp = combine_keys([left.cols[k] for k in p.left_on], doms)

    # --- build side: the 'hash table' analogue --------------------------------
    if jindex is not None:
        # cached index: the sorted permutation + sorted keys were built
        # once at preload/first use.  It covers the unfiltered base
        # table; a filtered build side is validated after the probe
        # against the matched row's mask (exact: keys are unique).
        perm, kb_sorted, _meta = jindex
        validate_mask = right.mask
    else:
        kb = combine_keys([right.cols[k] for k in p.right_on], doms)
        if right.mask is not None:
            kb = torch.where(right.mask, kb, _I32_MAX)  # never matches
        kb_sorted, perm = torch.sort(kb, stable=True)
        validate_mask = None

    pmask = left.the_mask()
    nb = kb_sorted.shape[0]
    info = _join_info(p, left.info, right.info)
    if nb == 0:
        matched = torch.zeros_like(pmask)
        pos = torch.zeros_like(kp)
    else:
        if strategy == "sortmerge":
            # Paper Fig. 6: sort-merge also sorts the (large) probe side,
            # then un-permutes results -- strictly more work, kept for
            # comparison.
            kp_s, probe_perm = torch.sort(kp, stable=True)
            idx = torch.empty_like(kp)
            idx[probe_perm] = torch.searchsorted(kb_sorted, kp_s,
                                                 out_int32=True)
        else:
            idx = torch.searchsorted(kb_sorted, kp, out_int32=True)
        # out of place: vmap has no batching rule for the in-place clamp_
        idx_c = idx.clamp(0, nb - 1)
        pos = perm[idx_c]  # build-table row of each (tentative) match
        matched = (kb_sorted[idx_c] == kp) & pmask
        if validate_mask is not None:
            matched = matched & validate_mask[pos]

    if p.how == "semi":
        return Stream(dict(left.cols), matched, info, left.device)
    if p.how == "anti":
        return Stream(dict(left.cols), pmask & ~matched, info, left.device)

    cols = dict(left.cols)
    for name in right.cols:
        if name in p.right_on:
            continue
        src = right.cols[name]
        gathered = (src[pos] if nb else
                    torch.zeros(left.n, dtype=src.dtype, device=left.device))
        if p.how == "left":
            gathered = torch.where(matched, gathered,
                                   torch.zeros((), dtype=gathered.dtype,
                                               device=left.device))
        cols[name] = gathered
    mask = matched if p.how == "inner" else pmask
    return Stream(cols, mask, info, left.device)


def type_max(dt: torch.dtype):
    return (torch.finfo(dt).max if dt.is_floating_point
            else torch.iinfo(dt).max)


def type_min(dt: torch.dtype):
    return (torch.finfo(dt).min if dt.is_floating_point
            else torch.iinfo(dt).min)


def _lower_aggregate(p: P.Aggregate, child: Stream, catalog: P.Catalog,
                     params: Optional[Dict[str, Any]] = None) -> Stream:
    info = static_info(p, catalog)
    mask = child.the_mask()
    dev = child.device

    def value(a: P.AggSpec) -> torch.Tensor:
        v = as_column(eval_expr(a.arg, child, params), child)
        if v.dtype == torch.bool:
            v = v.to(torch.int32)  # JAX sums bools into int32
        elif not v.is_floating_point() and a.op in ("sum", "avg"):
            v = v.to(torch.float32)
        return v

    def masked(vals, fill=0):
        # where, NOT multiply-by-mask: invalid rows may hold arbitrary
        # values (a division yields inf/nan there) and nan * 0 would
        # poison the sum
        return torch.where(mask, vals, torch.full((), fill, dtype=vals.dtype,
                                                  device=dev))

    if not p.keys:  # global aggregate
        cols: Dict[str, torch.Tensor] = {}
        cnt = mask.sum(dtype=torch.int32)
        for a in p.aggs:
            if a.op == "count":
                cols[a.name] = cnt[None]
                continue
            v = value(a)
            if a.op == "sum":
                cols[a.name] = masked(v).sum(dtype=v.dtype)[None]
            elif a.op == "avg":
                s = masked(v).sum()
                cols[a.name] = (s / torch.clamp(cnt, min=1))[None]
            elif a.op in ("min", "max"):
                fill = type_max(v.dtype) if a.op == "min" else type_min(
                    v.dtype)
                if child.n == 0:
                    # torch reduces no element to an error, where the
                    # neutral element is the answer (an empty row range
                    # of a sharded or morsel-split spine)
                    cols[a.name] = torch.full((1,), fill, dtype=v.dtype,
                                              device=dev)
                elif a.op == "min":
                    cols[a.name] = masked(v, fill).min()[None]
                else:
                    cols[a.name] = masked(v, fill).max()[None]
        return Stream(cols, None, info, dev)

    strides, domain = group_layout(p, child.info)
    code = torch.zeros((child.n,), dtype=torch.int32, device=dev)
    for k, s in zip(p.keys, strides):
        code = code + child.cols[k].to(torch.int32) * s
    # rows whose code falls outside the domain contribute nothing (JAX's
    # segment ops drop them; index_add would fault)
    ok = mask & (code >= 0) & (code < domain)
    code = torch.where(ok, code, 0).long()
    # every accumulator is out of place (index_add, scatter_reduce), so
    # torch.func.vmap can batch a param-dependent ``code`` or ``vals``
    # into an unbatched zeros (build_batch_callable); the in-place forms
    # refuse that, and their results are the same bit for bit
    cnt = torch.zeros(domain, dtype=torch.int32, device=dev).index_add(
        0, code, ok.to(torch.int32))
    cols = {}
    gidx = torch.arange(domain, dtype=torch.int32, device=dev)
    for k, s in zip(p.keys, strides):
        dom_k = child.info.cols[k].group_domain
        cols[k] = torch.div(gidx, s, rounding_mode="floor") % dom_k

    def seg(vals, op, fill):
        if op == "sum" and vals.is_floating_point():
            # accumulate in f64: on a CUDA device index_add_ adds one row
            # at a time with atomics, and an f32 accumulator far larger
            # than its addends stops growing (q1 at SF 10 sums 15 M rows
            # into one group)
            acc = torch.zeros((domain,), dtype=torch.float64, device=dev)
            acc = acc.index_add(0, code, torch.where(ok, vals, 0).double())
            return acc.to(vals.dtype)
        out = torch.full((domain,), fill, dtype=vals.dtype, device=dev)
        if op == "sum":
            return out.index_add(0, code, torch.where(ok, vals, fill))
        return out.scatter_reduce(0, code, torch.where(ok, vals, fill), op)

    for a in p.aggs:
        if a.op == "count":
            cols[a.name] = cnt
            continue
        v = value(a)
        if a.op == "sum":
            cols[a.name] = seg(v, "sum", 0)
        elif a.op == "avg":
            s_ = seg(v, "sum", 0)
            cols[a.name] = s_ / torch.clamp(cnt, min=1).to(s_.dtype)
        elif a.op == "min":
            cols[a.name] = seg(v, "amin", type_max(v.dtype))
        elif a.op in ("max", "any"):
            # any: FD carry-along, all members equal: max of valid ones
            cols[a.name] = seg(v, "amax", type_min(v.dtype))
    return Stream(cols, cnt > 0, info, dev)


def _lower_sort(p: P.Sort, child: Stream, catalog: P.Catalog) -> Stream:
    mask = child.the_mask()
    # lexicographic: stable sorts from the least significant key up;
    # invalid rows go last (the most significant key)
    keys = []
    for name, asc in reversed(p.by):
        v = child.cols[name]
        if v.dtype == torch.bool:
            v = v.to(torch.int32)
        if not asc:
            v = -v
        keys.append(v)
    keys.append((~mask).to(torch.int32))
    order = torch.arange(child.n, device=child.device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    cols = {n: c[order] for n, c in child.cols.items()}
    return Stream(cols, mask[order], child.info, child.device)


def lower_node(p: P.Plan, catalog: P.Catalog, scans: Dict[Any, Any],
               params: Optional[Dict[str, Any]] = None) -> Stream:
    """Recursively lower ``p``; ``scans`` maps id(Scan) -> leaf Stream."""
    if id(p) in scans:
        return scans[id(p)]
    # custom-lowering protocol: plan nodes from outside the core (the
    # native dispatch's NativeOp) implement ``lower_stream(catalog,
    # scans, params)`` plus ``static_info_hook``/``required_columns_hook``
    hook = getattr(p, "lower_stream", None)
    if hook is not None:
        return hook(catalog, scans, params)
    if isinstance(p, P.Scan):
        raise KeyError(f"unbound scan {p.table}")
    if isinstance(p, P.Filter):
        child = lower_node(p.child, catalog, scans, params)
        pred = as_column(eval_expr(p.pred, child, params), child)
        mask = pred if child.mask is None else (child.mask & pred)
        return Stream(child.cols, mask, child.info, child.device)
    if isinstance(p, P.MapBatches):
        child = lower_node(p.child, catalog, scans, params)
        outs = p.fn({c: child.cols[c] for c in p.columns})
        if set(outs) != set(p.out_names):
            raise TypeError(
                f"map_batches {p.name!r} returned columns "
                f"{sorted(outs)}, declared schema is "
                f"{sorted(p.out_names)}")
        produced = set(p.out_names)
        cols = {n: v for n, v in child.cols.items() if n not in produced}
        scols = {n: sc for n, sc in child.info.cols.items()
                 if n not in produced}
        for f in p.out_fields:
            v = torch.as_tensor(outs[f.name], device=child.device)
            if tuple(v.shape) != (child.n,):
                raise TypeError(
                    f"map_batches {p.name!r} output {f.name!r} has shape "
                    f"{tuple(v.shape)}; expected ({child.n},) -- batch UDFs "
                    "must be length-preserving 1-D columns")
            cols[f.name] = v.to(TORCH_OF[f.dtype])
            scols[f.name] = StaticCol(f.dtype, None, f.domain)
        return Stream(cols, child.mask, StaticInfo(scols, child.n),
                      child.device)
    if isinstance(p, P.Project):
        child = lower_node(p.child, catalog, scans, params)
        cols = {}
        schema = p.child.schema(catalog)
        scols = {}
        for name, e in p.outputs:
            if isinstance(e, E.Col):
                scols[name] = child.info.cols[e.name]
            elif isinstance(e, E.WithDomain):
                inner = (child.info.cols[e.arg.name]
                         if isinstance(e.arg, E.Col)
                         else StaticCol(E.infer_dtype(e.arg, schema)))
                scols[name] = StaticCol(inner.dtype, inner.dictionary,
                                        e.domain)
            else:
                scols[name] = StaticCol(E.infer_dtype(e, schema))
            v = as_column(eval_expr(e, child, params), child)
            want = TORCH_OF[scols[name].dtype]
            cols[name] = v if v.dtype == want else v.to(want)
        return Stream(cols, child.mask, StaticInfo(scols, child.n),
                      child.device)
    if isinstance(p, P.Join):
        left = lower_node(p.left, catalog, scans, params)
        right = lower_node(p.right, catalog, scans, params)
        return _lower_join(p, left, right, catalog,
                           scans.get(index_stream_key(p)))
    if isinstance(p, P.Aggregate):
        child = lower_node(p.child, catalog, scans, params)
        return _lower_aggregate(p, child, catalog, params)
    if isinstance(p, P.Sort):
        child = lower_node(p.child, catalog, scans, params)
        return _lower_sort(p, child, catalog)
    if isinstance(p, P.Limit):
        child = lower_node(p.child, catalog, scans, params)
        n = min(p.n, child.n)
        cols = {c_: c[:n] for c_, c in child.cols.items()}
        mask = None if child.mask is None else child.mask[:n]
        return Stream(cols, mask, StaticInfo(child.info.cols, n),
                      child.device)
    raise TypeError(f"cannot lower plan node {p!r}")


# ---------------------------------------------------------------------------
# heterogeneous handoff: relational stream -> matrix -> training kernel
# ---------------------------------------------------------------------------


def resolve_hyper(p: P.IterativeKernel,
                  params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Bind the kernel's hyper-parameters: Param placeholders pull their
    runtime value (a 0-d tensor) from ``params``; literals pass through.
    Shape-affecting hypers (e.g. k-means ``k``) must be literals -- a
    Param there fails inside the kernel, by design."""
    out: Dict[str, Any] = {}
    for k, v in p.hyper:
        if isinstance(v, E.Param):
            if params is None or v.name not in params:
                raise KeyError(
                    f"unbound hyper-parameter {v.name!r} of kernel "
                    f"{p.kernel.name}; pass a binding, e.g. "
                    f"compiled({v.name}=...)")
            out[k] = params[v.name]
        elif isinstance(v, E.Expr):
            raise TypeError(
                f"hyper-parameter {k!r} of {p.kernel.name} must be a "
                f"literal or param(), got expression {v!r}")
        else:
            out[k] = v
    return out


def apply_kernel(p: P.IterativeKernel, stream: Stream,
                 params: Optional[Dict[str, Any]] = None):
    """Stack the feature columns of ``stream`` into an [n, d] float32
    matrix on the stream's device and run the training kernel on it --
    under the whole-query engine the relational operators and the
    kernel's loop run in ONE function, no column leaving the device
    (paper Fig. 8).

    The validity mask becomes the kernel's sample weights and invalid
    rows are zeroed (their padded contents are unspecified), so the
    padded result equals the compacted interpreters' result.
    """
    mask = stream.the_mask()
    w = mask.to(torch.float32)
    x = torch.stack([stream.cols[c].to(torch.float32) for c in p.features],
                    dim=1)
    x = torch.where(mask[:, None], x, 0.0)
    y = None
    if p.label is not None:
        y = torch.where(mask, stream.cols[p.label].to(torch.float32), 0.0)
    return p.kernel(x, y, weights=w, **resolve_hyper(p, params))


# ---------------------------------------------------------------------------
# whole-query entry point
# ---------------------------------------------------------------------------


def required_scan_columns(p: P.Plan, catalog: P.Catalog) -> Dict[int, List[str]]:
    """Columns each Scan must bind (after optimizer pruning, this is small)."""
    out: Dict[int, List[str]] = {}

    def rec(node: P.Plan, needed: Optional[set]):
        if isinstance(node, P.Scan):
            names = node.schema(catalog).names
            cols = [n for n in names if needed is None or n in needed]
            out[id(node)] = cols or names[:1]
            return
        if isinstance(node, P.Filter):
            need = None if needed is None else set(needed) | set(E.columns_of(node.pred))
            rec(node.child, need)
        elif isinstance(node, P.Project):
            # lower_node evaluates every Project output, so every
            # output's inputs are required
            need = set()
            for name, e in node.outputs:
                need |= set(E.columns_of(e))
            rec(node.child, need)
        elif isinstance(node, P.Join):
            lneed = None if needed is None else set()
            rneed = None if needed is None else set()
            if needed is not None:
                lnames = set(node.left.schema(catalog).names)
                for n in needed:
                    (lneed if n in lnames else rneed).add(n)
                lneed |= set(node.left_on)
                rneed |= set(node.right_on)
            rec(node.left, lneed)
            rec(node.right, rneed if node.how not in ("semi", "anti")
                else (None if needed is None else set(node.right_on)))
        elif isinstance(node, P.Aggregate):
            need = set(node.keys)
            for a in node.aggs:
                if a.arg is not None:
                    need |= set(E.columns_of(a.arg))
            rec(node.child, need)
        elif isinstance(node, (P.Sort, P.Limit)):
            need = needed
            if isinstance(node, P.Sort) and needed is not None:
                need = set(needed) | {n for n, _ in node.by}
            rec(node.child, need)
        elif isinstance(node, P.MapBatches):
            if needed is None:
                need = None  # every pass-through column may be consumed
            else:
                need = ((set(needed) - set(node.out_names))
                        | set(node.columns))
            rec(node.child, need)
        elif isinstance(node, P.IterativeKernel):
            rec(node.child, set(node.required_columns()))
        elif hasattr(node, "required_columns_hook"):
            node.required_columns_hook(rec, needed)
        else:
            raise TypeError(f"cannot lower plan node {node!r}")

    rec(p, None)
    return out


def scan_paths(p: P.Plan) -> Dict[int, Tuple[int, ...]]:
    """Map ``id(Scan)`` -> root-to-scan child-index path.

    The path is a *structural* identity: it survives plan rebuilds
    (optimizer rewrites, ``with_children`` copies) that change every
    node's address, so it is the right key to hand to observability
    layers that outlive the plan object they were computed from.
    """
    out: Dict[int, Tuple[int, ...]] = {}

    def rec(node: P.Plan, path: Tuple[int, ...]) -> None:
        if isinstance(node, P.Scan):
            out[id(node)] = path
        for i, c in enumerate(node.children()):
            rec(c, path + (i,))

    rec(p, ())
    return out


def required_scan_columns_by_path(
        p: P.Plan, catalog: P.Catalog) -> Dict[Tuple[int, ...], List[str]]:
    """:func:`required_scan_columns`, keyed by child-index path instead
    of ``id(node)`` -- stable across plan copies and GC address reuse."""
    needed = required_scan_columns(p, catalog)
    paths = scan_paths(p)
    return {paths[sid]: cols for sid, cols in needed.items()
            if sid in paths}


@dataclasses.dataclass
class Result:
    """Execution result: padded host columns + validity mask + schema."""

    cols: Dict[str, np.ndarray]
    mask: Optional[np.ndarray]
    schema: T.Schema
    dicts: Dict[str, Optional[Tuple[str, ...]]]

    def num_rows(self) -> int:
        if self.mask is None:
            return len(next(iter(self.cols.values())))
        return int(self.mask.sum())

    def compact(self) -> Dict[str, np.ndarray]:
        """Valid rows only, strings decoded, host dtypes per schema."""
        if self.mask is None:
            sel = slice(None)
        else:
            sel = np.flatnonzero(self.mask)
        out = {}
        for f in self.schema:
            arr = np.asarray(self.cols[f.name])[sel]
            d = self.dicts.get(f.name)
            if d is not None:
                lut = np.asarray(d, dtype=object)
                out[f.name] = lut[arr]
            elif f.dtype == T.STRING and arr.dtype == object:
                out[f.name] = arr  # already-decoded strings (tuple engine)
            else:
                out[f.name] = arr.astype(T.numpy_dtype(f.dtype))
        return out

    def scalar(self, name: Optional[str] = None):
        c = self.compact()
        if name is None:
            name = next(iter(c))
        return c[name][0]


@dataclasses.dataclass
class ValueResult:
    """Non-relational execution result: the output of a plan rooted at
    :class:`repro_torch.core.plan.IterativeKernel` (e.g. a
    ``KMeansResult``), every tensor as a host numpy array.  Quacks
    enough like :class:`Result` for the stages API -- ``compact()`` is
    the identity on the value."""

    value: Any

    def compact(self):
        return self.value

    def num_rows(self) -> int:
        raise TypeError("a trained-kernel result has no row count; "
                        "use .value / compact()")

    def scalar(self, name: Optional[str] = None):
        raise TypeError("a trained-kernel result has no scalar columns; "
                        "use .value / compact()")


def build_callable(p: P.Plan, catalog: P.Catalog,
                   param_specs: Sequence[E.Param] = ()
                   ) -> Tuple[Callable[..., Any], List[Tuple[int, List[str]]],
                              List[JoinIndexSpec], Optional[StaticInfo]]:
    """Build the function over flat scan-column tensors.

    Returns (fn, arg_layout, index_layout, out_info) where arg_layout
    lists (scan_node_id, column_names) in argument order.  After the
    scan columns ``fn`` takes one (perm, sorted keys, meta) int32 triple
    per entry of ``index_layout`` -- the joins whose build side is served
    by the cached base-table index (``repro_torch.core.engines.
    IndexCache``) -- and then one 0-d tensor per ``param_specs`` entry,
    in spec order.
    Setting ``p._join_index_disabled`` keeps every join on its
    in-program sort.

    For a relational plan ``fn`` returns ``(out_cols, mask)``.  For a
    plan rooted at :class:`repro_torch.core.plan.IterativeKernel` -- the
    heterogeneous pipeline -- ``fn`` returns the kernel's result on the
    device instead, the relational half flowing straight into the
    training loop (``out_info`` is None).
    """
    needed = required_scan_columns(p, catalog)
    scan_nodes: List[P.Scan] = []

    def collect(node: P.Plan):
        if isinstance(node, P.Scan):
            scan_nodes.append(node)
        for c in node.children():
            collect(c)

    collect(p)
    layout = [(id(s), needed[id(s)]) for s in scan_nodes]
    statics = {id(s): _static_of_scan(catalog.table(s.table))
               for s in scan_nodes}
    if getattr(p, "_join_index_disabled", False):
        index_specs: Dict[int, JoinIndexSpec] = {}
    else:
        index_specs, _ = join_index_plan(p, catalog)
    index_items = list(index_specs.items())  # plan-walk order = arg order
    index_layout = [spec for _, spec in index_items]
    ml_root = isinstance(p, P.IterativeKernel)
    out_info = None if ml_root else static_info(p, catalog)
    param_specs = tuple(param_specs)
    out_names = None if ml_root else p.schema(catalog).names

    def fn(device: torch.device, *flat):
        it = iter(flat)
        scans: Dict[Any, Any] = {}
        for s in scan_nodes:
            cols = {name: next(it) for name in needed[id(s)]}
            static = StaticInfo(
                {n: statics[id(s)].cols[n] for n in needed[id(s)]},
                statics[id(s)].n_rows)
            scans[id(s)] = Stream(cols, None, static, device)
        for jid, _spec in index_items:
            scans[("joinidx", jid)] = (next(it), next(it), next(it))
        env = {spec.name: next(it) for spec in param_specs}
        if ml_root:
            stream = lower_node(p.child, catalog, scans, env or None)
            return apply_kernel(p, stream, env or None)
        stream = lower_node(p, catalog, scans, env or None)
        out_cols = {n: as_column(stream.cols[n], stream) for n in out_names}
        return out_cols, stream.the_mask()

    return fn, layout, index_layout, out_info


def build_batch_callable(p: P.Plan, catalog: P.Catalog,
                         param_specs: Sequence[E.Param],
                         ) -> Tuple[Callable[..., Any],
                                    List[Tuple[int, List[str]]],
                                    List[JoinIndexSpec],
                                    Optional[StaticInfo]]:
    """Build the vmap-coalesced variant of :func:`build_callable`.

    All bindings of one prepared template run the same function over the
    same tables -- only the ``param()`` scalars differ -- so a queue of B
    same-template requests is one batched call, not B.  The returned
    ``bfn(device, *flat)`` takes the same scan-column and join-index
    arguments as the single-binding function (shared, ``in_dims=None``)
    and one ``[B]`` tensor per param spec (the stacked bindings,
    ``in_dims=0``); every output gains a leading ``[B]`` axis.  The device
    stays outside the vmapped arguments.

    ``torch.func.vmap`` keeps the sharing real: operators that do not
    depend on a param (scans, index probes of param-free joins,
    dictionary gathers) run once, unbatched, and only the param-dependent
    dataflow fans out over the batch axis -- materialised at ``[B, n]``,
    since PyTorch runs each operator eagerly.

    Raises for a param-free template: with no binding axis, every request
    is the same execution -- run it once and share the result
    (``repro_torch.core.stages.Compiled.batch`` does exactly that).
    """
    param_specs = tuple(param_specs)
    if not param_specs:
        raise ValueError(
            "build_batch_callable needs param() placeholders; a "
            "param-free template has no binding axis -- execute it once "
            "and share the result across requests")
    fn, layout, index_layout, out_info = build_callable(p, catalog,
                                                        param_specs)
    n_shared = (sum(len(names) for _, names in layout)
                + 3 * len(index_layout))
    in_dims = (None,) * n_shared + (0,) * len(param_specs)

    def bfn(device: torch.device, *flat):
        return torch.func.vmap(lambda *a: fn(device, *a),
                               in_dims=in_dims)(*flat)

    return bfn, layout, index_layout, out_info
