"""Rule-based plan optimizer -- the Catalyst analogue.

Rules (paper section 2.3 describes Catalyst; section 6.1 notes Catalyst
does *no* join reordering -- we implement it anyway as a beyond-paper
optimization, off by default for paper parity):

* constant folding inside expressions,
* filter combination (adjacent Filters merge into one conjunction),
* predicate pushdown (below Project when possible, into either side of a
  Join when the predicate only references that side),
* projection pruning (drop unused Project outputs; insert narrow Projects
  above Scans so the compiled program binds only needed columns),
* join strategy selection by estimated build-side size
  ('sorted' = in-memory hash-join analogue vs 'sortmerge'; paper Fig. 6),
* optional greedy cost-based join reordering.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core import expr as E
from repro_torch.core import plan as P

# ---------------------------------------------------------------------------
# expression rules
# ---------------------------------------------------------------------------


def fold_constants(e: E.Expr) -> E.Expr:
    def rule(x: E.Expr) -> Optional[E.Expr]:
        if isinstance(x, E.BinOp) and isinstance(x.left, E.Lit) \
                and isinstance(x.right, E.Lit):
            l, r = x.left.value, x.right.value
            out = {"+": l + r, "-": l - r, "*": l * r,
                   "/": l / r if r != 0 else None}[x.op]
            if out is not None:
                return E.Lit(out)
        if isinstance(x, E.Not) and isinstance(x.arg, E.Not):
            return x.arg.arg
        if isinstance(x, E.BoolOp):
            # flatten nested and/and, or/or
            flat: List[E.Expr] = []
            changed = False
            for a in x.args:
                if isinstance(a, E.BoolOp) and a.op == x.op:
                    flat.extend(a.args)
                    changed = True
                else:
                    flat.append(a)
            if changed:
                return E.BoolOp(x.op, tuple(flat))
        return None

    return E.map_expr(e, rule)


def split_conjuncts(e: E.Expr) -> List[E.Expr]:
    if isinstance(e, E.BoolOp) and e.op == "and":
        out: List[E.Expr] = []
        for a in e.args:
            out.extend(split_conjuncts(a))
        return out
    return [e]


def conjoin(preds: List[E.Expr]) -> E.Expr:
    if len(preds) == 1:
        return preds[0]
    return E.BoolOp("and", tuple(preds))


# ---------------------------------------------------------------------------
# plan rules
# ---------------------------------------------------------------------------


def combine_filters(p: P.Plan) -> P.Plan:
    def rule(n: P.Plan) -> Optional[P.Plan]:
        if isinstance(n, P.Filter) and isinstance(n.child, P.Filter):
            return P.Filter(n.child.child,
                            conjoin([n.child.pred, n.pred]))
        return None

    return P.transform(p, rule)


def push_predicates(p: P.Plan, catalog: P.Catalog) -> P.Plan:
    """Push filter conjuncts through Projects and into Join sides."""

    def rule(n: P.Plan) -> Optional[P.Plan]:
        if not isinstance(n, P.Filter):
            return None
        child = n.child
        if isinstance(child, P.Project):
            # rewrite pred in terms of project inputs if all outputs
            # referenced are simple column aliases
            mapping = {name: e for name, e in child.outputs}
            ok = all(isinstance(mapping.get(c), (E.Col,))
                     for c in E.columns_of(n.pred))
            if ok:
                new_pred = E.map_expr(
                    n.pred,
                    lambda x: mapping[x.name] if isinstance(x, E.Col) else None)
                return P.Project(P.Filter(child.child, new_pred),
                                 child.outputs)
        if isinstance(child, P.MapBatches):
            # the UDF's declared column dependencies are what make this
            # safe: conjuncts not touching any produced column commute
            # with a row-wise batch UDF (DESIGN.md section 7)
            produced = set(child.out_names)
            below, keep = [], []
            for c in split_conjuncts(n.pred):
                (keep if set(E.columns_of(c)) & produced
                 else below).append(c)
            if below:
                pushed = P.MapBatches(
                    P.Filter(child.child, conjoin(below)), child.fn,
                    child.columns, child.out_fields, child.name)
                return P.Filter(pushed, conjoin(keep)) if keep else pushed
        if isinstance(child, P.Join):
            lnames = set(child.left.schema(catalog).names)
            rnames = (set() if child.how in ("semi", "anti")
                      else set(child.right.schema(catalog).names))
            left_preds, right_preds, keep = [], [], []
            for c in split_conjuncts(n.pred):
                cols = set(E.columns_of(c))
                if cols <= lnames:
                    left_preds.append(c)
                elif cols <= rnames and child.how == "inner":
                    right_preds.append(c)
                else:
                    keep.append(c)
            if left_preds or right_preds:
                new_left = (P.Filter(child.left, conjoin(left_preds))
                            if left_preds else child.left)
                new_right = (P.Filter(child.right, conjoin(right_preds))
                             if right_preds else child.right)
                new_join = P.Join(new_left, new_right, child.left_on,
                                  child.right_on, child.how, child.strategy)
                return P.Filter(new_join, conjoin(keep)) if keep else new_join
        return None

    # iterate to fixpoint (pushdowns enable further pushdowns)
    prev = None
    while prev is not p:
        prev = p
        p = combine_filters(P.transform(p, rule))
    return p


def prune_projections(p: P.Plan, catalog: P.Catalog) -> P.Plan:
    """Top-down required-column analysis; narrows Projects and adds
    column-pruning Projects directly above Scans."""

    def rec(n: P.Plan, needed: Optional[Set[str]]) -> P.Plan:
        if isinstance(n, P.Scan):
            names = n.schema(catalog).names
            if needed is None or set(names) <= needed:
                return n
            keep = [m for m in names if m in needed] or names[:1]
            return P.Project(n, tuple((m, E.col(m)) for m in keep))
        if isinstance(n, P.Filter):
            need = (None if needed is None
                    else needed | set(E.columns_of(n.pred)))
            return P.Filter(rec(n.child, need), n.pred)
        if isinstance(n, P.Project):
            outputs = (n.outputs if needed is None
                       else tuple((m, e) for m, e in n.outputs
                                  if m in needed) or n.outputs[:1])
            need: Set[str] = set()
            for _, e in outputs:
                need |= set(E.columns_of(e))
            return P.Project(rec(n.child, need), outputs)
        if isinstance(n, P.Join):
            lnames = set(n.left.schema(catalog).names)
            if needed is None:
                lneed: Optional[Set[str]] = None
                rneed: Optional[Set[str]] = None
            else:
                lneed = {m for m in needed if m in lnames} | set(n.left_on)
                rneed = ({m for m in needed if m not in lnames}
                         | set(n.right_on))
            if n.how in ("semi", "anti"):
                rneed = set(n.right_on)
            return P.Join(rec(n.left, lneed), rec(n.right, rneed),
                          n.left_on, n.right_on, n.how, n.strategy)
        if isinstance(n, P.Aggregate):
            need = set(n.keys)
            for a in n.aggs:
                if a.arg is not None:
                    need |= set(E.columns_of(a.arg))
            return P.Aggregate(rec(n.child, need), n.keys, n.aggs)
        if isinstance(n, P.Sort):
            need = (None if needed is None
                    else needed | {m for m, _ in n.by})
            return P.Sort(rec(n.child, need), n.by)
        if isinstance(n, P.Limit):
            return P.Limit(rec(n.child, needed), n.n)
        if isinstance(n, P.MapBatches):
            need = (None if needed is None
                    else ((needed - set(n.out_names)) | set(n.columns)))
            return P.MapBatches(rec(n.child, need), n.fn, n.columns,
                                n.out_fields, n.name)
        if isinstance(n, P.IterativeKernel):
            return P.IterativeKernel(
                rec(n.child, set(n.required_columns())), n.kernel,
                n.features, n.label, n.hyper)
        raise TypeError(n)

    return rec(p, None)


# ---------------------------------------------------------------------------
# join strategy + reordering
# ---------------------------------------------------------------------------


#: Selectivity guess for predicate shapes with no usable statistics
#: (range comparisons, UDFs, ...): the classic 1/3.
_DEFAULT_SELECTIVITY = 1.0 / 3.0


def _pred_stats(e: E.Expr, p: P.Plan, catalog: P.Catalog
                ) -> Tuple[Optional[Tuple[str, ...]], Optional[int]]:
    """(dictionary, domain) of the column a predicate side references,
    walking simple Project aliases down to the backing Scan for the
    dictionary (domains ride on the schema already)."""
    if not isinstance(e, E.Col):
        return None, None
    schema = p.schema(catalog)
    if e.name not in schema:
        return None, None
    domain = schema[e.name].domain
    name, node = e.name, p
    while True:
        if isinstance(node, P.Scan):
            return catalog.table(node.table).dictionary(name), domain
        if isinstance(node, P.Filter):
            node = node.child
            continue
        if isinstance(node, P.Project):
            target = dict(node.outputs).get(name)
            if isinstance(target, E.WithDomain):
                target = target.arg
            if not isinstance(target, E.Col):
                return None, domain
            name, node = target.name, node.child
            continue
        return None, domain


def _conjunct_selectivity(c: E.Expr, p: P.Plan,
                          catalog: P.Catalog) -> float:
    """Dictionary/domain-aware selectivity of one filter conjunct.

    Equality against a literal on a dictionary column hits 1/|dict| of
    the rows (uniform-dictionary assumption); dense-domain ints
    likewise 1/domain; ``isin`` scales by the member count; string
    predicates evaluate their LUT over the dictionary EXACTLY (the same
    dispatch-time evaluation the compiled engine bakes in).  Everything
    else keeps the 1/3 guess.
    """
    if isinstance(c, E.Cmp) and c.op in ("==", "!="):
        sides = ((c.left, c.right), (c.right, c.left))
        for colside, litside in sides:
            if not isinstance(litside, E.Lit):
                continue
            d, dom = _pred_stats(colside, p, catalog)
            card = len(d) if d is not None else dom
            if card:
                sel = 1.0 / card
                return sel if c.op == "==" else 1.0 - sel
    if isinstance(c, E.InSet):
        d, dom = _pred_stats(c.arg, p, catalog)
        card = len(d) if d is not None else dom
        if card:
            return min(1.0, len(c.values) / card)
    if isinstance(c, E.StrPred):
        d, _ = _pred_stats(c.arg, p, catalog)
        if d:
            lut = [E.match_str(c.kind, s, c.params) for s in d]
            return max(sum(lut) / len(lut), 1e-6)
    if isinstance(c, E.BoolOp) and c.op == "or":
        disj = 1.0
        for a in c.args:
            disj *= 1.0 - _conjunct_selectivity(a, p, catalog)
        return 1.0 - disj
    if isinstance(c, E.Not):
        return 1.0 - _conjunct_selectivity(c.arg, p, catalog)
    return _DEFAULT_SELECTIVITY


def filter_selectivity(pred: E.Expr, child: P.Plan,
                       catalog: P.Catalog) -> float:
    """Estimated surviving fraction of a Filter (conjuncts independent)."""
    sel = 1.0
    for c in split_conjuncts(pred):
        sel *= _conjunct_selectivity(c, child, catalog)
    return sel


def estimate_rows(p: P.Plan, catalog: P.Catalog) -> int:
    if isinstance(p, P.Scan):
        return catalog.table(p.table).num_rows
    if isinstance(p, P.Filter):
        child = estimate_rows(p.child, catalog)
        return max(1, int(child * filter_selectivity(p.pred, p.child,
                                                     catalog)))
    if isinstance(p, P.Project):
        return estimate_rows(p.child, catalog)
    if isinstance(p, P.Join):
        return estimate_rows(p.left, catalog)  # N:1 keeps probe cardinality
    if isinstance(p, P.Aggregate):
        return max(1, estimate_rows(p.child, catalog) // 10)
    if isinstance(p, (P.Sort,)):
        return estimate_rows(p.child, catalog)
    if isinstance(p, P.Limit):
        return min(p.n, estimate_rows(p.child, catalog))
    if isinstance(p, P.MapBatches):
        return estimate_rows(p.child, catalog)
    if isinstance(p, P.IterativeKernel):
        return 1
    raise TypeError(p)


def pick_join_strategies(p: P.Plan, catalog: P.Catalog) -> P.Plan:
    def rule(n: P.Plan) -> Optional[P.Plan]:
        if isinstance(n, P.Join) and n.strategy is None:
            # small build side -> 'sorted' (the in-memory hash analogue);
            # the planner never voluntarily picks 'sortmerge' (paper Fig. 6
            # shows it is the wrong default for main memory).
            return P.Join(n.left, n.right, n.left_on, n.right_on, n.how,
                          "sorted")
        return None

    return P.transform(p, rule)


def reorder_joins(p: P.Plan, catalog: P.Catalog) -> P.Plan:
    """Greedy smallest-build-first reordering of left-deep N:1 join chains.

    Beyond-paper: Catalyst (2017) had no join reordering at all (paper
    section 2.3); Flare matched HyPer's orders by hand.  A chain
    ``probe ⋈ b1 ⋈ b2 ⋈ ...`` where each build is independent of the others
    can be reordered so the most selective (smallest) builds run first.
    """

    def rule(n: P.Plan) -> Optional[P.Plan]:
        if not isinstance(n, P.Join) or n.how != "inner":
            return None
        # collect the chain of inner joins along the left spine
        chain: List[P.Join] = []
        cur: P.Plan = n
        while isinstance(cur, P.Join) and cur.how == "inner":
            chain.append(cur)
            cur = cur.left
        if len(chain) < 2:
            return None
        probe = cur
        probe_names = set(probe.schema(catalog).names)
        builds = []
        for j in reversed(chain):
            # keys must come from the original probe side for safe reorder
            if not set(j.left_on) <= probe_names:
                return None
            builds.append((estimate_rows(j.right, catalog), j))
        builds.sort(key=lambda t: t[0])
        out: P.Plan = probe
        for _, j in builds:
            out = P.Join(out, j.right, j.left_on, j.right_on, j.how,
                         j.strategy)
        return out

    return P.transform(p, rule)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def optimize(p: P.Plan, catalog: P.Catalog,
             join_reorder: bool = False) -> P.Plan:
    def fold(n: P.Plan) -> Optional[P.Plan]:
        if isinstance(n, P.Filter):
            return P.Filter(n.child, fold_constants(n.pred))
        return None

    p = P.transform(p, fold)
    p = combine_filters(p)
    p = push_predicates(p, catalog)
    if join_reorder:
        p = reorder_joins(p, catalog)
    p = pick_join_strategies(p, catalog)
    p = prune_projections(p, catalog)
    return p
