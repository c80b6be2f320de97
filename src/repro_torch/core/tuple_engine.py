"""Tuple-at-a-time Volcano engine (Graefe-style open/next/close).

The paper's interpreted baseline (Postgres, and the per-tuple iterator
glue inside Spark that Fig. 5 shows eating 80% of Q6) processes one row
per operator call through dynamic dispatch.  The ``volcano`` engine in
``engines.py`` is column-at-a-time numpy -- already vectorised, i.e. a
MonetDB-class baseline -- so this module supplies the genuinely
row-at-a-time engine for the Fig. 4/9 "interpreted" rows: Python
generators per operator, per-row expression interpretation, per-row hash
probes.  Every per-row virtual call the paper talks about is a real
Python call here.  It runs on the host whatever the context's device.

Correctness is differentially tested against the other engines; speed is
the *point* (it is the measured overhead).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.core import engines as ENG
from repro_torch.core import expr as E
from repro_torch.core import lower as L
from repro_torch.core import ml as ML
from repro_torch.core import plan as P
from repro_torch.relational import table as T

Row = Dict[str, Any]


def _eval_row(e: E.Expr, row: Row):
    if isinstance(e, E.Col):
        return row[e.name]
    if isinstance(e, E.Lit):
        return e.value
    if isinstance(e, E.BinOp):
        l, r = _eval_row(e.left, row), _eval_row(e.right, row)
        if e.op == "+":
            return l + r
        if e.op == "-":
            return l - r
        if e.op == "*":
            return l * r
        return l / r
    if isinstance(e, E.Cmp):
        l, r = _eval_row(e.left, row), _eval_row(e.right, row)
        return {"<": l < r, "<=": l <= r, ">": l > r, ">=": l >= r,
                "==": l == r, "!=": l != r}[e.op]
    if isinstance(e, E.BoolOp):
        if e.op == "and":
            return all(_eval_row(a, row) for a in e.args)
        return any(_eval_row(a, row) for a in e.args)
    if isinstance(e, E.Not):
        return not _eval_row(e.arg, row)
    if isinstance(e, E.InSet):
        return _eval_row(e.arg, row) in e.values
    if isinstance(e, E.StrPred):
        s = _eval_row(e.arg, row)
        return E.match_str(e.kind, s, e.params)
    if isinstance(e, E.IfThenElse):
        return (_eval_row(e.then, row) if _eval_row(e.cond, row)
                else _eval_row(e.other, row))
    if isinstance(e, E.Cast):
        return T.numpy_dtype(e.dtype).type(_eval_row(e.arg, row)).item()
    if isinstance(e, E.WithDomain):
        return _eval_row(e.arg, row)
    if isinstance(e, E.Udf):
        args = [ENG.host_tensor(np.asarray([_eval_row(a, row)]))
                for a in e.args]
        return float(ENG.host_array(e.fn(*args))[0])
    raise TypeError(e)


class TupleEngine:
    """Row-at-a-time interpreter; Param placeholders must already be
    bound (``repro_torch.core.stages.bind_params``)."""

    def execute(self, p: P.Plan, catalog: P.Catalog, cache=None):
        if isinstance(p, P.IterativeKernel):
            return self._train(p, catalog)
        schema = p.schema(catalog)
        rows = list(self._iter(p, catalog))
        cols: Dict[str, np.ndarray] = {}
        for f in schema:
            vals = [r[f.name] for r in rows]
            if f.dtype == T.STRING:
                cols[f.name] = np.asarray(vals, dtype=object)
            else:
                cols[f.name] = np.asarray(vals,
                                          dtype=T.numpy_dtype(f.dtype))
        return L.Result(cols, None, schema,
                        {f.name: None for f in schema})

    def _train(self, p: P.IterativeKernel,
               catalog: P.Catalog) -> L.ValueResult:
        """Row-at-a-time ETL feeding the kernel: rows are gathered one by
        one (the interpreted baseline), then trained in one batch on CPU
        float32 tensors.  Hyper Params must already be bound
        (``stages.bind_params``)."""
        rows = list(self._iter(p.child, catalog))
        d = len(p.features)
        x = torch.tensor([[row[c] for c in p.features] for row in rows],
                         dtype=torch.float32).reshape(len(rows), d)
        y = (torch.tensor([row[p.label] for row in rows],
                          dtype=torch.float32)
             if p.label is not None else None)
        w = torch.ones((len(rows),), dtype=torch.float32)
        for k, v in p.hyper:
            if isinstance(v, E.Expr):
                raise TypeError(
                    f"tuple engine needs bound hyper-parameters; "
                    f"{k!r} is still {v!r}")
        out = p.kernel(x, y, weights=w, **dict(p.hyper))
        return L.ValueResult(ML.to_host(out))

    # -- iterators -------------------------------------------------------------

    def _iter(self, p: P.Plan, catalog: P.Catalog) -> Iterator[Row]:
        if isinstance(p, P.Scan):
            tbl = catalog.table(p.table)
            names = tbl.schema.names
            decoded = [tbl.columns[n].decode() for n in names]
            for i in range(tbl.num_rows):
                yield {n: decoded[j][i].item()
                       if hasattr(decoded[j][i], "item")
                       else decoded[j][i]
                       for j, n in enumerate(names)}
        elif isinstance(p, P.Filter):
            for row in self._iter(p.child, catalog):
                if _eval_row(p.pred, row):      # per-row interpretation
                    yield row
        elif isinstance(p, P.Project):
            for row in self._iter(p.child, catalog):
                yield {name: _eval_row(e, row) for name, e in p.outputs}
        elif isinstance(p, P.MapBatches):
            # one-row batches: each row becomes a length-1 column dict --
            # every per-row call the paper talks about is a real call here
            produced = set(p.out_names)
            for row in self._iter(p.child, catalog):
                outs = p.fn({c: ENG.host_tensor(np.asarray([row[c]]))
                             for c in p.columns})
                if set(outs) != produced:
                    raise TypeError(
                        f"map_batches {p.name!r} returned {sorted(outs)}, "
                        f"declared {sorted(produced)}")
                new = {n: v for n, v in row.items() if n not in produced}
                for f in p.out_fields:
                    arr = ENG.host_array(outs[f.name])
                    if arr.shape != (1,):
                        raise TypeError(
                            f"map_batches {p.name!r} output {f.name!r} "
                            f"has shape {arr.shape} for a 1-row batch; "
                            "batch UDFs must be length-preserving")
                    new[f.name] = arr.astype(T.numpy_dtype(f.dtype))[0].item()
                yield new
        elif isinstance(p, P.Join):
            build: Dict[Tuple, Row] = {}
            for row in self._iter(p.right, catalog):
                key = tuple(row[k] for k in p.right_on)
                build.setdefault(key, row)
            payload = [n for n in p.right.schema(catalog).names
                       if n not in p.right_on]
            for row in self._iter(p.left, catalog):   # per-row probe
                key = tuple(row[k] for k in p.left_on)
                match = build.get(key)
                if p.how == "semi":
                    if match is not None:
                        yield row
                elif p.how == "anti":
                    if match is None:
                        yield row
                elif p.how == "inner":
                    if match is not None:
                        out = dict(row)
                        for n in payload:
                            out[n] = match[n]
                        yield out
                else:  # left
                    out = dict(row)
                    for n in payload:
                        out[n] = match[n] if match is not None else 0
                    yield out
        elif isinstance(p, P.Aggregate):
            yield from self._aggregate(p, catalog)
        elif isinstance(p, P.Sort):
            rows = list(self._iter(p.child, catalog))
            for name, asc in reversed(p.by):
                rows.sort(key=lambda r: r[name], reverse=not asc)
            yield from rows
        elif isinstance(p, P.Limit):
            for i, row in enumerate(self._iter(p.child, catalog)):
                if i >= p.n:
                    break
                yield row
        else:
            raise TypeError(p)

    def _aggregate(self, p: P.Aggregate, catalog) -> Iterator[Row]:
        groups: Dict[Tuple, List] = {}
        if not p.keys:  # global aggregates emit a row even on empty input
            groups[()] = [self._init_acc(a) for a in p.aggs]
        for row in self._iter(p.child, catalog):
            key = tuple(row[k] for k in p.keys)
            acc = groups.get(key)
            if acc is None:
                acc = groups[key] = [self._init_acc(a) for a in p.aggs]
            for a, slot in zip(p.aggs, acc):
                self._update_acc(a, slot, row)
        for key in sorted(groups, key=lambda k: tuple(map(str, k))):
            out: Row = {k: v for k, v in zip(p.keys, key)}
            for a, slot in zip(p.aggs, groups[key]):
                out[a.name] = self._final_acc(a, slot)
            yield out

    @staticmethod
    def _init_acc(a: P.AggSpec) -> List:
        if a.op in ("sum", "count"):
            return [0.0]
        if a.op == "avg":
            return [0.0, 0]
        if a.op == "min":
            return [float("inf")]
        if a.op == "max":
            return [float("-inf")]
        return [None]  # any

    @staticmethod
    def _update_acc(a: P.AggSpec, slot: List, row: Row) -> None:
        if a.op == "count":
            slot[0] += 1
            return
        v = _eval_row(a.arg, row)
        if a.op == "sum":
            slot[0] += v
        elif a.op == "avg":
            slot[0] += v
            slot[1] += 1
        elif a.op == "min":
            slot[0] = min(slot[0], v)
        elif a.op == "max":
            slot[0] = max(slot[0], v)
        elif a.op == "any":
            slot[0] = v if slot[0] is None else slot[0]

    @staticmethod
    def _final_acc(a: P.AggSpec, slot: List):
        if a.op == "avg":
            return slot[0] / max(slot[1], 1)
        if a.op == "count":
            return int(slot[0])
        return slot[0]
