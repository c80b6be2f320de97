"""EXPLAIN ANALYZE: run a query under the tracer and render what happened.

``df.explain(analyze=True)`` lands here: the full lifecycle
(optimize -> dispatch -> lower -> compile -> persist -> execute) runs
inside a :func:`repro_torch.obs.trace.capture` window, and the report
renders (in the JAX package's layout, ``repro.obs.analyze``)

* the optimized plan tree with rows / bound columns / bytes per Scan,
* per-phase wall times from the captured spans -- the same numbers a
  ``FLARE_TRACE=1`` Chrome-trace dump carries,
* compile provenance (memory-cache hit, disk tier, persist verdict),
* the native dispatch report: which kernel patterns fired, which
  fragments fell back and why, and per-join index provenance,
* the raw span tree for anything deeper.

Works on every registered engine; interpreted engines simply show fewer
phases (no compile/persist spans).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs import trace as OT

#: Lifecycle phases in report order (span names used by the pipeline).
PHASES = ("optimize", "dispatch", "lower", "compile", "persist", "execute")


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024.0
    return f"{n}B"


def _plan_tree(p, catalog, scan_cols: Dict[tuple, List[str]]) -> str:
    """Render the plan; ``scan_cols`` is keyed by root-to-scan child-index
    path (NOT ``id(node)`` -- addresses are recycled after GC and do not
    survive the plan copies the lowering pipeline makes)."""
    from repro_torch.core import plan as P
    lines: List[str] = []

    def rec(node, depth, path):
        desc = node.describe()
        if isinstance(node, P.Scan) and node.table in catalog:
            tbl = catalog.table(node.table)
            cols = scan_cols.get(path)
            names = cols if cols is not None else list(tbl.schema.names)
            nbytes = sum(tbl.columns[c].data.nbytes
                         for c in names if c in tbl.columns)
            desc += (f"  [rows={tbl.num_rows} cols={len(names)} "
                     f"bytes={_fmt_bytes(nbytes)}]")
        lines.append("  " * depth + ("*" if depth == 0 else "+- ") + desc)
        for i, c in enumerate(node.children()):
            rec(c, depth + 1, path + (i,))

    rec(p, 0, ())
    return "\n".join(lines)


def _phase_lines(trace: OT.Trace) -> List[str]:
    lines = []
    for phase in PHASES:
        spans = trace.find(phase)
        if not spans:
            continue
        total_ms = sum(s.duration_s for s in spans) * 1e3
        attrs: Dict[str, Any] = {}
        for s in sorted(spans, key=lambda s: s.t0):
            attrs.update(s.attrs)
        kv = " ".join(f"{k}={OT._short(v)}" for k, v in attrs.items())
        count = f" x{len(spans)}" if len(spans) > 1 else ""
        lines.append(f"{phase:<10}{total_ms:>10.3f} ms{count}"
                     + (f"  {kv}" if kv else ""))
    return lines


def _dispatch_lines(report) -> List[str]:
    lines: List[str] = []
    for d in getattr(report, "decisions", ()):
        verdict = "FIRED" if d.fired else "fallback"
        why = d.mode if d.fired else d.reason
        lines.append(f"{verdict:<9}{d.pattern:<22}{d.node}  [{why}]")
    for d in getattr(report, "index_decisions", ()):
        verdict = "indexed" if d.fired else "inline"
        lines.append(f"{verdict:<9}{d.pattern:<22}{d.node}  [{d.reason}]")
    return lines


def explain_analyze(df, engine: str = "compiled", native: bool = False,
                    params: Optional[Dict[str, Any]] = None,
                    mesh: Optional[Any] = None, axis: str = "data",
                    join_index: bool = True,
                    spans: bool = True) -> str:
    """Execute ``df`` once under the tracer and render the annotated
    plan + lifecycle report (the body of ``df.explain(analyze=True)``)."""
    from repro_torch.core import lower as L
    with OT.capture() as trace:
        lowered = df.lower(engine=engine, native=native, mesh=mesh,
                           axis=axis, join_index=join_index)
        compiled = lowered.compile()
        result = compiled.result(**(params or {}))

    plan = lowered.plan()
    catalog = df.ctx.catalog
    try:
        scan_cols = L.required_scan_columns_by_path(plan, catalog)
    except Exception:
        scan_cols = {}
    try:
        rows_out = result.num_rows()
    except Exception:
        rows_out = None

    out: List[str] = []
    out.append(f"== Physical Plan (analyzed: engine={compiled.engine_name}"
               + (f", {len(params)} bound param(s)" if params else "")
               + ") ==")
    out.append(_plan_tree(plan, catalog, scan_cols))

    out.append("")
    out.append("== Query Lifecycle ==")
    out.extend(_phase_lines(trace))
    stats = compiled.stats
    prov = [f"cache={'hit' if stats.cache_hit else 'miss'}",
            f"disk={'hit' if stats.disk_hit else 'miss'}"]
    if stats.persist:
        prov.append(f"persist={stats.persist}")
    prov.append(f"trace_compile_s={stats.trace_compile_s:.4f}")
    prov.append(f"run_s={stats.run_s:.6f}")
    if rows_out is not None:
        prov.append(f"rows_out={rows_out}")
    out.append("provenance: " + " ".join(prov))

    report = lowered.dispatch_report()
    if report is not None:
        out.append("")
        out.append("== Native Dispatch ==")
        out.extend(_dispatch_lines(report))

    if spans and len(trace):
        out.append("")
        out.append("== Spans ==")
        out.append(trace.tree_str())
    return "\n".join(out)
