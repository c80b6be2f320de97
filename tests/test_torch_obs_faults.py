"""The port's tracer, metrics registry and fault injection, on the CPU,
against the JAX package's (``repro.obs``, ``repro.resilience.faults``).

* tracer semantics: the disabled no-op, span nesting and attributes,
  exceptions recorded on their span, ``capture`` windows that do not leak
  into each other;
* ``REGISTRY`` counters and the snapshot's ``caches`` section, which is
  ``engines.cache_stats()``;
* the served path leaves the JAX package's span names: ``serve.submit``,
  ``serve.flush``, ``serve.dispatch``, ``serve.sync``, ``execute`` with
  ``mode=batch`` and ``compile`` with ``kind=batch``, with the same
  attributes on ``serve.flush`` and ``serve.dispatch``;
* a ``FaultPlan`` with the same seed and site fires on the same checks as
  the JAX package's, for every schedule kind; ``FLARE_FAULTS`` parses
  alike; an injected ``serve.dispatch`` fault is bisected away and an
  injected ``compile.xla`` fault fails the batch it builds (with
  ``FLARE_DEGRADE=off``; the ladder answers it otherwise);
* Chrome-trace export: the JAX package's schema, a round trip through
  ``spans_from_chrome`` (either package's reader), ``FLARE_TRACE_OUT``
  dumping at a child process's exit;
* EXPLAIN ANALYZE: every query's phase names and native-dispatch lines
  equal the JAX package's (its "interpret" mode is the port's "torch"),
  scan statistics keyed by structural path, tracing left off;
* the dispatch counters, and ``kernel_scope`` naming each fragment's
  launch in a ``torch.profiler`` trace.
"""
import json
import os
import subprocess
import sys
import warnings

import pytest
import torch

from conftest import SRC, assert_results_equal
from repro.core import FlareContext as JaxContext
from repro.obs import export as JOX
from repro.obs import metrics as JOM
from repro.obs import trace as JOT
from repro.relational import queries as JQ
from repro.resilience import faults as JFZ
from repro.serve import QueryServer as JaxServer
from repro_torch import resilience as RZ
from repro_torch.core import CompileCache, FlareContext
from repro_torch.core import engines as ENG
from repro_torch.core import lower as L
from repro_torch.obs import export as OX
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT
from repro_torch.resilience import faults as FZ
from repro_torch.serve import QueryServer

from test_torch_data_ir import as_spec

SF = 0.005


@pytest.fixture(scope="module")
def ctxs():
    jc = JaxContext()
    JQ.register_tpch(jc, sf=SF)
    pc = FlareContext(device="cpu")
    tables = {n: jc.catalog.table(n) for n in jc.catalog.names()}
    for name, tbl in PT.tables_from_numpy(as_spec(tables)).items():
        pc.register(name, tbl)
    return jc, pc


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    assert FZ.active() is None, "a test leaked an armed FaultPlan"


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------


def test_disabled_mode_is_a_noop(monkeypatch):
    monkeypatch.delenv(OT.ENV_VAR, raising=False)
    OT.TRACER.refresh_from_env()
    assert not OT.TRACER.on
    before = len(OT.TRACER.spans())
    sp = OT.span("anything", key="value")
    assert sp is OT.NULL_SPAN  # one shared object: no allocation per call
    with sp as inner:
        inner.set(more="attrs")  # all no-ops
    assert len(OT.TRACER.spans()) == before
    assert not OT.enabled()


def test_span_nesting_parent_ids_and_attrs():
    with OT.capture() as trace:
        with OT.span("outer", a=1) as outer:
            with OT.span("inner") as inner:
                inner.set(b=2)
        outer.set(after_exit=True)  # recorded spans mutate in place
    assert OT.enabled() is False  # capture() disables on exit
    outer_sp = trace.first("outer")
    inner_sp = trace.first("inner")
    assert inner_sp.parent_id == outer_sp.span_id
    assert outer_sp.parent_id is None
    assert outer_sp.attrs == {"a": 1, "after_exit": True}
    assert inner_sp.attrs == {"b": 2}
    assert outer_sp.t1 >= inner_sp.t1 >= inner_sp.t0 >= outer_sp.t0
    assert trace.children(outer_sp) == [inner_sp]
    assert "inner" in trace.descendant_names(outer_sp)
    assert trace.phase_totals()["inner"]["count"] == 1
    assert "outer" in trace.tree_str()


def test_span_records_exceptions():
    with OT.capture() as trace:
        with pytest.raises(ValueError):
            with OT.span("doomed"):
                raise ValueError("boom")
    assert trace.first("doomed").attrs["error"] == "ValueError"


def test_capture_isolates_sequential_windows():
    with OT.capture() as first:
        with OT.span("one"):
            pass
    with OT.capture() as second:
        with OT.span("two"):
            pass
    assert [s.name for s in first.spans] == ["one"]
    assert [s.name for s in second.spans] == ["two"]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_registry_counters():
    reg = OM.MetricsRegistry()
    reg.inc("x")
    reg.inc("x", 2)
    assert reg.get("x") == 3 and reg.counters() == {"x": 3}
    reg.reset_counters()
    assert reg.get("x") == 0


def test_snapshot_caches_are_cache_stats(ctxs):
    _, pc = ctxs
    Q.TEMPLATES["q14"](pc).lower(engine="compiled").compile()(
        **Q.TEMPLATE_BINDINGS["q14"][0])
    snap = OM.snapshot()
    assert snap["caches"] == ENG.cache_stats()
    assert {"compile", "device", "index"} <= set(snap["caches"])
    # the JAX package's sections, since the port has its store, dispatch
    # counters and ladder
    assert set(snap) == set(JOM.snapshot())
    assert set(snap["resilience"]) == set(JOM.snapshot()["resilience"])
    for kind in ("compile", "index"):
        assert set(snap["caches"][kind]["disk"]) == \
            set(JOM.snapshot()["disk"]["exec"])


# ---------------------------------------------------------------------------
# the served path's spans against the JAX package's
# ---------------------------------------------------------------------------


def _served_trace(server, capture, bindings):
    with capture() as trace:
        futs = [server.submit("q6", **b) for b in bindings]
        server.flush()
        for f in futs:
            f.result()
    return trace


def test_served_path_span_names_match_reference(ctxs):
    jc, pc = ctxs
    bindings = Q.random_bindings("q6", 3, seed=5)
    ours = _served_trace(QueryServer(pc), OT.capture, bindings)
    ref = _served_trace(JaxServer(jc), JOT.capture, bindings)
    want = {"serve.submit", "serve.flush", "serve.dispatch", "serve.sync",
            "execute", "compile"}
    names = {s.name for s in ours.spans}
    assert want <= names, sorted(names)
    assert want <= {s.name for s in ref.spans}
    for trace in (ours, ref):
        assert trace.first("serve.flush").attrs == {"drained": 3,
                                                    "groups": 1}
        dispatch = trace.first("serve.dispatch")
        assert dispatch.attrs["template"] == "q6"
        assert dispatch.attrs["requests"] == 3
        assert dispatch.attrs["bucket"] == 4
        assert "execute" in trace.descendant_names(dispatch)
        batch = [s for s in trace.find("execute")
                 if s.attrs.get("mode") == "batch"]
        assert len(batch) == 1
        assert batch[0].attrs["bindings"] == 3
        assert batch[0].attrs["bucket"] == 4
        assert [s.attrs["bucket"] for s in trace.find("compile")
                if s.attrs.get("kind") == "batch"] == [4]


def test_submit_and_result_spans(ctxs):
    _, pc = ctxs
    compiled = Q.TEMPLATES["q6"](pc).lower(engine="compiled").compile(
        cache=CompileCache())
    assert compiled.last_trace() is None  # nothing traced yet
    b = Q.TEMPLATE_BINDINGS["q6"][0]
    with OT.capture():
        compiled.submit(**b).result()
    assert compiled.last_trace().first("execute").attrs["mode"] == \
        "dispatch"
    with OT.capture():
        compiled.result(**b)
    assert compiled.last_trace().first("execute").attrs["mode"] == "sync"


# ---------------------------------------------------------------------------
# fault injection against the JAX package's
# ---------------------------------------------------------------------------


def _fires(mod, site, spec, seed, n=64):
    plan = mod.FaultPlan({site: spec}, seed=seed)
    return [plan.check(site) is not None for _ in range(n)]


@pytest.mark.parametrize("site", sorted(FZ.SITES))
@pytest.mark.parametrize("spec,seed", [("first:3", 0), ("every:3", 0),
                                       ("p:0.5", 0), ("p:0.5", 7),
                                       ("p:0.1", 9)])
def test_fault_plan_fires_as_reference(site, spec, seed):
    ours = _fires(FZ, site, spec, seed)
    assert ours == _fires(JFZ, site, spec, seed)
    if spec.startswith("p:0.5"):
        assert any(ours) and not all(ours)


def test_sites_are_reference_sites_and_raise_their_types():
    from repro_torch.kernels import KernelBudgetError
    from repro_torch.persist.store import StoreCorrupt
    assert set(FZ.SITES) <= set(JFZ.SITES)
    # every site of the JAX package but morsel.loop (core/morsel.py is
    # not ported)
    assert set(JFZ.SITES) - set(FZ.SITES) == {"morsel.loop"}
    expect = {"persist.load": StoreCorrupt,
              "persist.save": OSError,
              "compile.xla": FZ.CompileFault,
              "native.kernel": KernelBudgetError,
              "index.build": FZ.IndexBuildError,
              "serve.dispatch": FZ.DispatchFault}
    assert set(expect) == set(FZ.SITES)
    for site, etype in expect.items():
        with RZ.inject(site, "first:1"):
            with pytest.raises(etype):
                FZ.fault_point(site)
        FZ.fault_point(site)  # disarmed again: a no-op


def test_bad_plans_rejected():
    with pytest.raises(ValueError, match="unknown fault site"):
        FZ.FaultPlan({"morsel.loop": "first:1"})  # no such site here yet
    with pytest.raises(ValueError, match="unknown fault schedule"):
        FZ.FaultPlan({"compile.xla": "sometimes"})
    with pytest.raises(ValueError, match="0..1"):
        FZ.FaultPlan({"compile.xla": "p:1.5"})


def test_env_parsing_matches_reference(monkeypatch):
    spec = "serve.dispatch:first:1, compile.xla:p:0.5, seed:9"
    ours, ref = FZ.parse_env(spec), JFZ.parse_env(spec)
    assert ours.seed == ref.seed == 9
    assert ours.counts() == ref.counts()
    assert [ours.check("compile.xla") is not None for _ in range(32)] == \
        [ref.check("compile.xla") is not None for _ in range(32)]
    monkeypatch.setenv("FLARE_FAULTS", spec)
    plan = FZ.refresh_from_env()
    assert plan is not None and plan.seed == 9
    monkeypatch.delenv("FLARE_FAULTS")
    assert FZ.refresh_from_env() is None


def test_inject_nests_and_restores():
    with RZ.inject("compile.xla", "every:1") as outer:
        with RZ.inject("serve.dispatch", "every:1"):
            FZ.fault_point("compile.xla")  # outer plan shadowed: silent
            with pytest.raises(FZ.DispatchFault):
                FZ.fault_point("serve.dispatch")
        with pytest.raises(FZ.CompileFault):
            FZ.fault_point("compile.xla")
    assert outer.counts()["compile.xla"]["fired"] == 1


def test_injected_dispatch_fault_is_isolated_by_bisection(ctxs):
    _, pc = ctxs
    server = QueryServer(pc)
    bindings = Q.random_bindings("q6", 4, seed=2)
    fired = OM.REGISTRY.get("faults.fired.serve.dispatch")
    with RZ.inject("serve.dispatch", "first:1"):
        futs = [server.submit("q6", **b) for b in bindings]
        server.flush()
    compiled = server.compiled_for("q6")
    for b, f in zip(bindings, futs):  # the retried halves all succeed
        assert_results_equal(compiled(**b), f.result(timeout=30).compact())
    assert server.stats.bisects == 1 and server.stats.poisoned == 0
    assert OM.REGISTRY.get("faults.fired.serve.dispatch") == fired + 1


def test_injected_compile_fault_fails_the_batch_build(ctxs, monkeypatch):
    _, pc = ctxs
    compiled = Q.TEMPLATES["q19"](pc).lower(engine="compiled").compile()
    bindings = Q.random_bindings("q19", 16, seed=3)  # a bucket not built
    monkeypatch.setenv("FLARE_DEGRADE", "off")  # the ladder would answer
    with RZ.inject("compile.xla", "first:1"):
        with pytest.raises(FZ.CompileFault):
            compiled.batch(bindings)
    monkeypatch.delenv("FLARE_DEGRADE")
    # nothing was cached for the failed build: the next batch builds it
    got = compiled.batch(bindings)
    assert_results_equal(compiled(**bindings[0]), got[0].compact())
    assert compiled.stats.degraded == ()
    server = QueryServer(pc)
    with RZ.inject("serve.dispatch", "every:1"):
        futs = [server.submit("q19", **b) for b in bindings[:3]]
        server.flush()
    for f in futs:
        with pytest.raises(FZ.DispatchFault):
            f.result(timeout=1)
    assert server.stats.poisoned == 3


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------


def test_chrome_export_schema(tmp_path):
    with OT.capture() as trace:
        with OT.span("parent", kind="demo"):
            with OT.span("child"):
                pass
    doc = OX.to_chrome(trace.spans)
    json.dumps(doc)  # JSON-serializable as-is
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    assert meta and meta[0]["name"] == "process_name"
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == 2
    for ev in xs:
        assert set(ev) == {"name", "ph", "ts", "dur", "pid", "tid", "args"}
        assert ev["dur"] >= 0
    parent = next(e for e in xs if e["name"] == "parent")
    assert parent["args"]["kind"] == "demo"
    # the JAX package's exporter writes the same keys for the same spans
    ref = JOX.to_chrome(trace.spans)
    assert [set(e) for e in ref["traceEvents"]] == [set(e) for e in events]

    path = tmp_path / "trace.json"
    OX.dump_chrome(str(path), trace.spans)
    loaded = json.loads(path.read_text())
    for reader in (OX.spans_from_chrome, JOX.spans_from_chrome):
        rebuilt = OT.Trace(reader(loaded))
        assert {s.name for s in rebuilt.spans} == {"parent", "child"}
        assert (rebuilt.first("child").parent_id
                == rebuilt.first("parent").span_id)


def test_chrome_export_sanitizes_exotic_attrs():
    with OT.capture() as trace:
        with OT.span("odd") as sp:
            sp.set(obj=object(), nested={"k": (1, 2)})
    json.dumps(OX.to_chrome(trace.spans))  # flattened by _json_safe


_TRACE_CHILD = """
from repro_torch.core import FlareContext
from repro_torch.relational import queries as Q
import repro_torch.obs  # noqa: F401  (installs the exit dump)
ctx = FlareContext(device="cpu")
Q.register_tpch(ctx, sf=%(sf)r)
for name in ("q6", "q19"):
    Q.QUERIES[name](ctx).lower(engine="compiled", native=True).compile()()
"""


def test_flare_trace_out_dumps_at_exit(tmp_path):
    out = tmp_path / "trace.json"
    env = dict(os.environ, FLARE_TRACE="1", FLARE_TRACE_OUT=str(out),
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("FLARE_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _TRACE_CHILD % {"sf": SF}],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    trace = OT.Trace(OX.spans_from_chrome(json.loads(out.read_text())))
    for phase in ("optimize", "dispatch", "lower", "compile", "execute"):
        assert len(trace.find(phase)) >= 2, phase
    patterns = {s.attrs.get("patterns") for s in trace.find("dispatch")}
    assert patterns == {"filter-scalar-agg", "join-probe"}
    for sp in trace.find("lower"):  # every lower sits under its compile
        parent = next(p for p in trace.spans if p.span_id == sp.parent_id)
        assert parent.name == "compile"


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE against the JAX package's
# ---------------------------------------------------------------------------


def _section(text, title):
    lines = text.splitlines()
    if title not in lines:
        return None
    out = []
    for line in lines[lines.index(title) + 1:]:
        if not line.strip():
            break
        out.append(line)
    return out


@pytest.mark.parametrize("name", sorted(Q.QUERIES))
def test_explain_analyze_dispatch_lines_match_reference(ctxs, name):
    jc, pc = ctxs
    ours = Q.QUERIES[name](pc).explain(analyze=True, native=True)
    ref = JQ.QUERIES[name](jc).explain(analyze=True, native=True)
    assert "== Physical Plan (analyzed: engine=compiled-native" in ours
    want = [line.replace("[interpret]", "[torch]")
            for line in _section(ref, "== Native Dispatch ==")]
    assert _section(ours, "== Native Dispatch ==") == want
    phases = [line.split()[0]
              for line in _section(ours, "== Query Lifecycle ==")]
    assert phases == [line.split()[0] for line in
                      _section(ref, "== Query Lifecycle ==")]


def test_explain_analyze_q6_native(ctxs):
    _, pc = ctxs
    text = Q.QUERIES["q6"](pc).explain(analyze=True, native=True)
    for phase in ("optimize", "dispatch", "lower", "compile", "execute"):
        assert phase in text, phase
    assert "FIRED" in text and "filter-scalar-agg" in text
    assert "Scan lineitem" in text and "rows=" in text and "bytes=" in text
    assert "== Spans ==" in text and "rows_out=1" in text


def test_explain_analyze_q19_index_provenance(ctxs):
    _, pc = ctxs
    text = Q.QUERIES["q19"](pc).explain(analyze=True, native=True)
    assert "join-probe" in text
    assert "indexed  join-index" in text  # the join-index provenance row
    assert "index_lookup" in text         # where this run's index came from


def test_explain_analyze_scan_stats_cover_every_scan(ctxs):
    import re
    _, pc = ctxs
    for join_index in (True, False):
        df = Q.QUERIES["q6"](pc)
        text = df.explain(analyze=True, join_index=join_index)
        scan_lines = [ln for ln in text.splitlines() if "Scan " in ln]
        assert scan_lines and all("cols=" in ln for ln in scan_lines)
        plan = df.lower(engine="compiled", join_index=join_index).plan()
        by_path = L.required_scan_columns_by_path(plan, pc.catalog)
        want = {len(cols) for cols in by_path.values()}
        li = next(ln for ln in scan_lines if "lineitem" in ln)
        got = int(re.search(r"cols=(\d+)", li).group(1))
        assert got in want and got < 16, (got, want, li)


def test_scan_paths_stable_across_plan_copies(ctxs):
    from repro.core import lower as JL
    jc, pc = ctxs
    plan = Q.QUERIES["q5"](pc).plan
    copy = plan.with_children(plan.children())
    a = L.required_scan_columns_by_path(plan, pc.catalog)
    assert a and a == L.required_scan_columns_by_path(copy, pc.catalog)
    assert a == JL.required_scan_columns_by_path(JQ.QUERIES["q5"](jc).plan,
                                                 jc.catalog)


def test_explain_analyze_leaves_tracing_off(ctxs):
    _, pc = ctxs
    assert not OT.TRACER.on
    Q.QUERIES["q6"](pc).explain(analyze=True)
    assert not OT.TRACER.on
    text = Q.QUERIES["q6"](pc).explain()
    assert "Scan lineitem" in text and "Lifecycle" not in text


# ---------------------------------------------------------------------------
# dispatch counters and kernel scopes
# ---------------------------------------------------------------------------


def test_dispatch_counters_accumulate(ctxs):
    _, pc = ctxs
    before = OM.dispatch_section()
    Q.QUERIES["q6"](pc).lower(engine="compiled", native=True)
    after = OM.dispatch_section()
    assert after["rewrites"] == before["rewrites"] + 1
    assert after["fired"] == before["fired"] + 1
    assert after["patterns"]["filter-scalar-agg"]["fired"] >= 1
    assert set(after) == set(JOM.dispatch_section())


def test_kernel_scope_names_each_fragment_in_a_profile(ctxs):
    _, pc = ctxs
    compiled = Q.QUERIES["q19"](pc).lower(engine="compiled",
                                          native=True).compile()
    compiled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        compiled()
    names = [e.name for e in prof.events()]
    assert names.count("flare:join-probe") == 1
    assert "flare:filter-scalar-agg" not in names
    # off the profiler the scope costs no record_function
    assert OX.kernel_scope("flare:x") is OX.kernel_scope("flare:y")


def test_launch_serve_shim_warns():
    sys.modules.pop("repro_torch.launch.serve", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        import repro_torch.launch.serve as shim
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    from repro_torch.launch import serve_llm
    assert shim.generate is serve_llm.generate
