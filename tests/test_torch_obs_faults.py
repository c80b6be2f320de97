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
  injected ``compile.xla`` fault fails the batch it builds.
"""
import pytest

from conftest import assert_results_equal
from repro.core import FlareContext as JaxContext
from repro.obs import trace as JOT
from repro.relational import queries as JQ
from repro.resilience import faults as JFZ
from repro.serve import QueryServer as JaxServer
from repro_torch import resilience as RZ
from repro_torch.core import CompileCache, FlareContext
from repro_torch.core import engines as ENG
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
    assert set(snap) == {"caches", "serve", "counters", "resilience",
                         "trace"}


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
    assert set(FZ.SITES) <= set(JFZ.SITES)
    expect = {"compile.xla": FZ.CompileFault,
              "serve.dispatch": FZ.DispatchFault}
    assert set(expect) == set(FZ.SITES)
    for site, etype in expect.items():
        with RZ.inject(site, "first:1"):
            with pytest.raises(etype):
                FZ.fault_point(site)
        FZ.fault_point(site)  # disarmed again: a no-op


def test_bad_plans_rejected():
    with pytest.raises(ValueError, match="unknown fault site"):
        FZ.FaultPlan({"persist.load": "first:1"})  # no such site here yet
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


def test_injected_compile_fault_fails_the_batch_build(ctxs):
    _, pc = ctxs
    compiled = Q.TEMPLATES["q19"](pc).lower(engine="compiled").compile()
    bindings = Q.random_bindings("q19", 16, seed=3)  # a bucket not built
    with RZ.inject("compile.xla", "first:1"):
        with pytest.raises(FZ.CompileFault):
            compiled.batch(bindings)
    # nothing was cached for the failed build: the next batch builds it
    got = compiled.batch(bindings)
    assert_results_equal(compiled(**bindings[0]), got[0].compact())
    server = QueryServer(pc)
    with RZ.inject("serve.dispatch", "every:1"):
        futs = [server.submit("q19", **b) for b in bindings[:3]]
        server.flush()
    for f in futs:
        with pytest.raises(FZ.DispatchFault):
            f.result(timeout=1)
    assert server.stats.poisoned == 3
