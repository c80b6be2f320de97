"""The port's out-of-core morsel execution (``repro_torch.core.morsel``)
against the JAX package's (``repro.core.morsel``, ``tests/test_morsel.py``),
on the CPU at SF 0.01.

The same generated tables (the JAX generator's, carried across with
``tables_from_numpy``) and the same DataFrame program go through the JAX
package's ``compiled`` engine and the port's, each lowered with the same
``memory_budget`` / ``morsel_rows``:

* the morsel loop against the monolithic function (q1, q3, q6 at
  ``morsel_rows`` 1024 and 777 and a 64 KiB budget; rtol 2e-4, the JAX
  package's tolerance), one-row morsels, a single morsel that covers the
  table (bit-identical), every merge op across morsel boundaries, an
  empty selection and an empty spine, ``native=True`` composition (the
  same fired patterns as the JAX package), ``Compiled.batch``;
* the planner: the same ``morsel_rows`` and ``describe()`` as the JAX
  package for the same budget, the budget arithmetic and the error
  surface;
* the fault site ``morsel.loop``: it degrades at compile time, with the
  JAX package's events, and never at execute time.

Not ported here: the JAX package's parallel-engine morsel tests (the
sharded engine comes with ``core/parallel.py``), its paged join-probe
slab tests and its Pallas block-geometry tests (TPU artifacts).
"""
import numpy as np
import pytest

import repro.core as JC
import repro_torch.core as PC
from conftest import assert_results_equal
from repro.core import CompileCache as JaxCompileCache
from repro.core import FlareContext as JaxContext
from repro.core import morsel as JMO
from repro.relational import queries as JQ
from repro.resilience import faults as JFZ
from repro_torch import resilience as RZ
from repro_torch.core import CompileCache, FlareContext, col, lit
from repro_torch.core import lower as L
from repro_torch.core import morsel as MO
from repro_torch.kernels import KernelBudgetError
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT
from repro_torch.resilience import degrade as DG
from repro_torch.resilience import faults as FZ

from test_torch_data_ir import as_spec

SF = 0.01
RTOL = 2e-4

#: the JAX package's error type name -> the port's, where they differ
PORT_NAME = {"XlaCompileFault": "CompileFault"}


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
def _clean_slate(monkeypatch):
    monkeypatch.delenv("FLARE_DEGRADE", raising=False)
    monkeypatch.delenv("FLARE_CACHE_DIR", raising=False)
    DG.clear_events()
    yield
    assert FZ.active() is None, "a test leaked an armed FaultPlan"


def collect(df, **kwargs):
    return df.lower(engine="compiled", **kwargs).compile().collect()


def both(ctxs, build, **kwargs):
    """(JAX result, port result) of ``build(ctx, core module)`` on
    ``compiled``."""
    jc, pc = ctxs
    return (collect(build(jc, JC), **kwargs),
            collect(build(pc, PC), **kwargs))


def hops(events):
    return [(e["frm"], e["to"], e["phase"],
             PORT_NAME.get(e["error_type"], e["error_type"]))
            for e in events]


def merge_query(c, m):
    """Every merge op of the recomposition table, grouped (``m`` is the
    package's ``core`` module)."""
    return (c.table("lineitem")
            .group_by("l_returnflag")
            .agg(m.min_(m.col("l_quantity"), "min_q"),
                 m.max_(m.col("l_quantity"), "max_q"),
                 m.avg(m.col("l_discount"), "avg_d"),
                 m.sum_(m.col("l_extendedprice"), "sum_p"),
                 m.any_(m.col("l_tax"), "some_tax"),
                 m.count("n"))
            .sort("l_returnflag"))


# ---------------------------------------------------------------------------
# differential: the morsel loop against the monolithic function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qname", ["q1", "q3", "q6"])
@pytest.mark.parametrize("kwargs", [dict(morsel_rows=1024),
                                    # not aligned, not a divisor
                                    dict(morsel_rows=777),
                                    dict(memory_budget=64 * 1024)],
                         ids=["m1024", "m777", "b64k"])
def test_morsel_matches_monolithic_and_reference(ctxs, qname, kwargs):
    jc, pc = ctxs
    build = Q.QUERIES[qname]
    low = build(pc).lower(engine="compiled", **kwargs)
    assert MO.find_morsel_node(low.plan()) is not None
    got = low.compile().collect()
    assert_results_equal(collect(build(pc)), got, rtol=RTOL,
                         msg=f"{qname}/{kwargs} vs monolithic")
    want = collect(JQ.QUERIES[qname](jc), **kwargs)
    assert_results_equal(want, got, rtol=RTOL,
                         msg=f"{qname}/{kwargs} vs JAX package")


def test_one_row_morsels():
    """One row per morsel: every boundary is a morsel boundary.  The port
    runs its loop on the host, one lowering of the body per morsel, so
    one-row morsels over SF 0.01's ~60 k lineitem rows would run ~60 k
    lowerings; a table of 300 rows built here crosses the same
    boundaries in 300."""
    rng = np.random.default_rng(5)
    n = 300
    data = {"k": rng.integers(0, 5, n).astype(np.int32),
            "x": np.round(rng.uniform(-50, 50, n), 2),
            "y": rng.integers(-20, 20, n).astype(np.int32)}
    out = []
    for ctx, m, mo in ((JaxContext(), JC, JMO),
                       (FlareContext(device="cpu"), PC, MO)):
        ctx.from_arrays("t", data, domains={"k": 5})
        t = ctx.table("t")
        keyless = t.filter(m.col("x") > 0.0).agg(
            m.sum_(m.col("x"), "s"), m.count("n"), m.avg(m.col("y"), "a"))
        grouped = t.group_by("k").agg(
            m.sum_(m.col("x"), "s"), m.min_(m.col("y"), "mn"),
            m.max_(m.col("x"), "mx"), m.count("n")).sort("k")
        res = []
        for df in (keyless, grouped):
            low = df.lower(engine="compiled", morsel_rows=1)
            assert mo.find_morsel_node(low.plan()).morsel_rows == 1
            res.append((collect(df), low.compile().collect()))
        out.append(res)
    for (jbase, jgot), (base, got) in zip(*out):
        assert_results_equal(base, got, rtol=RTOL, msg="vs monolithic")
        assert_results_equal(jgot, got, rtol=RTOL, msg="vs JAX package")


def test_single_morsel_covering_table_is_bit_identical(ctxs):
    """``morsel_rows`` == the table length: one morsel whose views are
    the whole columns, so the result is bit-identical, not just close."""
    _, pc = ctxs
    n = pc.catalog.table("lineitem").num_rows
    for build in (Q.q6, Q.q1):
        base, got = collect(build(pc)), collect(build(pc), morsel_rows=n)
        for k in base:
            assert np.array_equal(np.asarray(base[k]), np.asarray(got[k])), k


def test_grouped_min_max_any_count_avg(ctxs):
    """Every merge op crosses a morsel boundary: min/max/any merge by
    their extremum, count/sum by addition, avg from the merged sum and
    count."""
    _, pc = ctxs
    want, got = both(ctxs, merge_query, morsel_rows=555)
    assert_results_equal(collect(merge_query(pc, PC)), got, rtol=RTOL)
    assert_results_equal(want, got, rtol=RTOL)


def test_empty_selection(ctxs):
    """A predicate that selects nothing: every morsel contributes only
    neutral elements, and keyless counts land on 0."""
    def build(c, m):
        return (c.table("lineitem")
                .filter(m.col("l_quantity") < m.lit(-1.0))
                .agg(m.sum_(m.col("l_extendedprice"), "s"), m.count("n")))

    want, got = both(ctxs, build, morsel_rows=256)
    assert np.atleast_1d(np.asarray(got["n"]))[0] == 0
    assert np.atleast_1d(np.asarray(got["s"]))[0] == 0.0
    assert_results_equal(collect(build(ctxs[1], PC)), got, rtol=RTOL)
    assert_results_equal(want, got, rtol=RTOL)


def test_empty_spine():
    """A spine of no rows: the loop runs no morsel; a zero-length one
    gives the partials' dtypes and the result is the neutral elements
    (keyless sum 0 and count 0, no valid group), as the monolithic
    function gives in both packages.  (The JAX package's own loop cannot
    slice a morsel out of an empty spine and raises while tracing, so
    the reference here is its monolithic function.)"""
    data = {"k": np.zeros(0, np.int32), "x": np.zeros(0, np.float64)}
    results = []
    for ctx, m in ((JaxContext(), JC), (FlareContext(device="cpu"), PC)):
        ctx.from_arrays("t", data, domains={"k": 4})
        t = ctx.table("t")
        keyless = t.agg(m.sum_(m.col("x"), "s"), m.count("n"),
                        m.avg(m.col("x"), "a"))
        grouped = t.group_by("k").agg(m.sum_(m.col("x"), "s"),
                                      m.min_(m.col("x"), "mn"), m.count("n"))
        results.append([collect(df) for df in (keyless, grouped)])
        if m is PC:
            results.append([collect(df, morsel_rows=128)
                            for df in (keyless, grouped)])
    want, base, got = results
    assert np.asarray(got[0]["n"])[0] == 0 and np.asarray(got[0]["s"])[0] == 0
    assert len(got[1]["k"]) == 0
    for w, b, g in zip(want, base, got):
        assert_results_equal(b, g, rtol=RTOL, msg="vs monolithic")
        assert_results_equal(w, g, rtol=RTOL, msg="vs JAX package")


@pytest.mark.parametrize("qname", ["q1", "q3", "q6", "join_micro"])
def test_morsel_composes_with_native_dispatch(ctxs, qname):
    """The dispatch pass annotates the partial aggregate inside the loop:
    the same patterns fire as in the JAX package, and the results match
    both the port's plain compiled function and the JAX package's."""
    jc, pc = ctxs
    build = getattr(Q, qname) if qname == "join_micro" else Q.QUERIES[qname]
    jbuild = (getattr(JQ, qname) if qname == "join_micro"
              else JQ.QUERIES[qname])
    low = build(pc).lower(engine="compiled", native=True, morsel_rows=1024)
    node = MO.find_morsel_node(low.plan())
    assert node is not None
    jlow = jbuild(jc).lower(engine="compiled", native=True, morsel_rows=1024)
    fired = low.dispatch_report().fired_patterns()
    assert fired and fired == jlow.dispatch_report().fired_patterns()
    # the annotated fragment sits under the loop
    assert "NativeKernel" in node.explain()
    got = low.compile().collect()
    assert_results_equal(collect(build(pc)), got, rtol=RTOL, msg=qname)
    assert_results_equal(jlow.compile().collect(), got, rtol=RTOL, msg=qname)


def test_batch_of_morsel_template(ctxs, recwarn):
    """``Compiled.batch`` vmaps the loop: each binding's slice equals its
    own call and the JAX package's batch."""
    jc, pc = ctxs
    bindings = [dict(b) for b in Q.TEMPLATE_BINDINGS["q6"]]
    bindings.append(dict(bindings[0], qty_hi=-1.0))  # selects nothing
    c = Q.TEMPLATES["q6"](pc).lower(engine="compiled", morsel_rows=1024) \
        .compile(cache=CompileCache())
    got = c.batch(bindings)
    assert not [w for w in recwarn if "atching rule" in str(w.message)]
    want = JQ.TEMPLATES["q6"](jc).lower(engine="compiled",
                                        morsel_rows=1024).compile() \
        .batch(bindings)
    assert len(got) == len(want) == len(bindings)
    for b, g, w in zip(bindings, got, want):
        assert_results_equal(c(**b), g.compact(), rtol=RTOL, msg=str(b))
        assert_results_equal(w.compact(), g.compact(), rtol=RTOL, msg=str(b))


# ---------------------------------------------------------------------------
# the planner: budget -> morsel size, and the error surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qname", ["q1", "q3", "q6"])
@pytest.mark.parametrize("budget", [64 * 1024, 300_000, 1 << 20])
def test_planner_parity(ctxs, qname, budget):
    """One budget picks the same morsel and the same merge recipe in both
    packages."""
    jc, pc = ctxs
    jnode = JMO.find_morsel_node(JQ.QUERIES[qname](jc).lower(
        engine="compiled", memory_budget=budget).plan())
    node = MO.find_morsel_node(Q.QUERIES[qname](pc).lower(
        engine="compiled", memory_budget=budget).plan())
    assert node is not None and jnode is not None
    assert node.morsel_rows == jnode.morsel_rows
    assert node.describe() == jnode.describe()
    assert MO.ROW_ALIGN == JMO.LANES
    assert MO.working_set_bytes(7, 1000) == JMO.working_set_bytes(7, 1000)


def test_budget_drives_morsel_size(ctxs):
    _, pc = ctxs
    df = Q.q6(pc)
    budget = 64 * 1024
    node = MO.find_morsel_node(df.lower(engine="compiled",
                                        memory_budget=budget).plan())
    assert node is not None
    n_cols = len(L.required_scan_columns(
        df.lower(engine="compiled").plan(), pc.catalog)[id(node.spine)])
    assert n_cols == 4
    assert node.morsel_rows % MO.ROW_ALIGN == 0
    assert MO.working_set_bytes(n_cols, node.morsel_rows) <= budget
    # one more aligned row block would exceed the budget
    assert MO.working_set_bytes(n_cols,
                                node.morsel_rows + MO.ROW_ALIGN) > budget
    assert MO.choose_morsel_rows(4, 100, 1 << 30) == 128  # capped


def test_generous_budget_keeps_monolithic_plan(ctxs):
    low = Q.q6(ctxs[1]).lower(engine="compiled", memory_budget=1 << 34)
    assert MO.find_morsel_node(low.plan()) is None


def test_morsel_rows_are_template_keyed(ctxs):
    """Different morsel sizes are different functions: neither the
    fingerprint nor the compile-cache key may collide."""
    df = Q.q6(ctxs[1])
    lows = [df.lower(engine="compiled", morsel_rows=m)
            for m in (128, 256, None)]
    assert len({low.plan().fingerprint() for low in lows}) == 3
    assert len({low.cache_key for low in lows}) == 3


def test_budget_too_small_raises(ctxs):
    with pytest.raises(MO.MemoryBudgetError, match="cannot hold"):
        Q.q6(ctxs[1]).lower(engine="compiled", memory_budget=16)


def test_plan_without_aggregate_raises(ctxs):
    df = ctxs[1].table("lineitem").filter(col("l_quantity") < lit(10.0))
    with pytest.raises(MO.MemoryBudgetError,
                       match="distributive aggregate"):
        df.lower(engine="compiled", memory_budget=1024)


def test_iterative_kernel_root_raises(ctxs):
    tr = ctxs[1].table("lineitem").train(
        "kmeans", columns=["l_quantity", "l_discount"], k=2, max_iter=3)
    with pytest.raises(MO.MemoryBudgetError, match="IterativeKernel"):
        tr.lower(engine="compiled", morsel_rows=128)


@pytest.mark.parametrize("engine", ["volcano", "stage", "tuple"])
def test_non_compiled_engine_raises(ctxs, engine):
    with pytest.raises(ValueError, match="compiled"):
        Q.q6(ctxs[1]).lower(engine=engine, memory_budget=1024)


def test_memory_budget_error_is_value_error():
    assert issubclass(MO.MemoryBudgetError, ValueError)
    assert issubclass(KernelBudgetError, ValueError)
    assert not DG.recoverable(MO.MemoryBudgetError("x"), "compile")


# ---------------------------------------------------------------------------
# the fault site morsel.loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_morsel_fault_degrades_at_compile_as_reference(ctxs, native):
    """An armed ``morsel.loop`` fails the compile; the ladder answers,
    with the JAX package's events.  From ``compiled-native`` the
    ``compiled`` rung keeps the morsel loop (its own compile checks the
    site again, and ``first:1`` has fired)."""
    jc, pc = ctxs
    b = dict(Q.TEMPLATE_BINDINGS["q6"][0])
    with JFZ.inject("morsel.loop", "first:1"):
        jcomp = JQ.TEMPLATES["q6"](jc).lower(
            engine="compiled", native=native, morsel_rows=1024) \
            .compile(cache=JaxCompileCache())
        want = jcomp(**b)
    with RZ.inject("morsel.loop", "first:1") as plan:
        c = Q.TEMPLATES["q6"](pc).lower(
            engine="compiled", native=native, morsel_rows=1024) \
            .compile(cache=CompileCache())
        got = c(**b)
    assert hops(c.stats.degraded) == hops(jcomp.stats.degraded)
    assert [h[2] for h in hops(c.stats.degraded)] == ["compile"]
    assert plan.counts()["morsel.loop"]["fired"] == 1
    if native:
        assert c.engine_name == "compiled"
        assert MO.find_morsel_node(c._plan).morsel_rows == 1024
    else:
        assert c.engine_name == "stage"
    assert_results_equal(want, got)
    oracle = Q.TEMPLATES["q6"](pc).lower(engine="volcano").compile()(**b)
    assert_results_equal(oracle, got)


def test_morsel_fault_never_fires_at_execute(ctxs):
    """The site sits where the template compiles: calls, submits and an
    already-built batch program check it no time."""
    _, pc = ctxs
    bindings = [dict(b) for b in Q.TEMPLATE_BINDINGS["q6"]]
    c = Q.TEMPLATES["q6"](pc).lower(engine="compiled", native=True,
                                    morsel_rows=1024) \
        .compile(cache=CompileCache())
    plain = Q.TEMPLATES["q6"](pc).lower(engine="compiled", morsel_rows=1024) \
        .compile(cache=CompileCache())
    plain.batch(bindings)  # builds the bucket's program
    with RZ.inject("morsel.loop", "every:1") as plan:
        for b in bindings:
            c(**b)
            c.submit(**b).result()
        plain.batch(bindings)
    assert plan.counts()["morsel.loop"]["checked"] == 0
    assert c.stats.degraded == () and plain.stats.degraded == ()


def test_morsel_fault_in_a_batch_build_degrades(ctxs):
    """A batched program is built at the first batch of its bucket: the
    site fires there (ahead of ``compile.xla``), counts as a compile, and
    the batch answers per binding from the ``stage`` rung."""
    _, pc = ctxs
    bindings = [dict(b) for b in Q.TEMPLATE_BINDINGS["q6"]]
    c = Q.TEMPLATES["q6"](pc).lower(engine="compiled", morsel_rows=1024) \
        .compile(cache=CompileCache())
    with RZ.inject({"morsel.loop": "first:1", "compile.xla": "every:1"}) \
            as plan:
        got = c.batch(bindings)
    assert plan.counts()["morsel.loop"]["fired"] == 1
    assert plan.counts()["compile.xla"]["checked"] == 0
    assert hops(c.stats.degraded) == [("compiled", "stage", "compile",
                                       "KernelBudgetError")]
    oracle = Q.TEMPLATES["q6"](pc).lower(engine="volcano").compile()
    for b, g in zip(bindings, got):
        assert_results_equal(oracle(**b), g.compact())


def test_morsel_fault_raises_typed_with_the_ladder_off(ctxs, monkeypatch):
    monkeypatch.setenv("FLARE_DEGRADE", "off")
    with RZ.inject("morsel.loop", "first:1"):
        with pytest.raises(KernelBudgetError, match="morsel.loop"):
            Q.TEMPLATES["q6"](ctxs[1]).lower(
                engine="compiled", morsel_rows=1024) \
                .compile(cache=CompileCache())
    assert DG.events() == ()
