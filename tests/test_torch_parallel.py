"""The port's sharded ``parallel`` engine (``repro_torch.core.parallel``)
against the JAX package's (``repro.core.parallel``,
``tests/test_engine_matrix.py``), on the CPU at SF 0.005.

The JAX package runs here in-process on its one CPU device, so its side
of every plan comparison is a 1-shard mesh.  The port's shards are row
ranges of the spine on one device (``launch.mesh.make_data_mesh(n,
device="cpu")``), so it runs at 1, 3 and 4 shards: results must not
depend on the shard count.

* the matrix: every query, every template binding and q22 on
  ``parallel`` and ``parallel`` with ``native=True``, against the JAX
  volcano oracle (ordered, rtol 5e-3 as ``tests/conftest.py`` sets it),
  and q1/q6/q13/q14 against ``tests/golden/`` at SF 0.01;
* plan shapes: at 1 shard the sharded plan equals the JAX package's
  ``shard_plan`` and the fired patterns its native report; the
  ``IterativeKernel`` root raises ``UnsupportedParallelPlan`` typed;
  wrong axes and ``mesh=`` on another engine raise ``ValueError``;
* shards: contiguous, 128-row-aligned row ranges (the rows per shard
  differ from the JAX package's padded partition; the results do not),
  empty shards included; a native fragment's plain version runs once
  per shard on the shard's rows;
* the merge table and a derandomized property: merged ragged partials
  equal the unsharded ones, and the engine equals ``compiled`` on random
  tables at any shard count;
* one compile per mesh shape, ``ShardedDispatchReport``, replicated
  join indexes, morsels per shard, the ladder's ``parallel -> compiled``
  rung, a persist attempt that writes nothing, the ``shard_plan`` span.
"""
import inspect
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch.core as PC
from conftest import assert_results_equal
from repro.core import CompileCache as JaxCompileCache
from repro.core import FlareContext as JaxContext
from repro.core import plan as JPL
from repro.core import parallel as JPAR
from repro.relational import queries as JQ
from repro.resilience import faults as JFZ
from repro_torch import resilience as RZ
from repro_torch.core import CompileCache, FlareContext, col, lit
from repro_torch.core import morsel as MO
from repro_torch.core import parallel as PAR
from repro_torch.core import plan as PL
from repro_torch.kernels.filter_agg import kernel as FA
from repro_torch.kernels.join_probe import kernel as JP
from repro_torch.kernels.segmented_reduce import kernel as SR
from repro_torch.launch import mesh as MESH
from repro_torch.obs import trace as OT
from repro_torch.persist import ArtifactStore
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT
from repro_torch.resilience import degrade as DG
from repro_torch.resilience import faults as FZ

from test_engine_matrix import (GOLDEN_QUERIES, GOLDEN_SEED, GOLDEN_SF,
                                load_golden)
from test_property import tables
from test_torch_data_ir import as_spec

SF = 0.005
SHARDS = (1, 3, 4)

TEMPLATE_CASES = [(t, i) for t in Q.TEMPLATES
                  for i in range(len(Q.TEMPLATE_BINDINGS[t]))]

#: the JAX package's error type name -> the port's, where they differ
PORT_NAME = {"XlaCompileFault": "CompileFault"}


def mesh(n, axis="data"):
    return MESH.make_data_mesh(n, axis=axis, device="cpu")


def port_ctx(jc):
    """A port context holding the JAX context's tables."""
    pc = FlareContext(device="cpu")
    tables = {n: jc.catalog.table(n) for n in jc.catalog.names()}
    for name, tbl in PT.tables_from_numpy(as_spec(tables)).items():
        pc.register(name, tbl)
    return pc


@pytest.fixture(scope="module")
def ctxs():
    jc = JaxContext()
    JQ.register_tpch(jc, sf=SF)
    return jc, port_ctx(jc)


@pytest.fixture(scope="module")
def oracle(ctxs):
    """JAX volcano results, once per (query, binding)."""
    cache = {}

    def get(key, df, params=None):
        if key not in cache:
            cache[key] = df.collect(engine="volcano", params=params)
        return cache[key]

    return get


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.delenv("FLARE_DEGRADE", raising=False)
    monkeypatch.delenv("FLARE_CACHE_DIR", raising=False)
    DG.clear_events()
    yield
    assert FZ.active() is None, "a test leaked an armed FaultPlan"


def run(df, n_shards, native, **params):
    return df.lower(engine="parallel", native=native,
                    mesh=mesh(n_shards)).compile()(**params)


def hops(events):
    return [(e["frm"], e["to"], e["phase"],
             PORT_NAME.get(e["error_type"], e["error_type"]))
            for e in events]


# ---------------------------------------------------------------------------
# the matrix: queries x {parallel, parallel-native} x shard counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("qname", list(Q.QUERIES))
def test_query_matrix(ctxs, oracle, qname, native, n_shards):
    jc, pc = ctxs
    want = oracle(qname, JQ.QUERIES[qname](jc))
    got = run(Q.QUERIES[qname](pc), n_shards, native)
    assert_results_equal(want, got, msg=f"{qname} x{n_shards} {native}")


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("tname,bi", TEMPLATE_CASES,
                         ids=[f"{t}-b{i}" for t, i in TEMPLATE_CASES])
def test_template_matrix(ctxs, oracle, tname, bi, native, n_shards):
    jc, pc = ctxs
    binding = Q.TEMPLATE_BINDINGS[tname][bi]
    want = oracle((tname, bi), JQ.TEMPLATES[tname](jc), params=binding)
    got = run(Q.TEMPLATES[tname](pc), n_shards, native, **binding)
    assert_results_equal(want, got,
                         msg=f"{tname}[{bi}] x{n_shards} {native}")


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
def test_q22_matrix(ctxs, oracle, native, n_shards):
    jc, pc = ctxs
    jbinding = JQ.q22_params(jc, "volcano")
    want = oracle("q22", JQ.q22(jc), params=jbinding)
    got = run(Q.q22(pc), n_shards, native, **Q.q22_params(pc, "compiled"))
    assert_results_equal(want, got, msg=f"q22 x{n_shards} {native}")


@pytest.fixture(scope="module")
def golden_ctx():
    c = FlareContext(device="cpu")
    Q.register_tpch(c, sf=GOLDEN_SF, seed=GOLDEN_SEED)
    return c


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("qname", GOLDEN_QUERIES)
def test_golden_anchoring(golden_ctx, qname, native):
    want = load_golden(qname)
    for n in (1, 4):
        got = run(Q.QUERIES[qname](golden_ctx), n, native)
        assert_results_equal(want, got, msg=f"{qname} golden x{n}")


# ---------------------------------------------------------------------------
# plan shapes against the JAX package's shard planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qname", list(Q.QUERIES))
def test_shard_plan_matches_reference(ctxs, qname):
    """At 1 shard the sharded plan is the JAX package's, and the native
    pass fires the same patterns (the port names its CPU mode "torch",
    the JAX package "interpret")."""
    jc, pc = ctxs
    for native in (False, True):
        jlow = JQ.QUERIES[qname](jc).lower(engine="parallel", native=native)
        low = Q.QUERIES[qname](pc).lower(engine="parallel", native=native,
                                         mesh=mesh(1))
        jtext = jlow.plan().explain().replace("/interpret]", "/torch]")
        assert low.plan().explain() == jtext, native
        node = PAR.find_shard_node(low.plan())
        assert node.describe() == JPAR.find_shard_node(
            jlow.plan()).describe()
        if native:
            assert (low.dispatch_report().fired_patterns()
                    == jlow.dispatch_report().fired_patterns())


def test_shard_node_names_axis_and_count(ctxs):
    _, pc = ctxs
    low = Q.q6(pc).lower(engine="parallel", mesh=mesh(4, "rows"),
                         axis="rows")
    assert low.plan().describe().startswith("ShardMerge[rowsx4]")
    assert "ShardMerge" in Q.q1(pc).lower(engine="parallel").explain()
    sorted_scan = (pc.table("lineitem")
                   .filter(col("l_quantity") < lit(5.0))
                   .sort("l_orderkey").limit(5))
    assert "ShardGather" in sorted_scan.lower(
        engine="parallel", mesh=mesh(3)).explain()


def test_iterative_kernel_root_raises_typed(ctxs):
    _, pc = ctxs
    tr = pc.table("lineitem").train(
        "kmeans", columns=["l_quantity", "l_discount"], k=2, max_iter=3)
    with pytest.raises(PAR.UnsupportedParallelPlan,
                       match="IterativeKernel") as ei:
        tr.lower(engine="parallel")
    assert type(ei.value) is PAR.UnsupportedParallelPlan


def test_wrong_axis_and_foreign_mesh_raise(ctxs):
    _, pc = ctxs
    with pytest.raises(ValueError, match="not in mesh axes"):
        Q.q6(pc).lower(engine="parallel", mesh=mesh(2), axis="model")
    for engine in ("compiled", "stage", "volcano"):
        with pytest.raises(ValueError, match="mesh= applies"):
            Q.q6(pc).lower(engine=engine, mesh=mesh(2))
    with pytest.raises(ValueError, match="native=True requires"):
        Q.q6(pc).lower(engine="stage", native=True)
    with pytest.raises(ValueError, match="context's columns live on"):
        Q.q6(pc).lower(engine="parallel",
                       mesh=MESH.make_data_mesh(2, device="meta"))


def test_mesh_surface():
    m = mesh(4)
    assert m.axis_names == ("data",) and m.shape == {"data": 4}
    assert m.devices == (torch.device("cpu"),) * 4
    h = MESH.make_host_mesh(device="cpu")
    assert h.axis_names == ("data", "model") and h.shape == {"data": 1,
                                                             "model": 1}
    assert MESH.make_data_mesh(device="cpu").shape == {"data": 1}
    assert MESH.make_data_mesh(device=["cpu", "cpu"]).device.type == "cpu"
    with pytest.raises(ValueError, match="n_shards"):
        MESH.make_data_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="distinct devices"):
        MESH.make_data_mesh(2, device=["cpu", "meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MESH.make_data_mesh(2)


# ---------------------------------------------------------------------------
# shards: boundaries, empty shards, one fragment launch per shard
# ---------------------------------------------------------------------------


def test_shard_bounds_are_aligned_and_cover_the_spine():
    for rows in (0, 1, 127, 128, 129, 1000, 30_000, 60_000_906):
        for n in (1, 2, 3, 4, 7, 8):
            b = PAR.shard_bounds(rows, n)
            assert len(b) == n and b[0][0] == 0 and b[-1][1] == rows
            assert all(e0 == s1 for (_, e0), (s1, _) in zip(b, b[1:]))
            assert all(s % MO.ROW_ALIGN == 0 or s == rows for s, _ in b)
            assert max(e - s for s, e in b) <= PAR.shard_rows(rows, n)
    # TPC-H SF 10's lineitem: 4 shards stay below 2^24 rows, 2 do not
    assert PAR.shard_rows(60_000_906, 4) == 15_000_320 < 1 << 24
    assert PAR.shard_rows(60_000_906, 2) == 30_000_512 > 1 << 24


@pytest.fixture(scope="module")
def small():
    """300 rows: at 4 shards of 128 the shards hold 128, 128, 44 and 0."""
    rng = np.random.default_rng(3)
    n = 300
    data = {"k": rng.integers(0, 5, n).astype(np.int32),
            "x": np.round(rng.uniform(-50, 50, n), 2),
            "y": rng.integers(-20, 20, n).astype(np.int32)}
    ctx = FlareContext(device="cpu")
    ctx.from_arrays("t", data, domains={"k": 5})
    return ctx


def small_queries(ctx):
    t = ctx.table("t")
    keyless = t.filter(col("x") > 0.0).agg(
        PC.sum_(col("x"), "s"), PC.count("n"), PC.avg(col("y"), "a"),
        PC.min_(col("y"), "mn"), PC.max_(col("x"), "mx"))
    grouped = t.group_by("k").agg(
        PC.sum_(col("x"), "s"), PC.min_(col("y"), "mn"),
        PC.max_(col("x"), "mx"), PC.avg(col("x"), "a"),
        PC.any_(col("k"), "ak"), PC.count("n")).sort("k")
    gathered = t.filter(col("y") > 0).sort("x").limit(40)
    plain = t.filter(col("y") > 0).select("x", "y")
    return {"keyless": keyless, "grouped": grouped, "gathered": gathered,
            "plain": plain}


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
def test_empty_shards_merge_and_gather(small, native, n_shards):
    """Shards past the spine's end are empty: their partials are the
    neutral elements of each merge, and the gather concatenates their
    zero-length columns."""
    assert PAR.shard_bounds(300, 8)[3:] == [(300, 300)] * 5
    for name, df in small_queries(small).items():
        want = df.lower(engine="compiled").compile()()
        got = run(df, n_shards, native)
        assert_results_equal(want, got, rtol=2e-4, msg=name)
        assert np.array_equal(np.asarray(want.get("n", [])),
                              np.asarray(got.get("n", [])))


def test_empty_spine(small):
    """Every shard is empty: the neutral elements, as ``compiled`` gives
    them (keyless count 0, no valid group)."""
    ctx = FlareContext(device="cpu")
    ctx.from_arrays("t", {"k": np.zeros(0, np.int32),
                          "x": np.zeros(0, np.float64),
                          "y": np.zeros(0, np.int32)}, domains={"k": 5})
    for name, df in small_queries(ctx).items():
        want = df.lower(engine="compiled").compile()()
        got = run(df, 4, False)
        assert_results_equal(want, got, msg=name)
    got = run(small_queries(ctx)["keyless"], 4, True)
    assert np.asarray(got["n"])[0] == 0 and np.asarray(got["s"])[0] == 0


def _recording(monkeypatch, module, name):
    """Record the ``n`` of every call of ``module.name`` (a kernel's plain
    version, which the native fragment runs on the CPU)."""
    fn = getattr(module, name)
    sig = inspect.signature(fn)
    seen = []

    def wrapper(*a, **kw):
        seen.append(sig.bind(*a, **kw).arguments["n"])
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return seen


@pytest.mark.parametrize("qname,module,name", [
    ("q6", FA, "filter_agg_general_plain"),
    ("q1", SR, "segmented_multi_sum_plain"),
    ("q3", JP, "join_probe_agg_plain"),
    ("q14", JP, "join_probe_agg_plain"),
    ("q19", JP, "join_probe_agg_plain")])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_fragment_runs_once_per_shard(ctxs, monkeypatch, qname, module,
                                      name, n_shards):
    """Each shard runs the native fragment once, on exactly its rows."""
    _, pc = ctxs
    low = Q.QUERIES[qname](pc).lower(engine="parallel", native=True,
                                     mesh=mesh(n_shards))
    c = low.compile()
    seen = _recording(monkeypatch, module, name)
    c()
    rows = pc.catalog.table("lineitem").num_rows
    assert seen == [e - s for s, e in PAR.shard_bounds(rows, n_shards)]


# ---------------------------------------------------------------------------
# the merge table and its properties
# ---------------------------------------------------------------------------


def test_merge_table_covers_every_distributive_op():
    assert set(PAR._MERGE_OPS) == set(PL.AGG_OPS) - {"avg"}
    assert PAR._MERGE_OPS == JPAR._MERGE_OPS
    assert set(PL.AGG_OPS) == set(JPL.AGG_OPS)


#: derandomized: every run draws the same examples
SETTINGS = settings(max_examples=25, deadline=None, derandomize=True)


@SETTINGS
@given(st.data())
def test_sharded_grouped_merge_matches_unsharded(data):
    """The merge rules fold per-shard dense group-vector partials --
    with the engines' masked-fill semantics -- across ragged partitions,
    empty shards included, into the unsharded partials for
    sum/count/avg/min/max/any (``tests/test_property.py``'s property,
    on the port's merge ops)."""
    g = data.draw(st.integers(1, 9), label="num_groups")
    n = data.draw(st.integers(0, 80), label="n_rows")
    n_shards = data.draw(st.integers(1, 5), label="n_shards")
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 31 - 1)))
    kind = data.draw(st.sampled_from(
        ["uniform", "constant", "boundary", "skewed"]), label="codes")
    if n == 0 or kind == "uniform":
        codes = rng.integers(0, g, n)
    elif kind == "constant":
        codes = np.full(n, data.draw(st.integers(0, g - 1)))
    elif kind == "boundary":
        codes = rng.choice([0, g - 1], n)
    else:
        hot = data.draw(st.integers(0, g - 1))
        codes = np.where(rng.random(n) < 0.95, hot, rng.integers(0, g, n))
    codes = torch.as_tensor(codes.astype(np.int64))
    vals = torch.as_tensor(np.round(rng.uniform(-100, 100, n), 1))
    valid = torch.as_tensor(rng.random(n) < 0.8)
    cuts = sorted(data.draw(st.lists(st.integers(0, n),
                                     min_size=n_shards - 1,
                                     max_size=n_shards - 1)))
    bounds = [0] + cuts + [n]
    hi = torch.finfo(torch.float64).max
    lo = torch.finfo(torch.float64).min

    def dense_partials(c, v, m):
        c, v = c[m], v[m]
        mx = torch.full((g,), lo, dtype=torch.float64).scatter_reduce(
            0, c, v, "amax")
        return {
            "count": torch.zeros(g, dtype=torch.int64).index_add(
                0, c, torch.ones_like(c)),
            "sum": torch.zeros(g, dtype=torch.float64).index_add(0, c, v),
            "min": torch.full((g,), hi, dtype=torch.float64)
            .scatter_reduce(0, c, v, "amin"),
            "max": mx, "any": mx.clone()}

    parts = [dense_partials(codes[a:b], vals[a:b], valid[a:b])
             for a, b in zip(bounds[:-1], bounds[1:])]
    ref = dense_partials(codes, vals, valid)
    collective = {"psum": torch.add, "pmin": torch.minimum,
                  "pmax": torch.maximum}
    for op in PAR._MERGE_OPS:
        # the fold the engine runs is the collective the table names
        acc = MO._fill(op, ref[op])
        for p in parts:
            want = collective[PAR._MERGE_OPS[op]](acc, p[op])
            acc = MO._merge(op, acc, p[op])
            assert torch.equal(acc, want), op
        torch.testing.assert_close(acc, ref[op], rtol=1e-12, atol=1e-9,
                                   msg=op)
    merged = {"sum": ref["sum"] * 0, "count": ref["count"] * 0}
    for p in parts:
        merged = {k: MO._merge("sum", merged[k], p[k]) for k in merged}
    torch.testing.assert_close(
        merged["sum"] / torch.clamp(merged["count"], min=1),
        ref["sum"] / torch.clamp(ref["count"], min=1), rtol=1e-12,
        atol=1e-9)


@SETTINGS
@given(tables(max_rows=700), st.integers(1, 6),
       st.lists(st.sampled_from(["k", "tag"]), min_size=0, max_size=2,
                unique=True))
def test_engine_matches_compiled_at_any_shard_count(tbl_dom, n_shards,
                                                    keys):
    """Every merge op over any shard count -- ragged last shards and
    empty shards included -- equals the monolithic function, on both
    ``parallel`` and ``parallel`` with ``native=True``; counts exactly."""
    pc = FlareContext(device="cpu")
    for name, tbl in PT.tables_from_numpy(as_spec({"t": tbl_dom[0]})
                                          ).items():
        pc.register(name, tbl)

    def q():
        base = pc.table("t").filter(col("y") > -30)
        aggs = [PC.sum_(col("x"), "sx"), PC.count("n"),
                PC.min_(col("y"), "mn"), PC.max_(col("x"), "mx"),
                PC.avg(col("x"), "ax")]
        if keys:
            aggs.append(PC.any_(col(keys[0]), "ak"))
            return base.group_by(*keys).agg(*aggs)
        return base.agg(*aggs)

    want = q().lower(engine="compiled").compile().collect()
    for native in (False, True):
        got = run(q(), n_shards, native)
        assert_results_equal(want, got, rtol=1e-4, atol=1e-3,
                             msg=f"x{n_shards} {native}")
        assert np.array_equal(np.asarray(want["n"]), np.asarray(got["n"]))


# ---------------------------------------------------------------------------
# templates, reports, indexes, morsels, the ladder, persist, spans
# ---------------------------------------------------------------------------


def test_cache_keys_follow_the_mesh(ctxs):
    _, pc = ctxs
    kc = Q.q6(pc).lower(engine="compiled").cache_key
    k1 = Q.q6(pc).lower(engine="parallel", mesh=mesh(1)).cache_key
    k4 = Q.q6(pc).lower(engine="parallel", mesh=mesh(4)).cache_key
    kr = Q.q6(pc).lower(engine="parallel", mesh=mesh(4, "rows"),
                        axis="rows").cache_key
    assert len({kc, k1, k4, kr}) == 4
    assert k4 == Q.q6(pc).lower(engine="parallel", mesh=mesh(4)).cache_key
    assert k1 == Q.q6(pc).lower(engine="parallel").cache_key  # default


def test_template_compiles_once_per_mesh_shape(ctxs):
    jc, pc = ctxs
    cache = CompileCache()
    tmpl = Q.q6_template(pc)
    hits = []
    for n, binding in ((4, Q.TEMPLATE_BINDINGS["q6"][0]),
                       (4, Q.TEMPLATE_BINDINGS["q6"][1]),
                       (3, Q.TEMPLATE_BINDINGS["q6"][1])):
        compiled = tmpl.lower(engine="parallel", mesh=mesh(n)) \
            .compile(cache=cache)
        hits.append(compiled.stats.cache_hit)
        want = JQ.q6_template(jc).collect(engine="volcano", params=binding)
        assert_results_equal(want, compiled(**binding), msg=str(binding))
    assert hits == [False, True, False]
    assert cache.misses == 2 and cache.hits == 1 and len(cache) == 2


def test_batch_keeps_per_binding_dispatch(ctxs):
    """As in the JAX package, ``Compiled.batch`` vmaps ``compiled``
    only: a ``parallel`` template refuses it with ``TypeError``."""
    jc, pc = ctxs
    bindings = Q.TEMPLATE_BINDINGS["q6"][:2]
    c = Q.q6_template(pc).lower(engine="parallel", mesh=mesh(2)).compile()
    with pytest.raises(TypeError, match="batched execution requires"):
        c.batch(bindings)
    with pytest.raises(TypeError, match="batched execution requires"):
        JQ.q6_template(jc).lower(engine="parallel").compile().batch(bindings)


def test_native_dispatch_report_per_shard(ctxs):
    _, pc = ctxs
    lowered = Q.q6(pc).lower(engine="parallel", native=True, mesh=mesh(4))
    rep = lowered.dispatch_report()
    assert isinstance(rep, PAR.ShardedDispatchReport)
    assert rep.fired_patterns() == ["filter-scalar-agg"]
    assert rep.n_shards == 4 and len(rep.per_shard) == 4
    for shard_rep in rep.per_shard:
        assert shard_rep.fired_patterns() == ["filter-scalar-agg"]
    assert "(SPMD: x4 shards along 'data')" in str(rep)
    assert lowered.compile().stats.dispatch is rep
    assert Q.q6(pc).lower(engine="parallel").dispatch_report() is None


@pytest.mark.parametrize("qname,pattern", [("q3", "join-probe"),
                                           ("q5", "join-probe"),
                                           ("q10", "join-probe")])
def test_join_queries_fire_native_on_replicated_indexes(ctxs, oracle, qname,
                                                        pattern):
    jc, pc = ctxs
    want = oracle(qname, JQ.QUERIES[qname](jc))
    lowered = Q.QUERIES[qname](pc).lower(engine="parallel", native=True,
                                         mesh=mesh(3))
    rep = lowered.dispatch_report()
    assert rep.fired_patterns() == [pattern] and not rep.fallbacks
    assert rep.joins_cached and not rep.joins_rebuilt
    assert_results_equal(want, lowered.compile()(), msg=qname)


def test_q10_replicates_build_indexes(ctxs, oracle):
    jc, pc = ctxs
    lowered = Q.q10(pc).lower(engine="parallel", mesh=mesh(4))
    jrep = JQ.q10(jc).lower(engine="parallel").dispatch_report()
    rep = lowered.dispatch_report()
    assert len(rep.joins_cached) == len(jrep.joins_cached) == 3
    assert_results_equal(oracle("q10", JQ.q10(jc)), lowered.compile()(),
                         msg="q10 parallel indexed")


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("qname", ["q1", "q6"])
def test_morsels_per_shard(ctxs, qname, native):
    """Each shard streams its own morsels behind the cross-shard merge,
    with the budget per shard; the answer is the monolithic one."""
    _, pc = ctxs
    df = Q.QUERIES[qname](pc)
    base = df.lower(engine="compiled").compile().collect()
    low = df.lower(engine="parallel", native=native, mesh=mesh(4),
                   memory_budget=16 * 1024)
    node = PAR.find_shard_node(low.plan())
    inner = MO.find_morsel_node(node)
    assert isinstance(node, PAR.ShardMerge) and inner is not None
    assert inner.morsel_rows < PAR.shard_rows(node.true_rows, 4)
    assert_results_equal(base, low.compile().collect(), rtol=2e-4,
                         msg=qname)


def test_gather_plan_under_budget_raises(ctxs):
    _, pc = ctxs
    df = pc.table("lineitem").filter(col("l_quantity") < lit(2.0))
    with pytest.raises(MO.MemoryBudgetError, match="gathers"):
        df.lower(engine="parallel", mesh=mesh(2), memory_budget=1024)
    with pytest.raises(MO.MemoryBudgetError, match="gathers"):
        df.lower(engine="parallel", mesh=mesh(2), morsel_rows=128)
    # a budget the whole shard fits passes through
    low = df.lower(engine="parallel", mesh=mesh(2), memory_budget=1 << 30)
    assert isinstance(PAR.find_shard_node(low.plan()), PAR.ShardGather)


@pytest.fixture
def fresh(ctxs):
    """Fresh port and JAX contexts (empty compile caches) on the same
    tables: a warm ``compiled`` entry would answer a degraded rung
    without reaching its fault site."""
    jc, _ = ctxs
    fj = JaxContext()
    for name in jc.catalog.names():
        fj.register(name, jc.catalog.table(name))
    return fj, port_ctx(jc)


def test_persistent_compile_fault_walks_parallel_compiled_stage(fresh):
    fj, fp = fresh
    b = dict(Q.TEMPLATE_BINDINGS["q6"][0])
    with JFZ.inject("compile.xla", "every:1"):
        jc_ = JQ.TEMPLATES["q6"](fj).lower(engine="parallel") \
            .compile(cache=JaxCompileCache())
        want = jc_(**b)
    with RZ.inject("compile.xla", "every:1"):
        c = Q.TEMPLATES["q6"](fp).lower(engine="parallel", mesh=mesh(4)) \
            .compile(cache=CompileCache())
        got = c(**b)
    assert hops(c.stats.degraded)[:2] == [
        ("parallel", "compiled", "compile", "CompileFault"),
        ("compiled", "stage", "compile", "CompileFault")]
    assert hops(c.stats.degraded) == hops(jc_.stats.degraded)
    assert_results_equal(want, got)


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
def test_one_compile_fault_hops_to_compiled(fresh, native):
    """``compile.xla`` armed ``first:1``: one ``parallel -> compiled`` hop
    (the mesh is shed), then the right answer."""
    _, fp = fresh
    b = dict(Q.TEMPLATE_BINDINGS["q6"][1])
    with RZ.inject("compile.xla", "first:1") as plan:
        c = Q.TEMPLATES["q6"](fp).lower(engine="parallel", native=native,
                                        mesh=mesh(4)) \
            .compile(cache=CompileCache())
    assert hops(c.stats.degraded) == [("parallel", "compiled", "compile",
                                       "CompileFault")]
    assert plan.counts()["compile.xla"]["fired"] == 1
    assert c.engine_name == "compiled"
    assert PAR.find_shard_node(c._plan) is None
    oracle = Q.TEMPLATES["q6"](fp).lower(engine="volcano").compile()(**b)
    assert_results_equal(oracle, c(**b))


def test_native_kernel_site_fires_per_fragment(fresh):
    """``native.kernel`` is checked once per fragment of an annotated
    parallel template, after ``morsel.loop`` and before ``compile.xla``;
    its ``KernelBudgetError`` degrades to ``compiled``."""
    _, fp = fresh
    with RZ.inject({"morsel.loop": "first:0", "native.kernel": "first:1",
                    "compile.xla": "first:0"}) as plan:
        c = Q.q6(fp).lower(engine="parallel", native=True, mesh=mesh(2),
                           morsel_rows=1024).compile(cache=CompileCache())
    counts = plan.counts()
    assert counts["native.kernel"]["fired"] == 1
    assert counts["morsel.loop"]["checked"] >= 1
    assert hops(c.stats.degraded) == [("parallel", "compiled", "compile",
                                       "KernelBudgetError")]
    assert_results_equal(Q.q6(fp).lower(engine="compiled").compile()(),
                         c())


def test_compile_fault_raises_typed_with_the_ladder_off(fresh, monkeypatch):
    monkeypatch.setenv("FLARE_DEGRADE", "off")
    with RZ.inject("compile.xla", "first:1"):
        with pytest.raises(FZ.CompileFault):
            Q.q6(fresh[1]).lower(engine="parallel", mesh=mesh(2)) \
                .compile(cache=CompileCache())
    assert DG.events() == ()


def test_persist_attempt_writes_nothing(ctxs, tmp_path):
    _, pc = ctxs
    store = ArtifactStore(tmp_path)
    c = Q.q6(pc).lower(engine="parallel", mesh=mesh(2)) \
        .compile(cache=CompileCache(), persist=store)
    assert c.stats.persist.startswith("unsupported")
    assert store.tier("exec").unsupported == 1
    assert store.tier("exec").writes == 0
    assert not [f for _, _, fs in os.walk(tmp_path) for f in fs]
    c()


def test_shard_plan_span(ctxs):
    _, pc = ctxs
    with OT.capture() as trace:
        Q.q6(pc).lower(engine="parallel", native=True, mesh=mesh(4)) \
            .compile(cache=CompileCache())()
    sp = trace.first("shard_plan")
    assert sp is not None
    assert sp.attrs["axis"] == "data" and sp.attrs["native"] is True
    names = {s.name for s in trace.spans}
    assert {"shard_plan", "dispatch", "lower", "compile",
            "execute"} <= names


def test_execute_parallel_one_shot(ctxs, oracle):
    jc, pc = ctxs
    plan = pc.optimized(Q.q1(pc).plan)
    got = PAR.execute_parallel(plan, pc.catalog, mesh(3)).compact()
    assert_results_equal(oracle("q1", JQ.q1(jc)), got)


def test_explain_analyze_on_a_mesh(ctxs):
    _, pc = ctxs
    text = Q.q6(pc).explain(analyze=True, engine="parallel", native=True)
    assert "ShardMerge" in text and "FIRED    filter-scalar-agg" in text
    from repro_torch.obs import analyze as OA
    text = OA.explain_analyze(Q.q1(pc), engine="parallel", mesh=mesh(3))
    assert "ShardMerge[datax3]" in text
