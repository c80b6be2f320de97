"""The port's stage, volcano and tuple engines against the JAX package.

The same generated tables (the reference generator's, carried across with
``tables_from_numpy``) go through the JAX volcano oracle and the port's
three engines at SF 0.005, the scale of the JAX engine matrix:

* ``stage`` and ``volcano`` on every query, every template binding and
  q22 in two phases, at ``conftest`` tolerance (rtol 5e-3: the stage
  engine's device columns are 32-bit);
* the port's ``volcano`` against the JAX one at rtol 1e-9: both are numpy
  float64 over byte-identical tables;
* ``tuple`` (row-at-a-time, slow by design) on every query and one
  binding per template, unordered as in the reference matrix: it emits
  groups in lexicographic key order.

Also: the stage decomposition and ``stages_run`` equal the reference's,
``collect()`` defaults to the stage engine, ``native=True`` is refused by
the interpreted engines, the heterogeneous plan nodes (``IterativeKernel``,
``MapBatches``) run on the three engines equal to the JAX volcano oracle,
and the port's ``data.io`` writes and reads what the JAX package's does.
"""
import numpy as np
import pytest

from conftest import assert_results_equal
from repro.core import FlareContext as JaxContext
from repro.core import engines as JENG
from repro.core import ml as JML
from repro.core import plan as JP
from repro.core import stages as JS
from repro.core import col as jcol
from repro.core import sum_ as jsum
from repro.data import io as JIO
from repro.relational import queries as JQ
from repro.relational import table as JT
from repro_torch.core import FlareContext, col, sum_
from repro_torch.core import engines as ENG
from repro_torch.core import ml as ML
from repro_torch.core import plan as P
from repro_torch.core import stages as S
from repro_torch.data import io as PIO
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT

from test_torch_data_ir import as_spec

SF = 0.005

TEMPLATE_CASES = [(t, i) for t in Q.TEMPLATES
                  for i in range(len(Q.TEMPLATE_BINDINGS[t]))]


@pytest.fixture(scope="module")
def ctxs():
    jc = JaxContext()
    JQ.register_tpch(jc, sf=SF)
    pc = FlareContext(device="cpu")
    tables = {n: jc.catalog.table(n) for n in jc.catalog.names()}
    for name, tbl in PT.tables_from_numpy(as_spec(tables)).items():
        pc.register(name, tbl)
    return jc, pc


def check_engines(want, df, params, what, tuple_engine=True):
    """``df`` on the port's engines against the JAX volcano result."""
    got = df.collect(engine="volcano", params=params)
    assert_results_equal(want, got, rtol=1e-9, atol=0,
                         msg=f"{what} volcano vs JAX volcano")
    assert_results_equal(want, df.collect(engine="stage", params=params),
                         msg=f"{what} stage")
    if tuple_engine:
        assert_results_equal(want, df.collect(engine="tuple", params=params),
                             ordered=False, msg=f"{what} tuple")


@pytest.mark.parametrize("qname", list(Q.QUERIES))
def test_query_on_every_port_engine(ctxs, qname):
    jc, pc = ctxs
    want = JQ.QUERIES[qname](jc).collect(engine="volcano")
    check_engines(want, Q.QUERIES[qname](pc), None, qname)


@pytest.mark.parametrize("tname,bi", TEMPLATE_CASES,
                         ids=[f"{t}-b{i}" for t, i in TEMPLATE_CASES])
def test_template_binding_on_every_port_engine(ctxs, tname, bi):
    jc, pc = ctxs
    binding = Q.TEMPLATE_BINDINGS[tname][bi]
    want = JQ.TEMPLATES[tname](jc).collect(engine="volcano", params=binding)
    # the tuple engine takes the first binding only: it is slow by design
    check_engines(want, Q.TEMPLATES[tname](pc), binding, f"{tname}[{bi}]",
                  tuple_engine=bi == 0)


def test_q22_two_phase_on_every_port_engine(ctxs):
    jc, pc = ctxs
    jbinding = JQ.q22_params(jc, "volcano")
    for engine in ("volcano", "stage"):
        binding = Q.q22_params(pc, engine)
        assert binding["acctbal_min"] == pytest.approx(
            jbinding["acctbal_min"], rel=1e-9 if engine == "volcano"
            else 5e-3)
    want = JQ.q22(jc).collect(engine="volcano", params=jbinding)
    check_engines(want, Q.q22(pc), Q.q22_params(pc, "volcano"), "q22")


@pytest.mark.parametrize("qname", list(Q.QUERIES))
def test_stage_decomposition_matches_reference(ctxs, qname):
    jc, pc = ctxs
    jlow = JQ.QUERIES[qname](jc).lower(engine="stage")
    low = Q.QUERIES[qname](pc).lower(engine="stage")
    assert low.compiler_ir() == jlow.compiler_ir()
    assert low.compiler_ir("stages") == [
        s.explain() for s in S.stage_decomposition(low.plan())]
    jeng, eng = JENG.StageEngine(), ENG.StageEngine()
    jeng.execute(jlow.plan(), jc.catalog, jc.cache)
    eng.execute(low.plan(), pc.catalog, pc.cache)
    assert eng.stages_run == jeng.stages_run == len(low.compiler_ir())
    assert len(JS.stage_decomposition(jlow.plan())) == eng.stages_run


def test_stage_engine_rejects_an_unknown_dialect(ctxs):
    _, pc = ctxs
    with pytest.raises(ValueError, match="stages"):
        Q.q3(pc).lower(engine="stage").compiler_ir("stablehlo")
    assert Q.q6(pc).lower(engine="volcano").compiler_ir() == \
        Q.q6(pc).lower(engine="volcano").plan().explain()


def test_collect_defaults_to_the_stage_engine(ctxs, monkeypatch):
    _, pc = ctxs
    runs = []
    execute = ENG.StageEngine.execute

    def spy(self, *args, **kwargs):
        runs.append(self)
        return execute(self, *args, **kwargs)

    monkeypatch.setattr(ENG.StageEngine, "execute", spy)
    got = Q.q1(pc).collect()
    assert len(runs) == 1
    assert_results_equal(Q.q1(pc).collect(engine="volcano"), got,
                         msg="collect()")
    assert Q.q1(pc).count() == len(got["l_returnflag"])
    assert len(runs) == 2


def test_show_prints_rows(ctxs, capsys):
    _, pc = ctxs
    Q.q1(pc).show(n=2)
    out = capsys.readouterr().out
    assert "l_returnflag" in out and "only showing top 2 of" in out


def test_execute_reports_compile_stats(ctxs):
    _, pc = ctxs
    stats = ENG.CompileStats()
    res = pc.execute(Q.q6(pc).plan, "stage", stats=stats)
    assert stats.engine == "stage" and res.num_rows() == 1
    assert stats.run_s > 0 and stats.cache_key[0] == "stage"


@pytest.mark.parametrize("engine", ["volcano", "stage", "tuple"])
def test_native_rejects_interpreted_engines(ctxs, engine):
    _, pc = ctxs
    with pytest.raises(ValueError, match="native=True requires"):
        Q.q6(pc).lower(engine=engine, native=True)


def _colsum(x, weights=None):
    return {"s": (x * weights[:, None]).sum(0)}


#: a training kernel and a batch UDF over one lineitem column, written for
#: each package: the JAX twins take jnp arrays, the port's torch tensors
KERNELS = {"jax": JML.TrainKernel("colsum", _colsum),
           "port": ML.TrainKernel("colsum", _colsum)}
DOUBLES = {"jax": lambda c: {"q2": c["l_quantity"] * 2.0},
           "port": lambda c: {"q2": c["l_quantity"] * 2.0}}


def heterogeneous_plans(ctx, P_, PT_, col_, sum_fn, side):
    """``IterativeKernel`` and ``MapBatches`` plans over lineitem."""
    li = ctx.table("lineitem").filter(col_("l_quantity") < 25.0)
    train = P_.IterativeKernel(li.plan, KERNELS[side],
                               ("l_quantity", "l_discount"), None, ())
    batches = P_.MapBatches(li.plan, DOUBLES[side], ("l_quantity",),
                            (PT_.Field("q2", PT_.FLOAT32),))
    return train, P_.Aggregate(batches, (), (sum_fn(col_("q2"), "s"),))


@pytest.mark.parametrize("engine", ["volcano", "stage", "tuple"])
def test_heterogeneous_plan_nodes_run(ctxs, engine):
    jc, pc = ctxs
    jplans = heterogeneous_plans(jc, JP, JT, jcol, jsum, "jax")
    pplans = heterogeneous_plans(pc, P, PT, col, sum_, "port")
    for jplan, pplan in zip(jplans, pplans):
        # the train plan's result is the kernel's dict {"s": [2]}, the
        # aggregate's a one-row column "s"
        want = JS.lower_plan(jplan, jc.catalog, "volcano", jc.cache,
                             jc.compile_cache).compile()()
        got = S.lower_plan(pplan, pc.catalog, pc.cache, pc.compile_cache,
                           engine=engine).compile()()
        assert_results_equal(want, got,
                             msg=f"{type(pplan.child).__name__} {engine}")


@pytest.fixture(scope="module")
def lineitem(ctxs):
    jc, pc = ctxs
    return jc.catalog.table("lineitem"), pc.catalog.table("lineitem")


def test_csv_writer_matches_reference(lineitem, tmp_path):
    jt, pt = lineitem
    JIO.to_csv(jt, str(tmp_path / "ref.csv"))
    PIO.to_csv(pt, str(tmp_path / "port.csv"))
    assert (tmp_path / "ref.csv").read_bytes() == \
        (tmp_path / "port.csv").read_bytes()


@pytest.mark.parametrize("reader", ["read_csv_compiled", "read_csv_generic"])
def test_csv_readers_match_reference(lineitem, tmp_path, reader):
    jt, pt = lineitem
    path = str(tmp_path / "li.csv")
    PIO.to_csv(pt, path)
    cols = ["l_quantity", "l_extendedprice", "l_returnflag", "l_shipdate"]
    want = getattr(JIO, reader)(path, jt.schema, cols)
    got = getattr(PIO, reader)(path, pt.schema, cols)
    assert got.schema.names == want.schema.names == cols
    for n in cols:
        np.testing.assert_array_equal(got.columns[n].decode(),
                                      want.columns[n].decode())
        assert got.schema[n].dtype == want.schema[n].dtype
    np.testing.assert_array_equal(got.columns["l_quantity"].decode(),
                                  pt.columns["l_quantity"].decode())


def test_compiled_csv_reader_source_matches_reference(lineitem):
    jt, pt = lineitem
    assert PIO.generate_csv_reader_source(pt.schema) == \
        JIO.generate_csv_reader_source(jt.schema)


def test_flarecol_round_trip_matches_reference(lineitem, tmp_path):
    jt, pt = lineitem
    JIO.write_flarecol(jt, str(tmp_path / "ref.flc"))
    PIO.write_flarecol(pt, str(tmp_path / "port.flc"))
    assert (tmp_path / "ref.flc").read_bytes() == \
        (tmp_path / "port.flc").read_bytes()
    back = PIO.read_flarecol(str(tmp_path / "port.flc"),
                             columns=["l_orderkey", "l_shipmode"])
    assert back.schema.names == ["l_orderkey", "l_shipmode"]
    np.testing.assert_array_equal(back.columns["l_shipmode"].decode(),
                                  pt.columns["l_shipmode"].decode())


def test_csv_direct_q6_equals_preloaded(lineitem, tmp_path):
    """The paper's "direct from CSV" row: q6 over a table read back by
    the compiled reader equals q6 over the generated table."""
    _, pt = lineitem
    path = str(tmp_path / "li.csv")
    PIO.to_csv(pt, path)
    direct = FlareContext(device="cpu")
    direct.register("lineitem", PIO.read_csv_compiled(path, pt.schema))
    pre = FlareContext(device="cpu")
    pre.register("lineitem", pt)
    got = Q.q6(direct).collect(engine="compiled")
    want = Q.q6(pre).collect(engine="compiled")
    assert_results_equal(want, got, rtol=1e-6, msg="q6 direct from CSV")
