"""Public functions of the port's modules against the JAX package's, on
the CPU at SF 0.005:

* ``core.engines.execute``, the one-shot front door (rows on each engine
  against the JAX package's);
* ``core.stages.Engine`` and ``available_engines`` (the JAX package's
  engines but ``parallel``, which comes with the sharded engine);
* ``native.registry.get_pattern`` / ``available_patterns`` and
  ``native.dispatch.has_native_ops``;
* ``relational.queries.join_micro`` (the paper's Fig. 6 join) on every
  engine with both join strategies;
* a batched template whose join sorts a ``param()``-filtered build side
  in the program: ``torch.func.vmap`` batches every operator of the join
  (no per-binding fallback loop) and equals per-binding calls.
"""
import warnings

import numpy as np
import pytest
import torch

import repro.core as JC
import repro.native as JN
import repro_torch.core as PC
import repro_torch.native as PN
from conftest import assert_results_equal
from repro.core import CompileStats as JaxCompileStats
from repro.core import FlareContext as JaxContext
from repro.core import engines as JENG
from repro.core import stages as JS
from repro.relational import queries as JQ
from repro_torch.core import CompileCache, CompileStats, FlareContext
from repro_torch.core import engines as ENG
from repro_torch.core import stages as S
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT

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


@pytest.mark.parametrize("engine", ["volcano", "compiled", "stage"])
@pytest.mark.parametrize("qname", ["q1", "q6", "q14"])
def test_execute_matches_reference(ctxs, engine, qname):
    jc, pc = ctxs
    jplan = jc.optimized(JQ.QUERIES[qname](jc).plan)
    plan = pc.optimized(Q.QUERIES[qname](pc).plan)
    want = JENG.execute(jplan, jc.catalog, engine, jc.cache).compact()
    stats = CompileStats()
    got = ENG.execute(plan, pc.catalog, engine,
                      cache=ENG.DeviceCache(torch.device("cpu")),
                      stats=stats)
    assert_results_equal(want, got.compact(), msg=f"{qname}/{engine}")
    assert stats.engine == engine and stats.cache_key is not None
    assert set(vars(stats)) == set(vars(JaxCompileStats()))


def test_execute_unoptimized_plan_and_params(ctxs):
    """``execute`` runs the plan it is given (no optimizer) and binds
    params, as the JAX package's does."""
    jc, pc = ctxs
    b = dict(Q.TEMPLATE_BINDINGS["q6"][1])
    want = JENG.execute(JQ.TEMPLATES["q6"](jc).plan, jc.catalog,
                        "volcano", params=b).compact()
    cc = CompileCache()
    got = ENG.execute(Q.TEMPLATES["q6"](pc).plan, pc.catalog, "compiled",
                      cache=pc.cache, params=b, compile_cache=cc)
    assert_results_equal(want, got.compact())
    assert len(cc) == 1


def test_execute_without_a_card_asks_for_the_cpu(ctxs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: execute() runs there")
    with pytest.raises(RuntimeError, match="torch.device\\('cpu'\\)"):
        ENG.execute(Q.q6(ctxs[1]).plan, ctxs[1].catalog, "compiled")


def test_available_engines_match_reference():
    assert PC.available_engines() == S.available_engines()
    assert set(S.available_engines()) == set(JC.available_engines()) - {
        "parallel"}
    with pytest.raises(ValueError, match="available"):
        S.get_engine("bogus")


def test_registered_engines_follow_the_protocol():
    """Every registered engine has the members ``Engine`` names, with the
    port's ``compile(artifact, device)``."""
    for name in S.available_engines():
        eng = S.get_engine(name)
        assert eng.name == name
        assert callable(eng.lower) and callable(eng.compile)
    assert set(S.Engine.__dict__) >= {"lower", "compile"}
    assert set(JS.Engine.__dict__) >= {"lower", "compile"}


def test_patterns_match_reference():
    assert PN.available_patterns() == JN.available_patterns()
    for name in PN.available_patterns():
        assert PN.get_pattern(name).name == name
        assert (PN.get_pattern(name).requires_index
                == JN.get_pattern(name).requires_index)
    with pytest.raises(KeyError):
        PN.get_pattern("no-such-pattern")


@pytest.mark.parametrize("qname", ["q1", "q6", "q13", "q14"])
def test_has_native_ops_matches_reference(ctxs, qname):
    jc, pc = ctxs
    for native in (False, True):
        jp = JQ.QUERIES[qname](jc).lower(engine="compiled",
                                         native=native).plan()
        pp = Q.QUERIES[qname](pc).lower(engine="compiled",
                                        native=native).plan()
        assert PN.has_native_ops(pp) == JN.has_native_ops(jp), native
    assert not PN.has_native_ops(Q.QUERIES[qname](pc).plan)


@pytest.mark.parametrize("strategy", [None, "sortmerge"])
@pytest.mark.parametrize("engine", ["compiled", "compiled-native", "stage",
                                    "volcano", "tuple"])
def test_join_micro_matches_reference(ctxs, engine, strategy):
    jc, pc = ctxs
    want = JQ.join_micro(jc, strategy).collect(engine="volcano")
    low = Q.join_micro(pc, strategy).lower(engine=engine)
    got = low.compile()()
    assert_results_equal(want, got, msg=f"{engine}/{strategy}")
    assert int(np.asarray(got["n"])[0]) == \
        pc.catalog.table("lineitem").num_rows
    if engine == "compiled-native":
        jlow = JQ.join_micro(jc, strategy).lower(engine="compiled",
                                                 native=True)
        assert (low.dispatch_report().fired_patterns()
                == jlow.dispatch_report().fired_patterns() == ["join-probe"])


def test_batched_in_program_join_needs_no_fallback_loop():
    """A build side filtered by a ``param()`` with no declared-unique key
    gets no cached index: the join sorts it in the program, so the probe
    positions depend on the binding.  vmap must batch every operator of
    that join (an in-place op there has no batching rule and makes torch
    warn and loop over the bindings), and each binding's slice equals
    its own call."""
    rng = np.random.default_rng(3)
    ctx = FlareContext(device="cpu")
    ctx.from_arrays("probe", {"k": rng.integers(0, 40, 500).astype(np.int32),
                              "x": np.round(rng.uniform(0, 10, 500), 2)},
                    domains={"k": 40})
    ctx.from_arrays("build", {"k": rng.permutation(40).astype(np.int32),
                              "w": rng.integers(0, 100, 40).astype(np.int32)},
                    domains={"k": 40})
    df = (ctx.table("probe")
          .join(ctx.table("build").filter(PC.col("w") < PC.param("w_hi",
                                                                 "int32")),
                on="k")
          .agg(PC.sum_(PC.col("x"), "s"), PC.count("n")))
    low = df.lower(engine="compiled")
    assert len(low.dispatch_report().joins_rebuilt) == 1
    c = low.compile(cache=CompileCache())
    bindings = [{"w_hi": v} for v in (0, 25, 50, 101)]
    with warnings.catch_warnings():
        # torch's per-binding fallback announces itself with this warning
        warnings.filterwarnings("error", message=".*batching rule")
        got = c.batch(bindings)
    for b, g in zip(bindings, got):
        assert_results_equal(c(**b), g.compact(), msg=str(b))
    assert int(np.asarray(got[0].compact()["n"])[0]) == 0
