"""The port's main path, end to end on the CPU, against the JAX package.

The same generated tables (the reference generator's, carried across with
``tables_from_numpy``) go through the JAX volcano oracle, the JAX
``compiled`` engine with native dispatch (Pallas interpret mode), and the
port's ``compiled`` engine with and without native dispatch (the kernels'
plain versions on the CPU), at SF 0.005 and ``conftest`` tolerance (rtol
5e-3: the device engines run in 32-bit floats).
"""
import importlib.util
import os

import pytest
import torch

from conftest import assert_results_equal
from repro.core import FlareContext as JaxContext
from repro.relational import queries as JQ
from repro_torch.core import FlareContext
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT

from test_torch_data_ir import as_spec
from test_torch_gpu import EXPR_FIRED, expr_queries

SF = 0.005
SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke.py")


@pytest.fixture(scope="module")
def expected_patterns():
    """``chip_smoke.EXPECTED_PATTERNS``, loaded from the script's file (it
    imports only the standard library and numpy at import)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.EXPECTED_PATTERNS


@pytest.fixture(scope="module")
def ctxs():
    jc = JaxContext()
    JQ.register_tpch(jc, sf=SF)
    pc = FlareContext(device="cpu")
    tables = {n: jc.catalog.table(n) for n in jc.catalog.names()}
    for name, tbl in PT.tables_from_numpy(as_spec(tables)).items():
        pc.register(name, tbl)
    return jc, pc


@pytest.mark.parametrize("qname", list(Q.QUERIES))
def test_query_matches_reference(ctxs, expected_patterns, qname):
    jc, pc = ctxs
    oracle = JQ.QUERIES[qname](jc).collect(engine="volcano")
    jlow = JQ.QUERIES[qname](jc).lower(engine="compiled", native=True)
    jnative = jlow.compile()()
    plain = Q.QUERIES[qname](pc).lower(engine="compiled").compile()()
    low = Q.QUERIES[qname](pc).lower(engine="compiled", native=True)
    native = low.compile()()
    for label, got in (("compiled", plain), ("compiled-native", native)):
        assert_results_equal(oracle, got, msg=f"{qname} {label} vs volcano")
        assert_results_equal(jnative, got,
                             msg=f"{qname} {label} vs JAX native")
    fired = low.dispatch_report().fired_patterns()
    assert fired == jlow.dispatch_report().fired_patterns()
    assert fired == expected_patterns[qname]
    assert [d.node for d in low.dispatch_report().fallbacks] == \
        [d.node for d in jlow.dispatch_report().fallbacks]


@pytest.mark.parametrize("tname", list(Q.TEMPLATES))
def test_template_matches_reference_and_compiles_once(ctxs, expected_patterns,
                                                     tname):
    jc, pc = ctxs
    jtmpl = JQ.TEMPLATES[tname](jc)
    jcompiled = jtmpl.lower(engine="compiled", native=True).compile()
    misses, hits = pc.compile_cache.misses, pc.compile_cache.hits
    for binding in Q.TEMPLATE_BINDINGS[tname]:
        low = Q.TEMPLATES[tname](pc).lower(engine="compiled", native=True)
        assert low.dispatch_report().fired_patterns() == \
            expected_patterns[f"template:{tname}"]
        got = low.compile()(**binding)
        assert_results_equal(jtmpl.collect(engine="volcano", params=binding),
                             got, msg=f"{tname} {binding} vs volcano")
        assert_results_equal(jcompiled(**binding), got,
                             msg=f"{tname} {binding} vs JAX native")
    # one compile serves every binding of the template
    n = len(Q.TEMPLATE_BINDINGS[tname])
    assert pc.compile_cache.misses - misses == 1
    assert pc.compile_cache.hits - hits == n - 1


def test_q22_two_phase_matches_reference(ctxs):
    jc, pc = ctxs
    jbinding = JQ.q22_params(jc, "volcano")
    binding = Q.q22_params(pc, "compiled-native")
    assert binding["acctbal_min"] == pytest.approx(jbinding["acctbal_min"],
                                                   rel=5e-3)
    oracle = JQ.q22(jc).collect(engine="volcano", params=jbinding)
    got = Q.q22(pc).lower(engine="compiled", native=True).compile()(
        **binding)
    assert_results_equal(oracle, got, msg="q22 two-phase")


def test_join_index_off_keeps_results(ctxs):
    """join_index=False: every join sorts its build side in the program
    and join-probe cannot fire; the answer is the same."""
    jc, pc = ctxs
    low = Q.q5(pc).lower(engine="compiled", native=True, join_index=False)
    assert "join-probe" not in low.dispatch_report().fired_patterns()
    assert not low.dispatch_report().joins_cached
    assert_results_equal(JQ.q5(jc).collect(engine="volcano"),
                         low.compile()(), msg="q5 join_index=False")


def test_context_defaults_to_the_card():
    if torch.cuda.is_available():
        assert FlareContext().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FlareContext()
    assert FlareContext(device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# expression forms the TPC-H suite does not reach
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(EXPR_FIRED))
def test_expression_forms_match_reference(ctxs, name):
    import repro.core as JC
    import repro_torch.core as PC
    jc, pc = ctxs
    want = expr_queries(jc, JC)[name].collect(engine="volcano")
    low = expr_queries(pc, PC)[name].lower(engine="compiled", native=True)
    assert low.dispatch_report().fired_patterns() == EXPR_FIRED[name]
    assert_results_equal(want, low.compile()(), msg=name)
