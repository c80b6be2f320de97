"""The port's CUDA kernels on an NVIDIA Hopper card (``-m gpu``).

Every test here needs an sm_90 device and skips elsewhere with the
reason; on the card run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each native fragment's kernel is held against the generic lowering of
the same query on the same card (rtol 1e-3: summation order differs).
This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; ``expr_queries`` is also used by the CPU tests.
"""
import pytest
import torch

from conftest import assert_results_equal
from repro_torch.core import FlareContext
from repro_torch.kernels.filter_agg import kernel as FA
from repro_torch.kernels.join_probe import kernel as JP
from repro_torch.kernels.segmented_reduce import kernel as SR
from repro_torch.relational import queries as Q


def expr_queries(ctx, m):
    """Queries whose fragments exercise the code generator beyond TPC-H:
    Not, IfThenElse over values and over predicates, numeric and
    dictionary isin (with an absent member), ordered comparisons against
    absent string literals, string-predicate code ranges, casts to bool,
    division, a grouped any_, and a composite join key.  ``m`` is the
    package's ``core`` module (JAX or port)."""
    col, lit, when, cast = m.col, m.lit, m.when, m.cast
    li = ctx.table("lineitem")
    part = ctx.table("part")
    return {
        "not-if-isin": li.filter(
            ~(col("l_returnflag") == "R")
            & col("l_shipmode").isin(["AIR", "MAIL", "NOT A MODE"])).agg(
            m.sum_(when(col("l_discount") > 0.05, col("l_extendedprice"),
                        col("l_tax")), "a"),
            m.avg(col("l_quantity") / (col("l_tax") + lit(0.01)), "b"),
            m.count("n")),
        "absent-literal-order": li.filter(
            (col("l_shipmode") < "MAX")
            & (col("l_shipinstruct") >= "D")
            & col("l_quantity").isin([1.0, 2.0, 3.0, 7.0])).agg(
            m.sum_(col("l_extendedprice"), "s"), m.count("n")),
        "bool-branches-cast": li.filter(
            when(col("l_quantity") > 10.0, col("l_discount") > 0.02,
                 col("l_tax") > 0.03)
            & cast(col("l_discount"), "bool")).agg(
            m.sum_(col("l_quantity"), "q"), m.count("n")),
        "grouped-any": li.filter(col("l_shipdate") > 9000).group_by(
            "l_returnflag", "l_linestatus").agg(
            m.sum_(col("l_discount") * col("l_tax"), "dt"),
            m.any_(col("l_linestatus"), "ls"),
            m.avg(col("l_extendedprice"), "p"), m.count("n")),
        "probe-strpred": li.join(part, on="l_partkey",
                                 right_on="p_partkey").filter(
            col("p_type").startswith("PROMO")
            | col("p_container").like("%BAG")
            | col("p_brand").contains("#3")).group_by("p_size").agg(
            m.sum_(col("l_quantity"), "q"), m.count("n")),
        "probe-composite-key": li.join(
            ctx.table("partsupp"), on=["l_partkey", "l_suppkey"],
            right_on=["ps_partkey", "ps_suppkey"]).agg(
            m.sum_(col("l_quantity") * col("ps_supplycost"), "cost"),
            m.count("n")),
    }


EXPR_FIRED = {"not-if-isin": ["filter-scalar-agg"],
               "absent-literal-order": ["filter-scalar-agg"],
               "bool-branches-cast": ["filter-scalar-agg"],
               "grouped-any": ["grouped-agg"],
               "probe-strpred": ["join-probe"],
               "probe-composite-key": ["join-probe"]}


@pytest.fixture
def card_ctx():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU (sm_90); the CUDA kernels "
                    "are built for sm_90a only")
    ctx = FlareContext(device="cuda")
    Q.register_tpch(ctx, sf=0.05)
    return ctx


@pytest.mark.gpu
def test_tpch_fragments_match_generic_on_card(card_ctx):
    before = (FA.launches, SR.launches, JP.launches)
    for name in ("q1", "q3", "q5", "q6", "q13", "q14"):
        native = Q.QUERIES[name](card_ctx).lower(native=True).compile()()
        plain = Q.QUERIES[name](card_ctx).lower().compile()()
        assert_results_equal(plain, native, rtol=1e-3, msg=name)
    after = (FA.launches, SR.launches, JP.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.gpu
def test_expression_forms_match_generic_on_card(card_ctx):
    import repro_torch.core as PC
    for name, df in expr_queries(card_ctx, PC).items():
        low = df.lower(engine="compiled", native=True)
        assert low.dispatch_report().fired_patterns() == EXPR_FIRED[name]
        assert_results_equal(df.lower().compile()(), low.compile()(),
                             rtol=1e-3, msg=name)
