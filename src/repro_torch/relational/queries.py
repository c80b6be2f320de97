"""TPC-H queries used in the paper's evaluation (Figs. 4, 6, 9).

Implemented via the deferred DataFrame API exactly as a Spark user would
write them.  Queries BUILD PLANS ONLY: the engine choice (``compiled``,
with or without ``native=True``) happens later, at ``df.lower(...)`` /
``collect`` time.  Join orders follow the reference formulation with the
probe side on the large table (paper section 6.1 matches HyPer's orders;
our N:1 chains give the same shapes).

The TPC-H selectivity variants (each official query is a template over
random substitution parameters) are expressed as *prepared-query
templates* in ``TEMPLATES``: ``q6_template`` and friends use
:func:`repro_torch.core.param` placeholders, so ONE compiled program serves
every parameter binding -- ``q6_template(ctx).lower("compiled")
.compile()(**binding)``.

Deviations from spec, recorded per DESIGN.md section 3: dates are dense
int32 days; Q10 outputs c_custkey (no c_name text column is generated);
Q13 uses the FD-aware two-phase group formulation; Q22 groups by
c_nationkey instead of phone prefix (no phone column).  None of these
change the operator mix the paper benchmarks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from repro_torch.core import (DataFrame, FlareContext, WithDomain, any_,
                              avg, cast, col, count, lit, param, sum_, when)
from repro_torch.relational.tpch import date, generate

# ---------------------------------------------------------------------------


def register_tpch(ctx: FlareContext, sf: float = 0.01, seed: int = 0) -> None:
    for name, tbl in generate(sf, seed).items():
        ctx.register(name, tbl)


def _rev():
    return col("l_extendedprice") * (lit(1.0) - col("l_discount"))


# -- Q1: pricing summary report (paper: Flare 34x over Spark) -----------------


def q1(ctx: FlareContext) -> DataFrame:
    li = ctx.table("lineitem")
    return (li.filter(col("l_shipdate") <= date("1998-12-01") - 90)
            .group_by("l_returnflag", "l_linestatus")
            .agg(sum_(col("l_quantity"), "sum_qty"),
                 sum_(col("l_extendedprice"), "sum_base_price"),
                 sum_(_rev(), "sum_disc_price"),
                 sum_(_rev() * (lit(1.0) + col("l_tax")), "sum_charge"),
                 avg(col("l_quantity"), "avg_qty"),
                 avg(col("l_extendedprice"), "avg_price"),
                 avg(col("l_discount"), "avg_disc"),
                 count("count_order"))
            .sort("l_returnflag", "l_linestatus"))


# -- Q3: shipping priority ------------------------------------------------------


def q3(ctx: FlareContext) -> DataFrame:
    li = ctx.table("lineitem").filter(col("l_shipdate") > date("1995-03-15"))
    orders = ctx.table("orders").filter(
        col("o_orderdate") < date("1995-03-15"))
    cust = ctx.table("customer").filter(col("c_mktsegment") == "BUILDING")
    return (li.join(orders, on="l_orderkey", right_on="o_orderkey")
            .join(cust, on="o_custkey", right_on="c_custkey")
            .group_by("l_orderkey")
            .agg(sum_(_rev(), "revenue"),
                 any_(col("o_orderdate"), "o_orderdate"),
                 any_(col("o_shippriority"), "o_shippriority"))
            .sort(("revenue", False), "o_orderdate")
            .limit(10))


# -- Q4: order priority checking (semi join; paper cites Q21 semi 89x) ---------


def q4(ctx: FlareContext) -> DataFrame:
    orders = ctx.table("orders").filter(
        (col("o_orderdate") >= date("1993-07-01"))
        & (col("o_orderdate") < date("1993-10-01")))
    late = ctx.table("lineitem").filter(
        col("l_commitdate") < col("l_receiptdate"))
    return (orders.join(late, on="o_orderkey", right_on="l_orderkey",
                        how="semi")
            .group_by("o_orderpriority")
            .agg(count("order_count"))
            .sort("o_orderpriority"))


# -- Q5: local supplier volume (5-way join; paper: 20x-60x) ---------------------


def q5(ctx: FlareContext) -> DataFrame:
    orders = ctx.table("orders").filter(
        (col("o_orderdate") >= date("1994-01-01"))
        & (col("o_orderdate") < date("1995-01-01")))
    q = (ctx.table("lineitem")
         .join(orders, on="l_orderkey", right_on="o_orderkey")
         .join(ctx.table("customer"), on="o_custkey", right_on="c_custkey")
         .join(ctx.table("supplier"), on="l_suppkey", right_on="s_suppkey")
         .filter(col("c_nationkey") == col("s_nationkey"))
         .join(ctx.table("nation"), on="s_nationkey", right_on="n_nationkey")
         .join(ctx.table("region"), on="n_regionkey", right_on="r_regionkey")
         .filter(col("r_name") == "ASIA"))
    return (q.group_by("n_name")
            .agg(sum_(_rev(), "revenue"))
            .sort(("revenue", False)))


# -- Q6: forecasting revenue change (the paper's running example) ---------------


def q6(ctx: FlareContext) -> DataFrame:
    li = ctx.table("lineitem")
    return (li.filter((col("l_shipdate") >= date("1994-01-01"))
                      & (col("l_shipdate") < date("1995-01-01"))
                      & col("l_discount").between(0.05, 0.07)
                      & (col("l_quantity") < 24.0))
            .agg(sum_(col("l_extendedprice") * col("l_discount"),
                      "revenue")))


# -- Q10: returned item reporting ------------------------------------------------


def q10(ctx: FlareContext) -> DataFrame:
    li = ctx.table("lineitem").filter(col("l_returnflag") == "R")
    orders = ctx.table("orders").filter(
        (col("o_orderdate") >= date("1993-10-01"))
        & (col("o_orderdate") < date("1994-01-01")))
    q = (li.join(orders, on="l_orderkey", right_on="o_orderkey")
         .join(ctx.table("customer"), on="o_custkey", right_on="c_custkey")
         .join(ctx.table("nation"), on="c_nationkey", right_on="n_nationkey"))
    return (q.group_by("o_custkey")
            .agg(sum_(_rev(), "revenue"),
                 any_(col("c_acctbal"), "c_acctbal"),
                 any_(col("n_name"), "n_name"))
            .sort(("revenue", False))
            .limit(20))


# -- Q13: customer distribution (left outer join; paper: 8x) ---------------------


def q13(ctx: FlareContext) -> DataFrame:
    per_cust = (ctx.table("orders")
                .filter(~col("o_comment").like("%special%requests%"))
                .group_by("o_custkey")
                .agg(count("c_count")))
    joined = (ctx.table("customer")
              .join(per_cust, on="c_custkey", right_on="o_custkey",
                    how="left")
              .select(("c_count",
                       WithDomain(cast(col("c_count"), "int32"), 256))))
    return (joined.group_by("c_count")
            .agg(count("custdist"))
            .sort(("custdist", False), ("c_count", False)))


# -- Q14: promotion effect (conditional aggregate) --------------------------------


def q14(ctx: FlareContext) -> DataFrame:
    li = ctx.table("lineitem").filter(
        (col("l_shipdate") >= date("1995-09-01"))
        & (col("l_shipdate") < date("1995-10-01")))
    q = (li.join(ctx.table("part"), on="l_partkey", right_on="p_partkey")
         .agg(sum_(when(col("p_type").like("PROMO%"), _rev(), 0.0),
                   "promo"),
              sum_(_rev(), "total")))
    return q.select(("promo_revenue",
                     lit(100.0) * col("promo") / col("total")))


# -- Q19: discounted revenue (disjunctive multi-attribute predicate) ---------------


def q19(ctx: FlareContext) -> DataFrame:
    li = ctx.table("lineitem")
    q = li.join(ctx.table("part"), on="l_partkey", right_on="p_partkey")
    b1 = ((col("p_brand") == "Brand#12")
          & col("p_container").isin(["SM CASE", "SM BOX", "SM PACK",
                                     "SM PKG"])
          & col("l_quantity").between(1.0, 11.0)
          & col("p_size").between(1, 5))
    b2 = ((col("p_brand") == "Brand#23")
          & col("p_container").isin(["MED BAG", "MED BOX", "MED PKG",
                                     "MED PACK"])
          & col("l_quantity").between(10.0, 20.0)
          & col("p_size").between(1, 10))
    b3 = ((col("p_brand") == "Brand#34")
          & col("p_container").isin(["LG CASE", "LG BOX", "LG PACK",
                                     "LG PKG"])
          & col("l_quantity").between(20.0, 30.0)
          & col("p_size").between(1, 15))
    common = (col("l_shipmode").isin(["AIR", "REG AIR"])
              & (col("l_shipinstruct") == "DELIVER IN PERSON"))
    return q.filter((b1 | b2 | b3) & common).agg(sum_(_rev(), "revenue"))


# -- Q22: global sales opportunity (anti join; paper: 57x) --------------------------


def q22(ctx: FlareContext) -> DataFrame:
    """Outer query of the two-phase Q22, as a prepared template.

    The scalar subquery (average positive account balance) is a runtime
    parameter ``acctbal_min`` -- compute it with :func:`q22_params` on
    any engine, then bind: ``q22(ctx).collect(engine,
    params=q22_params(ctx, engine))``.  Unlike the one-shot formulation
    this builds a pure plan: no engine choice happens here.
    """
    return (ctx.table("customer")
            .filter(col("c_acctbal") > param("acctbal_min", "float64"))
            .join(ctx.table("orders"), on="c_custkey", right_on="o_custkey",
                  how="anti")
            .group_by("c_nationkey")
            .agg(count("numcust"), sum_(col("c_acctbal"), "totacctbal"))
            .sort("c_nationkey"))


def q22_params(ctx: FlareContext, engine: str = "compiled"
               ) -> Dict[str, Any]:
    """Phase 1 of Q22: the scalar-subquery binding for :func:`q22`."""
    pos = (ctx.table("customer")
           .filter(col("c_acctbal") > 0.0)
           .agg(avg(col("c_acctbal"), "a")))
    compiled = pos.lower(engine=engine).compile()
    return {"acctbal_min": float(compiled.scalar("a"))}


# -- Fig. 6 micro-benchmark: lineitem |><| orders ------------------------------


def join_micro(ctx: FlareContext, strategy: str = None) -> DataFrame:
    """The paper's join micro-benchmark: lineitem probes orders.
    ``strategy`` picks the join ("sorted", the default, or "sortmerge",
    which also sorts the probe side)."""
    return (ctx.table("lineitem")
            .join(ctx.table("orders"), on="l_orderkey",
                  right_on="o_orderkey", strategy=strategy)
            .agg(sum_(col("l_extendedprice") * (lit(1.0)
                                                - col("l_discount")),
                      "revenue"),
                 count("n")))


# ---------------------------------------------------------------------------
# prepared-query templates (TPC-H substitution parameters as runtime params)
#
# The official benchmark draws random substitution parameters per run; with
# ``param()`` placeholders each query is ONE compiled program reused across
# all selectivity variants (prepared-statement semantics).  String-valued
# substitutions (brand, container) stay literal: string predicates are
# evaluated on the dictionary at lowering time.
# ---------------------------------------------------------------------------


def q6_template(ctx: FlareContext) -> DataFrame:
    """Q6 over DATE / DISCOUNT / QUANTITY substitution parameters."""
    li = ctx.table("lineitem")
    return (li.filter((col("l_shipdate") >= param("date_lo", "date"))
                      & (col("l_shipdate") < param("date_hi", "date"))
                      & col("l_discount").between(param("disc_lo", "float64"),
                                                  param("disc_hi", "float64"))
                      & (col("l_quantity") < param("qty_hi", "float64")))
            .agg(sum_(col("l_extendedprice") * col("l_discount"),
                      "revenue")))


def q6_binding(year: int = 1994, discount: float = 0.06,
               quantity: float = 24.0) -> Dict[str, Any]:
    """Spec-shaped Q6 substitution: [DATE, DATE+1y), DISCOUNT +/- 0.01."""
    return {"date_lo": date(f"{year}-01-01"),
            "date_hi": date(f"{year + 1}-01-01"),
            "disc_lo": round(discount - 0.01, 2),
            "disc_hi": round(discount + 0.01, 2),
            "qty_hi": quantity}


def q14_template(ctx: FlareContext) -> DataFrame:
    """Q14 over its DATE substitution parameter (one-month window)."""
    li = ctx.table("lineitem").filter(
        (col("l_shipdate") >= param("date_lo", "date"))
        & (col("l_shipdate") < param("date_hi", "date")))
    q = (li.join(ctx.table("part"), on="l_partkey", right_on="p_partkey")
         .agg(sum_(when(col("p_type").like("PROMO%"), _rev(), 0.0),
                   "promo"),
              sum_(_rev(), "total")))
    return q.select(("promo_revenue",
                     lit(100.0) * col("promo") / col("total")))


def q19_template(ctx: FlareContext) -> DataFrame:
    """Q19 over QUANTITY1/2/3 (each branch spans [q_i, q_i + 10])."""
    li = ctx.table("lineitem")
    q = li.join(ctx.table("part"), on="l_partkey", right_on="p_partkey")
    b1 = ((col("p_brand") == "Brand#12")
          & col("p_container").isin(["SM CASE", "SM BOX", "SM PACK",
                                     "SM PKG"])
          & col("l_quantity").between(param("qty1", "float64"),
                                      param("qty1", "float64") + lit(10.0))
          & col("p_size").between(1, 5))
    b2 = ((col("p_brand") == "Brand#23")
          & col("p_container").isin(["MED BAG", "MED BOX", "MED PKG",
                                     "MED PACK"])
          & col("l_quantity").between(param("qty2", "float64"),
                                      param("qty2", "float64") + lit(10.0))
          & col("p_size").between(1, 10))
    b3 = ((col("p_brand") == "Brand#34")
          & col("p_container").isin(["LG CASE", "LG BOX", "LG PACK",
                                     "LG PKG"])
          & col("l_quantity").between(param("qty3", "float64"),
                                      param("qty3", "float64") + lit(10.0))
          & col("p_size").between(1, 15))
    common = (col("l_shipmode").isin(["AIR", "REG AIR"])
              & (col("l_shipinstruct") == "DELIVER IN PERSON"))
    return q.filter((b1 | b2 | b3) & common).agg(sum_(_rev(), "revenue"))


QUERIES: Dict[str, Callable[[FlareContext], DataFrame]] = {
    "q1": q1, "q3": q3, "q4": q4, "q5": q5, "q6": q6,
    "q10": q10, "q13": q13, "q14": q14, "q19": q19,
}
# q22 is a prepared template over the scalar-subquery binding
# (q22_params); it joins the registry-driven benchmarks via bench_tpch.

#: Prepared-query templates + a representative list of spec-shaped
#: bindings, for benchmarks and differential tests.
TEMPLATES: Dict[str, Callable[[FlareContext], DataFrame]] = {
    "q6": q6_template, "q14": q14_template, "q19": q19_template,
    "q22": q22,
}

TEMPLATE_BINDINGS: Dict[str, Any] = {
    "q6": [q6_binding(1994, 0.06, 24.0),
           q6_binding(1995, 0.05, 25.0),
           q6_binding(1993, 0.07, 24.0)],
    "q14": [{"date_lo": date("1995-09-01"), "date_hi": date("1995-10-01")},
            {"date_lo": date("1994-03-01"), "date_hi": date("1994-04-01")},
            {"date_lo": date("1996-06-01"), "date_hi": date("1996-07-01")}],
    "q19": [{"qty1": 1.0, "qty2": 10.0, "qty3": 20.0},
            {"qty1": 5.0, "qty2": 12.0, "qty3": 25.0},
            {"qty1": 2.0, "qty2": 15.0, "qty3": 22.0}],
    # representative spreads around the spec's scalar-subquery value
    # (q22_params computes the exact one for a given catalog)
    "q22": [{"acctbal_min": 0.0},
            {"acctbal_min": 2500.0},
            {"acctbal_min": 4500.0}],
}


def random_bindings(name: str, n: int, seed: int = 0) -> list:
    """``n`` random-but-reproducible bindings for template ``name`` --
    the official benchmark's "draw substitution parameters per run", for
    a multi-tenant request mix.

    The draws follow the JAX package's ``repro.relational.queries.
    random_bindings``; the generator is seeded from a stable hash of the
    name (``zlib.crc32``) where the JAX package uses the salted builtin
    ``hash``, so the same (name, n, seed) gives the same bindings in
    every process.
    """
    import random
    import zlib
    rng = random.Random((zlib.crc32(name.encode()) & 0xFFFF) ^ seed)
    out = []
    for _ in range(n):
        if name == "q6":
            out.append(q6_binding(rng.randint(1993, 1997),
                                  round(rng.uniform(0.02, 0.09), 2),
                                  float(rng.randint(24, 25))))
        elif name == "q14":
            y, m = rng.randint(1993, 1997), rng.randint(1, 12)
            y2, m2 = (y + 1, 1) if m == 12 else (y, m + 1)
            out.append({"date_lo": date(f"{y}-{m:02d}-01"),
                        "date_hi": date(f"{y2}-{m2:02d}-01")})
        elif name == "q19":
            out.append({"qty1": float(rng.randint(1, 10)),
                        "qty2": float(rng.randint(10, 20)),
                        "qty3": float(rng.randint(20, 30))})
        elif name == "q22":
            out.append({"acctbal_min": round(rng.uniform(0.0, 5000.0), 2)})
        else:
            raise KeyError(f"no binding generator for template {name!r}")
    return out
