"""TPC-H dbgen-lite: synthetic generator for the benchmark tables.

Generates the eight TPC-H tables at a given scale factor with the schema,
key structure (dense 1..N primary keys, PK-FK relationships), value
distributions and comment patterns the reproduced queries exercise.
Cardinalities follow the spec: lineitem ~= 6,000,000 x SF, orders =
1,500,000 x SF, etc.  Dates are stored as int32 days-since-1970 (dense
domain -> direct-indexed grouping); helper :func:`date` converts literals.

The random draws, and so the tables, are those of the JAX package's
generator for the same ``(sf, seed)``, byte for byte.  String columns are
drawn as indices into their candidate lists and dictionary-encoded from
those indices (the used candidates, sorted), which is the encoding a
string-by-string ``np.unique`` gives, without materialising millions of
Python strings: at SF 10 lineitem holds 60 M rows.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.relational.table import STRING, Column, Table

__all__ = ["generate", "date", "NATIONS", "REGIONS"]

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# (name, regionkey) straight from the spec
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
SHIPINSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN"]

TYPE_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINERS = [f"{a} {b}" for a in
              ["SM", "MED", "LG", "JUMBO", "WRAP"]
              for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM"]]
BRANDS = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]

_EPOCH = np.datetime64("1970-01-01", "D")
START_DATE = "1992-01-01"
END_DATE = "1998-12-31"


def date(s: str) -> int:
    """'1994-01-01' -> int32 days-since-1970 (the engine's DATE encoding)."""
    return int((np.datetime64(s, "D") - _EPOCH).astype(np.int64))


_DATE_DOMAIN = date(END_DATE) + 200  # receiptdate can exceed END_DATE


_COMMENT_WORDS = ["carefully", "quickly", "furiously", "deposits",
                  "accounts", "packages", "theodolites", "pending",
                  "ironic", "final"]
_SPECIAL_COMMENT = "special packages requests"


def _encode(candidates: Sequence[str], idx: np.ndarray) -> Column:
    """Dictionary-encode ``candidates[idx]``: the dictionary is the sorted
    set of candidates that occur, as ``np.unique`` over the strings would
    give it (candidates must be distinct)."""
    used = np.flatnonzero(np.bincount(idx.ravel(), minlength=len(candidates)))
    names = [candidates[u] for u in used]
    order = sorted(range(len(names)), key=names.__getitem__)
    lut = np.zeros(len(candidates), np.int32)
    lut[used[order]] = np.arange(len(order), dtype=np.int32)
    return Column(lut[idx], STRING, tuple(names[k] for k in order))


def _comments(rng: np.random.Generator, n: int) -> Column:
    """Order comments; ~1% contain the Q13 'special ... requests' pattern."""
    w = len(_COMMENT_WORDS)
    base = rng.choice(w, (n, 3))
    candidates = [f"{a} {b} {c}" for a in _COMMENT_WORDS
                  for b in _COMMENT_WORDS for c in _COMMENT_WORDS]
    idx = (base[:, 0] * w + base[:, 1]) * w + base[:, 2]
    special = rng.random(n) < 0.01
    idx[special] = len(candidates)
    return _encode(candidates + [_SPECIAL_COMMENT], idx)


def _choice(rng: np.random.Generator, candidates: Sequence[str],
            n: int) -> Column:
    """``rng.choice(candidates, n)``, dictionary-encoded (same draws)."""
    return _encode(list(candidates), rng.choice(len(candidates), n))


def generate(sf: float = 0.01, seed: int = 0) -> Dict[str, Table]:
    """Generate all eight tables at scale factor ``sf``."""
    rng = np.random.default_rng(seed)

    n_part = max(int(200_000 * sf), 50)
    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 30)
    n_ord = max(int(1_500_000 * sf), 100)

    tables: Dict[str, Table] = {}

    # -- region / nation -------------------------------------------------------
    tables["region"] = Table.from_arrays(
        {"r_regionkey": np.arange(5, dtype=np.int32),
         "r_name": np.array(REGIONS, dtype=object)},
        domains={"r_regionkey": 5}, uniques=["r_regionkey"])

    tables["nation"] = Table.from_arrays(
        {"n_nationkey": np.arange(25, dtype=np.int32),
         "n_name": np.array([n for n, _ in NATIONS], dtype=object),
         "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32)},
        domains={"n_nationkey": 25, "n_regionkey": 5},
        uniques=["n_nationkey"])

    # -- supplier ----------------------------------------------------------------
    tables["supplier"] = Table.from_arrays(
        {"s_suppkey": np.arange(1, n_supp + 1, dtype=np.int32),
         "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int32),
         "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2)},
        domains={"s_suppkey": n_supp + 1, "s_nationkey": 25},
        uniques=["s_suppkey"])

    # -- part ----------------------------------------------------------------------
    t1 = rng.choice(len(TYPE_SYL1), n_part)
    t2 = rng.choice(len(TYPE_SYL2), n_part)
    t3 = rng.choice(len(TYPE_SYL3), n_part)
    p_types = _encode([f"{a} {b} {c}" for a in TYPE_SYL1 for b in TYPE_SYL2
                       for c in TYPE_SYL3],
                      (t1 * len(TYPE_SYL2) + t2) * len(TYPE_SYL3) + t3)
    p_retail = np.round(900 + (np.arange(1, n_part + 1) % 2000) / 10
                        + 100 * (np.arange(1, n_part + 1) % 5), 2)
    tables["part"] = Table.from_arrays(
        {"p_partkey": np.arange(1, n_part + 1, dtype=np.int32),
         "p_type": p_types,
         "p_brand": _choice(rng, BRANDS, n_part),
         "p_container": _choice(rng, CONTAINERS, n_part),
         "p_size": rng.integers(1, 51, n_part).astype(np.int32),
         "p_retailprice": p_retail.astype(np.float64)},
        domains={"p_partkey": n_part + 1, "p_size": 51},
        uniques=["p_partkey"])

    # -- partsupp (composite PK: partkey x 4 suppliers) -----------------------------
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int32), 4)
    ps_supp = ((ps_part + np.tile(np.arange(4, dtype=np.int32),
                                  n_part) * (n_supp // 4 + 1)) % n_supp
               + 1).astype(np.int32)
    tables["partsupp"] = Table.from_arrays(
        {"ps_partkey": ps_part, "ps_suppkey": ps_supp,
         "ps_availqty": rng.integers(1, 10_000, len(ps_part)).astype(np.int32),
         "ps_supplycost": np.round(rng.uniform(1, 1000, len(ps_part)), 2)},
        domains={"ps_partkey": n_part + 1, "ps_suppkey": n_supp + 1})

    # -- customer ----------------------------------------------------------------
    tables["customer"] = Table.from_arrays(
        {"c_custkey": np.arange(1, n_cust + 1, dtype=np.int32),
         "c_nationkey": rng.integers(0, 25, n_cust).astype(np.int32),
         "c_mktsegment": _choice(rng, SEGMENTS, n_cust),
         "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2)},
        domains={"c_custkey": n_cust + 1, "c_nationkey": 25},
        uniques=["c_custkey"])

    # -- orders ------------------------------------------------------------------
    # a third of customers place no orders (spec: only 2/3 have orders)
    active_cust = rng.choice(np.arange(1, n_cust + 1), max(2 * n_cust // 3, 1),
                             replace=False)
    o_orderdate = rng.integers(date(START_DATE), date("1998-08-02"),
                               n_ord).astype(np.int32)
    tables["orders"] = Table.from_arrays(
        {"o_orderkey": np.arange(1, n_ord + 1, dtype=np.int32),
         "o_custkey": rng.choice(active_cust, n_ord).astype(np.int32),
         "o_orderdate": o_orderdate,
         "o_orderpriority": _choice(rng, PRIORITIES, n_ord),
         "o_shippriority": np.zeros(n_ord, dtype=np.int32),
         "o_comment": _comments(rng, n_ord),
         "o_totalprice": np.round(rng.uniform(800, 500_000, n_ord), 2)},
        dtypes={"o_orderdate": "date"},
        domains={"o_orderkey": n_ord + 1, "o_custkey": n_cust + 1,
                 "o_orderdate": _DATE_DOMAIN, "o_shippriority": 1},
        uniques=["o_orderkey"])

    # -- lineitem -------------------------------------------------------------------
    per_order = rng.integers(1, 8, n_ord)
    l_orderkey = np.repeat(np.arange(1, n_ord + 1, dtype=np.int32), per_order)
    n_li = len(l_orderkey)
    l_partkey = rng.integers(1, n_part + 1, n_li).astype(np.int32)
    l_suppkey = ((l_partkey + rng.integers(0, 4, n_li)
                  * (n_supp // 4 + 1)) % n_supp + 1).astype(np.int32)
    l_quantity = rng.integers(1, 51, n_li).astype(np.float64)
    l_extprice = np.round(l_quantity * p_retail[l_partkey - 1] / 100.0, 2)
    l_discount = np.round(rng.integers(0, 11, n_li) / 100.0, 2)
    l_tax = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    odate_li = o_orderdate[l_orderkey - 1]
    l_shipdate = (odate_li + rng.integers(1, 122, n_li)).astype(np.int32)
    l_commitdate = (odate_li + rng.integers(30, 91, n_li)).astype(np.int32)
    l_receiptdate = (l_shipdate + rng.integers(1, 31, n_li)).astype(np.int32)
    cutoff = date("1995-06-17")
    l_linestatus = _encode(["F", "O"], (l_shipdate > cutoff).astype(np.int64))
    ret = rng.random(n_li)
    l_returnflag = _encode(["R", "A", "N"],
                           np.where(l_receiptdate <= cutoff,
                                    np.where(ret < 0.5, 0, 1), 2))
    tables["lineitem"] = Table.from_arrays(
        {"l_orderkey": l_orderkey,
         "l_partkey": l_partkey,
         "l_suppkey": l_suppkey,
         "l_quantity": l_quantity,
         "l_extendedprice": l_extprice,
         "l_discount": l_discount,
         "l_tax": l_tax,
         "l_returnflag": l_returnflag,
         "l_linestatus": l_linestatus,
         "l_shipdate": l_shipdate,
         "l_commitdate": l_commitdate,
         "l_receiptdate": l_receiptdate,
         "l_shipmode": _choice(rng, SHIPMODES, n_li),
         "l_shipinstruct": _choice(rng, SHIPINSTRUCT, n_li)},
        dtypes={"l_shipdate": "date", "l_commitdate": "date",
                "l_receiptdate": "date"},
        domains={"l_orderkey": n_ord + 1, "l_partkey": n_part + 1,
                 "l_suppkey": n_supp + 1, "l_shipdate": _DATE_DOMAIN,
                 "l_commitdate": _DATE_DOMAIN,
                 "l_receiptdate": _DATE_DOMAIN})

    return tables
