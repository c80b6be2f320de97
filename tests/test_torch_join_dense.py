"""The join index's facts and the probe's dense route, on the CPU.

``IndexCache`` records at build whether an index is *dense* (unique keys
filling ``[base, base + n)``) and *identity* (keys stored sorted); the
CUDA probe (``csrc/join_probe.cuh``) then computes a probe's position
instead of searching for it and skips the ``perm`` load.  Here:

* every single-column TPC-H primary-key index is dense and identity, and
  partsupp's composite key, gapped keys and duplicate keys are not dense;
* the dense rule (:func:`dense_position`, a mirror of the kernel's
  ``flare_probe_dense`` in torch) gives the lower bound clipped to the
  last key and the hit test of ``torch.searchsorted`` -- and, for NaN, of
  the kernel's binary search -- on integer, fractional, out-of-range, NaN
  and infinite keys;
* ``join_probe_agg`` given the index's ``meta`` equals the JAX package's
  Pallas kernel (interpret mode) on dense and gapped indexes, keyless and
  grouped (rtol 1e-5: f32 sums in different orders; max slots exact).
  On CPU tensors that is the plain version, which ignores ``meta``;
* every probe body names the probe columns its key reads
  (``Body.key_cols``, which ``chip_smoke.py``'s bound counts at valid
  rows);
* the heterogeneous plan nodes (``MapBatches``, ``IterativeKernel``) run
  on every engine and through ``compiled-native``, equal to the volcano
  oracle and to numpy.

The CUDA routes themselves -- on these edge keys too -- are held
bit-identical on the card (``tests/test_torch_gpu.py``).
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from conftest import assert_results_equal
from repro.kernels.join_probe import kernel as JJP
from repro_torch.core import FlareContext, col, sum_
from repro_torch.core import engines as ENG
from repro_torch.core import ml as ML
from repro_torch.core import plan as P
from repro_torch.core import stages as S
from repro_torch.kernels.join_probe import kernel as JP
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT

from test_torch_kernels import (BLOCK_ROWS, F32_MIN, RTOL, _data, _jp_body,
                                _jp_jax, _pad)

SF = 0.005

PRIMARY_KEYS = [("supplier", "s_suppkey"), ("part", "p_partkey"),
                ("customer", "c_custkey"), ("orders", "o_orderkey"),
                ("nation", "n_nationkey")]


@pytest.fixture(scope="module")
def ctx():
    c = FlareContext(device="cpu")
    Q.register_tpch(c, sf=SF)
    return c


# -- the index facts ----------------------------------------------------------


@pytest.mark.parametrize("table,key", PRIMARY_KEYS)
def test_tpch_primary_key_indexes_are_dense_and_identity(ctx, table, key):
    tbl = ctx.catalog.table(table)
    idx = ctx.cache.get_index(tbl, (key,))
    base = int(np.asarray(tbl[key]).min())
    assert idx.meta.dtype == torch.int32 and idx.meta.shape == (3,)
    assert idx.meta.tolist() == [1, base, 1]
    assert torch.equal(idx.perm, torch.arange(tbl.num_rows,
                                              dtype=torch.int32))


def test_partsupp_composite_key_is_not_dense(ctx):
    ps = ctx.catalog.table("partsupp")
    doms = (ps.schema["ps_partkey"].domain, ps.schema["ps_suppkey"].domain)
    idx = ctx.cache.get_index(ps, ("ps_partkey", "ps_suppkey"), doms)
    assert idx.unique and idx.meta.tolist()[0] == 0


def _table_index(keys):
    tbl = PT.Table.from_arrays({"k": np.asarray(keys, np.int32)})
    return ENG.IndexCache(torch.device("cpu")).get(tbl, ("k",))


@pytest.mark.parametrize("keys,meta", [
    (2 * np.arange(1, 101), [0, 0, 1]),                  # gapped
    (np.repeat(np.arange(1, 51), 2), [0, 0, 1]),         # duplicates
    (np.array([3, 1, 2, 5, 4]), [1, 1, 0]),              # dense, unsorted
    (np.arange(-7, 9), [1, -7, 1]),                      # negative base
    (np.array([5, 9, 7]), [0, 0, 0]),                    # gapped, unsorted
    (np.arange(1 << 24, (1 << 24) + 3), [0, 0, 1]),      # beyond f32-exact
])
def test_index_meta_of_keys(keys, meta):
    idx = _table_index(keys)
    assert idx.meta.tolist() == meta
    assert ENG.index_meta(np.asarray(keys, np.int64), idx.unique) == \
        tuple(meta)


def test_empty_index_meta():
    assert ENG.index_meta(np.zeros(0, np.int64), True) == (0, 0, 1)


# -- the dense position rule ---------------------------------------------------


def _search_mirror(kb, kp):
    """flare_probe (csrc/join_probe.cuh): lower bound by f32 compares,
    clipped to the last key, and its hit test."""
    lo, hi = 0, len(kb)
    while lo < hi:
        mid = (lo + hi) // 2
        if np.float32(kb[mid]) < np.float32(kp):
            lo = mid + 1
        else:
            hi = mid
    pos = min(lo, len(kb) - 1)
    return pos, bool(np.float32(kb[pos]) == np.float32(kp))


def dense_position(kp, base, nb):
    """``flare_probe_dense`` (csrc/join_probe.cuh) in torch, on a dense
    index (keys ``base .. base + nb - 1``, f32-exact): the lower bound
    clipped to ``nb - 1`` and the hit test, computed without a search.
    NaN, -inf and keys at or below ``base`` go to 0, keys above the last
    to ``nb - 1``."""
    kp = kp.to(torch.float32)
    lo, hi = float(base), float(base + nb - 1)
    inner = torch.ceil(torch.where((kp > lo) & (kp <= hi), kp, lo))
    pos = torch.where(kp > hi, nb - 1, inner.long() - base)
    pos = torch.where(kp > lo, pos, 0)
    hit = (pos + base).to(torch.float32) == kp
    return pos, hit


def _check_dense_rule(kp, base, nb):
    kp = torch.as_tensor(np.asarray(kp, np.float32))
    kb = torch.arange(base, base + nb, dtype=torch.float32)
    pos, hit = dense_position(kp, base, nb)
    ref = torch.searchsorted(kb, kp).clamp(max=nb - 1)
    nan = torch.isnan(kp)
    # torch sorts NaN last; the kernel's search (and so the dense rule)
    # puts it first.  Either way it misses, and a miss loads nothing.
    assert torch.equal(pos[~nan], ref[~nan])
    assert torch.equal(hit, kb[ref] == kp)
    for p, h, k in zip(pos.tolist(), hit.tolist(), kp.tolist()):
        assert (p, h) == _search_mirror(kb.numpy(), k)


INF = math.inf


@pytest.mark.parametrize("base,nb", [(1, 1), (1, 2), (0, 25), (1, 1000),
                                     (-40, 97), ((1 << 24) - 64, 65)])
@pytest.mark.parametrize("kind", ["integer", "fraction", "below", "above",
                                  "special"])
def test_dense_position_matches_the_search(base, nb, kind):
    rng = np.random.default_rng(nb)
    last = base + nb - 1
    if kind == "integer":
        kp = np.concatenate([[base, last], rng.integers(base, last + 1, 64)])
    elif kind == "fraction":
        kp = rng.uniform(base - 1, last + 1, 64)
        kp = np.concatenate([kp, [base + 0.5, last - 0.5, last + 0.25]])
    elif kind == "below":
        kp = np.concatenate([[base - 1, base - 0.5, -(2.0 ** 30)],
                             base - rng.uniform(0, 1e4, 16)])
    elif kind == "above":
        kp = np.concatenate([[last + 1, last + 0.5, 2.0 ** 30],
                             last + rng.uniform(0, 1e4, 16)])
    else:
        kp = [math.nan, -INF, INF, -0.0, 0.0, base, last]
    _check_dense_rule(kp, base, nb)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=True, allow_infinity=True),
                min_size=1, max_size=32),
       st.integers(-2000, 2000), st.integers(1, 300))
def test_dense_position_property(kp, base, nb):
    _check_dense_rule(kp, base, nb)


# -- join_probe_agg with the index's meta against the Pallas kernel -------------


def _dense_side(nb, seed, shuffled):
    rng = np.random.default_rng(seed)
    keys = np.arange(1, nb + 1)
    if shuffled:
        keys = rng.permutation(keys)
    pay = rng.uniform(0, 10, nb).astype(np.float32)
    grp = rng.integers(0, 512, nb).astype(np.int32)
    return keys.astype(np.int32), pay, grp


@pytest.mark.parametrize("index,dense", [("sorted", 1), ("shuffled", 1),
                                         ("gapped", 0)])
@pytest.mark.parametrize("mode", ["keyless", "onehot", "scatter"])
def test_join_probe_agg_with_meta_matches_pallas(index, dense, mode):
    """The wrapper with the index's meta, on CPU tensors: the plain
    version (which ignores meta) against Pallas, and the index's meta as
    built.  The kernel's routes run on the card."""
    n, nb = 2500 + 19, 300
    if index == "gapped":
        rng = np.random.default_rng(2)
        keys = rng.permutation(np.arange(1, 2 * nb + 1, 2)).astype(np.int32)
        pay = rng.uniform(0, 10, nb).astype(np.float32)
        grp = rng.integers(0, 512, nb).astype(np.int32)
    else:
        keys, pay, grp = _dense_side(nb, 3, index == "shuffled")
    rng = np.random.default_rng(11)
    pkeys = rng.integers(-5, 2 * nb + 5, n).astype(np.int32)
    d = _data(n, 7)
    scal = np.array([35.0], np.float32)
    groups = {"keyless": None, "onehot": 512, "scatter": 700}[mode]
    order = np.argsort(keys, kind="stable")
    barrays = [JJP.pad_build(jnp.asarray(keys[order], jnp.float32), jnp.inf),
               JJP.pad_build(jnp.asarray(pay[order]), 0.0),
               JJP.pad_build(jnp.asarray(grp[order], jnp.float32), 0.0)]
    pblocks = [_pad(pkeys.astype(np.float32)), _pad(d["price"]),
               _pad(d["qty"]), _pad(d["valid"].astype(np.float32))]
    body = _jp_jax(False, groups is not None)
    if groups is None:
        outs = JJP.join_probe_agg(body, pblocks, barrays, jnp.asarray(scal),
                                  3, BLOCK_ROWS, interpret=True)
        want = np.array([float(jnp.sum(o)) for o in outs])
    else:
        want = np.asarray(JJP.join_probe_agg(
            body, pblocks, barrays, jnp.asarray(scal), 3, BLOCK_ROWS,
            num_groups=groups, ops=("sum", "max", "sum"),
            fills=(0.0, F32_MIN, 0.0), accum=mode, interpret=True))
    idx = _table_index(keys)
    assert idx.meta.tolist()[0] == dense
    assert idx.meta.tolist()[2] == int(index == "sorted")
    got = JP.join_probe_agg(
        _jp_body(groups is not None),
        [torch.from_numpy(pkeys), torch.from_numpy(d["price"]),
         torch.from_numpy(d["qty"])],
        torch.from_numpy(d["valid"]), n, idx.keys, idx.perm, None,
        [torch.from_numpy(pay), torch.from_numpy(grp)],
        torch.from_numpy(scal), num_groups=groups, meta=idx.meta)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    if groups is not None:
        np.testing.assert_array_equal(got.numpy()[1], want[1])


def test_dense_route_finds_the_rows_the_search_finds(ctx):
    """The kernel's dense route (position by rule, row = position on an
    identity index) picks the rows and hits of the plain version's
    searchsorted, on TPC-H's part index and lineitem's part keys."""
    part = ctx.catalog.table("part")
    idx = ctx.cache.get_index(part, ("p_partkey",))
    dense, base, identity = idx.meta.tolist()
    assert dense and identity
    li = ctx.catalog.table("lineitem")
    kp = torch.from_numpy(np.asarray(li["l_partkey"])).float()
    kp = torch.cat([kp, torch.tensor([0.0, -1.0, 1e9, 2.5])])
    nb = idx.keys.shape[0]
    pos, hit = dense_position(kp, base, nb)
    ref = torch.searchsorted(idx.keys.float(), kp).clamp(max=nb - 1)
    assert torch.equal(pos, ref)
    assert torch.equal(hit, idx.keys.float()[ref] == kp)
    assert torch.equal(pos.to(torch.int32), idx.perm[ref])


@pytest.mark.parametrize("qname", ["q3", "q5", "q10", "q14", "q19"])
def test_probe_body_names_its_key_columns(ctx, qname, monkeypatch):
    """``Body.key_cols`` are the probe columns the probe key reads: the
    key is the same with every other probe column replaced."""
    calls = []
    orig = JP.join_probe_agg

    def spy(*args, **kwargs):
        calls.append(args)
        return orig(*args, **kwargs)

    monkeypatch.setattr(JP, "join_probe_agg", spy)
    Q.QUERIES[qname](ctx).lower(native=True).compile()()
    assert calls, qname
    body, pcols = calls[0][0], calls[0][1]
    assert body.key_cols and len(set(body.key_cols)) == len(body.key_cols)
    assert all(0 <= j < len(pcols) for j in body.key_cols)
    cols = [c.float() for c in pcols]
    junk = [c if j in body.key_cols else torch.full_like(c, -12345.0)
            for j, c in enumerate(cols)]
    assert torch.equal(body.probe_key(cols), body.probe_key(junk))


def test_probe_tile_rows_come_from_the_kernel_source():
    assert JP.TILE_ROWS == 1024
    assert JP.list_bytes() == 8 * 1024 * 2


# -- heterogeneous plan nodes -------------------------------------------------


def _colsum(x, weights=None):
    return {"s": (x * weights[:, None]).sum(0)}


KERNEL = ML.TrainKernel("colsum", _colsum)


def _hetero_plan(ctx, node):
    """A ``MapBatches`` under an aggregate, or an ``IterativeKernel``,
    over filtered lineitem."""
    li = ctx.table("lineitem").filter(col("l_quantity") < 25.0)
    if node == "MapBatches":
        batches = P.MapBatches(li.plan,
                               lambda c: {"q2": c["l_quantity"] * 2.0},
                               ("l_quantity",), (PT.Field("q2", PT.FLOAT32),))
        return P.Aggregate(batches, (), (sum_(col("q2"), "s"),))
    return P.IterativeKernel(li.plan, KERNEL, ("l_quantity", "l_discount"),
                             None, ())


def _numpy_answer(ctx, node):
    li = ctx.catalog.table("lineitem")
    q = np.asarray(li["l_quantity"], np.float64)
    d = np.asarray(li["l_discount"], np.float64)
    keep = q < 25.0
    if node == "MapBatches":
        return {"s": np.asarray([(q[keep] * 2.0).sum()])}
    return {"s": np.asarray([q[keep].sum(), d[keep].sum()])}


@pytest.mark.parametrize("engine", ["compiled", "volcano", "stage", "tuple"])
@pytest.mark.parametrize("node", ["MapBatches", "IterativeKernel"])
def test_every_engine_runs_heterogeneous_plan_nodes(ctx, engine, node):
    plan = _hetero_plan(ctx, node)
    got = S.lower_plan(plan, ctx.catalog, ctx.cache, ctx.compile_cache,
                       engine=engine).compile()()
    oracle = S.lower_plan(plan, ctx.catalog, ctx.cache, ctx.compile_cache,
                          engine="volcano").compile()()
    assert_results_equal(oracle, got, msg=f"{node} {engine}")
    assert_results_equal(_numpy_answer(ctx, node), got,
                         msg=f"{node} {engine} vs numpy")


def test_compiled_native_runs_heterogeneous_plan_nodes(ctx):
    for node in ("MapBatches", "IterativeKernel"):
        plan = _hetero_plan(ctx, node)
        low = S.lower_plan(plan, ctx.catalog, ctx.cache, ctx.compile_cache,
                           engine="compiled", native=True)
        oracle = S.lower_plan(plan, ctx.catalog, ctx.cache,
                              ctx.compile_cache, engine="volcano").compile()()
        assert_results_equal(oracle, low.compile()(), msg=f"{node} native")
        # the aggregate over the UDF's output is a dispatchable fragment;
        # the train plan holds no aggregate
        fired = low.dispatch_report().fired_patterns()
        assert fired == (["masked-filter-project"] if node == "MapBatches"
                         else [])
