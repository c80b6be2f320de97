"""Property-based tests (hypothesis) of the port against the JAX package:
engine equivalence on random tables and plans.

The strategies are ``tests/test_property.py``'s: random tables (dense
int keys, dictionary strings, floats; the JAX package's ``Table``,
carried across with ``tables_from_numpy``) and random predicates (drawn
as a spec here and built with each package's expression module).  Every
test runs the same program through the port's engines and the JAX
package's:

* filter and project: the port's ``compiled``, ``compiled-native`` and
  ``stage`` against the JAX package's ``compiled``, which computes in the
  same 32-bit device dtypes, and the port's ``volcano`` against the JAX
  ``volcano`` (both f64).  A 32-bit engine against an f64 one is not a
  property: a literal such as ``-9.5e-167`` rounds to ``-0.0`` in f32,
  so ``x > -9.5e-167`` keeps one row more on the f64 oracle, which makes
  the JAX package's own ``test_filter_project_equivalence`` unsteady;
* aggregates, joins and sort/limit: the port's engines against the JAX
  volcano oracle, at the JAX package's tolerances;
* optimizer invariance through ``engines.execute``;
* the morsel merge: any ``morsel_rows`` gives the monolithic answer on
  ``compiled`` and ``compiled-native`` (the sharded merge property and
  the sharded engine's are in ``tests/test_torch_parallel.py``);
* the join-index cache under adversarial keys, the dictionary round
  trip, and ``segmented_sum``'s plain version on adversarial codes.

``derandomize=True``: every run draws the same examples, so the count of
passes never moves.
"""
import numpy as np
import pytest

pytest.importorskip(
    "hypothesis",
    reason="optional dep: property tests need hypothesis installed")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as JC  # noqa: E402
import repro_torch.core as PC  # noqa: E402
from conftest import assert_results_equal  # noqa: E402
from repro.core import FlareContext as JaxContext  # noqa: E402
from repro.core import engines as JENG  # noqa: E402
from repro.relational.table import Table as JaxTable  # noqa: E402
from repro_torch.core import FlareContext  # noqa: E402
from repro_torch.core import engines as ENG  # noqa: E402
from repro_torch.core import morsel as MO  # noqa: E402
from repro_torch.relational import table as PT  # noqa: E402

from test_property import tables  # noqa: E402
from test_torch_data_ir import as_spec  # noqa: E402

MAX_EXAMPLES = 25
SETTINGS = settings(max_examples=MAX_EXAMPLES, deadline=None,
                    derandomize=True)

#: the port's engines every test runs (the JAX package's ``flare()``
#: shim is its ``compiled`` engine)
DEVICE_ENGINES = ("compiled", "compiled-native", "stage")


def contexts(**named):
    """A JAX and a port context holding the same tables (JAX ``Table``s
    by name)."""
    jc = JaxContext()
    pc = FlareContext(device="cpu")
    for name, tbl in named.items():
        jc.register(name, tbl)
    for name, tbl in PT.tables_from_numpy(as_spec(named)).items():
        pc.register(name, tbl)
    return jc, pc


def run(df, engine):
    return df.lower(engine=engine).compile().collect()


@st.composite
def predicate_specs(draw):
    """``test_property.predicates``' draws, as a spec for :func:`pred`."""
    kind = draw(st.integers(0, 5))
    if kind == 0:
        return (0, draw(st.floats(-100, 100, allow_nan=False)))
    if kind == 1:
        return (1, draw(st.integers(-50, 0)), draw(st.integers(0, 50)))
    if kind == 2:
        return (2, draw(st.sampled_from(["aa", "bb", "zz"])))
    if kind == 3:
        return (3,)
    if kind == 4:
        return (4, draw(st.integers(0, 11)))
    return (5, tuple(draw(st.lists(st.sampled_from(["aa", "bb", "cc"]),
                                   min_size=1, max_size=3))))


def pred(spec, m):
    """The predicate of ``spec`` in the package of core module ``m``."""
    col = m.col
    kind = spec[0]
    if kind == 0:
        return col("x") > spec[1]
    if kind == 1:
        return col("y").between(spec[1], spec[2])
    if kind == 2:
        return col("tag") == spec[1]
    if kind == 3:
        return (col("x") > 0.0) | (col("y") < 0)
    if kind == 4:
        return ~(col("k") == spec[1])
    return col("tag").isin(list(spec[1]))


def filter_project(ctx, m, spec, proj_kind):
    q = ctx.table("t").filter(pred(spec, m))
    if proj_kind == 1:
        q = q.select(("z", m.col("x") * 2.0 + 1.0), ("k", m.col("k")))
    elif proj_kind == 2:
        q = q.select(("w", m.when(m.col("y") > 0, m.col("x"),
                                  0.0 - m.col("x"))),
                     ("tag", m.col("tag")))
    elif proj_kind == 3:
        q = q.with_column("r", m.col("x") / (m.col("y") + m.lit(100)))
    return q


@SETTINGS
@given(tables(), predicate_specs(), st.integers(0, 3))
def test_filter_project_equivalence(tbl_dom, spec, proj_kind):
    jc, pc = contexts(t=tbl_dom[0])
    want32 = run(filter_project(jc, JC, spec, proj_kind), "compiled")
    for engine in DEVICE_ENGINES:
        got = run(filter_project(pc, PC, spec, proj_kind), engine)
        assert_results_equal(want32, got, msg=engine)
    want64 = run(filter_project(jc, JC, spec, proj_kind), "volcano")
    got = run(filter_project(pc, PC, spec, proj_kind), "volcano")
    assert_results_equal(want64, got, msg="volcano")


def aggregate(ctx, m, spec, keys):
    q = ctx.table("t").filter(pred(spec, m))
    aggs = [m.sum_(m.col("x"), "sx"), m.count("n"), m.min_(m.col("y"), "mn"),
            m.max_(m.col("x"), "mx"), m.avg(m.col("x"), "ax")]
    return q.group_by(*keys).agg(*aggs) if keys else q.agg(*aggs)


@SETTINGS
@given(tables(), predicate_specs(),
       st.lists(st.sampled_from(["k", "tag"]), min_size=0, max_size=2,
                unique=True))
def test_aggregate_equivalence(tbl_dom, spec, keys):
    jc, pc = contexts(t=tbl_dom[0])
    want = run(aggregate(jc, JC, spec, keys), "volcano")
    for engine in DEVICE_ENGINES:
        got = run(aggregate(pc, PC, spec, keys), engine)
        assert_results_equal(want, got, rtol=1e-2, atol=1e-2, msg=engine)
    got = run(aggregate(pc, PC, spec, keys), "volcano")
    assert_results_equal(want, got, msg="volcano")


@SETTINGS
@given(tables(max_rows=80), tables(max_rows=40),
       st.sampled_from(["inner", "left", "semi", "anti"]))
def test_join_equivalence(t1d, t2d, how):
    t1, dom1 = t1d
    _, dom2 = t2d
    # build side: unique keys (N:1 invariant)
    rng = np.random.default_rng(0)
    dom = max(dom1, dom2)
    keys = np.arange(dom, dtype=np.int32)
    keep = rng.random(dom) < 0.7
    build = JaxTable.from_arrays(
        {"k": keys[keep], "payload": np.round(
            rng.uniform(0, 10, int(keep.sum())), 3)},
        domains={"k": dom})
    probe = JaxTable.from_arrays(
        {"k": np.asarray(t1["k"]) % dom, "x": t1["x"]},
        domains={"k": dom})
    jc, pc = contexts(probe=probe, build=build)

    def q(ctx):
        return ctx.table("probe").join(ctx.table("build"), on="k", how=how)

    want = run(q(jc), "volcano")
    for engine in DEVICE_ENGINES + ("volcano",):
        assert_results_equal(want, run(q(pc), engine),
                             msg=f"join {how} {engine}")


@SETTINGS
@given(tables(), st.sampled_from([("x", True), ("x", False),
                                  ("y", True), ("k", False)]),
       st.integers(1, 20))
def test_sort_limit_equivalence(tbl_dom, by, n):
    jc, pc = contexts(t=tbl_dom[0])

    def q(ctx):
        # tie-break on x (near-unique float): a deterministic order
        return ctx.table("t").sort(by, ("x", True)).limit(n)

    want = run(q(jc), "volcano")
    for engine in ("compiled", "stage", "volcano"):
        assert_results_equal(want, run(q(pc), engine), msg=engine)


@SETTINGS
@given(tables(), predicate_specs())
def test_optimizer_invariance(tbl_dom, spec):
    """optimize(plan) must not change results (rule soundness), through
    the one-shot ``engines.execute``."""
    jc, pc = contexts(t=tbl_dom[0])

    def q(ctx, m):
        return (ctx.table("t").filter(pred(spec, m))
                .select(("k", m.col("k")), ("tag", m.col("tag")),
                        ("v", m.col("x") + 1.0))
                .filter(m.col("v") > -1000.0)
                .group_by("tag").agg(m.sum_(m.col("v"), "sv"),
                                     m.count("n")))

    cpu = ENG.DeviceCache(pc.device)
    plan = q(pc, PC).plan
    r_raw = ENG.execute(plan, pc.catalog, "volcano", cache=cpu).compact()
    r_opt = ENG.execute(pc.optimized(plan), pc.catalog, "volcano",
                        cache=cpu).compact()
    assert_results_equal(r_raw, r_opt, msg="optimizer")
    want = JENG.execute(q(jc, JC).plan, jc.catalog, "volcano").compact()
    assert_results_equal(want, r_raw, msg="vs JAX package")
    got = ENG.execute(pc.optimized(plan), pc.catalog, "compiled",
                      cache=cpu).compact()
    assert_results_equal(want, got, rtol=1e-2, atol=1e-2, msg="compiled")


@SETTINGS
@given(tables(), predicate_specs(),
       st.lists(st.sampled_from(["k", "tag"]), min_size=0, max_size=2,
                unique=True),
       st.integers(1, 130))
def test_morsel_merge_matches_monolithic(tbl_dom, spec, keys, morsel_rows):
    """Every merge op (sum, count, min, max, any, avg) over any morsel
    size, ragged last morsels and empty groups included, equals the
    monolithic function; counts exactly."""
    _, pc = contexts(t=tbl_dom[0])

    def q():
        base = pc.table("t").filter(pred(spec, PC))
        aggs = [PC.sum_(PC.col("x"), "sx"), PC.count("n"),
                PC.min_(PC.col("y"), "mn"), PC.max_(PC.col("x"), "mx"),
                PC.avg(PC.col("x"), "ax")]
        if keys:
            aggs.append(PC.any_(PC.col(keys[0]), "ak"))
            return base.group_by(*keys).agg(*aggs)
        return base.agg(*aggs)

    for engine in ("compiled", "compiled-native"):
        want = run(q(), engine)
        low = q().lower(engine=engine, morsel_rows=morsel_rows)
        assert MO.find_morsel_node(low.plan()).morsel_rows == morsel_rows
        got = low.compile().collect()
        assert_results_equal(want, got, rtol=1e-4, atol=1e-3, msg=engine)
        assert np.array_equal(np.asarray(want["n"]), np.asarray(got["n"]))


@SETTINGS
@given(st.lists(st.text(alphabet="abcdef", min_size=0, max_size=6),
                min_size=1, max_size=50))
def test_dictionary_roundtrip(strings):
    from repro.relational.table import dictionary_encode as jax_encode
    colm = PT.dictionary_encode(strings)
    assert list(colm.decode()) == [str(s) for s in strings]
    # codes are in sorted-dictionary order, as in the JAX package
    assert list(colm.dictionary) == sorted(set(str(s) for s in strings))
    ref = jax_encode(strings)
    assert np.array_equal(np.asarray(colm.data), np.asarray(ref.data))


@settings(max_examples=30, deadline=None, derandomize=True)
@given(
    probe_keys=st.lists(st.integers(0, 15), min_size=1, max_size=40),
    build_keys=st.lists(st.integers(0, 15), min_size=1, max_size=16),
    mask=st.lists(st.integers(0, 1), min_size=16, max_size=16),
    how=st.sampled_from(["inner", "left", "semi", "anti"]),
)
def test_join_index_cache_adversarial_keys(probe_keys, build_keys, mask,
                                           how):
    """The cached-index join equals the in-program sort and the JAX
    volcano oracle under duplicate and absent keys, for every join kind.
    Build sides are unfiltered when keys repeat (the cacheable contract)
    and filtered when unique (validated after the probe)."""
    build_arr = np.asarray(build_keys, np.int32)
    unique = len(set(build_keys)) == len(build_keys)
    out = []
    for ctx, m in ((JaxContext(), JC), (FlareContext(device="cpu"), PC)):
        ctx.from_arrays("probe", {
            "pk": np.asarray(probe_keys, np.int32),
            "x": np.arange(len(probe_keys), dtype=np.float64),
        }, domains={"pk": 16})
        ctx.from_arrays("build", {
            "k": build_arr,
            "v": np.arange(len(build_arr), dtype=np.float64),
            "flag": np.asarray(mask[:len(build_arr)], np.int32),
        }, domains={"k": 16}, uniques=["k"] if unique else [])
        build = ctx.table("build")
        if unique:
            build = build.filter(m.col("flag") == 1)
        out.append(ctx.table("probe").join(build, on="pk", right_on="k",
                                           how=how).sort("pk", "x"))
    jq, q = out
    lowered = q.lower(engine="compiled")
    assert len(lowered.dispatch_report().joins_cached) == 1
    warm = lowered.compile()()
    cold = q.lower(engine="compiled", join_index=False).compile()()
    assert_results_equal(cold, warm, msg=f"{how} adversarial")
    assert_results_equal(run(jq, "volcano"), warm,
                         msg=f"{how} adversarial vs JAX oracle")


@SETTINGS
@given(st.data())
def test_segmented_sum_plain_on_adversarial_codes(data):
    """``segmented_sum`` on CPU tensors (its plain version) equals the JAX
    package's reference for skewed, constant and boundary-hugging codes,
    ragged lengths and empty groups."""
    import torch
    from repro.kernels.segmented_reduce.ref import segmented_sum_ref
    from repro_torch.kernels.segmented_reduce.ops import segmented_sum

    g = data.draw(st.integers(1, 70), label="num_groups")
    n = data.draw(st.one_of(
        st.integers(1, 300),
        st.sampled_from([127, 128, 129, 1023, 1024, 1025, 8191, 8192])),
        label="n")
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 31 - 1)))
    kind = data.draw(st.sampled_from(
        ["uniform", "constant", "boundary", "skewed"]), label="codes")
    if kind == "uniform":
        codes = rng.integers(0, g, n)
    elif kind == "constant":
        codes = np.full(n, data.draw(st.integers(0, g - 1)))
    elif kind == "boundary":
        codes = rng.choice([0, g - 1], n)
    else:  # skewed: almost every row in one hot group
        hot = data.draw(st.integers(0, g - 1))
        codes = np.where(rng.random(n) < 0.95, hot, rng.integers(0, g, n))
    v = np.round(rng.uniform(-100, 100, n), 2).astype(np.float32)
    got = segmented_sum(torch.from_numpy(v),
                        torch.from_numpy(codes.astype(np.int32)), g)
    import jax.numpy as jnp
    want = segmented_sum_ref(jnp.asarray(v), jnp.asarray(codes, jnp.int32), g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-3)
