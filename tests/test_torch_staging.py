"""Staged UDFs on the port: one function over torch tensors, every engine.

Counterparts of ``tests/test_staging.py``: the same table (500 rows, seed
0) in a JAX ``FlareContext`` and a port ``FlareContext(device="cpu")``;
each UDF is written twice, with jnp ops for the JAX package and torch ops
for the port, and the port's ``compiled``, ``stage``, ``volcano`` and
``tuple`` engines are held against the JAX volcano oracle at
``conftest``'s tolerance (rtol 5e-3; 1e-4 for the Gaussian).  Every
engine hands a UDF torch tensors (``repro_torch.core.staging``): a UDF
written with torch ops -- ``torch.tanh`` -- runs on all four.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
import repro_torch.core as PC
from conftest import assert_results_equal
from repro.relational.table import Table as JTable
from repro_torch.core import ml as ML
from repro_torch.core import plan as PL
from repro_torch.core.lower import build_callable
from repro_torch.relational.table import Table

ENGINES = ["compiled", "stage", "volcano", "tuple"]


def _data():
    rng = np.random.default_rng(0)
    return {"x": rng.uniform(0, 10, 500),
            "y": rng.integers(0, 5, 500).astype(np.int32)}


@pytest.fixture(scope="module")
def ctxs():
    jc = JC.FlareContext()
    jc.register("t", JTable.from_arrays(_data(), domains={"y": 5}))
    pc = PC.FlareContext(device="cpu")
    pc.register("t", Table.from_arrays(_data(), domains={"y": 5}))
    return jc, pc


def _run(df, engine):
    if engine == "compiled":
        with pytest.warns(DeprecationWarning):
            return PC.flare(df).collect()
    return df.collect(engine=engine)


def _sqr_df(ctx, M):
    @M.udf("float64")
    def sqr(x):
        return x * x

    return (ctx.table("t")
            .select(("y", M.col("y")), ("s", sqr(M.col("x"))))
            .group_by("y").agg(M.sum_(M.col("s"), "ss")))


@pytest.mark.parametrize("engine", ENGINES)
def test_udf_all_engines(ctxs, engine):
    jc, pc = ctxs
    rv = _sqr_df(jc, JC).collect(engine="volcano")
    got = _run(_sqr_df(pc, PC), engine)
    assert_results_equal(rv, got, ordered=engine != "tuple",
                         msg=f"udf {engine}")
    want = np.asarray(pc.catalog.table("t")["x"]) ** 2
    np.testing.assert_allclose(got["ss"].sum(), want.sum(), rtol=1e-3)


@pytest.mark.parametrize("engine", ENGINES)
def test_udf_in_predicate(ctxs, engine):
    jc, pc = ctxs
    big = {JC: lambda x: x > 5.0, PC: lambda x: torch.gt(x, 5.0)}
    jq = jc.table("t").filter(JC.udf("bool")(big[JC])(JC.col("x")))
    pq = pc.table("t").filter(PC.udf("bool")(big[PC])(PC.col("x")))
    want = int((np.asarray(pc.catalog.table("t")["x"]) > 5.0).sum())
    assert jq.count(engine="stage") == want
    if engine == "compiled":
        with pytest.warns(DeprecationWarning):
            assert PC.flare(pq).count() == want
    else:
        assert pq.count(engine=engine) == want


def _gauss(M):
    exp = jnp.exp if M is JC else torch.exp

    @M.udf("float64")
    def gauss(x, y):
        return exp(-(x - y) ** 2 / 2.0)

    return gauss


@pytest.mark.parametrize("engine", ENGINES)
def test_udf_composes_with_torch_ops(ctxs, engine):
    jc, pc = ctxs
    jq = jc.table("t").select(("g", _gauss(JC)(JC.col("x"), JC.col("y"))))
    pq = pc.table("t").select(("g", _gauss(PC)(PC.col("x"), PC.col("y"))))
    rv = jq.collect(engine="volcano")
    assert_results_equal(rv, _run(pq, engine), rtol=1e-4,
                         msg=f"gauss {engine}")


@pytest.mark.parametrize("engine", ENGINES)
def test_torch_op_udf_on_every_engine(ctxs, engine):
    """``sum(tanh(x))`` with ``lambda x: torch.tanh(x)``: every engine
    hands the UDF tensors (the volcano oracle float64 CPU tensors, the
    tuple engine length-1 ones), so the one function runs on all four,
    equal to the JAX package with its jnp twin."""
    jc, pc = ctxs
    jt = JC.udf("float32")(lambda x: jnp.tanh(x))
    pt = PC.udf("float32")(lambda x: torch.tanh(x))
    want = jc.table("t").agg(JC.sum_(jt(JC.col("x") - 5.0), "s"))
    got = pc.table("t").agg(PC.sum_(pt(PC.col("x") - 5.0), "s"))
    rv = want.collect(engine="volcano")
    assert_results_equal(rv, _run(got, engine), msg=f"tanh {engine}")
    assert_results_equal(want.collect(engine="stage"),
                         got.collect(engine="stage"), msg="tanh stage")


def test_udf_sees_tensors_in_every_engine(ctxs):
    _, pc = ctxs
    seen = set()

    def spy(x):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        seen.add((tuple(x.shape), x.dtype))
        return x + 1.0

    q = pc.table("t").agg(PC.sum_(PC.udf("float64")(spy)(PC.col("x")), "s"))
    want = {"compiled": {((500,), torch.float32)},
            "stage": {((500,), torch.float32)},
            "volcano": {((500,), torch.float64)},
            "tuple": {((1,), torch.float64)}}
    for engine in ENGINES:
        seen.clear()
        q.lower(engine=engine).compile()()
        assert seen == want[engine], engine


def test_udf_with_a_param(ctxs):
    jc, pc = ctxs

    def build(ctx, M):
        scaled = M.udf("float32")(lambda x, g: x * g)
        return ctx.table("t").agg(
            M.sum_(scaled(M.col("x"), M.param("gain", "float32")), "s"))

    compiled = build(pc, PC).lower("compiled").compile()
    for gain in (0.5, 2.5):
        want = build(jc, JC).collect(engine="volcano",
                                     params={"gain": gain})
        assert_results_equal(want, compiled(gain=gain), msg=f"gain {gain}")
        for engine in ("stage", "volcano", "tuple"):
            assert_results_equal(
                want, build(pc, PC).collect(engine=engine,
                                            params={"gain": gain}),
                msg=f"gain {gain} {engine}")


def test_staged_udf_raw_and_repr():
    @PC.udf("float32", name="twice")
    def double(x):
        return 2 * x

    assert double.name == "twice" and double.dtype == "float32"
    assert double.__name__ == "double"
    assert torch.equal(double.raw(torch.ones(3)), torch.full((3,), 2.0))
    assert "twice" in repr(double)
    assert repr(double(PC.col("x"))) == "twice(x)"


def test_ml_kernels_fuse_with_etl(ctxs, monkeypatch):
    """Fig. 8 pattern: relational plan -> matrix -> kmeans in one
    function over device tensors, no column copied to the host."""
    _, pc = ctxs
    q = pc.table("t").filter(PC.col("x") > 1.0).select("x", "y")
    plan = pc.optimized(q.plan)
    fn, layout, _index_layout, _ = build_callable(plan, pc.catalog)
    scans = {}

    def walk(n):
        if isinstance(n, PL.Scan):
            scans[id(n)] = n.table
        for c in n.children():
            walk(c)

    walk(plan)
    args = [pc.cache.get(pc.catalog.table(scans[sid]), name)
            for sid, names in layout for name in names]

    def pipeline(*tensors):
        cols, mask = fn(pc.device, *tensors)
        x = torch.stack([cols["x"], cols["y"].to(torch.float32)], 1)
        x = x * mask[:, None]
        return ML.kmeans(x, k=3, max_iter=20, weights=mask.float()).centroids

    copies = []
    for name in ("cpu", "numpy"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda t, *a, _o=orig, _n=name, **k:
                            copies.append(_n) or _o(t, *a, **k))
    cent = pipeline(*args)
    assert copies == []
    assert tuple(cent.shape) == (3, 2)
    assert torch.isfinite(cent).all()
