"""The port's heterogeneous pipelines (paper Fig. 8 / 13) against the JAX
package, on the CPU.

The same numpy tables (``tests/test_heterogeneous.py``'s: N 2 000, D 4,
K 3, seed 7) go into a JAX ``FlareContext`` and a port ``FlareContext(
device="cpu")``.  Every test of ``tests/test_heterogeneous.py`` has a
counterpart here whose JAX twin runs the jnp function and whose port runs
the torch one, on the port's ``compiled``, ``stage``, ``volcano`` and
``tuple`` engines.  Tolerances are the reference tests': kmeans rtol 1e-3
/ atol 1e-3 with equal iteration counts, logreg rtol 1e-4 / atol 1e-5,
gda rtol 1e-3 / atol 1e-4, relational results at ``conftest``'s rtol 5e-3.

``core/ml.py``'s functions are held one by one against ``repro.core.ml``:
``dist`` (rtol 1e-5), ``until_converged`` (equal iteration counts),
``group_by_reduce`` by both routes (rtol 1e-5: the port sums in float64),
``_first_valid_rows`` (bit for bit), weighted ``kmeans``, ``logreg``,
``gda``, ``gene_barcode``, and unweighted ``kmeans`` on well-separated
clusters (the same centroids up to a permutation: its seeds differ).

The fused ``compiled`` engine's function runs ETL and training with no
host copy of a column, and ``compiled-native`` fires the same patterns as
the JAX package's dispatch pass on these plans and on the Fig. 8 lineitem
pipeline at SF 0.005.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as JC
import repro_torch.core as PC
from conftest import assert_results_equal
from repro.core import ml as JML
from repro.relational import queries as JQ
from repro.relational.table import Table as JTable
from repro_torch.core import ml as ML
from repro_torch.core import plan as P
from repro_torch.core import stages as S
from repro_torch.relational import table as PT
from repro_torch.relational.table import Table

from test_torch_data_ir import as_spec

N, D, K = 2_000, 4, 3
FEATURES = [f"f{i}" for i in range(D)]
ENGINES = ["compiled", "stage", "volcano", "tuple"]


def _points():
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 5, (K, D))
    assign = rng.integers(0, K, N)
    x = centers[assign] + rng.normal(0, 1, (N, D))
    data = {f"f{i}": x[:, i] for i in range(D)}
    data["quality"] = rng.uniform(0, 1, N)
    data["label"] = (assign % 2).astype(np.int32)
    return data


@pytest.fixture(scope="module")
def ctxs():
    data = _points()
    jc = JC.FlareContext()
    jc.register("points", JTable.from_arrays(data))
    pc = PC.FlareContext(device="cpu")
    pc.register("points", Table.from_arrays(data))
    return jc, pc


def _etl(ctx, M):
    return ctx.table("points").filter(M.col("quality") > 0.2)


def _both(ctxs, build):
    """``build(ctx, M)`` for the JAX package and the port."""
    jc, pc = ctxs
    return build(jc, JC), build(pc, PC)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


# ---------------------------------------------------------------------------
# core/ml.py, function by function
# ---------------------------------------------------------------------------


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 3, shape).astype(np.float32)


def test_dist_matches_reference():
    x, y = _rand((300, 5), 1), _rand((7, 5), 2)
    want = JML.dist(jnp.asarray(x), jnp.asarray(y))
    got = ML.dist(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        ML.dist(torch.from_numpy(x), torch.from_numpy(y), kind="L1")


@pytest.mark.parametrize("tol,max_iter", [(1e-3, 100), (0.0, 17),
                                          (0.5, 100), (1e-3, 0)])
def test_until_converged_iteration_counts(tol, max_iter):
    x0 = _rand((6,), 3)

    def jbody(s):
        return s * 0.5 + 0.25

    state, iters = JML.until_converged(jnp.asarray(x0), jbody, tol,
                                       max_iter)
    got, got_iters = ML.until_converged(torch.from_numpy(x0), jbody, tol,
                                        max_iter)
    assert int(got_iters) == int(iters)
    assert got_iters.dtype == torch.int32
    _close(got, state, rtol=1e-6)
    # param() bindings arrive as 0-d tensors
    again, n = ML.until_converged(torch.from_numpy(x0), jbody,
                                  torch.tensor(tol, dtype=torch.float32),
                                  torch.tensor(max_iter, dtype=torch.int32))
    assert int(n) == int(iters)


def test_until_converged_stops_on_nan_and_compares_in_f32():
    _, iters = ML.until_converged(torch.ones(3), lambda s: s * np.nan,
                                  1e-3, 50)
    assert int(iters) == 1  # NaN >= tol is false, as in XLA
    # a diff equal to float32(tol) continues (tol rounds to f32 first)
    tol = 0.1
    d = float(np.float32(tol))
    steps = []

    def diff(a, b):
        steps.append(1)
        return torch.tensor(d if len(steps) < 3 else 0.0)

    _, iters = ML.until_converged(torch.zeros(1), lambda s: s, tol, 10,
                                  diff)
    _, jiters = JML.until_converged(
        jnp.zeros(1), lambda s: s, tol, 10,
        lambda a, b: jnp.where(jnp.max(a) >= 0, jnp.float32(d), 0.0))
    assert int(iters) == 3 and int(jiters) == 10


@pytest.mark.parametrize("route", ["onehot", "index_add"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("width", [0, 5])
def test_group_by_reduce_matches_reference(route, weighted, width,
                                           monkeypatch):
    monkeypatch.setattr(ML, "group_route", lambda k: route)
    rng = np.random.default_rng(4)
    n, g = 3000, 6
    keys = rng.integers(-1, g + 1, n).astype(np.int32)  # some out of range
    vals = _rand((n, width) if width else (n,), 5)
    w = (rng.integers(0, 2, n).astype(np.float32) if weighted else None)
    js, jc = JML.group_by_reduce(jnp.asarray(keys), jnp.asarray(vals), g,
                                 None if w is None else jnp.asarray(w))
    ps, pc = ML.group_by_reduce(torch.from_numpy(keys), torch.from_numpy(vals),
                                g, None if w is None else torch.from_numpy(w))
    assert ps.dtype == torch.float32 and tuple(ps.shape) == js.shape
    _close(ps, js, rtol=1e-5, atol=1e-3)
    _close(pc, jc, rtol=0, atol=0)


def test_group_by_reduce_routes_agree_in_f64():
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 4, 50_000).astype(np.int32))
    vals = torch.from_numpy(_rand((50_000, 8), 6))
    w = torch.ones(50_000)
    a = ML.GROUP_ROUTES["onehot"](keys, vals, w, 4)
    b = ML.GROUP_ROUTES["index_add"](keys, vals, w, 4)
    assert a[0].dtype == b[0].dtype == torch.float64
    _close(a[0], b[0], rtol=1e-9, atol=1e-6)
    assert torch.equal(a[1], b[1])
    assert ML.group_route(4) == "onehot"
    assert ML.group_route(ML.ONEHOT_MAX_GROUPS) == "onehot"
    assert ML.group_route(ML.ONEHOT_MAX_GROUPS + 1) == "index_add"


@pytest.mark.parametrize("valid", [[1, 0, 1, 1, 0, 1, 1, 0], [0, 0, 0, 1],
                                   [0, 0, 0, 0], [1, 1, 1, 1, 1, 1]])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_first_valid_rows_bit_for_bit(valid, k):
    w = np.asarray(valid, np.float32)
    x = _rand((len(w), 3), 7)
    want = JML._first_valid_rows(jnp.asarray(x), jnp.asarray(w), k)
    got = ML._first_valid_rows(torch.from_numpy(x), torch.from_numpy(w), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_first_valid_rows_of_empty_input():
    got = ML._first_valid_rows(torch.zeros((0, 3)), torch.zeros(0), 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JML._first_valid_rows(
            jnp.zeros((0, 3)), jnp.zeros(0), 4)))


def _matrix(valid_share=0.8):
    data = _points()
    x = np.stack([data[c] for c in FEATURES], 1).astype(np.float32)
    y = data["label"].astype(np.float32)
    w = (data["quality"] < valid_share).astype(np.float32)
    return x * w[:, None], y * w, w


def test_weighted_kmeans_matches_reference():
    x, _, w = _matrix()
    want = JML.kmeans(jnp.asarray(x), K, max_iter=40, weights=jnp.asarray(w))
    got = ML.kmeans(torch.from_numpy(x), K, max_iter=40,
                    weights=torch.from_numpy(w))
    assert int(got.iters) == int(want.iters)
    _close(got.centroids, want.centroids, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(want.assignments))
    assert got.assignments.dtype == torch.int32


def test_unweighted_kmeans_well_separated_up_to_permutation():
    rng = np.random.default_rng(11)
    centers = np.asarray([[0, 0], [40, 0], [0, 40]], np.float32)
    assign = rng.integers(0, 3, 600)
    x = (centers[assign] + rng.normal(0, 0.5, (600, 2))).astype(np.float32)
    # seeds from a torch.Generator: draw until every cluster has one
    got = None
    for seed in range(20):
        r = ML.kmeans(torch.from_numpy(x), 3, max_iter=50, seed=seed)
        if len(set(r.assignments.tolist())) == 3:
            got = r
            break
    assert got is not None
    want = JML.kmeans(jnp.asarray(x), 3, max_iter=50, seed=0)
    order = lambda c: np.asarray(c)[np.lexsort(np.asarray(c).T[::-1])]
    _close(order(got.centroids), order(want.centroids), rtol=1e-3, atol=1e-3)
    # the seeds come from the generator, the same for the same seed
    again = ML.kmeans(torch.from_numpy(x), 3, max_iter=50, seed=seed)
    assert torch.equal(again.centroids, got.centroids)


def test_logreg_matches_reference():
    x, y, w = _matrix()
    want = JML.logreg(jnp.asarray(x), jnp.asarray(y), lr=0.3, max_iter=80,
                      weights=jnp.asarray(w))
    got = ML.logreg(torch.from_numpy(x), torch.from_numpy(y), lr=0.3,
                    max_iter=80, weights=torch.from_numpy(w))
    assert int(got.iters) == int(want.iters)
    _close(got.weights, want.weights, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_gda_matches_reference(weighted):
    x, y, w = _matrix()
    jw = jnp.asarray(w) if weighted else None
    pw = torch.from_numpy(w) if weighted else None
    want = JML.gda(jnp.asarray(x), jnp.asarray(y), weights=jw)
    got = ML.gda(torch.from_numpy(x), torch.from_numpy(y), weights=pw)
    for name in ("phi", "mu0", "mu1", "sigma"):
        _close(getattr(got, name), getattr(want, name), rtol=1e-3, atol=1e-4,
               err_msg=name)


def test_gene_barcode_matches_reference():
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 50, 5000).astype(np.float32)
    barcodes = rng.integers(0, 40, 5000).astype(np.int32)
    want = JML.gene_barcode(jnp.asarray(counts), jnp.asarray(barcodes), 40)
    got = ML.gene_barcode(torch.from_numpy(counts),
                          torch.from_numpy(barcodes), 40)
    _close(got, want, rtol=0, atol=0)  # integer sums, exact in f32


def test_train_kernel_registry():
    assert set(ML.TRAIN_KERNELS) >= {"kmeans", "logreg", "gda"}
    assert ML.train_kernel("logreg").needs_labels
    k = ML.train_kernel(ML.kmeans)
    assert k is ML.TRAIN_KERNELS["kmeans"]

    def mine(x, weights=None):
        return x.sum()

    adhoc = ML.train_kernel(mine)
    assert adhoc.name == "mine" and adhoc.fn is mine
    assert ML.train_kernel(adhoc) is adhoc
    with pytest.raises(TypeError, match="needs labels"):
        ML.TRAIN_KERNELS["gda"](torch.zeros((2, 2)))
    with pytest.raises(TypeError, match="cannot resolve"):
        ML.train_kernel(3)


# ---------------------------------------------------------------------------
# MapBatches: the four engines against the JAX package
# ---------------------------------------------------------------------------


def _radius_jax(cols):
    return {"r": jnp.sqrt(cols["f0"] ** 2 + cols["f1"] ** 2),
            "s": jnp.tanh(cols["f0"])}


def _radius_torch(cols):
    return {"r": torch.sqrt(cols["f0"] ** 2 + cols["f1"] ** 2),
            "s": torch.tanh(cols["f0"])}


RADIUS = {JC: _radius_jax, PC: _radius_torch}


def _radius_df(ctx, M):
    return (_etl(ctx, M)
            .map_batches(RADIUS[M], columns=["f0", "f1"],
                         schema={"r": "float32", "s": "float32"})
            .filter(M.col("r") < 5.0)
            .agg(M.sum_(M.col("r"), "total"), M.sum_(M.col("s"), "stot")))


@pytest.mark.parametrize("engine", ENGINES)
def test_map_batches_on_every_engine(ctxs, engine):
    jq, pq = _both(ctxs, _radius_df)
    oracle = jq.lower(engine="volcano").compile()()
    assert_results_equal(oracle, pq.lower(engine=engine).compile()(),
                         msg=f"map_batches {engine}")
    if engine != "volcano":
        assert_results_equal(jq.lower(engine=engine).compile()(),
                             pq.lower(engine=engine).compile()(),
                             msg=f"map_batches {engine} vs JAX {engine}")


@pytest.mark.parametrize("engine", ENGINES)
def test_map_batches_validates_schema(ctxs, engine):
    _, pc = ctxs
    with pytest.raises(ValueError, match="absent from the child"):
        pc.table("points").map_batches(
            _radius_torch, columns=["nope"], schema={"r": "float32"})

    def wrong(cols):
        return {"unexpected": cols["f0"]}

    q = pc.table("points").map_batches(
        wrong, columns=["f0"], schema={"r": "float32"})
    with pytest.raises(TypeError, match="declared"):
        q.lower(engine=engine).compile()()

    def shrinks(cols):
        return {"r": cols["f0"][:0]}

    q = (pc.table("points").filter(PC.col("quality") > 0.9)
         .map_batches(shrinks, columns=["f0"], schema={"r": "float32"}))
    with pytest.raises(TypeError, match="length-preserving"):
        q.lower(engine=engine).compile()()


# ---------------------------------------------------------------------------
# train(): fused compiled vs stage/volcano/tuple, and vs the JAX package
# ---------------------------------------------------------------------------


def _valid(pc):
    return np.asarray(_etl(pc, PC).select(*FEATURES).lower("compiled")
                      .compile().result().mask)


def _kmeans_df(ctx, M):
    return _etl(ctx, M).train("kmeans", columns=FEATURES, k=K, max_iter=40)


def test_fused_kmeans_matches_reference(ctxs):
    jq, pq = _both(ctxs, _kmeans_df)
    want = jq.lower(engine="compiled").compile()()
    got = pq.lower(engine="compiled").compile()()
    assert int(got.iters) == int(want.iters)
    _close(got.centroids, want.centroids, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.assignments,
                                  np.asarray(want.assignments))


@pytest.mark.parametrize("engine", ["stage", "volcano", "tuple"])
def test_kmeans_fallbacks_agree_with_fused(ctxs, engine):
    jq, pq = _both(ctxs, _kmeans_df)
    fused = pq.lower(engine="compiled").compile()()
    other = pq.lower(engine=engine).compile()()
    # deterministic first-k-valid init => same trajectory, padded or not
    _close(fused.centroids, other.centroids, rtol=1e-3, atol=1e-3)
    assert int(fused.iters) == int(other.iters)
    valid = _valid(ctxs[1])
    fa, oa = np.asarray(fused.assignments), np.asarray(other.assignments)
    if engine == "stage":  # the stage fallback is padded too
        assert (fa[valid] == oa[valid]).all()
    else:
        assert (fa[valid] == oa).all()
    # and the JAX package's same engine agrees
    ref = jq.lower(engine=engine).compile()()
    _close(other.centroids, ref.centroids, rtol=1e-3, atol=1e-3)
    assert int(other.iters) == int(ref.iters)


def _logreg_df(ctx, M, max_iter=60):
    return _etl(ctx, M).train("logreg", columns=FEATURES, label="label",
                              max_iter=max_iter)


def _gda_df(ctx, M):
    return _etl(ctx, M).train("gda", columns=FEATURES, label="label")


@pytest.mark.parametrize("engine", ["stage", "volcano", "tuple"])
def test_logreg_and_gda_fallbacks(ctxs, engine):
    jl, pl = _both(ctxs, _logreg_df)
    fused = pl.lower(engine="compiled").compile()()
    other = pl.lower(engine=engine).compile()()
    _close(fused.weights, other.weights, rtol=1e-4, atol=1e-5)
    assert int(fused.iters) == int(other.iters)
    ref = jl.lower(engine="compiled").compile()()
    _close(fused.weights, ref.weights, rtol=1e-4, atol=1e-5)

    jg, pg = _both(ctxs, _gda_df)
    gf = pg.lower(engine="compiled").compile()()
    go = pg.lower(engine=engine).compile()()
    gr = jg.lower(engine="compiled").compile()()
    for name in ("phi", "mu0", "mu1", "sigma"):
        _close(getattr(gf, name), getattr(go, name), rtol=1e-3, atol=1e-4,
               err_msg=name)
        _close(getattr(gf, name), getattr(gr, name), rtol=1e-3, atol=1e-4,
               err_msg=name)


def test_train_requires_label_when_needed(ctxs):
    _, pc = ctxs
    with pytest.raises(TypeError, match="needs labels"):
        pc.table("points").train("logreg", columns=FEATURES)
    with pytest.raises(ValueError, match="unknown training kernel"):
        pc.table("points").train("not-a-kernel", columns=FEATURES)
    with pytest.raises(KeyError, match="unknown label"):
        pc.table("points").train("logreg", columns=FEATURES, label="nope")
    with pytest.raises(KeyError, match="unknown column"):
        pc.table("points").to_matrix("nope")


def test_to_matrix_defaults_to_numeric_columns(ctxs):
    _, pc = ctxs
    view = pc.table("points").to_matrix()
    assert view.columns == tuple(FEATURES) + ("quality", "label")
    tr = pc.table("points").train("gda", label="label")
    assert tr.plan.features == tuple(FEATURES) + ("quality",)


def test_kmeans_fewer_valid_rows_than_k(ctxs):
    """Surplus seeds duplicate the LAST valid row on padded and
    compacted paths alike -- never a zeroed padding row."""
    jc, pc = ctxs
    qcol = np.asarray(pc.catalog.table("points")["quality"])
    srt = np.sort(qcol)
    thr = float((srt[-3] + srt[-4]) / 2)  # 3 rows pass, far from f32 edge

    def build(ctx, M):
        return (ctx.table("points").filter(M.col("quality") > thr)
                .train("kmeans", columns=FEATURES, k=K + 1, max_iter=10))

    jq, pq = _both(ctxs, build)
    fused = pq.lower(engine="compiled").compile()()
    oracle = pq.lower(engine="volcano").compile()()
    _close(fused.centroids, oracle.centroids, rtol=1e-4, atol=1e-4)
    ref = jq.lower(engine="compiled").compile()()
    _close(fused.centroids, ref.centroids, rtol=1e-4, atol=1e-4)
    assert int(fused.iters) == int(ref.iters)


def test_adhoc_kernels_do_not_share_cache_entries(ctxs):
    """Two same-named (lambda) kernels must fingerprint differently --
    a shared CompileCache key would serve the first one's function."""
    _, pc = ctxs
    a = _etl(pc, PC).train(lambda x, weights=None: {"m": torch.sum(x)},
                           columns=["f0"])
    b = _etl(pc, PC).train(lambda x, weights=None: {"m": torch.sum(x) * 1e3},
                           columns=["f0"])
    ra = a.lower(engine="compiled").compile()()["m"]
    rb = b.lower(engine="compiled").compile()()["m"]
    assert not np.allclose(ra, rb)
    assert a.lower("compiled").cache_key != b.lower("compiled").cache_key


# ---------------------------------------------------------------------------
# one fused function + prepared hyper-parameters
# ---------------------------------------------------------------------------


class _HostCopies:
    """Counts ``Tensor.cpu`` and ``Tensor.numpy`` calls."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("cpu", "numpy"):
            orig = getattr(torch.Tensor, name)

            def spy(t, *a, _orig=orig, _name=name, **kw):
                self.calls.append((_name, tuple(t.shape)))
                return _orig(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, spy)


def _fused_fn(pc, df):
    lowered = df.lower(engine="compiled")
    art = lowered._force()
    args = S._marshal_args(art.layout, art.index_layout, pc.catalog,
                           pc.cache)
    return art, args


def test_fused_pipeline_copies_no_column_to_the_host(ctxs, monkeypatch):
    """The ``compiled`` engine's function runs the filter, the feature
    stack and the training loop on the device: no column and no mask
    goes to the host (each iteration reads one 4-byte diff by
    ``.item()``), and the result comes out as device tensors."""
    _, pc = ctxs
    tr = _kmeans_df(pc, PC)
    art, args = _fused_fn(pc, tr)
    copies = _HostCopies(monkeypatch)
    items = []
    orig_item = torch.Tensor.item

    def item(t):
        items.append(tuple(t.shape))
        return orig_item(t)

    monkeypatch.setattr(torch.Tensor, "item", item)
    out = art.fn(pc.device, *args)
    assert copies.calls == []
    assert isinstance(out, ML.KMeansResult)
    assert all(isinstance(v, torch.Tensor) for v in out)
    assert items == [()] * int(out.iters)  # one 0-d diff per iteration
    # the stage engine, by contrast, copies its relational half
    tr.lower(engine="stage").compile()()
    assert any(n == "numpy" and len(s) == 1 and s[0] == N
               for n, s in copies.calls)


def test_param_hyper_prepared_pipeline(ctxs):
    def build(ctx, M):
        return _etl(ctx, M).train("logreg", columns=FEATURES, label="label",
                                  lr=M.param("lr", "float32"), max_iter=40)

    jq, pq = _both(ctxs, build)
    compiled = pq.lower(engine="compiled").compile()
    w1 = compiled(lr=0.05).weights
    w2 = compiled(lr=0.5).weights
    assert not np.allclose(w1, w2)   # the binding actually matters
    again = pq.lower(engine="compiled").compile()
    assert again.stats.cache_hit     # one template, many bindings
    oracle = pq.lower(engine="volcano").compile()(lr=0.5)
    _close(w2, oracle.weights, rtol=1e-4, atol=1e-5)
    ref = jq.lower(engine="compiled").compile()(lr=0.5)
    _close(w2, ref.weights, rtol=1e-4, atol=1e-5)
    for engine in ("stage", "tuple"):
        _close(pq.lower(engine=engine).compile()(lr=0.5).weights, w2,
               rtol=1e-4, atol=1e-5, err_msg=engine)


def test_param_max_iter_and_tol(ctxs):
    def build(ctx, M):
        return _etl(ctx, M).train("logreg", columns=FEATURES, label="label",
                                  max_iter=M.param("n", "int32"),
                                  tol=M.param("tol", "float32"))

    jq, pq = _both(ctxs, build)
    compiled = pq.lower(engine="compiled").compile()
    for n, tol in ((5, 0.0), (300, 1e-3)):
        got = compiled(n=n, tol=tol)
        want = jq.lower(engine="compiled").compile()(n=n, tol=tol)
        assert int(got.iters) == int(want.iters)
        _close(got.weights, want.weights, rtol=1e-4, atol=1e-5)


def test_flare_shim_runs_a_pipeline(ctxs):
    _, pc = ctxs
    with pytest.warns(DeprecationWarning):
        got = PC.flare(_kmeans_df(pc, PC)).collect()
    want = _kmeans_df(pc, PC).lower("compiled").compile()()
    _close(got.centroids, want.centroids, rtol=0, atol=0)
    with pytest.raises(TypeError, match="no row count"):
        _kmeans_df(pc, PC).lower("compiled").compile().count()


# ---------------------------------------------------------------------------
# the optimizer sees across the UDF boundary
# ---------------------------------------------------------------------------


def _find(plan, cls):
    out = []

    def rec(n):
        if isinstance(n, cls):
            out.append(n)
        for c in n.children():
            rec(c)

    rec(plan)
    return out


def _pushdown_df(ctx, M):
    return (ctx.table("points")
            .map_batches(RADIUS[M], columns=["f0", "f1"],
                         schema={"r": "float32", "s": "float32"})
            .filter((M.col("quality") > 0.5) & (M.col("r") < 2.0)))


@pytest.mark.parametrize("engine", ENGINES)
def test_filter_pushdown_across_map_batches(ctxs, engine):
    jq, pq = _both(ctxs, _pushdown_df)
    pc = ctxs[1]
    opt = pc.optimized(pq.plan)
    mbs = _find(opt, P.MapBatches)
    assert len(mbs) == 1
    # the quality conjunct crossed the UDF (it avoids produced columns)...
    below = _find(mbs[0].child, P.Filter)
    assert len(below) == 1 and "quality" in str(below[0].pred)
    # ...while the r conjunct (a produced column) stayed above
    above = [f for f in _find(opt, P.Filter) if f not in below]
    assert len(above) == 1 and "r" in str(above[0].pred)
    # and the rewrite preserves results
    jagg = jq.agg(JC.sum_(JC.col("r"), "t"))
    pagg = pq.agg(PC.sum_(PC.col("r"), "t"))
    assert_results_equal(jagg.lower(engine="volcano").compile()(),
                         pagg.lower(engine=engine).compile()(),
                         msg=f"pushdown differential {engine}")


def test_projection_pruned_to_declared_columns(ctxs):
    _, pc = ctxs
    q = (pc.table("points")
         .map_batches(_radius_torch, columns=["f0", "f1"],
                      schema={"r": "float32", "s": "float32"})
         .agg(PC.sum_(PC.col("r"), "t")))
    opt = pc.optimized(q.plan)
    mb = _find(opt, P.MapBatches)[0]
    scan_proj = _find(mb.child, P.Project)
    assert scan_proj, "expected a pruning Project above the scan"
    names = [n for n, _ in scan_proj[0].outputs]
    # only the UDF's declared inputs survive below the boundary
    assert set(names) == {"f0", "f1"}
    # and the compiled engine binds only those scan columns
    art = q.lower("compiled")._force()
    assert {n for _, names in art.layout for n in names} == {"f0", "f1"}


def test_train_prunes_to_features_and_label(ctxs):
    _, pc = ctxs
    tr = _etl(pc, PC).train("logreg", columns=FEATURES[:2], label="label",
                            max_iter=5)
    opt = pc.optimized(tr.plan)
    scan_proj = _find(opt, P.Project)
    assert scan_proj
    names = {n for n, _ in scan_proj[-1].outputs}
    assert names == {"f0", "f1", "label", "quality"}  # + filter input


# ---------------------------------------------------------------------------
# native dispatch fires what the JAX package's does
# ---------------------------------------------------------------------------


def _udf_select(ctx, M):
    # the UDF in the aggregate's argument: both dispatch passes fall back
    # ("unsupported expression: Udf").  A computed Project between the
    # filter and the aggregate would raise KeyError in both packages'
    # pattern analysis (ROADMAP Queue 3).
    sq = M.udf("float32")(RADIUS_SQ[M])
    return _etl(ctx, M).agg(M.sum_(sq(M.col("f0")), "sq"))


RADIUS_SQ = {JC: lambda x: jnp.square(x), PC: lambda x: torch.square(x)}

PIPELINES = {
    "map_batches": _radius_df,
    "pushdown": lambda c, M: _pushdown_df(c, M).agg(M.sum_(M.col("r"), "t")),
    "udf_select": _udf_select,
    "kmeans": _kmeans_df,
    "logreg": _logreg_df,
    "gda": _gda_df,
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_native_dispatch_matches_reference(ctxs, name):
    jq, pq = _both(ctxs, PIPELINES[name])
    jlow = jq.lower(engine="compiled", native=True)
    plow = pq.lower(engine="compiled", native=True)
    assert (plow.dispatch_report().fired_patterns()
            == jlow.dispatch_report().fired_patterns())
    got = plow.compile()()
    want = pq.lower(engine="volcano").compile()()
    if isinstance(got, dict):
        assert_results_equal(want, got, msg=name)
        return
    # padded (compiled) against compacted (volcano): assignments differ
    # in length, every other field is compared
    for field in set(got._fields) - {"assignments"}:
        _close(getattr(got, field), getattr(want, field), rtol=1e-3,
               atol=1e-3, err_msg=f"{name}.{field}")


@pytest.fixture(scope="module")
def tpch():
    jc = JC.FlareContext()
    JQ.register_tpch(jc, sf=0.005)
    pc = PC.FlareContext(device="cpu")
    tables = {n: jc.catalog.table(n) for n in jc.catalog.names()}
    for name, tbl in PT.tables_from_numpy(as_spec(tables)).items():
        pc.register(name, tbl)
    return jc, pc


def _log1p(M):
    if M is JC:
        return lambda c: {"log_price": jnp.log1p(c["l_extendedprice"])}
    return lambda c: {"log_price": torch.log1p(c["l_extendedprice"])}


def fig8_lineitem(ctx, M, tpch_date):
    """Paper Fig. 8 on TPC-H: lineitem shipped in 1995, a batch UDF's
    log price, k-means over four columns."""
    return (ctx.table("lineitem")
            .filter((M.col("l_shipdate") >= tpch_date("1995-01-01"))
                    & (M.col("l_shipdate") < tpch_date("1996-01-01")))
            .map_batches(_log1p(M), columns=["l_extendedprice"],
                         schema={"log_price": "float32"})
            .to_matrix("l_quantity", "l_discount", "l_tax", "log_price")
            .train("kmeans", k=8, max_iter=20))


def test_fig8_lineitem_pipeline_matches_reference(tpch):
    from repro.relational import tpch as JT
    from repro_torch.relational import tpch as PTP
    jc, pc = tpch
    jq = fig8_lineitem(jc, JC, JT.date)
    pq = fig8_lineitem(pc, PC, PTP.date)
    jlow = jq.lower(engine="compiled", native=True)
    plow = pq.lower(engine="compiled", native=True)
    assert (plow.dispatch_report().fired_patterns()
            == jlow.dispatch_report().fired_patterns())
    want = jq.lower(engine="compiled").compile()()
    got = plow.compile()()
    assert int(got.iters) == int(want.iters)
    _close(got.centroids, want.centroids, rtol=1e-3, atol=1e-3)
    staged = pq.lower(engine="stage").compile()()
    assert int(staged.iters) == int(got.iters)
    _close(staged.centroids, got.centroids, rtol=1e-4, atol=1e-4)
