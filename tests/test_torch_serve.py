"""The port's template serving (``repro_torch.serve`` + ``Compiled.batch``)
against the JAX package, on the CPU at SF 0.005.

The same generated tables (the JAX generator's, carried across with
``tables_from_numpy`` as ``tests/test_torch_slice.py`` does) go into a JAX
``FlareContext`` and a port ``FlareContext(device="cpu")``.  Every test of
``tests/test_serve.py`` has a counterpart here but the ``launch/serve.py``
shim's, which the port does not carry yet:

* differential: for every template and 1/3/5-request batches (3 and 5
  pad into buckets 4 and 8), the port's vmapped ``Compiled.batch`` equals
  its per-binding results and the JAX package's ``Compiled.batch``, at
  ``conftest`` tolerance;
* the async API (``submit``, ``block=False``) on ``compiled``,
  ``compiled-native`` (the kernels' plain versions here) and the eager
  engines; one build per (template, bucket); ``batch_bucket`` equal to
  the JAX package's; a param-free batch run once; ``TypeError`` on every
  engine that cannot batch;
* the server: coalescing per template, ragged occupancy, ``max_batch``
  chunks, an unknown template, ``NotDispatchedError``, an expired
  deadline, ``QueueFullError``, bisection around a poisoned binding, a
  background flush thread, concurrent submitters;
* ``percentile`` and ``ServeStats`` equal to the JAX package's on the
  same lists, ``random_bindings`` stable across processes;
* a ``train()`` template with a param: its batch equals its per-binding
  results.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import repro_torch.core as PC
from conftest import SRC, assert_results_equal
from repro.core import FlareContext as JaxContext
from repro.core import engines as JENG
from repro.relational import queries as JQ
from repro.serve import stats as JSTATS
from repro_torch.core import FlareContext, col, sum_
from repro_torch.core import engines as ENG
from repro_torch.core import stages as S
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT
from repro_torch.serve import (DeadlineExceededError, NotDispatchedError,
                               QueryServer, QueueFullError, ServeStats,
                               percentile)

from test_torch_data_ir import as_spec

SF = 0.005
TEMPLATE_NAMES = sorted(Q.TEMPLATES)
BATCH_SIZES = [1, 3, 5]


@pytest.fixture(scope="module")
def ctxs():
    jc = JaxContext()
    JQ.register_tpch(jc, sf=SF)
    pc = FlareContext(device="cpu")
    tables = {n: jc.catalog.table(n) for n in jc.catalog.names()}
    for name, tbl in PT.tables_from_numpy(as_spec(tables)).items():
        pc.register(name, tbl)
    return jc, pc


@pytest.fixture(scope="module")
def ctx(ctxs):
    return ctxs[1]


def bindings_for(name, n):
    """``n`` bindings cycling the registry's representative list."""
    base = Q.TEMPLATE_BINDINGS[name]
    return [dict(base[i % len(base)]) for i in range(n)]


def compiled_for(ctx, name, engine="compiled"):
    return Q.TEMPLATES[name](ctx).lower(engine=engine).compile()


# ---------------------------------------------------------------------------
# differential: batched == sequential == the JAX package's batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tname", TEMPLATE_NAMES)
@pytest.mark.parametrize("n", BATCH_SIZES)
def test_batch_matches_sequential_and_reference(ctxs, tname, n):
    jc, pc = ctxs
    bindings = Q.random_bindings(tname, n, seed=n)
    compiled = compiled_for(pc, tname)
    sequential = [compiled.result(**b).compact() for b in bindings]
    batched = compiled.batch(bindings)
    jbatched = JQ.TEMPLATES[tname](jc).lower(
        engine="compiled").compile().batch(bindings)
    assert len(batched) == len(jbatched) == n
    for i, (want, got, ref) in enumerate(zip(sequential, batched, jbatched)):
        # vmap changes no arithmetic: the slice equals its own result
        assert_results_equal(want, got.compact(), rtol=1e-6,
                             msg=f"{tname} binding {i} of batch {n}")
        assert_results_equal(ref.compact(), got.compact(),
                             msg=f"{tname} binding {i} vs JAX batch")


def test_batch_block_false_returns_async_handles(ctx):
    compiled = compiled_for(ctx, "q6")
    bindings = bindings_for("q6", 3)
    handles = compiled.batch(bindings, block=False)
    assert all(isinstance(h, S.AsyncResult) for h in handles)
    want = [compiled.result(**b).compact() for b in bindings]
    for w, h in zip(want, handles):
        assert h.ready()  # CPU: no event, the work has run
        assert_results_equal(w, h.compact())


# ---------------------------------------------------------------------------
# the async single-binding API
# ---------------------------------------------------------------------------


def test_call_block_false_is_public_async_path(ctx):
    compiled = compiled_for(ctx, "q6")
    binding = Q.TEMPLATE_BINDINGS["q6"][0]
    handle = compiled(block=False, **binding)
    assert isinstance(handle, S.AsyncResult)
    assert handle.block_until_ready() is handle
    assert_results_equal(compiled(**binding), handle.compact())
    # the materialised result is cached on the handle
    assert handle.result() is handle.result()
    assert handle.ready()


@pytest.mark.parametrize("tname", TEMPLATE_NAMES)
def test_native_submit_matches_result(ctx, tname):
    """``compiled-native`` submits run the fragments' kernels (their
    plain versions on the CPU) behind a deferred handle."""
    compiled = compiled_for(ctx, tname, engine="compiled-native")
    for b in bindings_for(tname, 2):
        handle = compiled.submit(**b)
        assert isinstance(handle, S.AsyncResult)
        assert_results_equal(compiled.result(**b).compact(),
                             handle.compact(), rtol=0, atol=0, msg=tname)


@pytest.mark.parametrize("engine", ["stage", "volcano", "tuple"])
def test_submit_works_on_engines_without_deferred_path(ctx, engine):
    # no raw/finalize split: submit runs eagerly behind an already-ready
    # handle (uniform API)
    compiled = compiled_for(ctx, "q6", engine=engine)
    binding = Q.TEMPLATE_BINDINGS["q6"][0]
    handle = compiled.submit(**binding)
    assert handle.ready()
    assert_results_equal(compiled(**binding), handle.compact())


@pytest.mark.parametrize("engine",
                         ["compiled-native", "stage", "volcano", "tuple"])
def test_batch_rejects_non_batchable_engines(ctx, engine):
    compiled = compiled_for(ctx, "q6", engine=engine)
    with pytest.raises(TypeError, match="batched execution"):
        compiled.batch(bindings_for("q6", 2))


def test_param_free_batch_runs_once_and_shares(ctx):
    q = ctx.table("lineitem").agg(sum_(col("l_quantity"), "s"))
    compiled = q.lower(engine="compiled").compile()
    handles = compiled.batch([{}, {}, {}], block=False)
    # perfect coalescing: one execution, every request shares the handle
    assert len(handles) == 3
    assert handles[0] is handles[1] is handles[2]
    assert_results_equal(compiled(), handles[0].compact())


def test_batch_callable_needs_params(ctx):
    from repro_torch.core import lower as L
    q = ctx.table("lineitem").agg(sum_(col("l_quantity"), "s"))
    with pytest.raises(ValueError, match="param-free"):
        L.build_batch_callable(ctx.optimized(q.plan), ctx.catalog, ())


# ---------------------------------------------------------------------------
# caching: one build per (template, bucket)
# ---------------------------------------------------------------------------


def test_one_compile_per_bucket(ctx):
    cache = S.CompileCache()
    compiled = Q.TEMPLATES["q6"](ctx).lower(
        engine="compiled").compile(cache=cache)
    base_entries = len(cache)
    h0, m0 = cache.hits, cache.misses
    compiled.batch(bindings_for("q6", 3))   # ragged -> bucket 4, builds
    compiled.batch(bindings_for("q6", 4))   # full bucket 4 -> cache hit
    compiled.batch(bindings_for("q6", 3))   # hit again
    assert len(cache) == base_entries + 1   # ONE batched program
    assert cache.misses == m0 + 1
    assert cache.hits == h0 + 2
    compiled.batch(bindings_for("q6", 8))   # new bucket -> second build
    assert len(cache) == base_entries + 2
    batch_keys = [k for k in cache._entries
                  if isinstance(k[-1], tuple) and k[-1][0] == "batch"]
    assert sorted(k[-1][1] for k in batch_keys) == [4, 8]
    assert all(k[:-1] == compiled.cache_key for k in batch_keys)


def test_batch_bucket_matches_reference():
    assert [ENG.batch_bucket(n) for n in range(1, 131)] == \
        [JENG.batch_bucket(n) for n in range(1, 131)]
    with pytest.raises(ValueError):
        ENG.batch_bucket(0)


def test_cache_stats_aggregates_live_caches(ctx):
    compiled_for(ctx, "q14").result(**Q.TEMPLATE_BINDINGS["q14"][0])
    snap = ENG.cache_stats()
    assert {"compile", "device", "index"} <= set(snap)
    for kind, agg in snap.items():
        assert agg["caches"] >= 1, kind
        assert agg["hits"] >= 0 and agg["misses"] >= 0
        assert 0.0 <= agg["hit_rate"] <= 1.0
    assert snap["compile"]["entries"] >= len(ctx.compile_cache)


# ---------------------------------------------------------------------------
# the server: admission -> coalesce -> vmap execute -> deferred copy
# ---------------------------------------------------------------------------


def test_mixed_template_queue_coalesces_per_template(ctx):
    server = QueryServer(ctx)
    reqs = []
    for name in ("q6", "q14", "q6", "q19", "q22", "q14", "q6"):
        base = Q.TEMPLATE_BINDINGS[name]
        reqs.append((name, dict(base[len(reqs) % len(base)])))
    futs = [server.submit(name, **params) for name, params in reqs]
    assert server.queue_depth() == len(reqs)
    assert server.flush() == len(reqs)
    assert server.queue_depth() == 0
    for (name, params), fut in zip(reqs, futs):
        want = server.compiled_for(name).result(**params).compact()
        assert_results_equal(want, fut.result().compact(), msg=name)
    # 7 requests, 4 template groups -> 4 dispatches
    assert server.stats.batches == 4
    assert server.stats.coalesce_ratio() == pytest.approx(1 - 4 / 7)


def test_server_telemetry(ctx):
    server = QueryServer(ctx)
    bindings = bindings_for("q6", 8)
    server.serve([("q6", b) for b in bindings])
    st = server.stats
    assert st.submitted == st.completed == 8
    assert st.batches == 1
    assert st.coalesce_ratio() == pytest.approx(1 - 1 / 8)
    assert st.batch_occupancy() == pytest.approx(1.0)  # 8 fills bucket 8
    assert st.max_queue_depth == 8
    assert len(st.latencies_s) == 8
    assert 0 < st.p50_s() <= st.p99_s()
    tele = server.telemetry()
    assert tele["serve"]["completed"] == 8
    assert tele["templates"]["q6"]["engine"] == "compiled"
    assert "compile" in tele["caches"]


@pytest.mark.parametrize("n,max_batch,batches,occupancy", [
    (3, 64, 1, 0.75),        # 3 live requests in a bucket-4 program
    (6, 4, 2, 1.0),          # 4 + 2: two full buckets of 4 and 2
    (5, 64, 1, 0.625),       # 5 in bucket 8
])
def test_server_chunks_and_occupancy(ctx, n, max_batch, batches, occupancy):
    server = QueryServer(ctx, max_batch=max_batch)
    results = server.serve([("q6", b) for b in bindings_for("q6", n)])
    assert len(results) == n
    assert server.stats.batches == batches
    assert server.stats.batch_occupancy() == pytest.approx(occupancy)


def test_server_unknown_template_fails_the_future(ctx):
    server = QueryServer(ctx)
    fut = server.submit("q99")
    server.flush()
    with pytest.raises(KeyError, match="q99"):
        fut.result()


def test_future_timeout_before_flush(ctx):
    server = QueryServer(ctx)
    fut = server.submit("q6", **Q.TEMPLATE_BINDINGS["q6"][0])
    with pytest.raises(NotDispatchedError, match="not dispatched"):
        fut.result(timeout=0.01)
    server.flush()
    fut.result(timeout=10)


def test_deadline_cancels_cleanly_without_dispatch(ctx):
    server = QueryServer(ctx)
    b = Q.TEMPLATE_BINDINGS["q6"][0]
    doomed = server.submit("q6", deadline_s=0.0, **b)
    time.sleep(0.002)
    live = server.submit("q6", **b)
    assert server.flush() == 1  # the expired request never executed
    with pytest.raises(DeadlineExceededError):
        doomed.result(timeout=1)
    assert_results_equal(compiled_for(ctx, "q6")(**b),
                         live.result(timeout=30).compact())
    assert server.stats.deadline_expired == 1


def test_queue_full_backpressure(ctx):
    server = QueryServer(ctx, max_queue=2)
    b = Q.TEMPLATE_BINDINGS["q6"][0]
    server.submit("q6", **b)
    server.submit("q6", **b)
    with pytest.raises(QueueFullError, match="admission queue full"):
        server.submit("q6", **b)
    assert server.stats.rejected == 1
    assert server.flush() == 2  # backpressure cleared by draining


def test_poison_request_fails_alone(ctx):
    """One bad binding in a coalesced batch: bisection isolates it --
    every healthy waiter completes, only the poison future errors."""
    server = QueryServer(ctx)
    bindings = Q.random_bindings("q6", 7, seed=11)
    healthy = [server.submit("q6", **b) for b in bindings[:5]]
    poison = server.submit("q6", nonsense=1.0)
    healthy += [server.submit("q6", **b) for b in bindings[5:]]
    server.flush()
    compiled = compiled_for(ctx, "q6")
    for b, f in zip(bindings, healthy):
        assert_results_equal(compiled(**b), f.result(timeout=30).compact())
    with pytest.raises(TypeError, match="unknown parameter"):
        poison.result(timeout=1)
    assert server.stats.poisoned == 1
    assert server.stats.bisects >= 1


def test_threaded_server_background_flush(ctx):
    binding = Q.TEMPLATE_BINDINGS["q6"][0]
    want = compiled_for(ctx, "q6")(**binding)
    with QueryServer(ctx) as server:
        futs = [server.submit("q6", **b) for b in bindings_for("q6", 4)]
        got = futs[0].result(timeout=30)
    assert_results_equal(want, got.compact())
    assert server._worker is None  # stopped on exit


def test_concurrent_submitters(ctx):
    server = QueryServer(ctx).start(interval_s=0.001)
    try:
        bindings = bindings_for("q14", 8)
        outs = [None] * len(bindings)

        def client(i):
            outs[i] = server.submit("q14", **bindings[i]).result(timeout=60)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bindings))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()
    compiled = server.compiled_for("q14")
    for b, out in zip(bindings, outs):
        assert_results_equal(compiled.result(**b).compact(), out.compact())
    assert server.stats.completed == len(bindings)


def test_preload_readies_every_template(ctx):
    server = QueryServer(ctx, warm_start=True)
    assert server.stats.preloaded == len(Q.TEMPLATES)
    assert server.stats.disk_hits == 0  # no persistent store yet
    assert set(server.telemetry()["templates"]) == set(Q.TEMPLATES)


# ---------------------------------------------------------------------------
# random_bindings, percentile, ServeStats
# ---------------------------------------------------------------------------


def test_random_bindings_reproducible():
    for name in TEMPLATE_NAMES:
        a = Q.random_bindings(name, 5, seed=7)
        assert a == Q.random_bindings(name, 5, seed=7) and len(a) == 5
    assert Q.random_bindings("q6", 3, seed=1) != \
        Q.random_bindings("q6", 3, seed=2)
    # seeded from a stable hash: another process, another hash salt,
    # the same draws
    code = ("from repro_torch.relational import queries as Q; "
            "print(repr(Q.random_bindings('q19', 3, seed=4)))")
    env = dict(os.environ, PYTHONPATH=SRC, PYTHONHASHSEED="12345")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == repr(Q.random_bindings("q19", 3, seed=4))
    with pytest.raises(KeyError, match="no binding generator"):
        Q.random_bindings("q1", 1)


@pytest.mark.parametrize("values", [
    [float(i) for i in range(1, 101)], [], [3.0], [5.0, 1.0, 4.0, 2.0],
    list(np.random.default_rng(0).exponential(1.0, 37))])
@pytest.mark.parametrize("q", [0, 50, 95, 99, 100])
def test_percentile_matches_reference(values, q):
    assert percentile(values, q) == JSTATS.percentile(values, q)


def test_serve_stats_match_reference():
    ours, ref = ServeStats(), JSTATS.ServeStats()
    assert ours.to_dict() == ref.to_dict()  # empty: all zeros
    rng = np.random.default_rng(1)
    for st in (ours, ref):
        st.submitted = 9
        st.record_batch(5, 8, 0.25, 0.01)
        st.record_batch(4, 4, 0.0, 0.02)
    for v in rng.exponential(0.01, 9):
        for st in (ours, ref):
            st.record_latency(float(v))
            st.record_queue(float(v) / 2)
            st.record_sync(float(v) / 4)
    assert ours.to_dict() == ref.to_dict()
    assert ours.coalesce_ratio() == pytest.approx(1 - 2 / 9)
    assert ours.batch_occupancy() == pytest.approx((5 / 8 + 1) / 2)


# ---------------------------------------------------------------------------
# a train() template with a param
# ---------------------------------------------------------------------------


def test_train_template_batch_matches_per_binding():
    rng = np.random.default_rng(7)
    n, d = 600, 3
    x = rng.normal(0, 2, (n, d))
    data = {f"f{i}": x[:, i] for i in range(d)}
    data["label"] = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
    pc = FlareContext(device="cpu")
    pc.from_arrays("points", data)
    tr = pc.table("points").train(
        "logreg", columns=[f"f{i}" for i in range(d)], label="label",
        lr=PC.param("lr", "float32"), max_iter=20)
    compiled = tr.lower(engine="compiled").compile()
    bindings = [{"lr": 0.05}, {"lr": 0.5}, {"lr": 0.2}]
    batched = compiled.batch(bindings)
    for b, got in zip(bindings, batched):
        want = compiled(**b)
        for name, w in want._asdict().items():
            np.testing.assert_array_equal(getattr(got.value, name), w,
                                          err_msg=f"{b} {name}")
    assert not np.allclose(batched[0].value.weights,
                           batched[1].value.weights)
