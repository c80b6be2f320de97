"""The port's degradation ladder and fault sites
(``repro_torch.resilience``), on the CPU at SF 0.005, against the JAX
package's (``repro.resilience``, ``tests/test_resilience.py``).

* the ladder's shape (the JAX package's, its ``parallel`` rung
  included) and its closed allowlist, which holds no error that can stand for a
  failed kernel: an nvcc failure, a CUDA or ``torch.cuda`` error and
  ``UnsupportedDeviceError`` all raise typed with the ladder on;
* per fault site and schedule, the same fault plan gives the same
  degradation events (engine hops, phase, error type; the port's
  ``CompileFault`` is the JAX package's ``XlaCompileFault``) as the JAX
  package on the same tables, and the degraded answer equals the JAX
  package's at ``conftest`` tolerance (rtol 5e-3);
* sticky execute-time fallbacks, ``submit`` and ``batch`` degrading (per
  binding where the rung cannot batch), ``FLARE_DEGRADE=off`` raising
  typed, the events and ``obs.snapshot()``'s resilience section;
* persist faults healing below the ladder (quarantine, counted save
  errors) and the store's unlink races;
* ``FLARE_FAULTS`` armed in a child process gives the JAX package's
  events.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import SRC, assert_results_equal
from repro.core import CompileCache as JaxCompileCache
from repro.core import FlareContext as JaxContext
from repro.relational import queries as JQ
from repro.resilience import degrade as JDG
from repro.resilience import faults as JFZ
from repro_torch import resilience as RZ
from repro_torch.core import CompileCache, FlareContext
from repro_torch.core.parallel import UnsupportedParallelPlan
from repro_torch.kernels import (KernelBudgetError, UnsupportedDeviceError,
                                 on_card)
from repro_torch.kernels import cuda_build as CB
from repro_torch.native import dispatch as ND
from repro_torch.persist.store import (ArtifactStore, StoreCorrupt,
                                       StoreVersionMiss)
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT
from repro_torch.resilience import degrade as DG
from repro_torch.resilience import faults as FZ

from test_torch_data_ir import as_spec

SF = 0.005

#: the JAX package's error type name -> the port's, where they differ
PORT_NAME = {"XlaCompileFault": "CompileFault"}


@pytest.fixture(scope="module")
def jax_tables():
    jc = JaxContext()
    JQ.register_tpch(jc, sf=SF)
    return {n: jc.catalog.table(n) for n in jc.catalog.names()}


@pytest.fixture(scope="module")
def spec(jax_tables):
    return as_spec(jax_tables)


def jax_context(jax_tables):
    """A fresh JAX context over the shared tables: fresh caches, so
    index builds and compiles really run."""
    jc = JaxContext()
    for name, tbl in jax_tables.items():
        jc.register(name, tbl)
    return jc


def port_context(spec):
    pc = FlareContext(device="cpu")
    for name, tbl in PT.tables_from_numpy(spec).items():
        pc.register(name, tbl)
    return pc


@pytest.fixture(scope="module")
def ctx(spec):
    return port_context(spec)


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.delenv("FLARE_DEGRADE", raising=False)
    monkeypatch.delenv("FLARE_CACHE_DIR", raising=False)
    DG.clear_events()
    JDG.clear_events()
    yield
    assert FZ.active() is None, "a test leaked an armed FaultPlan"


def binding(name, i=0):
    return dict(Q.TEMPLATE_BINDINGS[name][i])


def oracle(ctx, name, b):
    return Q.TEMPLATES[name](ctx).lower(engine="volcano").compile()(**b)


def hops(events):
    return [(e["frm"], e["to"], e["phase"],
             PORT_NAME.get(e["error_type"], e["error_type"]))
            for e in events]


# ---------------------------------------------------------------------------
# the ladder and its allowlist
# ---------------------------------------------------------------------------


def test_ladder_shape():
    assert DG.LADDER == JDG.LADDER


@pytest.mark.parametrize("err,absorbed", [
    (KernelBudgetError("geometry"), True),
    (FZ.CompileFault("x"), True),
    (FZ.IndexBuildError("x"), True),
    (StoreCorrupt("x"), True),
    (StoreVersionMiss("x"), True),
    # shard planning refused the plan before any launch
    (UnsupportedParallelPlan("x"), True),
    # a kernel that failed to build or run must never degrade
    (CB.UnitBuildError("nvcc failed"), False),
    (RuntimeError("flare_filter_agg: CUDA error 700 at launch"), False),
    (torch.cuda.OutOfMemoryError("out of memory"), False),
    (UnsupportedDeviceError("no kernel for meta"), False),
    # nor may a wrong-answer class
    (ValueError("x"), False), (TypeError("x"), False),
    (AssertionError("x"), False), (ZeroDivisionError("x"), False),
    (KeyError("x"), False), (OSError("x"), False),
    (FZ.DispatchFault("x"), False)])
def test_recoverable_allowlist_is_closed(err, absorbed):
    assert DG.recoverable(err) is absorbed
    assert DG.recoverable(err, "compile") is absorbed


@pytest.mark.parametrize("err,absorbed", [
    # at launch a KernelBudgetError is a wrapper refusing its arguments
    (KernelBudgetError("check_columns: 2 columns for a body of 3"), False),
    (FZ.CompileFault("x"), True),
    (FZ.IndexBuildError("x"), True),
    (StoreCorrupt("x"), True),
    (StoreVersionMiss("x"), True),
    (UnsupportedParallelPlan("x"), False),
    (CB.UnitBuildError("nvcc failed"), False),
    (RuntimeError("flare_filter_agg: CUDA error 700 at launch"), False),
    (UnsupportedDeviceError("no kernel for meta"), False),
    (ValueError("x"), False)])
def test_recoverable_allowlist_at_execute(err, absorbed):
    assert DG.recoverable(err, "execute") is absorbed


def test_on_card_error_does_not_degrade(ctx, monkeypatch):
    """``on_card`` on a device with no kernel raises a type that is not on
    the allowlist: the query fails typed instead of answering from the
    generic lowering."""
    real = ND.NativeOp.lower_stream

    def on_meta(self, catalog, scans, params):
        on_card(torch.empty(1, device="meta"))
        return real(self, catalog, scans, params)

    c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
        .compile(cache=CompileCache())
    monkeypatch.setattr(ND.NativeOp, "lower_stream", on_meta)
    with pytest.raises(UnsupportedDeviceError):
        c(**binding("q6"))
    assert c.stats.degraded == () and c._degraded_to is None
    assert DG.events() == ()


def test_kernel_budget_error_at_execute_degrades(ctx, monkeypatch):
    """A ``KernelBudgetError`` at execute time does not degrade: there it
    comes from a kernel wrapper's argument checks at launch, and a hop
    to ``compiled`` would let the kernel stop running for good.  It
    raises with no event, and the template keeps its native program."""
    real = ND.NativeOp.lower_stream

    def refuse(self, catalog, scans, params):
        raise KernelBudgetError("check_columns: refused at launch")

    c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
        .compile(cache=CompileCache())
    monkeypatch.setattr(ND.NativeOp, "lower_stream", refuse)
    with pytest.raises(KernelBudgetError, match="refused at launch"):
        c(**binding("q6"))
    with pytest.raises(KernelBudgetError):
        c.submit(**binding("q6"))
    assert c.stats.degraded == () and c._degraded_to is None
    assert DG.events() == ()
    monkeypatch.setattr(ND.NativeOp, "lower_stream", real)
    assert_results_equal(oracle(ctx, "q6", binding("q6")),
                         c(**binding("q6")))


def test_kernel_budget_error_at_compile_degrades(ctx):
    """The control: the same type raised while the template compiles
    (the ``native.kernel`` site, where the port prepares each fragment)
    hops to ``compiled`` with one compile-phase event."""
    with RZ.inject("native.kernel", "first:1"):
        c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
            .compile(cache=CompileCache())
    assert hops(c.stats.degraded) == [
        ("compiled-native", "compiled", "compile", "KernelBudgetError")]
    assert_results_equal(oracle(ctx, "q6", binding("q6")),
                         c(**binding("q6")))


def test_unit_build_failure_raises_with_the_ladder_on(ctx, monkeypatch):
    """An nvcc failure in the compile path raises out of ``compile()``;
    nothing degrades."""
    def nvcc_fails(self, artifact, device):
        raise CB.UnitBuildError("nvcc failed on flare_x.cu")

    monkeypatch.setattr(ND.NativeWholeQueryEngine, "compile", nvcc_fails)
    assert DG.enabled()
    with pytest.raises(CB.UnitBuildError):
        Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
            .compile(cache=CompileCache())
    assert DG.events() == ()


# ---------------------------------------------------------------------------
# per-site hops against the JAX package's
# ---------------------------------------------------------------------------

#: (site, schedule, template, native, call): the fault plan and what runs
#: under it -- a compile, then "call" one binding or "batch" three
SCENARIOS = [
    ("native.kernel", "first:1", "q6", True, "call"),
    ("native.kernel", "every:1", "q14", True, "call"),
    ("compile.xla", "first:1", "q6", False, "call"),
    ("compile.xla", "first:1", "q19", True, "call"),
    ("compile.xla", "every:1", "q6", False, "call"),
    ("index.build", "every:1", "q14", False, "call"),
    ("index.build", "every:1", "q19", True, "call"),
    ("index.build", "first:1", "q14", False, "batch"),
    ("persist.load", "every:1", "q6", False, "call"),
    ("persist.save", "every:1", "q6", True, "call"),
]


def _scenario(pkg, ctx_, site, spec_, name, native, call):
    """Run one scenario on one package; returns (events, results)."""
    queries, inject, cache = pkg
    b = dict(Q.TEMPLATE_BINDINGS[name][0])
    bindings = [dict(Q.TEMPLATE_BINDINGS[name][i % len(
        Q.TEMPLATE_BINDINGS[name])]) for i in range(3)]
    with inject(site, spec_):
        c = queries.TEMPLATES[name](ctx_).lower(
            engine="compiled", native=native).compile(cache=cache())
        if call == "batch":
            out = [r.compact() for r in c.batch(bindings)]
        else:
            out = [c(**b)]
    return hops(c.stats.degraded), out


@pytest.mark.parametrize("site,spec_,name,native,call", SCENARIOS)
def test_fault_site_hops_match_reference(jax_tables, spec, tmp_path, site,
                                         spec_, name, native, call):
    jc, pc = jax_context(jax_tables), port_context(spec)
    if site.startswith("persist."):
        from repro.persist import ArtifactStore as JaxStore
        jstore = JaxStore(tmp_path / "jax")
        pstore = ArtifactStore(tmp_path / "port")
        jc.cache.indexes.store = jstore
        pc.cache.indexes.store = pstore
        # a first compile writes the artifact the faulted load reads
        JQ.TEMPLATES[name](jc).lower(engine="compiled", native=native) \
            .compile(cache=JaxCompileCache())
        Q.TEMPLATES[name](pc).lower(engine="compiled", native=native) \
            .compile(cache=CompileCache())
    want_events, want = _scenario((JQ, JFZ.inject, JaxCompileCache), jc,
                                  site, spec_, name, native, call)
    got_events, got = _scenario((Q, RZ.inject, CompileCache), pc,
                                site, spec_, name, native, call)
    assert got_events == want_events
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_results_equal(w, g, msg=f"{site} {name}")
    if site.startswith("persist."):
        # persist faults heal below the ladder
        assert got_events == []


def test_index_fault_degrades_at_execute_and_sticks(spec):
    pc = port_context(spec)
    b = binding("q14")
    want = oracle(pc, "q14", b)
    with RZ.inject("index.build", "every:1"):
        c = Q.TEMPLATES["q14"](pc).lower(engine="compiled") \
            .compile(cache=CompileCache())
        got = c(**b)
    assert_results_equal(want, got)
    assert ("compiled", "stage", "execute", "IndexBuildError") in \
        hops(c.stats.degraded)
    # sticky: later calls route straight to the fallback rung
    assert c._degraded_to is not None
    assert c._degraded_to.engine_name == "stage"
    assert_results_equal(want, c(**b))


def test_submit_degrades_at_execute(spec):
    pc = port_context(spec)
    b = binding("q14")
    with RZ.inject("index.build", "every:1"):
        c = Q.TEMPLATES["q14"](pc).lower(engine="compiled") \
            .compile(cache=CompileCache())
        handle = c.submit(**b)
    assert_results_equal(oracle(pc, "q14", b), handle.compact())
    assert hops(c.stats.degraded)[0][:3] == ("compiled", "stage", "execute")


def test_batch_degrades_per_binding(spec):
    pc = port_context(spec)
    bindings = [binding("q14", i % len(Q.TEMPLATE_BINDINGS["q14"]))
                for i in range(3)]
    want = [oracle(pc, "q14", b) for b in bindings]
    with RZ.inject("index.build", "every:1"):
        c = Q.TEMPLATES["q14"](pc).lower(engine="compiled") \
            .compile(cache=CompileCache())
        got = c.batch(bindings)
    assert len(got) == 3
    for w, g in zip(want, got):
        assert_results_equal(w, g.compact())
    assert c.stats.degraded and c._degraded_to.engine_name == "stage"


def test_degrade_keeps_the_context_device(ctx):
    with RZ.inject("native.kernel", "first:1"):
        c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
            .compile(cache=CompileCache())
    assert c.engine_name == "compiled"
    assert c._device_cache is ctx.cache
    assert c._device_cache.device == torch.device("cpu")


def test_degrade_off_raises_typed(ctx, monkeypatch):
    monkeypatch.setenv("FLARE_DEGRADE", "off")
    with RZ.inject("native.kernel", "first:1"):
        with pytest.raises(KernelBudgetError) as ei:
            Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
                .compile(cache=CompileCache())
    assert type(ei.value) is KernelBudgetError  # not wrapped
    with RZ.inject("compile.xla", "first:1"):
        with pytest.raises(FZ.CompileFault):
            Q.TEMPLATES["q6"](ctx).lower(engine="compiled") \
                .compile(cache=CompileCache())
    assert DG.events() == ()


def test_index_error_typed_through_call_and_submit(spec, monkeypatch):
    monkeypatch.setenv("FLARE_DEGRADE", "off")
    pc = port_context(spec)
    b = binding("q14")
    with RZ.inject("index.build", "every:1"):
        c = Q.TEMPLATES["q14"](pc).lower(engine="compiled") \
            .compile(cache=CompileCache())
        with pytest.raises(FZ.IndexBuildError):
            c(**b)
        with pytest.raises(FZ.IndexBuildError):
            c.submit(**b)  # the AsyncResult dispatch path


def test_degrade_never_masks_wrong_answer_errors(ctx):
    assert DG.enabled()
    c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled").compile()
    with pytest.raises(TypeError, match="unknown parameter"):
        c(bogus=1.0)
    with pytest.raises(KeyError, match="unbound query parameter"):
        c()
    assert c.stats.degraded == ()


def test_degrade_events_recorded(ctx):
    with RZ.inject("native.kernel", "first:1"):
        Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
            .compile(cache=CompileCache())
    evs = DG.events()
    assert len(evs) == 1
    assert (evs[0].frm, evs[0].to) == ("compiled-native", "compiled")
    assert evs[0].error_type == "KernelBudgetError"
    snap = DG.stats()
    assert snap["events"] == 1
    assert snap["transitions"] == {"compiled-native->compiled": 1}
    assert set(snap) == set(JDG.stats())


def test_obs_snapshot_has_resilience_section(ctx):
    from repro_torch import obs
    with RZ.inject("compile.xla", "first:1") as plan:
        snap = obs.snapshot()
        assert snap["resilience"]["faults"] == plan.counts()
    snap = obs.snapshot()
    assert snap["resilience"]["faults"] == {}
    assert "degrade" in snap["resilience"]


# ---------------------------------------------------------------------------
# persist faults heal below the ladder
# ---------------------------------------------------------------------------


def test_persist_load_fault_quarantines_and_recompiles(ctx, tmp_path):
    store = ArtifactStore(tmp_path / "store")
    b = binding("q6")
    want = oracle(ctx, "q6", b)
    Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True).compile(
        cache=CompileCache(), persist=store)  # writes through
    assert store.tier("exec").writes >= 1
    with RZ.inject("persist.load", "every:1"):
        c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
            .compile(cache=CompileCache(), persist=store)
        got = c(**b)
    assert_results_equal(want, got)
    assert c.stats.degraded == () and not c.stats.disk_hit
    assert store.tier("exec").quarantined >= 1
    exec_dir = os.path.dirname(store.path_for("exec", "0" * 16))
    assert [f for f in os.listdir(exec_dir) if f.endswith(".quarantine")]


def test_persist_save_fault_counts_and_continues(ctx, tmp_path):
    store = ArtifactStore(tmp_path / "store")
    b = binding("q6")
    with RZ.inject("persist.save", "every:1"):
        c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled") \
            .compile(cache=CompileCache(), persist=store)
        got = c(**b)
    assert_results_equal(oracle(ctx, "q6", b), got)
    assert store.tier("exec").errors >= 1
    assert store.tier("exec").writes == 0
    assert c.stats.persist == "error: write failed"


def test_corrupt_artifact_quarantined_not_deleted(tmp_path):
    store = ArtifactStore(tmp_path / "store")
    path = store.save("exec", "d" * 16, {"m": 1}, [b"payload"])
    with open(path, "r+b") as f:
        f.seek(0)
        f.write(b"XXXX")  # clobber the magic
    assert store.load("exec", "d" * 16) is None
    assert not os.path.exists(path)
    assert os.path.exists(path + ".quarantine")
    st = store.tier("exec")
    assert st.corrupt == 1 and st.quarantined == 1
    # quarantined junk is invisible to entries/nbytes/evict
    assert store.entries("exec") == 0
    assert store.nbytes() == 0
    assert st.to_dict()["quarantined"] == 1


def test_quarantine_race_is_counted_not_raised(tmp_path):
    store = ArtifactStore(tmp_path / "store")
    gone = store.path_for("exec", "e" * 16)
    store._quarantine("exec", gone)  # no file: a reader beat us to it
    st = store.tier("exec")
    assert st.unlink_raced == 1 and st.quarantined == 0


def test_evict_unlink_race_is_missing_ok(tmp_path, monkeypatch):
    store = ArtifactStore(tmp_path / "small")
    for i in range(4):
        store.save("exec", f"{i:016x}", {"i": i}, [b"x" * 512])
    real_unlink = os.unlink
    raced = {"n": 0}

    def racy_unlink(p, *a, **kw):
        # a second evicting process wins exactly once
        if raced["n"] == 0 and str(p).endswith(".flare"):
            raced["n"] += 1
            real_unlink(p)  # the other process's unlink
        return real_unlink(p, *a, **kw)

    monkeypatch.setattr(os, "unlink", racy_unlink)
    evicted = store.evict(0)
    assert raced["n"] == 1
    st = store.tier("exec")
    assert st.unlink_raced == 1
    assert evicted == 3 and st.evicted == 3
    assert store.entries("exec") == 0


def test_clear_unlink_race_is_missing_ok(tmp_path, monkeypatch):
    store = ArtifactStore(tmp_path / "store")
    store.save("exec", "f" * 16, {"m": 1}, [b"x"])
    real_unlink = os.unlink

    def racy_unlink(p, *a, **kw):
        real_unlink(p)
        return real_unlink(p, *a, **kw)  # second call: FileNotFoundError

    monkeypatch.setattr(os, "unlink", racy_unlink)
    store.clear()  # must not raise
    assert store.tier("exec").unlink_raced == 1


# ---------------------------------------------------------------------------
# FLARE_FAULTS in a child process
# ---------------------------------------------------------------------------

_CHILD = """
import json
from repro_torch.core import CompileCache, FlareContext
from repro_torch.core.parallel import UnsupportedParallelPlan
from repro_torch.relational import queries as Q
ctx = FlareContext(device="cpu")
Q.register_tpch(ctx, sf=%(sf)r)
c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True).compile(
    cache=CompileCache())
res = c(**dict(Q.TEMPLATE_BINDINGS["q6"][0]))
print(json.dumps({"degraded": list(c.stats.degraded),
                  "revenue": float(res["revenue"][0])}))
"""


def test_env_armed_faults_in_a_child_match_reference(jax_tables):
    spec_ = "native.kernel:first:1, seed:3"
    env = dict(os.environ, FLARE_FAULTS=spec_,
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("FLARE_DEGRADE", None)
    env.pop("FLARE_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD % {"sf": SF}],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    # the same plan, armed from the same spec, in the JAX package
    jc = jax_context(jax_tables)
    with JFZ.inject(JFZ.parse_env(spec_)):
        c = JQ.TEMPLATES["q6"](jc).lower(engine="compiled", native=True) \
            .compile(cache=JaxCompileCache())
        want = c(**dict(JQ.TEMPLATE_BINDINGS["q6"][0]))
    assert hops(child["degraded"]) == hops(c.stats.degraded) == [
        ("compiled-native", "compiled", "compile", "KernelBudgetError")]
    assert_results_equal({"revenue": [child["revenue"]]}, want)
