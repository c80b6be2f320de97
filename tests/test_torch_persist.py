"""The port's persistent artifact store (``repro_torch.persist`` + the disk
tier under its compile and index caches), on the CPU at SF 0.005, against
the JAX package's (``repro.persist``, ``tests/test_persist.py``).

The same generated tables (the JAX generator's, carried across with
``tables_from_numpy``) go into JAX and port contexts.  Every test of
``tests/test_persist.py`` has a counterpart here but the JAX-specific
tier checks (a PjRt executable's platform, the ``jax.export`` tier on a
jaxlib drift), which become the port's envelope drift and stale unit
sources:

* the container: save/load, ``stable_digest`` and ``index_digest`` equal
  to the JAX package's for the same parts and tables, truncated,
  bad-magic and quarantined artifacts, envelope flips, LRU eviction;
* the exec tier: a second context serves ``compiled`` and
  ``compiled-native`` templates off disk (results equal to the first
  context's and to the JAX package's at ``conftest`` tolerance, rtol
  5e-3), corrupt / flipped / stale artifacts fall back to a rebuild,
  batch programs persist per bucket, UDF and ``train()`` plans persist,
  ``persist=False`` and ``FLARE_CACHE_DIR``;
* the index tier: a loaded index equals a fresh build, ``meta`` included;
  the digest tracks the data; an artifact without ``meta`` is corrupt;
* telemetry: the ``disk`` breakdown of ``cache_stats()``, the store's
  stats dict, ``QueryServer.preload``'s disk hits;
* a second *process* serves from the first's store: no build, no write;
* ``cuda_build.load_library`` names a library file by its bytes' hash.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC, assert_results_equal
from repro.core import CompileCache as JaxCompileCache
from repro.core import FlareContext as JaxContext
from repro.persist import index_digest as jax_index_digest
from repro.persist import stable_digest as jax_stable_digest
from repro.relational import queries as JQ
from repro_torch.core import CompileCache, FlareContext
from repro_torch.core import engines as ENG
from repro_torch.core import stages as S
from repro_torch.kernels import cuda_build as CB
from repro_torch.persist import (ArtifactStore, FORMAT_VERSION, envelope,
                                 index_digest, plan_persistable,
                                 stable_digest)
from repro_torch.persist import store as PS
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT
from repro_torch.serve import QueryServer

from test_torch_data_ir import as_spec

SF = 0.005
Q6_BINDING = dict(Q.TEMPLATE_BINDINGS["q6"][0])
ENGINES = ["compiled", "compiled-native"]


@pytest.fixture(autouse=True)
def _no_ambient_store(monkeypatch):
    """Isolate from any ``$FLARE_CACHE_DIR`` in the invoking shell --
    these tests pass their stores explicitly."""
    monkeypatch.delenv(PS.CACHE_DIR_ENV, raising=False)


@pytest.fixture
def store(tmp_path):
    return ArtifactStore(tmp_path / "store")


@pytest.fixture(scope="module")
def jax_ctx():
    jc = JaxContext()
    JQ.register_tpch(jc, sf=SF)
    return jc


@pytest.fixture(scope="module")
def spec(jax_ctx):
    return as_spec({n: jax_ctx.catalog.table(n)
                    for n in jax_ctx.catalog.names()})


def make_ctx(spec, store=None):
    ctx = FlareContext(device="cpu", store=store)
    for name, tbl in PT.tables_from_numpy(spec).items():
        ctx.register(name, tbl)
    return ctx


def compile_template(ctx, name="q6", engine="compiled", **kw):
    return Q.TEMPLATES[name](ctx).lower(engine=engine).compile(
        cache=CompileCache(), **kw)


def reference(jax_ctx, name, binding):
    return JQ.TEMPLATES[name](jax_ctx).lower(engine="compiled").compile(
        cache=JaxCompileCache())(**binding)


def exec_paths(store):
    d = os.path.dirname(store.path_for("exec", "0"))
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".flare"))


def rewrite_header(path, mutate):
    """Reopen an artifact and apply ``mutate(header_dict)`` in place,
    leaving the payload (and its checksum) untouched."""
    with open(path, "rb") as f:
        blob = f.read()
    magic = blob[:6]
    hlen = int.from_bytes(blob[6:10], "little")
    header = json.loads(blob[10:10 + hlen].decode())
    payload = blob[10 + hlen:]
    mutate(header)
    hdr = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(magic + len(hdr).to_bytes(4, "little") + hdr + payload)


# ---------------------------------------------------------------------------
# the container: save/load, digests, corruption, version envelope
# ---------------------------------------------------------------------------


def test_save_load_roundtrip(store):
    meta = {"answer": 42, "names": ["a", "b"]}
    sections = [b"alpha", b"", b"gamma" * 100]
    path = store.save("exec", "d" * 64, meta, sections)
    assert path and os.path.exists(path)
    assert os.path.dirname(path).endswith(
        os.path.join(f"torch-v{FORMAT_VERSION}", "exec"))
    header, got = store.load("exec", "d" * 64, envelope_keys=("format",))
    assert got == sections
    assert header["meta"] == meta
    assert header["envelope"]["format"] == FORMAT_VERSION
    st = store.tier("exec")
    assert (st.writes, st.hits, st.misses) == (1, 1, 0)
    assert st.bytes_written > 0 and st.bytes_read > 0


def test_absent_artifact_is_plain_miss(store):
    assert store.load("index", "0" * 64) is None
    st = store.tier("index")
    assert (st.misses, st.corrupt, st.version_miss) == (1, 0, 0)


@pytest.mark.parametrize("parts", [
    ("pin",), ("exec", ("q6", "compiled", 3)), ("exec", ("q6", "compiled", 4)),
    (b"raw",), ("raw",), ("index", 1, ("k",), (), 2000, 1.5, True, None)])
def test_stable_digest_matches_reference(parts):
    assert stable_digest(*parts) == jax_stable_digest(*parts)
    assert stable_digest(*parts) == stable_digest(*parts)


def test_stable_digest_is_process_independent():
    assert stable_digest(b"raw") != stable_digest("raw")
    assert stable_digest("exec", ("q6", 3)) != stable_digest("exec", ("q6", 4))
    # pinned: a salted component (builtin hash) would break cross-process
    # artifact addressing silently
    assert stable_digest("pin") == (
        "ae2d0226c275039121f283848ebf06072979e524fcd4c67263a420b2de40b458")


@pytest.mark.parametrize("table,keys", [
    ("orders", ("o_orderkey",)), ("part", ("p_partkey",)),
    ("customer", ("c_custkey",)), ("nation", ("n_nationkey",))])
def test_index_digest_matches_reference(jax_ctx, spec, table, keys):
    pc = make_ctx(spec)
    assert index_digest(pc.catalog.table(table), keys, ()) == \
        jax_index_digest(jax_ctx.catalog.table(table), keys, ())


def test_exec_digest_matches_reference(jax_ctx, spec):
    """The template key, hence the exec digest, is the JAX package's for
    the plain ``compiled`` engine: both key the same plan the same way."""
    from repro.core import stages as JS
    pc = make_ctx(spec)
    for name in sorted(Q.TEMPLATES):
        ours = Q.TEMPLATES[name](pc).lower(engine="compiled").cache_key
        ref = JQ.TEMPLATES[name](jax_ctx).lower(engine="compiled").cache_key
        assert S._exec_digest(ours) == JS._exec_digest(ref), name


def test_truncated_artifact_is_corrupt_and_quarantined(store):
    store.save("exec", "e" * 64, {}, [b"payload-bytes"])
    path = store.path_for("exec", "e" * 64)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    assert store.load("exec", "e" * 64) is None
    st = store.tier("exec")
    assert st.corrupt == 1 and st.misses == 1 and st.quarantined == 1
    assert not os.path.exists(path)  # moved aside: rebuilt, not re-tripped
    assert os.path.exists(path + ".quarantine")
    assert store.load("exec", "e" * 64) is None  # now a plain miss
    assert st.corrupt == 1 and st.misses == 2


def test_bad_magic_is_corrupt(store):
    store.save("index", "f" * 64, {}, [b"x"])
    path = store.path_for("index", "f" * 64)
    with open(path, "r+b") as f:
        f.write(b"NOPE")
    assert store.load("index", "f" * 64) is None
    assert store.tier("index").corrupt == 1


def test_envelope_format_flip_is_version_miss(store):
    store.save("index", "a" * 64, {}, [b"x"])
    path = store.path_for("index", "a" * 64)
    rewrite_header(path, lambda h: h["envelope"].update(format=999))
    assert store.load("index", "a" * 64) is None
    st = store.tier("index")
    assert st.version_miss == 1 and st.corrupt == 0
    assert os.path.exists(path)  # version misses keep the file


def test_envelope_covers_toolchain_and_device():
    env = envelope()
    assert set(env) == {"format", "torch", "cuda", "nvcc", "nvcc_flags",
                        "device", "capability", "device_count",
                        "device_dtypes"}
    assert env["format"] == FORMAT_VERSION
    assert env["torch"] == torch.__version__
    # the flags the units are built with pin their machine code too
    assert env["nvcc_flags"] == " ".join(CB.NVCC_FLAGS)
    # the 32-bit device dtypes, the JAX package's x64=False
    assert env["device_dtypes"] == ["bool", "float32", "int32"]
    if not torch.cuda.is_available():
        assert (env["device"], env["device_count"], env["nvcc"]) == \
            ("cpu", 0, None)


def test_lru_eviction_under_limit(tmp_path):
    limited = ArtifactStore(tmp_path / "small", limit_bytes=3000)
    for i in range(4):
        limited.save("exec", f"{i:064d}", {}, [b"z" * 1000])
    assert limited.tier("exec").evicted >= 1
    assert limited.nbytes() <= 3000
    # the newest artifact survived (eviction is LRU by mtime)
    assert os.path.exists(limited.path_for("exec", f"{3:064d}"))


# ---------------------------------------------------------------------------
# exec tier end-to-end: restart-without-rebuild inside one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_exec_disk_roundtrip_between_contexts(jax_ctx, spec, store, engine):
    c1 = compile_template(make_ctx(spec, store), engine=engine)
    want = c1.collect(**Q6_BINDING)
    assert not c1.stats.disk_hit and c1.stats.persist == "written"
    assert store.tier("exec").writes == 1

    c2 = compile_template(make_ctx(spec, store), engine=engine)
    got = c2.collect(**Q6_BINDING)
    # on the CPU no compile needs a kernel unit: the hit reuses the layout
    assert c2.stats.disk_hit and c2.stats.persist == "hit:layout"
    assert store.tier("exec").writes == 1  # no second write-through
    assert_results_equal(want, got, msg="disk exec")
    assert_results_equal(reference(jax_ctx, "q6", Q6_BINDING), got,
                         msg="vs the JAX package")


@pytest.mark.parametrize("name", sorted(Q.TEMPLATES))
def test_store_results_match_reference(jax_ctx, spec, tmp_path, name):
    """Every template, native, through a store: the second context's
    disk-served result equals the first's and the JAX package's."""
    store = ArtifactStore(tmp_path / "s")
    binding = dict(Q.TEMPLATE_BINDINGS[name][0])
    first = compile_template(make_ctx(spec, store), name, "compiled-native")
    want = first(**binding)
    again = compile_template(make_ctx(spec, store), name, "compiled-native")
    got = again(**binding)
    assert again.stats.disk_hit
    assert_results_equal(want, got, msg=name)
    assert_results_equal(reference(jax_ctx, name, binding), got, msg=name)


def test_corrupt_exec_artifact_falls_back_to_rebuild(jax_ctx, spec, store):
    compile_template(make_ctx(spec, store)).collect(**Q6_BINDING)
    (path,) = exec_paths(store)
    with open(path, "r+b") as f:
        f.truncate(200)
    c2 = compile_template(make_ctx(spec, store))
    got = c2.collect(**Q6_BINDING)
    assert not c2.stats.disk_hit
    assert store.tier("exec").corrupt == 1
    assert store.tier("exec").writes == 2  # rebuilt artifact re-written
    assert_results_equal(reference(jax_ctx, "q6", Q6_BINDING), got,
                         msg="rebuild after corruption")


def test_version_flip_falls_back_to_rebuild(spec, store):
    compile_template(make_ctx(spec, store)).collect(**Q6_BINDING)
    (path,) = exec_paths(store)
    rewrite_header(path, lambda h: h["envelope"].update(format=999))
    c2 = compile_template(make_ctx(spec, store))
    c2.collect(**Q6_BINDING)
    assert not c2.stats.disk_hit
    assert store.tier("exec").version_miss == 1


@pytest.fixture
def card_units(monkeypatch):
    """The unit hooks of a compile on the card, on the CPU: every fragment
    needs its unit, a built unit's library is its source's stand-in bytes,
    and loading a library or building units is recorded, not done."""
    calls = {"loaded": [], "built": []}
    monkeypatch.setattr(S, "_units",
                        lambda artifact, device: S.PX.unit_list(
                            artifact.kernel_sources))
    monkeypatch.setattr(CB, "library_bytes",
                        lambda src: b"sm_90a code of " + src.encode())
    monkeypatch.setattr(CB, "load_library",
                        lambda src, data: calls["loaded"].append((src, data)))
    monkeypatch.setattr(CB, "build_all",
                        lambda units: calls["built"].extend(units))
    return calls


def test_native_tier_loads_stored_libraries(jax_ctx, spec, store,
                                            card_units):
    """Under the full envelope each unit's library comes from the
    artifact's bytes; nvcc runs for none."""
    ctx = make_ctx(spec, store)
    units = S.PX.unit_list(Q.TEMPLATES["q6"](ctx).lower(
        engine="compiled-native").kernel_sources())
    assert units
    c1 = compile_template(ctx, engine="compiled-native")
    c1.collect(**Q6_BINDING)
    assert c1.stats.persist == "written"
    c2 = compile_template(make_ctx(spec, store), engine="compiled-native")
    got = c2.collect(**Q6_BINDING)
    assert c2.stats.disk_hit and c2.stats.persist == "hit:native"
    assert card_units["built"] == []
    assert card_units["loaded"] == [
        (src, b"sm_90a code of " + src.encode()) for src in units]
    assert_results_equal(reference(jax_ctx, "q6", Q6_BINDING), got,
                         msg="native tier")


@pytest.mark.parametrize("field,value", [
    ("torch", "0.0.0"), ("nvcc", "0.0"), ("device", "another card"),
    # machine code built without --fmad=false, or for another target
    ("nvcc_flags", "-gencode arch=compute_90a,code=sm_90a -O3 -shared"),
    ("nvcc_flags", "-gencode arch=compute_80,code=sm_80 -std=c++17 -O3 "
                   "--fmad=false -shared -Xcompiler -fPIC")])
def test_envelope_drift_serves_portable_tier(jax_ctx, spec, store, field,
                                             value, card_units):
    """Machine code is pinned to the exact toolchain, flags and device;
    when only those drift, the portable tier (the unit sources) still
    serves: the units are built again, no stored library is loaded."""
    compile_template(make_ctx(spec, store),
                     engine="compiled-native").collect(**Q6_BINDING)
    (path,) = exec_paths(store)

    def drift(header):
        assert field in header["envelope"]  # the field is written, pinned
        header["envelope"][field] = value

    rewrite_header(path, drift)
    c2 = compile_template(make_ctx(spec, store), engine="compiled-native")
    got = c2.collect(**Q6_BINDING)
    assert c2.stats.disk_hit and c2.stats.persist == "hit:portable"
    assert card_units["loaded"] == [] and card_units["built"]
    assert_results_equal(reference(jax_ctx, "q6", Q6_BINDING), got,
                         msg="portable tier")


@pytest.mark.parametrize("engine", ENGINES)
def test_unitless_hit_reuses_layout_whatever_the_envelope(spec, store,
                                                          engine):
    """A compile that needs no unit has no machine code to pin: under a
    drifted envelope its hit still reuses only the layout."""
    compile_template(make_ctx(spec, store), engine=engine) \
        .collect(**Q6_BINDING)
    (path,) = exec_paths(store)
    rewrite_header(path, lambda h: h["envelope"].update(nvcc_flags="-O0"))
    c2 = compile_template(make_ctx(spec, store), engine=engine)
    c2.collect(**Q6_BINDING)
    assert c2.stats.disk_hit and c2.stats.persist == "hit:layout"


def test_stale_unit_sources_are_version_miss(spec, store):
    """An artifact whose stored unit sources differ from what the plan
    generates now (a changed kernel skeleton) is stale: a version miss
    and a rebuild, never a library loaded for the wrong source."""
    c1 = compile_template(make_ctx(spec, store), engine="compiled-native")
    c1.collect(**Q6_BINDING)
    digest = S._exec_digest(c1.cache_key)
    header, sections = store.load("exec", digest, envelope_keys=("format",))
    stale = sections[1].replace(b"flare_row", b"flare_old", 1)
    assert stale != sections[1]
    store.save("exec", digest, header["meta"], [sections[0], stale])
    c2 = compile_template(make_ctx(spec, store), engine="compiled-native")
    c2.collect(**Q6_BINDING)
    assert not c2.stats.disk_hit and c2.stats.persist == "written"
    assert store.tier("exec").version_miss == 1


def test_batch_executors_persist_per_bucket(spec, store):
    bindings = [dict(b) for b in Q.TEMPLATE_BINDINGS["q6"][:2]]
    c1 = compile_template(make_ctx(spec, store))
    want = [r.compact() for r in c1.batch(bindings)]
    writes = store.tier("exec").writes
    assert writes >= 2  # the template + its bucket-2 batch program

    c2 = compile_template(make_ctx(spec, store))
    got = [r.compact() for r in c2.batch(bindings)]
    assert store.tier("exec").writes == writes  # everything came off disk
    assert store.tier("exec").hits >= 2
    for w, g in zip(want, got):
        assert_results_equal(w, g, msg="persisted batch program")


def _udf_df(ctx):
    return ctx.table("lineitem").map_batches(
        lambda cols: {"double_qty": cols["l_quantity"] * 2.0},
        columns=["l_quantity"], schema={"double_qty": "float64"})


def test_udf_plan_persists_with_content_hashed_fingerprint(spec, store):
    df = _udf_df(make_ctx(spec, store))
    ok, reason = plan_persistable(df.plan)
    assert ok, reason
    assert "#" in df.plan.fingerprint()       # content-hash marker
    assert "@" not in df.plan.fingerprint()   # no process-local address
    compiled = df.lower(engine="compiled").compile(cache=CompileCache())
    want = compiled.collect()
    assert compiled.stats.persist == "written"
    assert store.tier("exec").unsupported == 0
    assert len(exec_paths(store)) == 1

    c2 = _udf_df(make_ctx(spec, store)).lower(
        engine="compiled").compile(cache=CompileCache())
    got = c2.collect()
    assert c2.stats.disk_hit and c2.stats.persist.startswith("hit")
    assert store.tier("exec").writes == 1
    assert_results_equal(want, got, msg="persisted UDF template")


def test_iterative_kernel_plan_persists_as_value_kind(spec, store):
    """A ``train()`` root persists under kind="value" and a fresh context
    hits it.  (The JAX package's counterpart reads its artifact back as a
    version miss on the CPU; ROADMAP Queue 3.)"""
    def make(ctx_):
        return (ctx_.table("lineitem")
                .train("logreg", columns=["l_quantity", "l_extendedprice"],
                       label="l_discount", max_iter=5))

    c1 = make(make_ctx(spec, store)).lower(
        engine="compiled").compile(cache=CompileCache())
    want = c1()
    assert c1.stats.persist == "written", c1.stats.persist
    c2 = make(make_ctx(spec, store)).lower(
        engine="compiled").compile(cache=CompileCache())
    got = c2()
    assert c2.stats.disk_hit and c2.stats.persist.startswith("hit")
    st = store.tier("exec")
    assert (st.hits, st.version_miss, st.writes) == (1, 0, 1)
    np.testing.assert_allclose(np.asarray(want.weights),
                               np.asarray(got.weights), rtol=1e-5)


def test_persist_false_disables_the_store(spec, store):
    ctx = make_ctx(spec, store)
    Q.TEMPLATES["q6"](ctx).lower(engine="compiled").compile(
        cache=CompileCache(), persist=False).collect(**Q6_BINDING)
    assert store.tier("exec").writes == 0 and not exec_paths(store)


def test_flare_cache_dir_is_the_default_store(spec, tmp_path, monkeypatch):
    monkeypatch.setenv(PS.CACHE_DIR_ENV, str(tmp_path / "ambient"))
    store = PS.default_store()
    assert store is PS.default_store()  # one handle per configuration
    c1 = compile_template(make_ctx(spec), engine="compiled-native")
    c1.collect(**Q6_BINDING)
    assert c1.stats.persist == "written"
    c2 = compile_template(make_ctx(spec), engine="compiled-native")
    c2.collect(**Q6_BINDING)
    assert c2.stats.disk_hit
    assert store.tier("exec").hits == 1


# ---------------------------------------------------------------------------
# index tier: a disk round trip equals a fresh build, meta included
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keys,dense,identity", [
    (lambda rng: rng.permutation(2000), 1, 0),        # dense, shuffled
    (lambda rng: np.arange(2000), 1, 1),              # dense, sorted
    (lambda rng: rng.permutation(2000) * 3 + 7, 0, 0)])  # gapped
def test_index_roundtrip_equals_fresh_build(store, keys, dense, identity):
    tbl = PT.Table.from_arrays(
        {"k": keys(np.random.default_rng(3)).astype(np.int32),
         "v": np.random.default_rng(4).normal(size=2000)},
        domains={"k": 8000}, uniques=["k"])
    cpu = torch.device("cpu")
    fresh = ENG.IndexCache(cpu).get(tbl, ("k",))
    c1 = ENG.IndexCache(cpu, store=store)
    c1.get(tbl, ("k",))
    assert c1.disk_hits == 0 and store.tier("index").writes == 1

    c2 = ENG.IndexCache(cpu, store=store)
    loaded = c2.get(tbl, ("k",))
    assert c2.disk_hits == 1 and store.tier("index").writes == 1
    for name in ("perm", "keys", "meta"):
        a, b = getattr(loaded, name), getattr(fresh, name)
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a, b), name
    assert loaded.unique and fresh.unique
    assert loaded.meta.tolist()[0::2] == [dense, identity]


def test_index_digest_tracks_data_content(store):
    a = PT.Table.from_arrays({"k": np.arange(100, dtype=np.int32)})
    b = PT.Table.from_arrays({"k": np.arange(1, 101, dtype=np.int32)})
    assert index_digest(a, ("k",), ()) != index_digest(b, ("k",), ())
    cpu = torch.device("cpu")
    ENG.IndexCache(cpu, store=store).get(a, ("k",))
    c2 = ENG.IndexCache(cpu, store=store)
    c2.get(b, ("k",))  # different data may NOT hit a's artifact
    assert c2.disk_hits == 0


def test_index_artifact_without_meta_is_corrupt(store):
    """An index artifact with perm and keys only (the JAX package's
    layout) would send the probe down its search route: it is refused as
    corrupt and the index rebuilt."""
    tbl = PT.Table.from_arrays({"k": np.arange(50, dtype=np.int32)},
                               uniques=["k"])
    cpu = torch.device("cpu")
    digest = index_digest(tbl, ("k",), ())
    built = ENG.IndexCache(cpu).get(tbl, ("k",))
    store.save("index", digest, {"n": 50, "unique": True},
               [built.perm.numpy().tobytes(), built.keys.numpy().tobytes()])
    c = ENG.IndexCache(cpu, store=store)
    got = c.get(tbl, ("k",))
    assert c.disk_hits == 0 and store.tier("index").corrupt == 1
    assert torch.equal(got.meta, built.meta)


# ---------------------------------------------------------------------------
# telemetry surfaces
# ---------------------------------------------------------------------------


def test_cache_stats_has_disk_breakdown(spec, store):
    from repro.persist import store as JPS
    c = compile_template(make_ctx(spec, store))  # keeps its caches alive
    c.collect(**Q6_BINDING)
    snap = ENG.cache_stats()
    for kind, agg in snap.items():
        assert agg["caches"] >= 1
        assert 0.0 <= agg["hit_rate"] <= 1.0
    for kind, tier in (("compile", "exec"), ("index", "index")):
        # the JAX package's keys, one for one
        assert set(snap[kind]["disk"]) == set(JPS.live_store_stats()[tier])
    assert snap["compile"]["disk"]["writes"] >= 1


def test_store_stats_dict_shape(store):
    d = store.stats_dict()
    assert set(d["entries"]) == {"exec", "index"}
    assert d["root"] == store.root and d["nbytes"] == 0
    assert d["exec"]["hit_rate"] == 0.0


def test_live_store_stats_zero_without_stores():
    snap = PS.live_store_stats()
    for tier in ("exec", "index"):
        assert "hits" in snap[tier] and "stores" in snap[tier]


def test_serve_preload_reports_disk_hits(jax_ctx, spec, store):
    few = {"q6": Q.TEMPLATES["q6"]}
    s1 = QueryServer(make_ctx(spec, store), templates=few)
    assert s1.preload() == 1
    assert s1.stats.disk_hits == 0  # cold: everything compiled

    s2 = QueryServer(make_ctx(spec, store), templates=few, warm_start=True)
    assert s2.stats.preloaded == 1
    assert s2.stats.disk_hits >= 2  # the template + its bucket-1 program
    assert s2.stats.preload_s > 0
    d = s2.stats.to_dict()
    assert d["preloaded"] == 1 and d["disk_hits"] == s2.stats.disk_hits
    got = s2.serve([("q6", Q6_BINDING)])[0]
    assert_results_equal(reference(jax_ctx, "q6", Q6_BINDING), got.compact(),
                         msg="preloaded serve")


# ---------------------------------------------------------------------------
# loading a unit from store bytes
# ---------------------------------------------------------------------------


def test_load_library_names_files_by_content(tmp_path, monkeypatch):
    opened = []
    monkeypatch.setattr(CB, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(CB.ctypes, "CDLL", lambda p: opened.append(p) or p)
    monkeypatch.setattr(CB, "_libs", {})
    monkeypatch.setattr(CB, "_lib_files", {})
    builds, loads = CB.builds, CB.store_loads
    CB.load_library("unit a", b"library one")
    CB.load_library("unit b", b"library two")
    CB.load_library("unit a", b"library three")  # already loaded: kept
    monkeypatch.setattr(CB, "_libs", {})
    CB.load_library("unit c", b"library one")    # same bytes, same file
    assert len(opened) == 3 and opened[0] == opened[2] != opened[1]
    assert all(os.path.basename(p).startswith("flare_lib_") for p in opened)
    assert open(opened[1], "rb").read() == b"library two"
    assert CB.builds == builds and CB.store_loads == loads + 3
    assert CB.library_bytes("unit c") == b"library one"


# ---------------------------------------------------------------------------
# a second PROCESS serves from the first's store
# ---------------------------------------------------------------------------

_PROC_CODE = """
import json, sys
from repro_torch.core import CompileCache, FlareContext
from repro_torch.kernels import cuda_build as CB
from repro_torch.persist import store as PS
from repro_torch.relational import queries as Q

ctx = FlareContext(device="cpu")
Q.register_tpch(ctx, sf=%(sf)r)
out = {"results": {}, "disk_hit": {}}
for name in ("q6", "q19"):
    for engine in ("compiled", "compiled-native"):
        compiled = Q.TEMPLATES[name](ctx).lower(engine=engine).compile(
            cache=CompileCache())
        res = compiled.collect(**dict(Q.TEMPLATE_BINDINGS[name][0]))
        key = name + "/" + engine
        out["results"][key] = {k: [float(x) for x in v]
                               for k, v in res.items()}
        out["disk_hit"][key] = compiled.stats.disk_hit
out["store"] = PS.live_store_stats()
out["builds"] = CB.builds
json.dump(out, sys.stdout)
"""


def run_process(cache_dir):
    env = dict(os.environ, FLARE_CACHE_DIR=str(cache_dir),
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _PROC_CODE % {"sf": SF}],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def test_cross_process_restart_compiles_nothing(tmp_path):
    """Process A populates the store; process B (a fresh interpreter)
    serves every template and index from it: zero store misses, zero
    writes, identical results."""
    cache_dir = tmp_path / "shared-store"
    a = run_process(cache_dir)
    b = run_process(cache_dir)
    ae, be = a["store"]["exec"], b["store"]["exec"]
    assert ae["writes"] == 4 and ae["hits"] == 0
    assert be["writes"] == 0, f"process B rebuilt: {be}"
    assert be["misses"] == 0 and be["hits"] == 4 and be["hit_rate"] == 1.0
    assert all(b["disk_hit"].values()), b["disk_hit"]
    # q19 joins: its build-side index also comes off disk
    assert b["store"]["index"]["writes"] == 0
    assert b["store"]["index"]["hits"] >= 1
    assert a["builds"] == b["builds"] == 0  # the CPU builds no unit
    for key in a["results"]:
        assert_results_equal(a["results"][key], b["results"][key],
                             msg=f"cross-process {key}")
