"""Drive the PyTorch port's main path on one NVIDIA Hopper GPU and check it.

    python3 chip_smoke.py            # TPC-H SF 10 (lineitem: 60 M rows)
    python3 chip_smoke.py --sf 1     # a smaller scale

Phases, in order; any failure exits non-zero:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA
   and nvcc versions;
2. data and build: ``tpch.generate(sf, seed)`` on the host, columns and
   join indexes to the device, then every kernel unit of the suite built
   with one nvcc per unit, all at once;
3. kernels against their plain PyTorch versions, on the main path's own
   inputs (captured from one native run of q6, a q1-shaped grouped query
   with an ``any_`` max slot, q14, q5 and q3): ``filter_agg_general``,
   ``segmented_multi_sum`` and ``join_probe_agg`` keyless, grouped in
   shared memory and grouped by global atomics; kernel, plain and
   library-call times by CUDA events, the bound from bytes and operations;
4. the main path: all TPC-H queries and every template binding through
   ``lower(engine="compiled", native=True).compile()``, the fired patterns
   held against ``EXPECTED_PATTERNS``, each result against the generic
   ``compiled`` lowering, each kernel's launch count (reset just before,
   read just after), steady-state ms per query, one build per template;
   then one profiled run per query: device time, busy share, top kernels;
5. goldens: q1, q6, q13 and q14 at SF 0.01 against ``tests/golden``.

The line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Patterns each query and template fires (the JAX package fires the same
#: ones at SF 0.005; tests/test_torch_slice.py holds the two together).
EXPECTED_PATTERNS = {
    "q1": ["grouped-agg"],
    "q3": ["join-probe"],
    "q4": ["masked-filter-project"],
    "q5": ["join-probe"],
    "q6": ["filter-scalar-agg"],
    "q10": ["join-probe"],
    "q13": ["masked-filter-project"],
    "q14": ["join-probe"],
    "q19": ["join-probe"],
    "template:q6": ["filter-scalar-agg"],
    "template:q14": ["join-probe"],
    "template:q19": ["join-probe"],
    "template:q22": ["masked-filter-project"],
}

#: Fragments that stay on the generic lowering: q13's per-customer count
#: has a group domain above segmented_multi_sum's MAX_GROUPS.
EXPECTED_FALLBACKS = {"q13": ["Aggregate keys=['o_custkey']"]}

#: Dispatch decisions that differ at full scale from SF 0.005, with their
#: cause (also in PERF.md).  None so far.
SCALE_CHANGES: dict = {}

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
H100_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores

SUM_RTOL = 1e-3      # kernel vs plain sums: summation order differs
RESULT_RTOL = 5e-3   # query results, as tests/conftest.py compares them


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def environment(torch, CB) -> str:
    card = card_line()
    nvcc = subprocess.run([CB.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{nvcc[-1] if nvcc else 'nvcc ?'}, device "
        f"{torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)}")
    return card


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, runs: int = 10, warmup: int = 2) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(torch, fn, runs: int = 5) -> float:
    """Median wall time of ``fn`` (which ends in a host copy)."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def body_ops(src: str) -> int:
    """f32 operations per row of a generated body: its arithmetic,
    comparison and select operators (an estimate for the bound)."""
    body = src[src.find("flare_row"):]
    return len(re.findall(r"(?<![=!<>&|])([-+*/?]|[<>]=?|==|!=)(?![=>])",
                          body))


def bound_ms(byte_count: int, ops: float):
    t_bytes = byte_count / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


class Capture:
    """Records the arguments of every call of one kernel wrapper while
    active, so the kernel checks replay the main path's own inputs."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def wrapper(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def capture_args(torch, ctx, df, module, name):
    with Capture(module, name) as cap:
        df.lower(engine="compiled", native=True).compile()()
    check(len(cap.calls) == 1,
          f"expected one {name} call, saw {len(cap.calls)}")
    return cap.calls[0]


def compare(torch, got, want, what: str, max_slots=()) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    for j in max_slots:
        check(torch.equal(got[j], want[j]), f"{what}: max slot {j} differs")
    err = (got - want).abs()
    tol = SUM_RTOL * want.abs() + 1e-3
    check(bool((err <= tol).all()),
          f"{what}: max abs err {float(err.max())} beyond rtol {SUM_RTOL}")
    return float(err.max())


def kernel_checks(torch, ctx, Q, FA, SR, JP, col, sum_, avg, count, any_,
                  lit):
    """Phase 3: returns one record per kernel mode for the JSON line."""
    from repro_torch.relational.tpch import date

    records = []
    # -- filter_agg_general: q6 -----------------------------------------------
    args, kw = capture_args(torch, ctx, Q.q6(ctx), FA, "filter_agg_general")
    body, cols, valid, n, scal = args
    got = FA.filter_agg_general(*args)
    want = FA.filter_agg_general_plain(*args)
    err = compare(torch, got, want, "filter_agg_general")
    ops = n * body_ops(body.src)
    b, by = bound_ms(nbytes(list(cols) + [valid, scal, got]), ops)
    records.append(dict(
        name="filter_agg_general", route="cuda",
        source="src/repro_torch/kernels/csrc/filter_agg.cuh",
        replaces="src/repro/kernels/filter_agg/kernel.py:99",
        shape=f"q6: {n} rows x {len(cols)} cols", max_abs_err=err,
        ms=cuda_ms(torch, lambda: FA.filter_agg_general(*args)),
        plain_ms=cuda_ms(torch, lambda: FA.filter_agg_general_plain(*args)),
        bound_ms=b, bound_by=by, library_ms=None))

    # -- segmented_multi_sum: q1 with an any_ max slot ------------------------
    li = ctx.table("lineitem")
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    q1x = (li.filter(col("l_shipdate") <= date("1998-12-01") - 90)
           .group_by("l_returnflag", "l_linestatus")
           .agg(sum_(col("l_quantity"), "sum_qty"),
                sum_(col("l_extendedprice"), "sum_base_price"),
                sum_(rev, "sum_disc_price"),
                sum_(rev * (lit(1.0) + col("l_tax")), "sum_charge"),
                avg(col("l_discount"), "avg_disc"),
                any_(col("l_shipdate"), "max_ship"),
                count("count_order")))
    args, kw = capture_args(torch, ctx, q1x, SR, "segmented_multi_sum")
    body, cols, valid, codes, n, groups, scal = args
    got = SR.segmented_multi_sum(*args)
    want = SR.segmented_multi_sum_plain(*args)
    max_slots = [j for j, op in enumerate(body.ops) if op == "max"]
    check(len(max_slots) == 1 and groups == 6, "q1-shaped: G=6, one max row")
    err = compare(torch, got, want, "segmented_multi_sum", max_slots)
    ops = n * body_ops(body.src)
    b, by = bound_ms(nbytes(list(cols) + [valid, codes, scal, got]), ops)
    # library yardstick: one index_add_ of the precomputed slot values
    ok = valid if valid is not None else torch.ones(
        n, dtype=torch.bool, device=scal.device)
    pred, vals = body.rows([c.float() for c in cols], ok, scal)
    stacked = torch.stack(vals)
    idx = torch.where(pred, codes, 0).long()
    acc = torch.zeros(body.n_out, groups, dtype=torch.float32,
                      device=scal.device)
    lib = cuda_ms(torch, lambda: acc.zero_().index_add_(1, idx, stacked))
    del stacked, idx, acc, pred, vals
    records.append(dict(
        name="segmented_multi_sum", route="cuda",
        source="src/repro_torch/kernels/csrc/segmented_reduce.cuh",
        replaces="src/repro/kernels/segmented_reduce/kernel.py:104",
        shape=f"q1 + any_: {n} rows, G={groups}, n_out={body.n_out}",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: SR.segmented_multi_sum(*args)),
        plain_ms=cuda_ms(torch, lambda: SR.segmented_multi_sum_plain(*args)),
        bound_ms=b, bound_by=by, library_ms=lib))

    # -- join_probe_agg: q14 keyless, q5 shared, q3 global --------------------
    for qname, mode in (("q14", "keyless"), ("q5", "shared"),
                        ("q3", "global")):
        args, kw = capture_args(torch, ctx, Q.QUERIES[qname](ctx), JP,
                                "join_probe_agg")
        body = args[0]
        groups = kw.get("num_groups")
        check(JP.accum_mode(body.n_out, groups) == mode,
              f"{qname}: expected {mode} accumulation")
        got = JP.join_probe_agg(*args, **kw)
        want = JP.join_probe_agg_plain(*args, **kw)
        max_slots = [j for j, op in enumerate(body.ops) if op == "max"]
        err = compare(torch, got, want, f"join_probe_agg[{mode}]",
                      max_slots if groups else ())
        (_, pcols, pvalid, n, keys, perm, bmask, bcols, scal) = args
        search = n * math.ceil(math.log2(max(2, keys.numel())))
        ops = n * body_ops(body.src) + search
        b, by = bound_ms(nbytes(list(pcols) + list(bcols)
                                + [pvalid, keys, perm, bmask, scal, got]),
                         ops)
        records.append(dict(
            name=f"join_probe_agg[{mode}]", route="cuda",
            source="src/repro_torch/kernels/csrc/join_probe.cuh",
            replaces=("src/repro/kernels/join_probe/kernel.py:193"
                      if mode == "keyless" else
                      "src/repro/kernels/join_probe/kernel.py:276"),
            shape=(f"{qname}: {n} probe rows x {len(pcols)} cols, "
                   f"build {keys.numel()} rows x {len(bcols)} cols"
                   + (f", G={groups}" if groups else "")),
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: JP.join_probe_agg(*args, **kw)),
            plain_ms=cuda_ms(torch,
                             lambda: JP.join_probe_agg_plain(*args, **kw)),
            bound_ms=b, bound_by=by, library_ms=None))
    torch.cuda.synchronize()
    for r in records:
        log("[kernel] " + json.dumps(r))
    return records


# ---------------------------------------------------------------------------
# phase 4 and 5: main path, goldens
# ---------------------------------------------------------------------------


def assert_close(got, want, what: str) -> None:
    check(set(got) == set(want), f"{what}: columns {sorted(got)} vs "
          f"{sorted(want)}")
    for k in want:
        x = np.atleast_1d(np.asarray(got[k]))
        y = np.atleast_1d(np.asarray(want[k]))
        check(x.shape == y.shape, f"{what}/{k}: shape {x.shape} vs {y.shape}")
        if x.dtype == object or y.dtype == object:
            check(list(x) == list(y), f"{what}/{k}: strings differ")
            continue
        xf, yf = x.astype(np.float64), y.astype(np.float64)
        check(bool(np.isfinite(xf).all()), f"{what}/{k}: non-finite")
        # relative, counts included: f32 counts near 2^24 round
        bad = np.abs(xf - yf) > RESULT_RTOL * np.abs(yf) + 1e-6
        check(not bad.any(), f"{what}/{k}: {xf[bad][:3]} vs {yf[bad][:3]}")


def report_check(label: str, lowered) -> None:
    rep = lowered.dispatch_report()
    fired = rep.fired_patterns() if rep is not None else []
    key = label.split()[0]
    if fired != EXPECTED_PATTERNS[key] and key not in SCALE_CHANGES:
        log(f"[dispatch] {label}: {rep}")
        raise SmokeFailure(f"{label}: fired {fired}, expected "
                           f"{EXPECTED_PATTERNS[key]}")
    falls = [d.node for d in rep.fallbacks] if rep is not None else []
    want = EXPECTED_FALLBACKS.get(key, [])
    if (len(falls) != len(want) or not all(
            f.startswith(w) for f, w in zip(falls, want))) \
            and key not in SCALE_CHANGES:
        log(f"[dispatch] {label}: {rep}")
        raise SmokeFailure(f"{label}: fallbacks {falls}, expected {want}")


def main_path(torch, ctx, Q, FA, SR, JP, CB):
    """Phase 4: every query and binding, native vs generic."""
    per_query = {}
    for mod in (FA, SR, JP):
        mod.launches = 0
    builds_before = CB.builds
    for name, build in Q.QUERIES.items():
        lowered = build(ctx).lower(engine="compiled", native=True)
        report_check(name, lowered)
        compiled = lowered.compile()
        got = compiled()
        want = build(ctx).lower(engine="compiled").compile()()
        assert_close(got, want, name)
        ms = host_ms(torch, lambda: compiled.result())
        per_query[name] = ms
        log(f"[query] {json.dumps({'query': name, 'ms': ms, 'rows': len(next(iter(got.values())))})}")
    q22_binding = Q.q22_params(ctx, engine="compiled-native")
    for tname, build in Q.TEMPLATES.items():
        bindings = list(Q.TEMPLATE_BINDINGS[tname])
        if tname == "q22":
            bindings.append(q22_binding)
        builds0 = CB.builds
        sources = set()
        times = []
        native_compiles = 0
        for b in bindings:
            lowered = build(ctx).lower(engine="compiled", native=True)
            report_check(f"template:{tname} {b}", lowered)
            sources.update(lowered.kernel_sources())
            compiled = lowered.compile()
            native_compiles += not compiled.stats.cache_hit
            got = compiled(**b)
            want = build(ctx).lower(engine="compiled").compile()(**b)
            assert_close(got, want, f"template {tname} {b}")
            times.append(host_ms(torch, lambda: compiled.result(**b)))
        rec = {"template": tname, "bindings": len(bindings),
               "kernel_units": len(sources),
               "native_compiles": native_compiles,
               "nvcc_builds_during_bindings": CB.builds - builds0,
               "ms_per_binding": times}
        check(len(sources) == 1 and native_compiles == 1,
              f"template {tname}: {len(sources)} kernel units, "
              f"{native_compiles} compiles for {len(bindings)} bindings")
        per_query[f"template:{tname}"] = float(np.median(times))
        log(f"[template] {json.dumps(rec)}")
    torch.cuda.synchronize()
    launches = {"filter_agg_general": FA.launches,
                "segmented_multi_sum": SR.launches,
                "join_probe_agg": JP.launches}
    log(f"[launches] {json.dumps(launches)} nvcc builds in phase 4: "
        f"{CB.builds - builds_before}")
    check(CB.builds == builds_before, "phase 4 built a kernel unit that "
          "phase 2 did not")
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the main path")
    return per_query, launches


def device_breakdown(torch, ctx, Q) -> dict:
    """Phase 4b: one profiled steady-state run per query (torch.profiler,
    CUPTI): device time, its share of the run's wall time, and the
    kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, build in Q.QUERIES.items():
        compiled = build(ctx).lower(engine="compiled", native=True).compile()
        compiled.result()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            compiled.result()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) is not None
                   and "CUDA" in str(e.device_type)]
        dev = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:4]
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "device_busy_share": dev / wall if wall else None,
                     "top": [[e.key[:60], e.self_device_time_total / 1e3,
                              e.count] for e in top]}
        log(f"[profile] {json.dumps({'query': name, **out[name]})}")
    return out


def goldens(torch, FlareContext, Q) -> None:
    ctx = FlareContext(device="cuda")
    Q.register_tpch(ctx, sf=0.01, seed=0)
    for q in ("q1", "q6", "q13", "q14"):
        with open(os.path.join(ROOT, "tests", "golden", f"{q}.json")) as f:
            gold = json.load(f)
        check(gold["sf"] == 0.01 and gold["seed"] == 0, f"golden {q} scale")
        want = {k: np.asarray(v, dtype=object if isinstance(v[0], str)
                              else np.float64)
                for k, v in gold["columns"].items()}
        got = Q.QUERIES[q](ctx).lower(engine="compiled",
                                      native=True).compile()()
        assert_close(got, want, f"golden {q}")
        log(f"[golden] {q} ok")


def run(sf: float, seed: int) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.core import (FlareContext, any_, avg, col, count,
                                      lit, sum_)
        from repro_torch.kernels import cuda_build as CB
        from repro_torch.kernels.filter_agg import kernel as FA
        from repro_torch.kernels.join_probe import kernel as JP
        from repro_torch.kernels.segmented_reduce import kernel as SR
        from repro_torch.relational import queries as Q
    except ImportError as ex:
        print(f"chip_smoke: the repro_torch package is missing ({ex})",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    card = environment(torch, CB)

    t0 = time.perf_counter()
    ctx = FlareContext(device="cuda")
    Q.register_tpch(ctx, sf=sf, seed=seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx.preload()
    torch.cuda.synchronize()
    rows = {n: ctx.catalog.table(n).num_rows for n in ctx.catalog.names()}
    log(f"[data] sf={sf} seed={seed} rows={json.dumps(rows)} generate "
        f"{t_gen:.1f} s, to device + join indexes "
        f"{time.perf_counter() - t0:.1f} s, device bytes "
        f"{torch.cuda.memory_allocated()}")

    t0 = time.perf_counter()
    sources = set()
    for name, build in Q.QUERIES.items():
        sources.update(build(ctx).lower(native=True).kernel_sources())
    for name, build in Q.TEMPLATES.items():
        sources.update(build(ctx).lower(native=True).kernel_sources())
    CB.build_all(sources)
    # q22's phase 1 (the scalar subquery) is a fragment of its own
    Q.q22_params(ctx, engine="compiled-native")
    log(f"[build] {len(sources) + 1} kernel units of the suite, {CB.builds} "
        f"nvcc builds, {time.perf_counter() - t0:.1f} s, into "
        f"{CB.BUILD_DIR}")

    records = kernel_checks(torch, ctx, Q, FA, SR, JP, col, sum_, avg,
                            count, any_, lit)
    per_query, launches = main_path(torch, ctx, Q, FA, SR, JP, CB)
    for r in records:
        r["launches"] = launches[r["name"].split("[")[0]]
    device_breakdown(torch, ctx, Q)
    del ctx
    torch.cuda.empty_cache()
    goldens(torch, FlareContext, Q)
    log(f"[summary] per-query steady-state ms at SF {sf}: "
        f"{json.dumps(per_query)}")
    log(f"[summary] total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of the main path (default 10)")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    try:
        return run(a.sf, a.seed)
    except SmokeFailure as ex:
        print(f"chip_smoke: FAILED: {ex}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
