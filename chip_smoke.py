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
5. goldens: q1, q6, q13 and q14 at SF 0.01 against ``tests/golden``;
6. the LM path's kernels against their plain versions, on the path's own
   inputs, after a line with the tensor-core flash kernel's registers,
   shared memory and spill bytes: ``flash_attention`` on layer 0's q/k/v
   of the full-width ``qwen3-0.6b`` forward -- the tensor-core kernel
   (B 4 x S 4096, bf16, causal; also non-causal, and S 4000, not a
   multiple of the tile) and the CUDA-core kernel on the same inputs in
   f32 --, ``decode_attention`` on the serving path's layer-0 cache after
   prefill (B 8, 2048 + 1 positions) and at ``decode_32k``'s length (B 8,
   S 32 768, lengths from the seed); each held to one rounding of its
   plain version's output (bf16, or the f32 kernel tests' limit), a limit
   that must also reject faults planted on the same inputs (among them
   the KV heads rolled by one); kernel, plain and
   ``scaled_dot_product_attention`` times, the bound;
7. the LM main path, weights from the seed on the card: ``Model.forward``
   with ``attn_impl="pallas"`` at B 4 x S 4096 (28 tensor-core flash
   launches per forward) against ``attn_impl="blockwise"``, its
   steady-state ms and ``Model.loss``; the same forward in f32 (28
   CUDA-core flash launches) against the f32 blockwise forward;
   ``serve_llm.generate`` at B 8 x 2048 + 32 tokens (prefill ms, decode
   ms, tokens/s; prefill takes the tensor-core kernel on every layer);
   the prefill and decode logits against a forward over prompt +
   completion; launch counts (reset just before, read just after); one
   profiled forward and decode run;
8. the paper's Q6/Q1 engine ladder on the SF 10 context of phases 2-5
   (run after phase 5, before the LM phases): q6 and q1 on ``volcano``
   (once, numpy f64 on the host), ``stage`` (median of 5), ``compiled``
   and ``compiled-native`` (phase 4) and the hand-written rows --
   ``filter_agg_q6`` on the device cache's columns with the constants
   of ``benchmarks/bench_q6.py``, two ``segmented_sum`` calls (G 6) for
   q1's ``sum_qty`` and ``sum_base_price`` -- each equal to compiled,
   with the compiled / hand-written ratio; launch counts of both kernels
   (reset just before the ladder, read just after); the stage engine on
   every query, template binding and q22 in two phases against compiled;
   the tuple engine at SF 0.01 against the goldens and volcano; both
   kernels against their plain versions (SF 10 columns, and G 512 codes
   from the seed; bit for bit on dyadic inputs at ragged lengths and
   unaligned views; G 513 and 700 launch nothing); the direct-from-CSV
   row (lineitem at SF 0.1 through ``io.to_csv`` and
   ``read_csv_compiled``, then compiled q6) against the preloaded q6.

The line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
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

H100_BF16_OPS_PER_S = 989e12  # bf16 tensor cores, dense (data sheet)

SUM_RTOL = 1e-3      # kernel vs plain sums: summation order differs
RESULT_RTOL = 5e-3   # query results, as tests/conftest.py compares them


def days(iso: str) -> int:
    """A date as the engine's DATE encoding: days since 1970-01-01."""
    return int(np.datetime64(iso, "D").astype(np.int64))


#: the hand-written Q6 row's constants (benchmarks/bench_q6.py:149-150)
Q6_CONSTANTS = dict(date_lo=days("1994-01-01"), date_hi=days("1995-01-01"),
                    disc_lo=0.05, disc_hi=0.07, qty_hi=24.0)
#: Q1's shipdate cutoff, 1998-12-01 minus 90 days
Q1_CUTOFF = days("1998-12-01") - 90
#: lengths of the dyadic bit-for-bit checks: tails of 1-3 rows past the
#: 16-byte loads, and one that spans every block of the grid
RAGGED = (1, 3, 4097, 1_000_003)


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
    """Phase 4: every query and binding, native vs generic.  Returns the
    native ms, the generic ms and the generic results (phase 8 reuses
    them) and the launch counts."""
    per_query, generic_ms, generic = {}, {}, {}
    for mod in (FA, SR, JP):
        mod.launches = 0
    builds_before = CB.builds
    for name, build in Q.QUERIES.items():
        lowered = build(ctx).lower(engine="compiled", native=True)
        report_check(name, lowered)
        compiled = lowered.compile()
        got = compiled()
        plain = build(ctx).lower(engine="compiled").compile()
        want = generic[name] = plain()
        assert_close(got, want, name)
        ms = host_ms(torch, lambda: compiled.result())
        per_query[name] = ms
        generic_ms[name] = host_ms(torch, lambda: plain.result())
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
            generic[(tname, json.dumps(b, sort_keys=True))] = want
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
    return per_query, generic_ms, generic, launches


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


# ---------------------------------------------------------------------------
# phases 6 and 7: the LM path (qwen3-0.6b at full width)
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
#: the forward at train_4k's length; its batch of 256 is cut to 4 to fit
#: one card (with the f32 logits of the loss)
FWD_BATCH, FWD_LEN = 4, 4096
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 2048, 32
#: decode_32k's cache length at B 8 (its batch of 128 cut to 8)
DECODE32K = dict(b=8, hkv=8, group=2, s=32768, d=64)

#: kernel vs plain on the path's bf16 inputs: both round an f32 result to
#: bf16 once, so an element may differ by one rounding of the output, at
#: most 2^-7 |want|; the floor, 1e-3 of the largest |want|, covers outputs
#: near 0, where the two f32 sums' different order shows above that.
OUT_ROUNDING, OUT_FLOOR = 2.0 ** -7, 1e-3
#: the same limit for f32 outputs (as ``ATTN_TOL`` in the card tests):
#: the two f32 sums differ by their order only
F32_ROUNDING, F32_FLOOR = 1e-5, 1e-5
#: logits of two bf16 paths: a few bf16 roundings that differ between
#: the paths grow along 28 layers of residual stream, so single logits may
#: differ by several ulps.  The budget is measured in the same run: the
#: error of the reference bf16 forward (blockwise) against an f32 forward.
#: Every bf16 comparison of the LM path must stay within this factor of
#: that error (mean and max abs), plus a small slack for each:
NOISE_FACTOR, NOISE_SLACK = 2.0, {"mean_abs_err": 1e-3,
                                  "max_abs_err": 5e-2}


class CaptureFirst(Capture):
    """Capture that keeps a copy of the first call's tensor arguments."""

    def __enter__(self):
        def wrapper(*args, **kwargs):
            if not self.calls:
                self.calls.append(([a.clone() if hasattr(a, "clone") else a
                                    for a in args], dict(kwargs)))
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, wrapper)
        return self


def out_limit(torch, dtype):
    """(rel, floor) of the kernel-vs-plain limit for outputs of ``dtype``."""
    return ((F32_ROUNDING, F32_FLOOR) if dtype == torch.float32
            else (OUT_ROUNDING, OUT_FLOOR))


def rounding_excess(torch, got, want, what: str):
    """Max abs error of an attention output ``got`` against ``want``, and
    the largest ratio of an element's error to its limit, |d| <= rel
    |want| + floor max|want| with :func:`out_limit` of want's dtype (above
    1: outside it)."""
    check(tuple(got.shape) == tuple(want.shape),
          f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    rel, floor = out_limit(torch, want.dtype)
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    limit = rel * w.abs() + floor * float(w.abs().max())
    return float(err.max()), float((err / limit).max())


def close_err(torch, got, want, what: str):
    """Max abs error of ``got`` against ``want``, and its largest
    error/limit ratio; fails outside the limit."""
    err, excess = rounding_excess(torch, got, want, what)
    rel, floor = out_limit(torch, want.dtype)
    check(excess <= 1.0, f"{what}: max abs err {err}, {excess:.3g} times "
          f"the limit {rel} |want| + {floor} max|want|")
    return err, excess


def planted_faults(torch, want, faults: dict, what: str) -> dict:
    """The limit must reject each planted fault (a wrong output) on the
    path's own inputs; returns each fault's largest error/limit ratio."""
    out = {}
    for name, bad in faults.items():
        _, out[name] = rounding_excess(torch, bad, want, f"{what} {name}")
        check(out[name] > 1.0, f"{what}: the kernel check passes the "
              f"planted fault '{name}' (error/limit {out[name]:.3g})")
    log(f"[fault] {what} rejected, error/limit: {json.dumps(out)}")
    return out


def logit_err(torch, got, want, what: str, noise: dict = None) -> dict:
    """Max and mean abs error of two logit tensors (one leading slice at
    a time); checked against ``noise`` (the bf16 budget) when given."""
    check(tuple(got.shape) == tuple(want.shape),
          f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    worst, total = 0.0, 0.0
    for g, w in zip(got, want):
        g = g.float()
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite logits")
        err = (g - w.float()).abs()
        worst = max(worst, float(err.max()))
        total += float(err.double().sum())
    out = {"max_abs_err": worst, "mean_abs_err": total / max(got.numel(), 1)}
    for key, got_err in (out.items() if noise else ()):
        limit = NOISE_FACTOR * noise[key] + NOISE_SLACK[key]
        check(got_err <= limit, f"{what}: {key} {got_err} beyond {limit} "
              f"(the bf16 budget {noise})")
    return out


def attn_bound(byte_count: int, flops: float,
               ops_per_s: float = H100_BF16_OPS_PER_S):
    t_bytes = byte_count / H100_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


#: the flash wrapper's two kernels, by ``FL.route``
FLASH_SOURCES = {
    "mma": "src/repro_torch/kernels/csrc/flash_attention_mma.cuh",
    "cuda_cores": "src/repro_torch/kernels/csrc/flash_attention.cuh"}


def bf16_p_excess(torch, FL, q, k, v, causal: bool, want) -> float:
    """Error/limit of attention with P rounded to bf16 before P V (the
    model's own rounding) against ``want`` (f32 P), in plain torch on the
    same inputs: why the tensor-core kernel splits P into two bf16 parts."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b * hkv, h // hkv, s, d).float()
    logits = torch.einsum("kgqd,ksd->kgqs", qg,
                          k.reshape(b * hkv, s, d).float()) * d ** -0.5
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, FL.NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    del logits
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("kgqs,ksd->kgqd", p.bfloat16().float(),
                       v.reshape(b * hkv, s, d).float()) / l
    del p
    return rounding_excess(torch, out.reshape(q.shape).to(q.dtype), want,
                           "bf16 P")[1]


def flash_record(torch, F, FL, q, k, v, causal: bool, label: str,
                 faults: bool = False) -> dict:
    b, h, s, d = q.shape
    kernel = FL.route(q.dtype, d)
    check(label.split("[")[0] == f"flash_attention_{kernel}",
          f"{label}: these inputs take the {kernel} kernel")
    got = FL.flash_attention(q, k, v, causal=causal)
    want = FL.flash_attention_plain(q, k, v, causal=causal)
    err, excess = close_err(torch, got, want, label)
    extra = ({"bf16_p_err_over_limit": bf16_p_excess(torch, FL, q, k, v,
                                                     causal, want)}
             if kernel == "mma" else {})
    if faults:
        # wrong output scale, wrong softmax scale, each query head on the
        # wrong KV head, the last K tile dropped
        tail = FL.flash_attention_core_plain(
            q.reshape(b * h, s, d), *[t[:, :, :s - 64].reshape(-1, s - 64, d)
                                      for t in (k, v)], causal=False)
        planted_faults(torch, want, {
            "output x 0.9": got * 0.9,
            "softmax scale x 0.9": FL.flash_attention(
                q, k, v, causal=causal, scale=0.9 * d ** -0.5),
            "KV heads rolled by one": FL.flash_attention_plain(
                q, k.roll(1, dims=1), v.roll(1, dims=1), causal=causal),
            **({} if causal else
               {"last K tile dropped": tail.reshape(q.shape)})}, label)
        del tail
    del want
    pairs = s * (s + 1) // 2 if causal else s * s      # unmasked (q, k)
    bnd, by = attn_bound(nbytes([q, k, v, got]), 4.0 * d * b * h * pairs,
                         H100_BF16_OPS_PER_S if kernel == "mma"
                         else H100_F32_OPS_PER_S)
    rec = dict(
        name=label, route="cuda", source=FLASH_SOURCES[kernel],
        replaces="src/repro/kernels/flash_attention/kernel.py:73",
        shape=(f"B {b} x H {h} (Hkv {k.shape[1]}) x S {s} x D {d}, "
               f"{str(q.dtype).split('.')[-1]}, "
               f"{'causal' if causal else 'non-causal'}"),
        max_abs_err=err, err_over_limit=excess, **extra,
        ms=cuda_ms(torch, lambda: FL.flash_attention(q, k, v,
                                                     causal=causal)),
        plain_ms=cuda_ms(torch, lambda: FL.flash_attention_plain(
            q, k, v, causal=causal), runs=5, warmup=1),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)))
    log("[kernel] " + json.dumps(rec))
    return rec


def decode_record(torch, F, DA, q, k, v, lengths, label: str) -> dict:
    got = DA.decode_attention(q, k, v, lengths)
    want = DA.decode_attention_plain(q, k, v, lengths)
    err, _ = close_err(torch, got, want, label)
    b, h, d = q.shape
    planted_faults(torch, want, {
        "output x 0.9": got * 0.9,
        "softmax scale x 0.9": DA.decode_attention(
            q, k, v, lengths, scale=0.9 * d ** -0.5),
        "last 64 keys dropped": DA.decode_attention(
            q, k, v, (lengths - 64).clamp_min(1)),
        "length off by one": DA.decode_attention(
            q, k, v, (lengths - 1).clamp_min(1))}, label)
    del want
    hkv, s = k.shape[1], k.shape[2]
    n = lengths.clamp(0, s)
    n = torch.where(n == 0, s, n)               # length 0 reads every row
    rows = int(n.sum()) * hkv                   # cache rows the data needs
    bnd, by = attn_bound(2 * rows * d * k.element_size()
                         + nbytes([q, lengths, got]),
                         4.0 * d * (h // hkv) * rows)
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    rec = dict(
        name=label, route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cuh",
        replaces="src/repro/kernels/decode_attention/kernel.py:65",
        shape=(f"B {b} x H {h} (Hkv {hkv}) x S {s} x D {d}, "
               f"{str(q.dtype).split('.')[-1]}, lengths "
               f"{lengths.tolist()}"),
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: DA.decode_attention(q, k, v, lengths)),
        plain_ms=cuda_ms(torch, lambda: DA.decode_attention_plain(
            q, k, v, lengths), runs=5, warmup=1),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True)))
    log("[kernel] " + json.dumps(rec))
    return rec


def lm_inputs(torch, cfg, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (FWD_BATCH, FWD_LEN), generator=g,
                           device="cuda")
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    return tokens, labels


def lm_kernel_checks(torch, F, Model, serve_llm, FL, DA, cfg, params,
                     tokens, seed: int) -> list:
    """Phase 6: each attention kernel against its plain version on the
    LM path's own inputs."""
    records = []
    with CaptureFirst(FL, "flash_attention") as cap:
        Model(cfg).forward(params, {"tokens": tokens})
    (q, k, v), _ = cap.calls[0]
    check(tuple(q.shape) == (FWD_BATCH, cfg.n_heads, FWD_LEN, cfg.head_dim_)
          and q.dtype == torch.bfloat16, f"flash input {tuple(q.shape)}")
    records.append(flash_record(torch, F, FL, q, k, v, True,
                                "flash_attention_mma", faults=True))
    records.append(flash_record(torch, F, FL, q, k, v, False,
                                "flash_attention_mma[non-causal]",
                                faults=True))
    s2 = FWD_LEN - 96                    # not a multiple of the 64-row tile
    records.append(flash_record(
        torch, F, FL, *[t[:, :, :s2].contiguous() for t in (q, k, v)],
        True, f"flash_attention_mma[S={s2}]"))
    # the CUDA-core kernel, which the route keeps for f32 (and other D)
    records.append(flash_record(
        torch, F, FL, *[t.float() for t in (q, k, v)], True,
        "flash_attention_cuda_cores[f32]", faults=True))
    del q, k, v, cap

    with CaptureFirst(DA, "decode_attention") as cap:
        serve_llm.generate(LM_ARCH, reduced=False, batch=SERVE_BATCH,
                           prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                           params=params,
                           attn_impl="pallas")
    (q, k, v, lengths), _ = cap.calls[0]
    check(tuple(k.shape) == (SERVE_BATCH, cfg.n_kv,
                             SERVE_PROMPT + SERVE_GEN, cfg.head_dim_)
          and bool((lengths == SERVE_PROMPT + 1).all()),
          f"serving cache {tuple(k.shape)}, lengths {lengths.tolist()}")
    records.append(decode_record(torch, F, DA, q, k, v, lengths,
                                 "decode_attention"))
    del q, k, v, cap

    c = DECODE32K
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(c["b"], c["hkv"] * c["group"], c["d"], generator=g,
                    device="cuda").bfloat16()
    k = torch.randn(c["b"], c["hkv"], c["s"], c["d"], generator=g,
                    device="cuda").bfloat16()
    v = torch.randn(k.shape, generator=g, device="cuda").bfloat16()
    lengths = torch.randint(1, c["s"] + 1, (c["b"],), generator=g,
                            device="cuda", dtype=torch.int32)
    records.append(decode_record(torch, F, DA, q, k, v, lengths,
                                 "decode_attention[decode_32k]"))
    torch.cuda.synchronize()
    return records


def lm_main_path(torch, Model, serve_llm, FL, DA, cfg, params, tokens,
                 labels) -> dict:
    """Phase 7: the LM path's entry points at full width, with the
    kernels' launch counts reset just before and read just after."""
    out = {}
    FL.launches = FL.launches_mma = FL.launches_cuda_cores = 0
    DA.launches = 0
    model = Model(cfg)
    batch = {"tokens": tokens}

    def forward(m=model, kernel="mma"):
        before = (FL.launches_mma, FL.launches_cuda_cores)
        logits, _ = m.forward(params, batch)
        made = {"mma": FL.launches_mma - before[0],
                "cuda_cores": FL.launches_cuda_cores - before[1]}
        want = {k: cfg.n_layers if k == kernel else 0 for k in made}
        check(made == want, f"a forward launched the flash kernels "
              f"{made} times, not {want}")
        return logits

    logits = forward()
    check(tuple(logits.shape) == (FWD_BATCH, FWD_LEN, cfg.padded_vocab),
          f"logits {tuple(logits.shape)}")
    ref, _ = Model(dataclasses.replace(cfg, attn_impl="blockwise")
                   ).forward(params, batch)
    exact, _ = Model(dataclasses.replace(cfg, attn_impl="blockwise",
                                         compute_dtype=torch.float32)
                     ).forward(params, batch)
    noise = logit_err(torch, ref, exact, "blockwise bf16 vs f32")
    out["blockwise_vs_f32"] = noise
    out["forward_vs_f32"] = logit_err(torch, logits, exact,
                                      "forward pallas vs f32", noise)
    out["forward_vs_blockwise"] = logit_err(
        torch, logits, ref, "forward pallas vs blockwise", noise)
    del logits, ref
    # scoring in f32: the route sends f32 to the CUDA-core kernel
    f32_model = Model(dataclasses.replace(cfg, compute_dtype=torch.float32))
    out["forward_f32_vs_f32_blockwise"] = logit_err(
        torch, forward(f32_model, "cuda_cores"), exact,
        "forward pallas f32 vs f32 blockwise", noise)
    del exact
    out["forward_ms"] = host_ms(torch, forward, runs=5)
    loss, metrics = model.loss(params, {"tokens": tokens, "labels": labels})
    out["loss"] = float(loss)
    check(math.isfinite(out["loss"]) and
          abs(out["loss"] - math.log(cfg.vocab)) < 3.0,
          f"loss {out['loss']} far from ln(vocab) {math.log(cfg.vocab)}")

    kw = dict(reduced=False, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              params=params, attn_impl="pallas")
    serve_llm.generate(LM_ARCH, gen=2, **kw)           # warm-up
    before = FL.launches_mma
    res = serve_llm.generate(LM_ARCH, gen=SERVE_GEN, return_logits=True,
                             **kw)
    check(FL.launches_mma - before == cfg.n_layers,
          f"prefill launched the tensor-core flash kernel "
          f"{FL.launches_mma - before} times, not {cfg.n_layers}")
    st = res["stats"]
    out.update(prefill_ms=st.prefill_s * 1e3, decode_ms=st.decode_s * 1e3,
               decode_tokens_per_s=st.tokens_per_s)
    prompts = torch.as_tensor(serve_llm.synthetic_prompts(
        SERVE_BATCH, SERVE_PROMPT, cfg.vocab), device="cuda")
    comp = torch.as_tensor(res["completions"], device="cuda")
    seq = torch.cat([prompts, comp], dim=1)
    full, _ = model.forward(params, {"tokens": seq})
    out["prefill_vs_forward"] = logit_err(
        torch, res["prefill_logits"], full[:, SERVE_PROMPT - 1],
        "prefill vs forward", noise)
    dec_want = full[:, SERVE_PROMPT:]
    out["decode_vs_forward"] = logit_err(
        torch, res["decode_logits"], dec_want, "decode vs forward", noise)
    out["decode_argmax_agreement"] = float(
        (res["decode_logits"].argmax(-1) == dec_want.argmax(-1))
        .float().mean())
    del full, dec_want, res
    torch.cuda.synchronize()
    out["launches"] = {"flash_attention_mma": FL.launches_mma,
                       "flash_attention_cuda_cores": FL.launches_cuda_cores,
                       "decode_attention": DA.launches}
    want_dec = cfg.n_layers * (2 + SERVE_GEN)
    check(DA.launches == want_dec, f"decode_attention launched "
          f"{DA.launches} times on the main path, not {want_dec}")
    check(FL.launches == FL.launches_mma + FL.launches_cuda_cores,
          "flash_attention's launch counts do not add up")
    for k, n in out["launches"].items():
        check(n > 0, f"{k} was never launched on the main path")
    log(f"[lm] {json.dumps(out)}")
    return out


def lm_profile(torch, Model, serve_llm, cfg, params, tokens) -> dict:
    """Phase 7b: one profiled forward and four profiled decode steps:
    device time, busy share and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import param as PM

    model = Model(cfg)
    prompts = torch.as_tensor(serve_llm.synthetic_prompts(
        SERVE_BATCH, SERVE_PROMPT, cfg.vocab), device="cuda")
    lp = PM.cast_compute(params, cfg.compute_dtype)
    logits, caches = model.prefill(lp, {"tokens": prompts},
                                   cache_len=SERVE_PROMPT + SERVE_GEN)
    tok = logits.argmax(-1)
    runs = {
        "forward": lambda: model.forward(params, {"tokens": tokens}),
        "decode x4": lambda: [model.decode_step(lp, tok, caches,
                                                SERVE_PROMPT + i)
                              for i in range(4)],
    }
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) is not None
                   and "CUDA" in str(e.device_type)]
        dev = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "device_busy_share": dev / wall if wall else None,
                     "top": [[e.key[:70], e.self_device_time_total / 1e3,
                              e.count] for e in top]}
        log(f"[profile] {json.dumps({'lm': name, **out[name]})}")
    del caches
    return out


def lm_phases(torch, seed: int, launches_out: dict) -> list:
    """Phases 6, 7 and 7b; returns the kernel records."""
    import torch.nn.functional as F
    from repro_torch.configs import get
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FL
    from repro_torch.launch import serve_llm
    from repro_torch.models.modeling import Model

    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must run in full f32 (the plain versions' logits)")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get(LM_ARCH), attn_impl="pallas")
    model = Model(cfg)
    params = model.init(seed)
    torch.cuda.synchronize()
    log(f"[lm] {LM_ARCH}: {model.n_params()} parameters from seed {seed}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
        f"{time.perf_counter() - t0:.1f} s")
    tokens, labels = lm_inputs(torch, cfg, seed)
    log(f"[lm] flash_attention_mma resources by head width (registers and "
        f"local spill bytes per thread, shared bytes per block): "
        f"{json.dumps(FL.mma_resources())}")
    records = lm_kernel_checks(torch, F, Model, serve_llm, FL, DA, cfg,
                               params, tokens, seed)
    torch.cuda.empty_cache()
    main = lm_main_path(torch, Model, serve_llm, FL, DA, cfg, params,
                        tokens, labels)
    launches_out.update(main["launches"])
    torch.cuda.empty_cache()
    lm_profile(torch, Model, serve_llm, cfg, params, tokens)
    log(f"[lm] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phases 6-7 "
        f"took {time.perf_counter() - t0:.1f} s")
    return records


# ---------------------------------------------------------------------------
# phase 8: the paper's Q6/Q1 engine ladder, on the SF 10 context
# ---------------------------------------------------------------------------


def wall_ms(fn):
    """Result and wall ms of one run of ``fn`` (which ends on the host)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def q1_inputs(torch, ctx):
    """The hand-written Q1 row's inputs, built in torch from the device
    cache: group codes from the returnflag and linestatus dictionary codes
    (G = 6, the compiled engine's group order) and the two value columns
    with the rows past the cutoff zeroed."""
    li = ctx.catalog.table("lineitem")
    get = lambda n: ctx.cache.get(li, n)  # noqa: E731
    n_ls = len(li.dictionary("l_linestatus"))
    groups = len(li.dictionary("l_returnflag")) * n_ls
    codes = get("l_returnflag") * n_ls + get("l_linestatus")
    keep = get("l_shipdate") <= Q1_CUTOFF
    qty = torch.where(keep, get("l_quantity"), 0.0)
    price = torch.where(keep, get("l_extendedprice"), 0.0)
    return codes, qty, price, groups


def q6_columns(ctx):
    li = ctx.catalog.table("lineitem")
    return [ctx.cache.get(li, n) for n in ("l_quantity", "l_extendedprice",
                                           "l_discount", "l_shipdate")]


def ladder_q6(torch, ctx, Q, FQ, per_query, generic_ms, generic) -> dict:
    want = float(generic["q6"]["revenue"][0])
    volcano, v_ms = wall_ms(lambda: Q.q6(ctx).collect(engine="volcano"))
    stage = Q.q6(ctx).lower(engine="stage").compile()
    got_stage = stage()
    cols = q6_columns(ctx)
    hand = lambda: float(FQ.filter_agg_q6(*cols, **Q6_CONSTANTS))  # noqa
    rows = {"volcano": v_ms,
            "stage": host_ms(torch, lambda: stage.result()),
            "compiled": generic_ms["q6"],
            "compiled-native": per_query["q6"],
            "hand-written": host_ms(torch, hand)}
    for label, got in (("volcano", volcano["revenue"][0]),
                       ("stage", got_stage["revenue"][0]),
                       ("hand-written", hand())):
        check(abs(float(got) - want) <= RESULT_RTOL * abs(want),
              f"q6 {label} {float(got)} vs compiled {want}")
    return rows


def ladder_q1(torch, ctx, Q, SS, per_query, generic_ms, generic) -> dict:
    want = generic["q1"]
    volcano, v_ms = wall_ms(lambda: Q.q1(ctx).collect(engine="volcano"))
    assert_close(volcano, want, "q1 volcano")
    stage = Q.q1(ctx).lower(engine="stage").compile()
    assert_close(stage(), want, "q1 stage")

    def hand():
        codes, qty, price, groups = q1_inputs(torch, ctx)
        return (SS.segmented_sum(qty, codes, groups).cpu().numpy(),
                SS.segmented_sum(price, codes, groups).cpu().numpy())

    rows = {"volcano": v_ms,
            "stage": host_ms(torch, lambda: stage.result()),
            "compiled": generic_ms["q1"],
            "compiled-native": per_query["q1"],
            "hand-written": host_ms(torch, hand)}
    sum_qty, sum_price = hand()
    li = ctx.catalog.table("lineitem")
    rf, ls = li.dictionary("l_returnflag"), li.dictionary("l_linestatus")
    code = np.asarray([rf.index(a) * len(ls) + ls.index(b) for a, b in
                       zip(want["l_returnflag"], want["l_linestatus"])])
    for label, got, ref in (("sum_qty", sum_qty, want["sum_qty"]),
                            ("sum_base_price", sum_price,
                             want["sum_base_price"])):
        ref = np.asarray(ref, np.float64)
        check(bool(np.all(np.abs(got[code] - ref) <= RESULT_RTOL
                          * np.abs(ref))),
              f"q1 hand-written {label} {got[code]} vs compiled {ref}")
        rest = np.setdiff1d(np.arange(len(got)), code)
        check(bool(np.all(got[rest] == 0)), f"q1 hand-written {label}: "
              "a group the compiled q1 does not emit is not 0")
    return rows


def stage_suite(torch, ctx, Q, generic) -> dict:
    """The stage engine (the reference's default) on every query, every
    template binding and q22 in two phases, against the compiled
    lowering; returns the wall ms of each run."""
    out = {}
    for name, build in Q.QUERIES.items():
        got, out[name] = wall_ms(
            lambda: build(ctx).lower(engine="stage").compile()())
        assert_close(got, generic[name], f"stage {name}")
    for tname, build in Q.TEMPLATES.items():
        for b in Q.TEMPLATE_BINDINGS[tname]:
            key = (tname, json.dumps(b, sort_keys=True))
            got, out[f"template:{tname} {key[1]}"] = wall_ms(
                lambda: build(ctx).lower(engine="stage").compile()(**b))
            assert_close(got, generic[key], f"stage template {tname} {b}")
    binding = Q.q22_params(ctx, engine="stage")
    native = Q.q22_params(ctx, engine="compiled-native")
    check(abs(binding["acctbal_min"] - native["acctbal_min"])
          <= RESULT_RTOL * abs(native["acctbal_min"]),
          f"q22 phase 1 on stage {binding} vs native {native}")
    got, out["q22 two-phase"] = wall_ms(
        lambda: Q.q22(ctx).lower(engine="stage").compile()(**binding))
    assert_close(got, Q.q22(ctx).lower(engine="compiled").compile()(
        **binding), "stage q22 two-phase")
    return out


def tuple_goldens(torch, FlareContext, Q) -> dict:
    """The row-at-a-time engine at the goldens' scale, SF 0.01 (60 M rows
    one at a time would take hours): q1, q6, q14 against tests/golden and
    against the port's volcano engine; returns the wall ms of each."""
    ctx = FlareContext(device="cuda")
    Q.register_tpch(ctx, sf=0.01, seed=0)
    out = {}
    for q in ("q1", "q6", "q14"):
        with open(os.path.join(ROOT, "tests", "golden", f"{q}.json")) as f:
            gold = json.load(f)
        got, out[q] = wall_ms(lambda: Q.QUERIES[q](ctx).collect(
            engine="tuple"))
        oracle = Q.QUERIES[q](ctx).collect(engine="volcano")
        for label, want in (("golden", gold["columns"]), ("volcano", oracle)):
            for k, v in want.items():
                a, b = np.asarray(got[k]), np.asarray(v)
                if a.dtype == object or b.dtype.kind in "OUS":
                    a, b = sorted(map(str, a)), sorted(map(str, b))
                    check(a == b, f"tuple {q}/{k} vs {label}: strings")
                    continue
                a, b = np.sort(a.astype(np.float64)), np.sort(
                    b.astype(np.float64))
                check(a.shape == b.shape and bool(np.all(
                    np.abs(a - b) <= RESULT_RTOL * np.abs(b) + 1e-6)),
                    f"tuple {q}/{k} vs {label}")
    return out


def dyadic_checks(torch, FQ, SS, seed: int) -> None:
    """Both kernels bit for bit against plain on inputs where every
    summation order gives the same f32 sum (prices multiples of 1/4 below
    1 times discounts 7/128, 8/128 or 1/8; values multiples of 1/4 in
    [-8, 8)), at ragged lengths and through column views that start one
    element in (pointers 4 bytes past a 16-byte boundary): a dropped tail
    row or vector lane shows as a mismatch."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = max(RAGGED) + 1
    qty = torch.randint(1, 50, (m,), generator=g, device="cuda").float()
    price = torch.randint(0, 4, (m,), generator=g, device="cuda").float() / 4
    disc = torch.tensor([7 / 128, 8 / 128, 1 / 8], device="cuda")[
        torch.randint(0, 3, (m,), generator=g, device="cuda")]
    date = torch.randint(Q6_CONSTANTS["date_lo"] - 60,
                         Q6_CONSTANTS["date_hi"] + 60, (m,), generator=g,
                         device="cuda", dtype=torch.int32)
    values = torch.randint(-32, 32, (m,), generator=g,
                           device="cuda").float() / 4
    checked = 0
    for n in RAGGED:
        for off in (0, 1):
            cols = [t[off:off + n] for t in (qty, price, disc, date)]
            got = FQ.filter_agg_q6(*cols, **Q6_CONSTANTS)
            want = FQ.filter_agg_q6_plain(*cols, **Q6_CONSTANTS)
            check(torch.equal(got, want), f"filter_agg_q6 dyadic n={n} "
                  f"offset {off}: {float(got)} vs {float(want)}")
            for groups in (6, 512):
                codes = torch.randint(-2, groups + 2, (n,), generator=g,
                                      device="cuda", dtype=torch.int32)
                c = torch.empty(n + off, dtype=torch.int32,
                                device="cuda")[off:]
                c.copy_(codes)
                v = values[off:off + n]
                got = SS.segmented_sum(v, c, groups)
                want = SS.segmented_sum_plain(v, c, groups)
                check(torch.equal(got, want), f"segmented_sum dyadic n={n} "
                      f"G={groups} offset {off}: max abs err "
                      f"{float((got - want).abs().max())}")
                checked += 1
    log(f"[ladder] dyadic bit-for-bit checks passed: {len(RAGGED) * 2} "
        f"filter_agg_q6, {checked} segmented_sum (lengths {list(RAGGED)}, "
        f"aligned and one element in)")


def q6_record(torch, FQ, cols, launches: int) -> dict:
    got = FQ.filter_agg_q6(*cols, **Q6_CONSTANTS)
    want = FQ.filter_agg_q6_plain(*cols, **Q6_CONSTANTS)
    err = compare(torch, got.reshape(1), want.reshape(1), "filter_agg_q6")
    n = cols[0].numel()
    # per row: five comparisons, four ands, a select, a product, an add
    b, by = bound_ms(nbytes(list(cols) + [got]), 12 * n)
    return dict(
        name="filter_agg_q6", route="cuda",
        source="src/repro_torch/kernels/csrc/filter_agg_q6.cuh",
        replaces="src/repro/kernels/filter_agg/kernel.py:58",
        shape=f"q6: {n} rows x 4 cols", launches=launches,
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: FQ.filter_agg_q6(*cols, **Q6_CONSTANTS)),
        plain_ms=cuda_ms(torch, lambda: FQ.filter_agg_q6_plain(
            *cols, **Q6_CONSTANTS)),
        bound_ms=b, bound_by=by, library_ms=None)


def segsum_record(torch, SS, values, codes, groups: int, label: str,
                  launches: int) -> dict:
    got = SS.segmented_sum(values, codes, groups)
    want = SS.segmented_sum_plain(values, codes, groups)
    err = compare(torch, got, want, label)
    n = values.numel()
    # per row: two range comparisons and one add
    b, by = bound_ms(nbytes([values, codes, got]), 3 * n)
    return dict(
        name=label, route="cuda",
        source="src/repro_torch/kernels/csrc/segmented_sum.cuh",
        replaces="src/repro/kernels/segmented_reduce/kernel.py:73",
        shape=f"{n} rows, G={groups}", launches=launches, max_abs_err=err,
        ms=cuda_ms(torch, lambda: SS.segmented_sum(values, codes, groups)),
        plain_ms=cuda_ms(torch, lambda: SS.segmented_sum_plain(
            values, codes, groups), runs=5, warmup=1),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.bincount(
            codes, weights=values, minlength=groups)))


def direct_csv(torch, FlareContext, Q, io) -> dict:
    """The paper's "direct from CSV" row, on the host: lineitem at SF 0.1
    written with ``io.to_csv``, then ``read_csv_compiled`` plus compiled
    q6 against q6 over the preloaded table."""
    pre = FlareContext(device="cuda")
    Q.register_tpch(pre, sf=0.1, seed=0)
    pre.preload("lineitem")
    li = pre.catalog.table("lineitem")
    path = os.path.join(ROOT, "build", "csv", "lineitem_sf0.1.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _, write_ms = wall_ms(lambda: io.to_csv(li, path))
    try:
        def direct():
            ctx = FlareContext(device="cuda")
            ctx.register("lineitem", io.read_csv_compiled(path, li.schema))
            return Q.q6(ctx).lower(engine="compiled").compile()()
        got, direct_ms = wall_ms(direct)
    finally:
        os.remove(path)
    compiled = Q.q6(pre).lower(engine="compiled").compile()
    want = compiled()
    assert_close(got, want, "q6 direct from CSV")
    return {"rows": li.num_rows, "to_csv_ms": write_ms,
            "direct_csv_q6_ms": direct_ms,
            "preloaded_q6_ms": host_ms(torch, lambda: compiled.result())}


def engine_ladder(torch, ctx, Q, per_query, generic_ms, generic,
                  seed: int) -> list:
    """Phase 8; returns the kernel records of its two kernels."""
    from repro_torch.core import FlareContext
    from repro_torch.data import io
    from repro_torch.kernels.filter_agg import ops as FQ
    from repro_torch.kernels.segmented_reduce import ops as SS

    t0 = time.perf_counter()
    # the ladder drives both hand-written rows: launches counted from here
    FQ.launches = SS.launches = 0
    q6 = ladder_q6(torch, ctx, Q, FQ, per_query, generic_ms, generic)
    q1 = ladder_q1(torch, ctx, Q, SS, per_query, generic_ms, generic)
    torch.cuda.synchronize()
    launches = {"filter_agg_q6": FQ.launches, "segmented_sum": SS.launches}
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the engine ladder")
    for q, rows in (("q6", q6), ("q1", q1)):
        ratio = rows["compiled"] / rows["hand-written"]
        log(f"[ladder] {json.dumps({'query': q, 'sf_rows': len(q6_columns(ctx)[0]), 'ms': rows, 'compiled_over_hand_written': ratio, 'native_over_hand_written': rows['compiled-native'] / rows['hand-written']})}")
    log(f"[ladder] launches on the ladder: {json.dumps(launches)}")

    suite = stage_suite(torch, ctx, Q, generic)
    log(f"[ladder] stage engine, every query, binding and q22 two-phase "
        f"equal to compiled; wall ms: {json.dumps(suite)}")
    tup = tuple_goldens(torch, FlareContext, Q)
    log(f"[ladder] tuple engine at SF 0.01 equals the goldens and volcano; "
        f"wall ms: {json.dumps(tup)}")

    # each kernel against its plain version (launches here do not count)
    cols = q6_columns(ctx)
    records = [q6_record(torch, FQ, cols, launches["filter_agg_q6"])]
    codes, qty, _, groups = q1_inputs(torch, ctx)
    check(groups == 6, f"q1 has {groups} groups")
    records.append(segsum_record(torch, SS, qty, codes, groups,
                                 "segmented_sum", launches["segmented_sum"]))
    g = torch.Generator(device="cuda").manual_seed(seed)
    price = cols[1]
    codes512 = torch.randint(0, 512, price.shape, generator=g,
                             device="cuda", dtype=torch.int32)
    records.append(segsum_record(torch, SS, price, codes512, 512,
                                 "segmented_sum[G512]",
                                 launches["segmented_sum"]))
    del codes, qty, codes512
    dyadic_checks(torch, FQ, SS, seed)
    before = SS.launches
    for groups in (513, 700):
        codes = torch.randint(0, groups, (4097,), generator=g, device="cuda",
                              dtype=torch.int32)
        vals = price[:4097]
        got = SS.segmented_sum(vals, codes, groups)
        check(torch.equal(got, SS.segmented_sum_plain(vals, codes, groups)),
              f"segmented_sum G={groups} scatter route")
    check(SS.launches == before, "segmented_sum launched its kernel above "
          "MAX_GROUPS")
    for r in records:
        log("[kernel] " + json.dumps(r))

    csv = direct_csv(torch, FlareContext, Q, io)
    log(f"[ladder] direct from CSV: {json.dumps(csv)}")
    log(f"[ladder] phase 8 took {time.perf_counter() - t0:.1f} s")
    return records


def run(sf: float, seed: int) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch.launch.serve_llm  # noqa: F401
        import repro_torch.relational.queries  # noqa: F401
        from repro_torch.kernels import cuda_build as CB
    except ImportError as ex:
        print(f"chip_smoke: the repro_torch package is missing ({ex})",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    card = environment(torch, CB)
    from repro_torch.kernels.filter_agg import ops as FQ
    from repro_torch.kernels.segmented_reduce import ops as SS
    fixed = [CB.fixed_unit("flash_attention.cuh"),
             CB.fixed_unit("flash_attention_mma.cuh"),
             CB.fixed_unit("decode_attention.cuh"),
             FQ.unit_source(**Q6_CONSTANTS), SS.unit_source()]
    records = tpch_phases(torch, sf, seed, fixed, t_all)
    torch.cuda.empty_cache()
    lm_launches: dict = {}
    lm_records = lm_phases(torch, seed, lm_launches)
    for r in lm_records:
        r["launches"] = lm_launches[r["name"].split("[")[0]]
    log(f"[summary] total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": records + lm_records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def tpch_phases(torch, sf: float, seed: int, fixed, t_all: float) -> list:
    """Phases 2-5 (TPC-H); returns the kernel records."""
    from repro_torch.core import (FlareContext, any_, avg, col, count, lit,
                                  sum_)
    from repro_torch.kernels import cuda_build as CB
    from repro_torch.kernels.filter_agg import kernel as FA
    from repro_torch.kernels.join_probe import kernel as JP
    from repro_torch.kernels.segmented_reduce import kernel as SR
    from repro_torch.relational import queries as Q

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
    CB.build_all(list(sources) + fixed)
    # q22's phase 1 (the scalar subquery) is a fragment of its own
    Q.q22_params(ctx, engine="compiled-native")
    log(f"[build] {len(sources) + 1 + len(fixed)} kernel units of the "
        f"suite ({len(fixed)} fixed units), {CB.builds} "
        f"nvcc builds, {time.perf_counter() - t0:.1f} s, into "
        f"{CB.BUILD_DIR}")

    records = kernel_checks(torch, ctx, Q, FA, SR, JP, col, sum_, avg,
                            count, any_, lit)
    per_query, generic_ms, generic, launches = main_path(torch, ctx, Q, FA,
                                                         SR, JP, CB)
    for r in records:
        r["launches"] = launches[r["name"].split("[")[0]]
    device_breakdown(torch, ctx, Q)
    goldens(torch, FlareContext, Q)
    log(f"[summary] per-query steady-state ms at SF {sf}: "
        f"{json.dumps(per_query)}")
    log(f"[summary] generic lowering, steady-state ms at SF {sf}: "
        f"{json.dumps(generic_ms)}")
    log(f"[summary] TPC-H phases 2-5 {time.perf_counter() - t_all:.1f} s")
    records += engine_ladder(torch, ctx, Q, per_query, generic_ms, generic,
                             seed)
    del ctx
    torch.cuda.empty_cache()
    return records


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
