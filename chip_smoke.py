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
   with an ``any_`` max slot, q14, q19, q5 and q3): ``filter_agg_general``,
   ``segmented_multi_sum`` and ``join_probe_agg`` keyless (q14, q19),
   grouped in shared memory (q5) and grouped by global atomics (q3), and
   on q14's index with every other part dropped (gapped: the search
   route); kernel, plain and library-call times by CUDA events, the bound
   from bytes and operations.  For ``join_probe_agg`` also: every
   single-column primary-key index dense and identity and partsupp's
   composite one not dense; ``device_ms`` (a CUDA graph of one call
   replayed after an L2 flush) and ``search_device_ms`` (the same call
   with the index's ``meta`` zeroed: the binary-search route of the same
   kernel), keyless results bit-identical between the two routes;
   ``bound_ms`` from the bytes the work needs (the mask, the key columns'
   sectors holding a valid row, the other probe columns' sectors holding
   a matched row, the matched build rows) beside
   ``bound_all_rows_ms`` (every probe and build column read in full),
   the shared accumulator's copies (``reps``) and the unit's registers,
   spill bytes, shared bytes and resident blocks per SM (the grid is
   that many blocks per SM);
4. the main path: all TPC-H queries and every template binding through
   ``lower(engine="compiled", native=True).compile()``, the fired patterns
   held against ``EXPECTED_PATTERNS``, each result against the generic
   ``compiled`` lowering, each kernel's launch count (reset just before,
   read just after), steady-state ms per query, one build per template;
   then one profiled run per query: device time, busy share, top kernels
   (a warmed profiler step), and the busy share of a profile without the
   warm step, the kind of profile earlier versions of this script took;
5. goldens: q1, q6, q13 and q14 at SF 0.01 against ``tests/golden``;
6. the LM path's kernels against their plain versions, on the path's own
   inputs, after lines with the tensor-core flash kernel's and the decode
   kernel's registers, shared memory and spill bytes:
   ``flash_attention`` on layer 0's q/k/v of the full-width
   ``qwen3-0.6b`` forward -- the tensor-core kernel (B 4 x S 4096, bf16,
   causal; also non-causal, and S 4000, not a multiple of the tile) and
   the CUDA-core kernel on the same inputs in f32, and in bf16 at
   recurrentgemma-2b's layer shape on inputs from the seed (B 8 x H 10
   (Hkv 1) x S 2048 x D 256, causal; its rolled-heads fault rolls the
   batch rows) --, the tensor-core kernel at D 160 on seeded inputs (B 1
   x H 4 (Hkv 1) x S 256, causal) against an emulation of its arithmetic
   with and without the split of P into two bf16 parts (it must lie far
   nearer the split one), ``decode_attention``
   on the serving path's layer-0 cache after prefill (B 8, 2048 + 1
   positions) and at ``decode_32k``'s length (B 8, S 32 768, lengths from
   the seed); each held to one rounding of its plain version's output
   (bf16, or the f32 kernel tests' limit), a limit that must also reject
   faults planted on the same inputs (among them the KV heads rolled by
   one); kernel, plain and ``scaled_dot_product_attention`` times by
   events around eager calls, the bound; for decode also two calls
   bit-identical, the schedule the kernel wrote (chunk, items) against
   its Python mirror, ``device_ms`` and ``library_device_ms`` (a CUDA
   graph of one call replayed after an L2 flush, median), the wrapper's
   host microseconds per call, and ``no_memset_device_ms``: the kernel
   built without its ticket memset (the folding block resets the ticket),
   bit-identical to the kernel;
7. the LM main path, weights from the seed on the card: ``Model.forward``
   with ``attn_impl="pallas"`` at B 4 x S 4096 (28 tensor-core flash
   launches per forward) against ``attn_impl="blockwise"``, its
   steady-state ms and ``Model.loss``; the same forward in f32 (28
   CUDA-core flash launches) against the f32 blockwise forward;
   ``serve_llm.generate`` at B 8 x 2048 + 32 tokens (prefill ms, decode
   ms, tokens/s; prefill takes the tensor-core kernel on every layer);
   the prefill and decode logits against a forward over prompt +
   completion; launch counts (reset just before, read just after); one
   profiled forward and four decode steps profiled four times with a
   warm step and four times without (``flare_decode_kernel`` launched
   once per wrapper call in more than half of the profiles: the decode
   records' ``launches_per_call``;
   each profile's device events and those it missed against the
   fullest);
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
   unaligned views; G 513 and 700 launch nothing), with ``device_ms`` for
   ``segmented_sum`` and ``library_device_ms`` for ``bincount`` (its
   kernels' device time by torch.profiler, the median of three profiles
   that saw the same events: it syncs with the host, so no graph holds
   it) and the accumulator's copies (``reps``); the direct-from-CSV
   row (lineitem at SF 0.1 through ``io.to_csv`` and
   ``read_csv_compiled``, then compiled q6) against the preloaded q6;
9. the heterogeneous pipelines (paper Fig. 8 / 13), after phase 8 on the
   same context: ``benchmarks/bench_ml.py``'s points table at 10 M rows
   (d 8, seed 0, ``quality > 0.1``) through kmeans (k 4), logreg, gda, a
   ``map_batches`` (torch ops) and a ``@udf`` select; each fused
   (``compiled``) against staged (``stage``: the same iterations, fields
   at rtol 1e-4) and ``compiled-native`` (its fired patterns printed),
   host ms (median of 5), one profile of each (device ms, busy share,
   device-to-host copies), the per-iteration bound; kmeans, logreg and
   gda with tol 0 and a fixed ``max_iter`` against the volcano oracle on
   the host, once (the reference tests' limits); ``group_by_reduce``
   alone by both routes at k 4 to 64 (equal sums, CUDA-event ms); the
   Fig. 8 shape on the SF 10 lineitem (shipped in 1995, a
   ``map_batches`` log price, kmeans k 8 over four columns), fused
   against staged.  Its lines are
   tagged ``[hetero]``; it launches none of the seven kernels but the
   one ``compiled-native`` fires on the ``map_batches`` aggregate;
10. template serving, after phase 9 on the same context: the templates
   q6, q14, q19 and q22 (its first binding from ``q22_params``) at B 1,
   4, 8, 16 and 64 bindings from ``random_bindings``, each served one at
   a time by ``Compiled.result`` on ``compiled``, one at a time by
   ``Compiled.submit`` on ``compiled-native`` (the kernels: launches
   reset to 0 before the phase and read after it, the records'
   ``serving_launches``; each template's kernel at least once per
   binding) and through ``QueryServer(ctx, engine="compiled")`` (submit,
   flush, read every future: one vmapped ``Compiled.batch``, which
   launches none of the kernels); every served result equal to both at
   rtol 5e-3; req/s and p50/p99 latency of each way, occupancy, coalesce
   ratio, the first batch's wall and build seconds, the peak device
   bytes of the server's run (after a reset); exactly one batched
   program per (template, bucket) in the ``CompileCache``; each batch's
   ``raw`` under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   sync); a batch of 8 q6 bindings with one poisoned (an unknown
   parameter) that fails only that future, the 7 others equal to their
   sequential results, by bisection.  Its lines are tagged ``[serve]``;
12. out-of-core morsel execution, after phase 10 on the same context:
   q1, q3, q6 and ``join_micro`` on ``compiled`` and ``compiled-native``
   at ``memory_budget`` 8 GiB (every query fits whole: no loop), 1 GiB,
   256 MiB and 64 MiB (q6: 1 / 2 / 8 / 29 morsels at SF 10), each run
   against the monolithic ``compiled`` run (rtol 5e-3; integer columns
   exactly, except a native run whose kernel counted more than 2^24
   rows in one launch in its f32 slot) with the monolithic run's fired
   patterns, the fragment's kernel launched once per morsel (launches
   reset to 0 before the phase, read after it: the records'
   ``morsel_launches``), no nvcc build; per run ``morsel_rows``, morsels, the modelled working set,
   host ms (median of 5) and the peak device bytes above the resident
   columns beside the monolithic run's (``compiled``'s q1 and q6 below
   it at 256 MiB, a gate); ``morsel.loop`` armed ``first:1`` on q6's
   template degrading its native compile to ``compiled`` with the loop
   kept, equal to the volcano oracle.  Its lines are tagged
   ``[morsel]``;
13. the sharded ``parallel`` engine, after phase 12 on the same context:
   each shard a row range of the spine (``ceil(rows / n)`` rounded up to
   128 rows) on the one card; first each main-path kernel against its
   plain version on every shard's own inputs (captured from one native
   run at 4 shards of q6, q1, q19 and q3; every view 16-byte aligned);
   then q1, q3, q6, q14 and q19, the q6 and q14 templates (two bindings
   each) and a gather plan (a filter, then sort and limit) on
   ``parallel`` and ``parallel`` with ``native=True`` at 1, 2, 4 and 8
   shards, each against the monolithic ``compiled`` run (rtol 5e-3;
   integers exactly wherever no launch counted more than 2^24 rows),
   with phase 4's fired patterns, the fragment's kernel launched exactly
   once per shard (launches reset to 0 just before each run, read just
   after: the records' ``parallel_launches``), one compile per mesh
   shape (the second binding a cache hit), no nvcc build; host ms
   (median of 5) of q1, q3, q6 and q19 beside the monolithic runs'; the
   peak device bytes above the resident columns of q1 and q3 at 1 and 8
   shards; native q1 at 4 shards under a 256 MiB budget (shards x
   morsels launches); ``compile.xla`` armed ``first:1`` on q6's native
   parallel template: one ``parallel -> compiled`` hop and the right
   answer.  Its lines are tagged ``[parallel]``;
11. runtime services, after phase 13: (a) the restart -- two fresh
   processes, each from a fresh copy of ``src/repro_torch`` (what ``git
   archive`` holds of the package) with an empty ``build/kernels/``,
   against one new store under ``build/runtime/``, each running the four
   templates and the nine queries on ``compiled-native`` at the phase's
   SF after ``preload``; the cold one builds every unit with nvcc (the
   templates' one at a time, the queries' all at once) and every join
   index, the warm one must build none: 0 nvcc builds, a ``hit:native``
   disk hit for every template and query (a hit that needed units and
   built none; a hit with no unit is ``hit:layout``), at least one unit
   loaded from the store by each template's compile, no store write or
   miss, index
   hits with ``meta`` equal to the cold build's, all three main-path
   kernels launched (counts reset to 0 before the run, read after),
   results equal to the cold ones (floats within 1e-5 relative);
   each template's first-query ms cold / warm-disk / warm-memory (the
   columns of ``benchmarks/bench_coldstart.py``) and each stored index's
   load ms against a device rebuild of it; (b) the ladder on the SF
   context: ``native.kernel`` armed ``first:1`` makes q6 answer from
   ``compiled`` with one event and the result equal to ``compiled``'s,
   ``FLARE_DEGRADE=off`` raises ``KernelBudgetError``, a unit nvcc
   refuses raises ``UnitBuildError`` out of ``compile()`` with no hop;
   (c) q6 and q19 traced, dumped as Chrome JSON and rebuilt with
   ``spans_from_chrome``; one ``torch.profiler`` window in which the
   launch of the ``flare_filter_agg`` kernel, found by the kernel's
   correlation id, lies inside the ``flare:filter-scalar-agg`` range;
   ``explain(analyze=True)`` of q6 and q19 naming the fired pattern and
   the index provenance.  Its lines are tagged ``[runtime]``;
14. the LM train step, after phases 6-7 (the TPC-H context and the
   serving weights released): full-width ``qwen3-0.6b`` (f32 master
   weights, bf16 compute, remat ``full``, ``attn_impl="ring"``: the
   blockwise attention on one card) through ``launch.train.train_loop``
   at B 4 x S 4096 on ``LMDataPipeline.synthetic`` (400 documents
   through the ``compiled`` ETL); first one bf16 step against the same
   step computed in f32 on one row (the loss within one bf16 rounding,
   every leaf's gradient at cosine >= 0.99); then 20 steps of
   ``warmup_cosine`` with a checkpoint at steps 10 and 20 (the mean loss
   of the last 3 below the first 3's), and a fresh run resumed from step
   10 (each loss of steps 10-19 within 1e-3 relative of the first
   run's); the attention kernels' launch counts reset before and read
   after (none may run: neither has a backward pass); step ms (median,
   host clock after a sync), tokens/s, peak device memory, the
   checkpoint's bytes and save and restore ms, the step's bound; one
   profiled step (device ms, busy share, top kernels).  Its lines are
   tagged ``[train]``.
15. the MoE family and the configs past qwen3, after phase 14 (its
   state freed): (a) ``olmoe-1b-7b`` at full width from the seed (the
   bf16 copy only, each stacked layer weight at its own contraction's
   fan-in), served B 8 x 2048 + 32 greedy tokens through
   ``serve_llm.generate`` with the kernels' counts reset before and read
   after (flash 16, decode 512), prefill ms, decode tokens/s, peak
   bytes, slots dropped per layer; a timed and a profiled prefill of
   token ids drawn over the vocab (the serving prompts are mostly
   padding); flash at its layer-0 shape and decode at group 1 against
   their plain versions; the MoE gate on two batches of such token ids
   (:func:`moe_gate`: layer 0 against :func:`moe_reference`, the logits
   and route sets of the kernel path against flash's plain version, each
   part against planted faults; beside part 3, the share of route sets
   that differ with SDPA in flash's place); (b) ``decode_attention``
   against its plain version at groups 9 (D 128) and 10 (D 256), with
   planted faults; (c) ``starcoder2-7b`` (D 128) and ``pixtral-12b`` (D
   160, with its seeded 256-row prefix) at full width with 4 layers, B 8
   x 2048 and 4 decode steps, both with flash on the tensor cores (4
   launches each, none on the CUDA cores), the prefill logits against
   the blockwise path's within the bf16 budget, flash at its shape; (d)
   flash on the tensor cores at pixtral's shape (B 8 x H 32 (Hkv 8) x S
   2304 x D 160, causal) on inputs from the seed, with phase 6's planted
   faults, and its registers and spill bytes.  Its lines are tagged
   ``[moe]``;
16. the encdec family, after phase 15 (its state freed):
   ``seamless-m4t-large-v2`` at full width and depth from the seed (12
   encoder and 12 decoder layers, each stacked weight at its own
   fan-in); its f32 blockwise prefill first, for the budget, then the
   f32 masters freed; (a) served B 8 x 2048 + 32 greedy tokens through
   ``serve_llm.generate`` with 512 seeded frame embeddings, the kernels'
   counts reset before and read after (flash 24 on the tensor cores: 12
   non-causal in the encoder, 12 causal in the decoder's prefill;
   decode 384), prefill ms, decode tokens/s, peak bytes; (c) the gate:
   the served prefill logits within the bf16 budget (blockwise bf16
   against blockwise f32) of the blockwise bf16 path's, the first decode
   step's logits within it of a forward's (2 rows), and three planted
   faults beyond it -- frames from another seed, the cross attention
   skipped in every decoder layer, the encoder run causally; (b) flash
   at the encoder's (S 512, non-causal) and the decoder's (S 2048,
   causal) layer-0 inputs and decode at the first step's (group 1, D
   64, lengths 2049) against their plain versions with phase 6's planted
   faults, taken from a kernel-path prefill of token ids drawn over the
   vocab.  Its lines are tagged ``[encdec]``;
17. the ssm family, after phase 16 (its state freed): ``mamba2-130m`` at
   full width and depth from the seed (each stacked mixer matrix at its
   own fan-in, the per-head decays drawn as the Mamba2 reference draws
   them); (a) served B 8 x 2048 + 32 greedy tokens through
   ``serve_llm.generate`` on token ids drawn over the vocab, prefill ms,
   decode ms and tokens/s, peak bytes, the parameter count beside the
   JAX package's, the attention kernels' counts reset before and read
   after (none: the family has no attention); (b) the gate: the served
   prefill logits and every decode step's within the bf16 budget (a
   bf16 forward over prompt and completion against the f32 forward) of
   the bf16 forward's at the same positions, and three planted faults
   beyond it over the first decode steps -- the decay skipped in the
   decode step, the conv tail taken one position early, the decode
   started from a zeroed state; (c) ``long_500k``: B 1, a prompt of
   524 032 seeded token ids, 256 greedy tokens through
   ``serve_llm.generate``, prefill ms, decode tokens/s, peak bytes
   against the card's, the last decode step's logits within the budget
   (``Model.prefill`` over all 524 288 tokens in bf16 against f32) of
   the bf16 prefill's; (d) five train steps at B 4 x S 4096 through
   ``launch.train.train_loop`` on synthetic documents, step ms,
   tokens/s, peak bytes, a finite loss; (e) device profiles of four
   decode steps at B 8 and of the ``long_500k`` prefill through its
   first 2 layers (device ms, busy share, launches, top kernels).  Its
   lines are tagged ``[ssm]``.

The line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
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


#: graph_ms: bytes read between replays to evict the 50 MB L2 cache (a
#: read, so no dirty lines are written back during the timed replay), and
#: the sleep that holds the stream while the host launches the replay
L2_FLUSH_BYTES = 128 << 20
SLEEP_CYCLES = 200_000


def graph_ms(torch, fn, runs: int = 20) -> float:
    """Device ms of one call of ``fn``: a CUDA graph of the call, replayed
    between two events, each replay after an L2 flush and behind a sleep
    that hides the host's launch; the median of ``runs`` replays."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    flush = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    times = []
    for _ in range(runs + 1):
        flush.amax()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph, flush
    return float(np.median(times[1:]))


#: Ranges torch.profiler also lists as device events, over the kernels
#: they enclose: the step's own annotation and the port's kernel scopes
#: (``repro_torch.obs.export.kernel_scope``, "flare:<pattern>").
ANNOTATIONS = ("ProfilerStep", "flare:")


def device_work(e) -> bool:
    """Is profiler event ``e`` (or an average of such) a kernel or copy
    on the device, not an annotation range over them?"""
    return ("CUDA" in str(getattr(e, "device_type", ""))
            and not e.key.startswith(ANNOTATIONS)
            and not getattr(e, "is_user_annotation", False))


def in_launch_order(events) -> list:
    """Names of the device events (kernels and copies) among a profile's
    ``events``, by start time."""
    dev = [e for e in events if device_work(e)]
    return [e.name for e in sorted(dev, key=lambda e: e.time_range.start)]


def profiled(torch, fn, warm=None):
    """The device events (kernels and copies) of one call of ``fn`` by
    torch.profiler (CUPTI), its wall ms, and the events' names in launch
    order.  The profiler records its second step only: the first
    (``warm``, else ``fn``) runs while tracing comes up, whose cost would
    otherwise land in the wall time (:func:`profiled_cold` is the kind
    without it).  Either kind can miss device events at random
    (:func:`lost_events`), and one profile of a call (phase 8, ``bincount``)
    held an event more than the others, so a caller that needs every event
    takes several profiles and keeps those that agree."""
    from torch.profiler import ProfilerActivity, profile, schedule

    done = []   # the recorded step's events, handed over as it ends
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: done.append(
                     (p.key_averages(), in_launch_order(p.events())))
                 ) as prof:
        (warm or fn)()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    check(len(done) == 1, "the profiler recorded no step")
    events = [e for e in done[0][0] if device_work(e)]
    return events, wall, done[0][1]


def profiled_cold(torch, fn):
    """:func:`profiled` of the kind earlier versions took: tracing comes up
    around the one call of ``fn``, with no step before it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if device_work(e)]
    return events, wall, in_launch_order(prof.events())


def lost_events(want: list, got: list) -> list:
    """The events of ``want`` (names in launch order) that ``got`` lacks,
    as ``[index in want, name]``; ``want`` is walked in order, so an
    event that ``got`` holds out of order counts as lost."""
    lost, j = [], 0
    for i, name in enumerate(want):
        if j < len(got) and got[j] == name:
            j += 1
        else:
            lost.append([i, name[:50]])
    return lost


def profiled_device_ms(torch, fn, agree: int = 3, most: int = 15):
    """Device ms of one call of ``fn`` that a CUDA graph cannot capture
    (it syncs with the host): the device time of every kernel and copy the
    call launched, by :func:`profiled`, each call after an L2 flush.  A
    profile can miss events or hold one that is not the call's, so it
    profiles until ``agree`` profiles saw the same device events in the
    same order (at most ``most`` profiles) and takes the median over
    those.  Returns it and each profile's count of device events."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")

    def warm_then_flush():
        fn()
        flush.amax()

    times, seqs = [], []
    while len(seqs) < most:
        events, _, names = profiled(torch, fn, warm=warm_then_flush)
        times.append(sum(e.self_device_time_total for e in events) / 1e3)
        seqs.append(tuple(names))
        if names and seqs.count(seqs[-1]) >= agree:
            break
    del flush
    counts = [len(q) for q in seqs]
    check(bool(seqs[-1]) and seqs.count(seqs[-1]) >= agree,
          f"no {agree} of {len(seqs)} profiles saw the call's device events "
          f"alike: events {counts}")
    full = [t for t, q in zip(times, seqs) if q == seqs[-1]]
    return float(np.median(full)), counts


def wrapper_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``: the wall time of ``calls``
    calls issued without a sync, over ``calls``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


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
    from repro_torch.core import FlareContext
    from repro_torch.core import engines as ENG
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

    # -- join_probe_agg: q14 and q19 keyless, q5 shared, q3 global, and a
    # gapped index (the search route) -----------------------------------------
    index_routes(torch, ctx, FlareContext, Q, JP, col, sum_)
    for qname, mode in PROBE_RECORDS:
        args, kw = capture_args(torch, ctx, Q.QUERIES[qname](ctx), JP,
                                "join_probe_agg")
        meta = kw["meta"]
        check(meta is not None and meta[0].item() == 1
              and meta[2].item() == 1,
              f"{qname}: the probe's index is not dense and identity")
        records.append(probe_record(torch, JP, args, kw, qname, mode))
    # q14's build side cut to every other part and shuffled: gapped and
    # not identity, so the kernel binary-searches it and reads perm
    args, kw = capture_args(torch, ctx, Q.q14(ctx), JP, "join_probe_agg")
    gapped, meta = gapped_build(torch, ENG, args, 16)
    check(meta.tolist() == [0, 0, 0], f"gapped index meta {meta.tolist()}")
    records.append(probe_record(torch, JP, gapped, {**kw, "meta": meta},
                                "gapped q14", "keyless"))
    torch.cuda.synchronize()
    for r in records:
        log("[kernel] " + json.dumps(r))
    return records


#: join_probe_agg records of phase 3: (query, accumulation)
PROBE_RECORDS = (("q14", "keyless"), ("q19", "keyless"), ("q5", "shared"),
                 ("q3", "global"))
#: the single-column TPC-H primary keys: each index must be dense and
#: identity (the kernel computes the position and skips perm)
PRIMARY_KEYS = (("supplier", "s_suppkey"), ("part", "p_partkey"),
                ("customer", "c_custkey"), ("orders", "o_orderkey"),
                ("nation", "n_nationkey"))


def index_routes(torch, ctx, FlareContext, Q, JP, col, sum_) -> None:
    """The index facts that pick the probe's route: every single-column
    primary-key index dense and identity; partsupp's composite key (at SF
    0.01: at SF 10 it leaves the int32 key range and is not indexed) not
    dense, and a join on it fires join-probe, launches the kernel (the
    search route) and equals the generic lowering."""
    for tname, key in PRIMARY_KEYS:
        tbl = ctx.catalog.table(tname)
        meta = ctx.cache.get_index(tbl, (key,)).meta.tolist()
        check(meta == [1, int(np.asarray(tbl[key]).min()), 1],
              f"{tname}.{key} index meta {meta}: not dense and identity")
    small = FlareContext(device="cuda")
    Q.register_tpch(small, sf=0.01, seed=0)
    df = small.table("lineitem").join(
        small.table("partsupp"), on=["l_partkey", "l_suppkey"],
        right_on=["ps_partkey", "ps_suppkey"]).agg(
        sum_(col("l_quantity") * col("ps_supplycost"), "cost"),
        sum_(col("l_quantity"), "qty"))
    lowered = df.lower(engine="compiled", native=True)
    fired = lowered.dispatch_report().fired_patterns()
    check(fired == ["join-probe"], f"composite-key join fired {fired}")
    args, kw = capture_args(torch, small, df, JP, "join_probe_agg")
    meta = kw["meta"].tolist()
    check(meta[0] == 0, f"partsupp composite index meta {meta}: dense")
    before = JP.launches
    got = lowered.compile()()
    torch.cuda.synchronize()
    check(JP.launches == before + 1, "the composite-key probe did not "
          "launch the kernel")
    assert_close(got, df.lower(engine="compiled").compile()(),
                 "composite-key join")
    compare(torch, JP.join_probe_agg(*args, **kw),
            JP.join_probe_agg_plain(*args, **kw), "composite-key probe")
    log(f"[kernel] index routes: {len(PRIMARY_KEYS)} primary-key indexes "
        f"dense and identity; partsupp's composite key (meta {meta}) by "
        f"search, equal to the generic lowering")


def gapped_build(torch, ENG, args, seed: int):
    """q14's build side cut to every other part, in a shuffled order: a
    table whose keys are gapped (not dense) and not stored sorted (not
    identity), with its own sorted index.  Returns the probe's arguments
    over it and the index's meta."""
    (body, pcols, pvalid, n, keys, perm, bmask, bcols, scal) = args
    dev = keys.device
    key_of_row = torch.empty_like(keys)
    key_of_row[perm.long()] = keys
    g = torch.Generator(device=dev).manual_seed(seed)
    sel = torch.arange(0, keys.numel(), 2, device=dev)
    rows = sel[torch.randperm(sel.numel(), generator=g, device=dev)]
    tkeys = key_of_row[rows]
    keys_g, perm_g = torch.sort(tkeys, stable=True)
    meta = ENG.index_meta(tkeys.cpu().numpy().astype(np.int64), True)
    gapped = (body, pcols, pvalid, n, keys_g, perm_g.to(torch.int32),
              None if bmask is None else bmask[rows].contiguous(),
              [b[rows].contiguous() for b in bcols], scal)
    return gapped, torch.tensor(meta, dtype=torch.int32, device=dev)


def sectors(torch, sel, size: int) -> int:
    """32-byte sectors of a column of ``size``-byte elements that hold at
    least one row selected by the bool mask ``sel``."""
    rows = 32 // size
    pad = torch.zeros(-sel.numel() % rows, dtype=torch.bool,
                      device=sel.device)
    return int(torch.cat([sel, pad]).view(-1, rows).any(1).sum())


def needed_bytes(torch, args, meta, got) -> int:
    """Bytes a probe must move: the mask; the 32-byte sectors of the key
    columns (``body.key_cols``) that hold a valid row, and of the other
    probe columns that hold a matched row (flare_row reads them for
    matched rows only); on an index that is not dense (``meta``), the
    sectors of the sorted keys at the valid rows' positions (the search's
    last step), and on one that is not identity, those of perm at the
    hits' positions; at each distinct build row a valid row's key hits,
    its mask byte and -- where it matches -- its payload; the output."""
    (body, pcols, pvalid, n, keys, perm, bmask, bcols, scal) = args
    dense, _, identity = meta.tolist()
    valid = pvalid if pvalid is not None else torch.ones(
        n, dtype=torch.bool, device=scal.device)
    kb = keys.float()
    kp = body.probe_key([c.float() for c in pcols])
    pos = torch.searchsorted(kb, kp).clamp_(max=kb.shape[0] - 1)
    hit = (kb[pos] == kp) & valid
    row = perm[pos].long()
    matched = hit if bmask is None else hit & bmask[row]
    check(len(body.key_cols) > 0, "the probe body names no key column")
    total = n if pvalid is not None else 0
    for j, c in enumerate(pcols):
        total += 32 * sectors(torch, valid if j in body.key_cols
                              else matched, c.element_size())
    if not dense:
        total += 32 * torch.unique(pos[valid] // 8).numel()
    if not identity:
        total += 32 * torch.unique(pos[hit] // 8).numel()
    rows = torch.unique(row[hit])
    if bmask is not None:
        total += rows.numel()
        rows = rows[bmask[rows]]
    total += rows.numel() * sum(b.element_size() for b in bcols)
    return total + got.numel() * got.element_size()


def probe_record(torch, JP, args, kw, qname: str, mode: str) -> dict:
    """One join_probe_agg record: the kernel against plain; for keyless
    fragments the dense and search routes bit-identical; event, device
    and plain times; the bound of the needed bytes and the all-rows
    bound (every probe and build column read in full)."""
    body = args[0]
    groups = kw.get("num_groups")
    check(JP.accum_mode(body.n_out, groups) == mode,
          f"{qname}: expected {mode} accumulation")
    search_kw = {**kw, "meta": torch.zeros_like(kw["meta"])}
    got = JP.join_probe_agg(*args, **kw)
    want = JP.join_probe_agg_plain(*args, **kw)
    max_slots = [j for j, op in enumerate(body.ops) if op == "max"]
    err = compare(torch, got, want, f"join_probe_agg[{qname}]",
                  max_slots if groups else ())
    searched = JP.join_probe_agg(*args, **search_kw)
    if mode == "keyless":
        check(torch.equal(got, searched), f"join_probe_agg[{qname}]: the "
              f"dense and search routes differ: {got} vs {searched}")
    else:
        compare(torch, searched, want, f"join_probe_agg[{qname}] search",
                max_slots)
    (_, pcols, pvalid, n, keys, perm, bmask, bcols, scal) = args
    search = n * math.ceil(math.log2(max(2, keys.numel())))
    ops = n * body_ops(body.src) + search
    all_rows, by_all = bound_ms(nbytes(list(pcols) + list(bcols) + [
        pvalid, keys, perm, bmask, scal, got]), ops)
    valid_rows = n if pvalid is None else int(pvalid.sum())
    b, by = bound_ms(needed_bytes(torch, args, kw["meta"], got),
                     valid_rows * body_ops(body.src))
    reps = JP.shared_replicas(body.n_out, groups) if mode == "shared" else 1
    meta = kw["meta"].tolist()
    return dict(
        name=f"join_probe_agg[{qname} {mode}]", route="cuda",
        source="src/repro_torch/kernels/csrc/join_probe.cuh",
        replaces=("src/repro/kernels/join_probe/kernel.py:193"
                  if mode == "keyless" else
                  "src/repro/kernels/join_probe/kernel.py:276"),
        shape=(f"{qname}: {n} probe rows ({valid_rows} valid) x "
               f"{len(pcols)} cols, build {keys.numel()} rows x "
               f"{len(bcols)} cols" + (f", G={groups}" if groups else "")),
        index_meta=meta, reps=reps,
        resources=JP.resources(body, groups), max_abs_err=err,
        ms=cuda_ms(torch, lambda: JP.join_probe_agg(*args, **kw)),
        device_ms=graph_ms(torch, lambda: JP.join_probe_agg(*args, **kw)),
        search_device_ms=graph_ms(
            torch, lambda: JP.join_probe_agg(*args, **search_kw)),
        plain_ms=cuda_ms(torch,
                         lambda: JP.join_probe_agg_plain(*args, **kw)),
        bound_ms=b, bound_by=by, bound_all_rows_ms=all_rows,
        bound_all_rows_by=by_all, library_ms=None)


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
    out = {}
    for name, build in Q.QUERIES.items():
        compiled = build(ctx).lower(engine="compiled", native=True).compile()
        compiled.result()
        kernels, wall, names = profiled(torch, compiled.result)
        dev = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:4]
        # the same run profiled as earlier versions did (no warm step), whose
        # busy shares are not comparable with the warmed step's
        cold, cold_wall, cold_names = profiled_cold(torch, compiled.result)
        cold_dev = sum(e.self_device_time_total for e in cold) / 1e3
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "device_busy_share": dev / wall if wall else None,
                     "cold_wall_ms": cold_wall, "cold_device_ms": cold_dev,
                     "cold_busy_share": (cold_dev / cold_wall
                                         if cold_wall else None),
                     "events": len(names), "cold_events": len(cold_names),
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
        # wrong KV head (of the next batch row where there is one KV
        # head), the last K tile dropped
        roll = 1 if k.shape[1] > 1 else 0
        tail = FL.flash_attention_core_plain(
            q.reshape(b * h, s, d), *[t[:, :, :s - 64].reshape(-1, s - 64, d)
                                      for t in (k, v)], causal=False)
        planted_faults(torch, want, {
            "output x 0.9": got * 0.9,
            "softmax scale x 0.9": FL.flash_attention(
                q, k, v, causal=causal, scale=0.9 * d ** -0.5),
            "KV heads rolled by one": FL.flash_attention_plain(
                q, k.roll(1, dims=roll), v.roll(1, dims=roll),
                causal=causal),
            **({} if causal else
               {"last K tile dropped": tail.reshape(q.shape)})}, label)
        del tail
    del want
    pairs = s * (s + 1) // 2 if causal else s * s      # unmasked (q, k)
    # the peak of the inputs' type, whichever route the kernel takes
    bnd, by = attn_bound(nbytes([q, k, v, got]), 4.0 * d * b * h * pairs,
                         H100_F32_OPS_PER_S if q.dtype == torch.float32
                         else H100_BF16_OPS_PER_S)
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


def seeded_flash_record(torch, F, FL, c: dict, seed: int, label: str):
    """flash_record with phase 6's planted faults at the head layout ``c``
    (b, h, hkv, s, d), bf16, causal, on normal inputs from the seed,
    beside the kernel's resources where it is the tensor-core one."""
    g = torch.Generator(device="cuda").manual_seed(seed + c["d"])
    q, k, v = (torch.randn(c["b"], h, c["s"], c["d"], generator=g,
                           device="cuda").bfloat16()
               for h in (c["h"], c["hkv"], c["hkv"]))
    rec = flash_record(torch, F, FL, q, k, v, True, label, faults=True)
    if FL.route(q.dtype, c["d"]) == "mma":
        rec["resources"] = FL.mma_resources()[c["d"]]
        log(f"[kernel] {label}: resources {json.dumps(rec['resources'])}")
    return rec


#: the D 160 split check of phase 6: B 1 x H 4 (Hkv 1) x S 256, causal,
#: seeded.  The kernel adds P V as (P rounded to bf16) V + (the rest of
#: P, rounded to bf16) V; a kernel that dropped the second part would
#: still pass the one-rounding limit at D 160 (bf16_p_err_over_limit
#: 0.79-0.96, PERF.md), so this check compares the kernel with the two
#: emulations of its arithmetic: its mean distance to the split one must
#: be below SPLIT_MARGIN of its distance to the one without the split.
#: On the CPU the plain version (f32 P) sits at about 1/600 of that
#: ratio (tests/test_torch_flash_mma.py), the emulation without the
#: split at infinity.
SPLIT_CHECK = dict(b=1, h=4, hkv=1, s=256, d=160)
SPLIT_MARGIN = 0.1
#: the emulation's tile and exp2 scale (flash_attention_mma.cuh)
MMA_TILE, LOG2E = 64, 1.4426950408889634


def emulate_flash_mma(torch, q, k, v, causal: bool, split: bool = True):
    """What ``flash_attention_mma.cuh`` computes, in f32 on the CPU (a
    copy of the CPU tests' emulation): q ``[BH, S, D]``, k/v ``[BHkv, S,
    D]`` bf16 -> ``[BH, S, D]`` bf16; bf16 products are exact in f32 and
    added in f32, the online softmax runs per 64-key tile in base 2, and
    P V is added as P rounded to bf16 times V plus, with ``split``, the
    rest of P rounded to bf16 times V."""
    bh, s, d = q.shape
    group = bh // k.shape[0]
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    qf = q.float()
    kf = k.float().repeat_interleave(group, 0)
    vf = v.float().repeat_interleave(group, 0)
    out = torch.empty(bh, s, d, dtype=torch.float32)
    t = MMA_TILE
    n_k = math.ceil(s / t)
    for qt in range(math.ceil(s / t)):
        rows = torch.arange(qt * t, (qt + 1) * t)
        qb = qf[:, qt * t:(qt + 1) * t]
        qb = torch.cat([qb, qb.new_zeros(bh, t - qb.shape[1], d)], 1)
        m = torch.full((bh, t, 1), -1e30)
        l = torch.zeros(bh, t, 1)
        acc = torch.zeros(bh, t, d)
        for j in range(min(qt + 1, n_k) if causal else n_k):
            keys = torch.arange(j * t, (j + 1) * t)
            kb = torch.zeros(bh, t, d)
            vb = torch.zeros(bh, t, d)
            n = min(s - j * t, t)             # rows past S are zero-filled
            kb[:, :n] = kf[:, j * t:j * t + n]
            vb[:, :n] = vf[:, j * t:j * t + n]
            x = (qb @ kb.transpose(1, 2)) * scale_log2
            if causal:
                x = x.masked_fill(keys[None, :] > rows[:, None], -1e30)
            x = x.masked_fill((keys >= s)[None, :], -math.inf)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = p.bfloat16().float()
            acc = acc * alpha + hi @ vb
            if split:
                acc = acc + (p - hi).bfloat16().float() @ vb
            m = m_new
        o = acc / l.clamp_min(1e-30)
        out[:, qt * t:(qt + 1) * t] = o[:, :min(t, s - qt * t)]
    return out.bfloat16()


def split_check(torch, FL, seed: int) -> dict:
    """Phase 6: the tensor-core kernel at D 160 on seeded inputs
    (:data:`SPLIT_CHECK`) against :func:`emulate_flash_mma` with and
    without the split of P: the mean absolute distance and the share of
    elements that differ, each way; fails unless the kernel lies within
    :data:`SPLIT_MARGIN` of its distance to the unsplit emulation."""
    c = SPLIT_CHECK
    g = torch.Generator(device="cuda").manual_seed(seed + 1160)
    q, k, v = (torch.randn(c["b"], h, c["s"], c["d"], generator=g,
                           device="cuda").bfloat16()
               for h in (c["h"], c["hkv"], c["hkv"]))
    check(FL.route(q.dtype, c["d"]) == "mma", "D 160 takes the tensor cores")
    got = FL.flash_attention(q, k, v, causal=True).float().cpu().reshape(
        c["b"] * c["h"], c["s"], c["d"])
    args = [t.cpu().reshape(-1, c["s"], c["d"]) for t in (q, k, v)]
    out = {"shape": dict(c, causal=True), "margin": SPLIT_MARGIN}
    for name, split in (("split", True), ("bf16_p", False)):
        diff = (got - emulate_flash_mma(torch, *args, causal=True,
                                        split=split).float()).abs()
        out[f"mean_abs_to_{name}"] = float(diff.mean())
        out[f"share_differing_{name}"] = float((diff > 0).float().mean())
    out["ratio"] = out["mean_abs_to_split"] / max(out["mean_abs_to_bf16_p"],
                                                  1e-30)
    log(f"[kernel] flash_attention_mma D 160 split check {json.dumps(out)}")
    check(out["mean_abs_to_bf16_p"] > 0 and out["ratio"] < SPLIT_MARGIN,
          f"flash_attention_mma at D 160 is not clearly nearer the split "
          f"emulation than the unsplit one: {json.dumps(out)}")
    return out


def decode_reset_unit(CB) -> str:
    """The decode unit without its ticket memset: the block that folds a
    pair sets the pair's ticket back to 0, so a scratch zeroed once serves
    every call on one stream.  A follow-up's design, timed beside the
    kernel in phase 6 (``no_memset_device_ms``)."""
    src = CB.fixed_unit("decode_attention.cuh")
    for old, new in {
            "cudaMemsetAsync(words, 0, (size_t)(pairs + 4) * 4, s)":
                "cudaSuccess",
            "    if (!*flag_s) continue;\n":
                "    if (!*flag_s) continue;\n    if (t == 0) a.ctr[it.bkv] = 0;\n",
    }.items():
        check(src.count(old) == 1, f"decode unit: '{old.strip()}' is not "
              f"in csrc/decode_attention.cuh once")
        src = src.replace(old, new)
    return src


def decode_reset_call(torch, CB, DA, q, k, v, lengths):
    """One call of :func:`decode_reset_unit`'s kernel on these inputs, on a
    scratch zeroed once (not the wrapper: its launches are not counted)."""
    src = decode_reset_unit(CB)
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group, dt = h // hkv, DA._DTYPES[q.dtype]
    out = (ctypes.c_int * 2)()
    CB.raise_on(CB.entry(src, "flare_decode_prepare",
                         DA._SIGNATURES["flare_decode_prepare"])(
        dt, b, group, d, ctypes.cast(out, ctypes.c_void_p)),
        "decode without memset: occupancy")
    grid = out[0] * CB.sm_count(q)
    scratch = torch.zeros(DA.scratch_words(b, hkv, group, d, grid),
                          dtype=torch.int32, device=q.device)
    run = CB.entry(src, "flare_decode_attention",
                   DA._SIGNATURES["flare_decode_attention"])

    def call():
        o = torch.empty_like(q)
        CB.raise_on(run(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lengths.data_ptr(), o.data_ptr(), b, hkv, group, s,
                        d, d ** -0.5, dt, grid, scratch.data_ptr(),
                        CB.stream(q)), "decode without memset")
        return o
    return call


def decode_record(torch, F, CB, DA, q, k, v, lengths, label: str,
                  faults: bool = True) -> dict:
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    got, sched = DA.decode_attention_launch(q, k, v, lengths)
    want = DA.decode_attention_plain(q, k, v, lengths)
    err, excess = close_err(torch, got, want, label)
    # the schedule the kernel computed on the device, against the mirror
    grid = DA.grid_size(q, b, h // hkv, d)
    chunk, items = DA.decode_schedule(lengths.tolist(), hkv, s, d,
                                      q.element_size(), grid)
    sched = sched.tolist()
    check(sched == [chunk, len(items)], f"{label}: the kernel's schedule "
          f"[chunk, items] {sched} is not the mirror's {[chunk, len(items)]}")
    again = DA.decode_attention(q, k, v, lengths)
    check(torch.equal(got, again), f"{label}: two calls on the same inputs "
          f"differ (the fold must run in item order)")
    del again
    planted_faults(torch, want, {} if not faults else {
        "output x 0.9": got * 0.9,
        "softmax scale x 0.9": DA.decode_attention(
            q, k, v, lengths, scale=0.9 * d ** -0.5),
        "last 64 keys dropped": DA.decode_attention(
            q, k, v, (lengths - 64).clamp_min(1)),
        "length off by one": DA.decode_attention(
            q, k, v, (lengths - 1).clamp_min(1))}, label)
    del want

    def kernel():
        return DA.decode_attention(q, k, v, lengths)

    reset = decode_reset_call(torch, CB, DA, q, k, v, lengths)
    for _ in range(2):          # the second call finds the tickets reset
        check(torch.equal(reset(), got), f"{label}: the kernel without "
              f"its memset differs from the kernel")
    n = lengths.clamp(0, s)
    n = torch.where(n == 0, s, n)               # length 0 reads every row
    rows = int(n.sum()) * hkv                   # cache rows the data needs
    bnd, by = attn_bound(2 * rows * d * k.element_size()
                         + nbytes([q, lengths, got]),
                         4.0 * d * (h // hkv) * rows)
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                              enable_gqa=True)

    rec = dict(
        name=label, route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cuh",
        replaces="src/repro/kernels/decode_attention/kernel.py:65",
        shape=(f"B {b} x H {h} (Hkv {hkv}) x S {s} x D {d}, "
               f"{str(q.dtype).split('.')[-1]}, lengths "
               f"{lengths.tolist()}"),
        max_abs_err=err, err_over_limit=excess,
        ms=cuda_ms(torch, kernel),
        plain_ms=cuda_ms(torch, lambda: DA.decode_attention_plain(
            q, k, v, lengths), runs=5, warmup=1),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(torch, library),
        device_ms=graph_ms(torch, kernel),
        library_device_ms=graph_ms(torch, library),
        wrapper_host_us=wrapper_us(torch, kernel),
        no_memset_device_ms=graph_ms(torch, reset),
        grid=grid, chunk=sched[0], items=sched[1])
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
    from repro_torch.kernels import cuda_build as CB
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
    # the CUDA-core kernel, which the route keeps for f32 and for bf16 at
    # the other widths: recurrentgemma-2b's layer (10 / 1 heads, D 256)
    records.append(flash_record(
        torch, F, FL, *[t.float() for t in (q, k, v)], True,
        "flash_attention_cuda_cores[f32]", faults=True))
    del q, k, v, cap
    c = LARGE_GROUPS["recurrentgemma-2b"]
    records.append(seeded_flash_record(
        torch, F, FL, dict(b=SERVE_BATCH, h=c["hkv"] * c["group"],
                           hkv=c["hkv"], s=SERVE_PROMPT, d=c["d"]),
        seed, "flash_attention_cuda_cores[bf16 D 256, recurrentgemma-2b]"))
    split_check(torch, FL, seed)

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
    records.append(decode_record(torch, F, CB, DA, q, k, v, lengths,
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
    records.append(decode_record(torch, F, CB, DA, q, k, v, lengths,
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
    with torch.no_grad():      # scoring: no graph over the logits
        loss, metrics = model.loss(params, {"tokens": tokens,
                                            "labels": labels})
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


#: profiles of phase 7b's decode steps of each kind, warmed and cold (a
#: profile can miss device events: the launch check reads the majority)
DECODE_PROFILES = 4


def lm_profile(torch, Model, serve_llm, DA, cfg, params, tokens) -> dict:
    """Phase 7b: one profiled forward and four profiled decode steps:
    device time, busy share and the kernels that take most of it; for
    decode, from :data:`DECODE_PROFILES` warmed and as many cold profiles
    of the steps, also the decode kernels' launches against the wrapper's
    calls and the events each profile missed."""
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
        counted = {}

        def recorded():
            before = DA.launches
            fn()
            counted["calls"] = DA.launches - before

        decode = name.startswith("decode")
        n_prof = DECODE_PROFILES if decode else 1
        warmed = [profiled(torch, recorded, warm=fn) for _ in range(n_prof)]
        kernels, wall, _ = max(warmed, key=lambda r: len(r[2]))
        calls = counted["calls"]
        dev = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "device_busy_share": dev / wall if wall else None,
                     "top": [[e.key[:70], e.self_device_time_total / 1e3,
                              e.count] for e in top]}
        if decode:
            cold = [profiled_cold(torch, recorded) for _ in range(n_prof)]
            seen = [[[e.key[:70], e.self_device_time_total / 1e3, e.count]
                     for e in r[0] if "flare_decode" in e.key]
                    for r in warmed + cold]
            counts = [sum(d[2] for d in dec) for dec in seen]
            # one decode launch per wrapper call (a layer of a step): the
            # kernel, no fold pass.  A profile can miss launches, and may
            # hold an event that is not the steps', so more than half of
            # them must show one launch per call.
            check(calls == 4 * cfg.n_layers
                  and counts.count(calls) > len(counts) // 2
                  and all(len(dec) <= 1 and all(
                      "flare_decode_kernel" in d[0] for d in dec)
                          for dec in seen),
                  f"decode x4 ran the decode kernels {seen} in {calls} "
                  f"wrapper calls, not one kernel once a call")
            out[name]["decode_attention"] = seen[counts.index(calls)][0]
            out[name]["decode_calls"] = calls
            # what each profile missed against the fullest of all
            ref = max((r[2] for r in warmed + cold), key=len)
            out[name]["profiles"] = {
                kind: [{"events": len(r[2]), "decode_launches": c,
                        "n_lost": len(lost_events(ref, r[2])),
                        "lost": lost_events(ref, r[2])[:4],
                        "wall_ms": r[1]} for r, c in zip(rs, cs)]
                for kind, rs, cs in (("warmed", warmed, counts[:n_prof]),
                                     ("cold", cold, counts[n_prof:]))}
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
    c = DECODE32K
    log(f"[lm] decode_attention resources (registers and local spill bytes "
        f"per thread, shared bytes per block, blocks per SM), at the path's "
        f"bf16 group {c['group']} D {c['d']} and at f32 group 8 D 256: "
        + json.dumps({
            "bf16 G2 D64": DA.resources(torch.bfloat16, SERVE_BATCH,
                                        c["group"], c["d"]),
            "f32 G8 D256": DA.resources(torch.float32, SERVE_BATCH, 8, 256)}))
    records = lm_kernel_checks(torch, F, Model, serve_llm, FL, DA, cfg,
                               params, tokens, seed)
    torch.cuda.empty_cache()
    main = lm_main_path(torch, Model, serve_llm, FL, DA, cfg, params,
                        tokens, labels)
    launches_out.update(main["launches"])
    torch.cuda.empty_cache()
    dec = lm_profile(torch, Model, serve_llm, DA, cfg, params,
                     tokens)["decode x4"]
    for r in records:
        if r["name"].startswith("decode_attention"):
            r["launches_per_call"] = (dec["decode_attention"][2]
                                      / dec["decode_calls"])
    log(f"[lm] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phases 6-7 "
        f"took {time.perf_counter() - t0:.1f} s")
    return records


# ---------------------------------------------------------------------------
# phase 14: the LM train step (qwen3-0.6b at full width)
# ---------------------------------------------------------------------------

#: train_4k's length; its batch of 256 cut to 4 (one card)
TRAIN_BATCH, TRAIN_SEQ = 4, 4096
#: 20 steps of warmup_cosine (peak 1e-3, 5 warm-up steps), a checkpoint
#: every 10; the resumed run restores step 10 and runs steps 10-19 again
TRAIN_STEPS, TRAIN_CKPT, TRAIN_LR, TRAIN_WARMUP = 20, 10, 1e-3, 5
#: documents for the run: 92 rows of 4097 tokens, 23 batches (no wrap)
TRAIN_DOCS = 400
#: the bf16 step against the f32 step: B 1 of the same batch
COMPARE_BATCH = 1
#: bf16 vs f32: the loss within one bf16 rounding (2^-7 relative), each
#: leaf's gradient at cosine >= 0.99
LOSS_ROUNDING, GRAD_COSINE = 2.0 ** -7, 0.99
#: a resumed step's loss against the uninterrupted run's: the embedding's
#: backward accumulates with atomics on the card, so the two runs differ
#: in the order of some f32 sums (not bit for bit): relative 1e-3 at most
RESUME_RTOL = 1e-3


def train_bound_ms(cfg, n_params: int, batch: int, seq: int) -> float:
    """The least time of one step on the card: 6 N T matmul flops (forward
    and backward of every parameter for T tokens) plus causal attention's
    forward and backward, 3 x 2 S^2 D flops per (sequence, layer, query
    head), at the bf16 tensor-core rate; no recomputation counted."""
    tokens = batch * seq
    attn = 3 * 2 * seq * seq * cfg.head_dim_ * cfg.n_heads * cfg.n_layers \
        * batch
    return (6 * n_params * tokens + attn) / H100_BF16_OPS_PER_S * 1e3


def bf16_vs_f32(torch, Model, ST, cfg, state, batch) -> dict:
    """One bf16 step against the same step computed in f32 on
    :data:`COMPARE_BATCH` rows of ``batch``: the loss and each leaf's
    gradient."""
    from repro_torch.models import param as PM
    small = {k: v[:COMPARE_BATCH] for k, v in batch.items()}
    loss, _, g16 = ST.loss_and_grads(Model(cfg), state["params"], small)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    loss32, _, g32 = ST.loss_and_grads(Model(f32), state["params"], small)
    want = dict(PM.flatten_with_paths(g32))
    cos = {}
    for name, g in PM.flatten_with_paths(g16):
        a, b = g.double().flatten(), want[name].double().flatten()
        cos[name] = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))
    out = {"batch": COMPARE_BATCH, "loss_bf16": float(loss),
           "loss_f32": float(loss32),
           "loss_rel_diff": abs(float(loss) / float(loss32) - 1),
           "min_grad_cosine": min(cos.values()),
           "min_grad_cosine_leaf": min(cos, key=cos.get)}
    check(out["loss_rel_diff"] <= LOSS_ROUNDING,
          f"bf16 loss {out['loss_bf16']} vs f32 {out['loss_f32']}: more "
          f"than one bf16 rounding apart")
    check(out["min_grad_cosine"] >= GRAD_COSINE,
          f"bf16 vs f32 gradient cosine {cos}")
    del g16, g32, want
    return out


def train_profile(torch, step_fn, state, batch) -> dict:
    """One profiled train step after a warm one: device ms, busy share
    (of the profiled step's wall), the kernels that take most of the
    device time.  Device events only: a step launches some 110 000
    kernels, and the host-side events would multiply the profiler's own
    post-processing (about 100 s with them)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    done = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: done.append(p.key_averages())
                 ) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    check(len(done) == 1, "the profiler recorded no step")
    kernels = [e for e in done[0] if device_work(e)]
    dev = sum(e.self_device_time_total for e in kernels) / 1e3
    check(dev > 0, "the profile of a train step holds no device time")
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"wall_ms": wall, "device_ms": dev, "device_busy_share":
            dev / wall, "kernels": sum(e.count for e in kernels),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def train_phase(torch, seed: int) -> dict:
    """Phase 14: the trainer's main path at full width -- the
    Flare-built data pipeline, init from the seed, one bf16 step against
    f32, 20 steps with checkpoints, a resume from step 10 -- with the
    attention kernels' launch counts reset before and read after (none:
    training takes the blockwise route), then one profiled step."""
    import shutil
    from repro_torch.configs import get
    from repro_torch.data.pipeline import LMDataPipeline
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FL
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import TrainRun, train_loop
    from repro_torch.models.modeling import Model
    from repro_torch.optim import AdamWConfig, warmup_cosine

    t_phase = time.perf_counter()
    cfg = get(LM_ARCH)
    check(cfg.attn_impl == "ring" and cfg.remat == "full",
          f"{LM_ARCH} trains with attn_impl {cfg.attn_impl}, remat "
          f"{cfg.remat}")
    model = Model(cfg)
    n_params = model.n_params()
    out = {"arch": LM_ARCH, "params": n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
           "remat": cfg.remat, "attn_impl": cfg.attn_impl}
    FL.launches = FL.launches_mma = FL.launches_cuda_cores = 0
    DA.launches = 0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    parts = {}

    def lap(name, t_start):
        parts[name] = time.perf_counter() - t_start
        return time.perf_counter()

    # bf16 against f32 on the first batch, from the seed's state
    t0 = time.perf_counter()
    pipe = LMDataPipeline.synthetic(TRAIN_SEQ, TRAIN_BATCH,
                                    n_docs=TRAIN_DOCS, seed=seed)
    out["pipeline"] = {"rows": len(pipe.rows),
                       "batches_per_epoch": pipe.batches_per_epoch}
    t0 = lap("pipeline", t0)
    check(pipe.batches_per_epoch >= TRAIN_STEPS,
          f"{pipe.batches_per_epoch} batches for {TRAIN_STEPS} steps")
    state = ST.init_train_state(model, seed)
    out["bf16_vs_f32"] = bf16_vs_f32(torch, Model, ST, cfg, state,
                                     pipe.next_batch())
    del state
    torch.cuda.empty_cache()
    t0 = lap("bf16_vs_f32", t0)
    log(f"[train] bf16 vs f32 step: {json.dumps(out['bf16_vs_f32'])}")

    # 20 steps through the trainer, then steps 10-19 again from step 10
    ckpt_dir = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(arch=LM_ARCH, reduced=False, steps=TRAIN_STEPS,
              batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
              warmup=TRAIN_WARMUP, ckpt_dir=ckpt_dir,
              ckpt_every=TRAIN_CKPT, seed=seed, n_docs=TRAIN_DOCS,
              log_every=5, device="cuda")
    full = train_loop(TrainRun(**kw))
    torch.cuda.synchronize()
    t0 = lap("run_20_steps", t0)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["resident_gb"] = resident / 1e9
    losses = full["losses"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check(last < first, f"the loss did not fall: first 3 {first}, last 3 "
          f"{last}")
    step_ms = [t * 1e3 for t in full["step_s"][1:]]
    out.update(losses=losses, first3=first, last3=last,
               step_ms_first=full["step_s"][0] * 1e3,
               step_ms=float(np.median(step_ms)), step_ms_min=min(step_ms),
               step_ms_max=max(step_ms))
    out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (out["step_ms"] / 1e3)
    out["bound_ms"] = train_bound_ms(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    out["bound_share"] = out["bound_ms"] / out["step_ms"]
    torch.cuda.empty_cache()

    # the latest checkpoint is step 20's: drop it, so the trainer
    # resumes from step 10's
    shutil.rmtree(os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:010d}"))
    resumed = train_loop(TrainRun(**kw))
    t0 = lap("resumed_10_steps", t0)
    check(resumed["start_step"] == TRAIN_CKPT,
          f"resumed at {resumed['start_step']}, not {TRAIN_CKPT}")
    diffs = [abs(a / b - 1) for a, b in zip(resumed["losses"],
                                            losses[TRAIN_CKPT:])]
    check(len(diffs) == TRAIN_STEPS - TRAIN_CKPT
          and max(diffs) <= RESUME_RTOL,
          f"resumed losses {resumed['losses']} vs {losses[TRAIN_CKPT:]}")
    ck = full["checkpoint"]
    out["checkpoint"] = {"bytes": ck["bytes"], "save_ms": ck["save_ms"],
                         "restore_ms": resumed["checkpoint"]["restore_ms"],
                         "resume_max_rel_diff": max(diffs),
                         "resume_rtol": RESUME_RTOL}
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out["launches"] = {"flash_attention": FL.launches,
                       "decode_attention": DA.launches}
    check(FL.launches == 0 and DA.launches == 0,
          f"training launched the attention kernels {out['launches']}")
    torch.cuda.empty_cache()

    # one profiled step on a fresh state
    state = ST.init_train_state(model, seed)
    step_fn = ST.make_train_step(model, AdamWConfig(
        lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)))
    batch = ST.batch_to(pipe.next_batch(), "cuda")
    out["profile"] = train_profile(torch, step_fn, state, batch)
    out["profile"]["device_ms_over_step_ms"] = (
        out["profile"]["device_ms"] / out["step_ms"])
    del state, batch
    torch.cuda.empty_cache()
    lap("profile", t0)
    out["parts_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] {json.dumps(out)}")
    log(f"[train] step {out['step_ms']:.1f} ms (median of "
        f"{len(step_ms)}), {out['tokens_per_s']:.0f} tokens/s, bound "
        f"{out['bound_ms']:.1f} ms, peak {out['peak_gb']:.2f} GB, "
        f"checkpoint {ck['bytes']} bytes saved in "
        f"{json.dumps([round(x) for x in ck['save_ms']])} ms, restored in "
        f"{out['checkpoint']['restore_ms']:.0f} ms; phase 14 took "
        f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the MoE family and the configs past qwen3 (olmoe-1b-7b at full
# width; decode beyond 8 heads per KV head; starcoder2-7b and pixtral-12b
# at full width with 4 layers)
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
#: (b) decode_attention beyond 8 query heads per KV head, at the serving
#: cache of B 8 x (2048 + 32): starcoder2-7b's 36 / 4 heads at D 128 and
#: recurrentgemma-2b's 10 / 1 at D 256 (its config is not yet ported)
LARGE_GROUPS = {"starcoder2-7b": dict(hkv=4, group=9, d=128),
                "recurrentgemma-2b": dict(hkv=1, group=10, d=256)}
#: (c) dense configs served at full width, depth cut to 4 layers (all of
#: them would not leave room beside the phase's other work: pixtral's 40
#: layers are 49 GB of f32 weights), B 8 x 2048 (+ pixtral's 256-row
#: prefix) and 4 decode steps; both take flash on the tensor cores
#: (starcoder2-7b at D 128, pixtral-12b at D 160)
DEPTH_CUT, DEPTH_GEN = {"starcoder2-7b": 4, "pixtral-12b": 4}, 4
#: (d) flash at this config's layer-0 serving shape (its heads, B 8 x its
#: prefix + 2048) on seeded inputs: the served prompts are mostly padding,
#: on which a planted fault can stay within one rounding; seeded normal
#: inputs let each one show
SEEDED_FLASH_ARCH = "pixtral-12b"
#: the MoE gate, part 2: per token, the kernel path's logits against the
#: plain path's (the same model with flash's plain version) within four
#: bf16 roundings of the row's largest logit (|d| <= 4 x 2^-7 max|want|)
#: at the tokens whose routes agree in every layer; part 3: the share of
#: (token, layer) route sets that differ between the two paths.  On the
#: H100 with the gate's two batches of token ids (PERF.md section 6):
#: the agreeing tokens' logits differ by 2.38 / 2.41 roundings (the
#: attention's one-rounding differences, grown over 16 layers), the
#: planted faults by 9.25 and more; route sets differ at 12.5 / 12.1 %
#: of (token, layer), the planted faults at 27.0 % and more
ROUTE_ROW_ROUNDINGS = 4.0
ROUTE_FLIP_LIMIT = 0.18
#: the gate's prompts: B 8 x 2048 token ids drawn uniformly over the
#: vocab, one batch from each of these offsets of the seed
GATE_SEEDS = (101, 102)


def random_prompts(torch, vocab: int, seed: int):
    """[SERVE_BATCH, SERVE_PROMPT] token ids drawn uniformly over the
    vocab from ``seed``, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                         device="cuda")


def moe_reference(torch, p, c, x):
    """The MoE layer's function in plain PyTorch, written apart from
    ``layers.moe``: the f32 router softmax and top-k (the routes), each
    slot's place in its expert by a stable sort of the slots in token
    order (not a one-hot cumsum), slots at or past the capacity dropped,
    each expert's products on its kept rows alone, the weighted outputs
    added per token in f32.  Returns (out, experts [T, k], kept [T, k])."""
    import torch.nn.functional as F
    b, s, d = x.shape
    t, k, e = b * s, c.top_k, c.n_experts
    xt = x.reshape(t, d)
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = math.ceil(t * k / e * c.capacity_factor)
    cap = max(-(-cap // 128) * 128, 128)
    flat = top_e.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(t * k, device=x.device) - starts[flat[order]]
    kept = pos < cap
    w = top_p.reshape(-1)
    out = torch.zeros(t, d, dtype=torch.float32, device=x.device)
    for ex in range(e):
        slots = order[starts[ex]:starts[ex] + counts[ex]]
        slots = slots[kept[slots]]
        if slots.numel() == 0:
            continue
        tok = slots // k
        xe = xt[tok]
        h = xe @ p["w_in"][ex]
        if c.act == "swiglu":
            h = F.silu(xe @ p["w_gate"][ex]) * h
        else:
            h = F.gelu(h, approximate="tanh")
        out.index_add_(0, tok, (h @ p["w_out"][ex]).float() * w[slots, None])
    return out.reshape(b, s, d).to(x.dtype), top_e, kept.reshape(t, k)


def route_codes(torch, routes: list, n_experts: int):
    """[layers, T, k] of each (token, layer)'s route set: its experts,
    a dropped slot's expert offset by E, sorted along k."""
    return torch.stack([torch.where(r["kept"], r["experts"],
                                    r["experts"] + n_experts)
                        .sort(-1).values for r in routes])


def row_excess(torch, got, want, rows):
    """The largest |got - want| in bf16 roundings of its row's largest
    logit (2^-7 max|want|) over the ``rows`` [B, S] of two [B, S, V]
    logit tensors, and the same over all rows."""
    worst_in, worst_all = 0.0, 0.0
    for g, w, r in zip(got, want, rows):
        w = w.float()
        lim = 2.0 ** -7 * w.abs().amax(-1, keepdim=True)
        ratio = ((g.float() - w).abs() / lim).amax(-1)
        check(bool(torch.isfinite(g).all()), "non-finite logits")
        worst_all = max(worst_all, float(ratio.max()))
        if bool(r.any()):
            worst_in = max(worst_in, float(ratio[r].max()))
    return worst_in, worst_all


def keeping_dropped(L, layer: int, n_layers: int):
    """A planted fault: ``layers.moe`` whose dispatch, at layer ``layer``
    of each pass over ``n_layers``, ignores the capacity (every slot is
    computed and added) while its routes, as recorded, are the rule's
    (the slots at or past the capacity marked dropped)."""
    real = L.moe
    calls = [0]

    def moe(p, c, x, sc):
        at = calls[0] % n_layers == layer
        calls[0] += 1
        out = real(p, c, x, sc)              # records the rule's routes
        if not at:
            return out
        cap = L.moe_capacity
        L.moe_capacity = lambda c_, t: -(-t // 128) * 128
        try:
            with L.recording_routes():       # this call's are not kept
                y = real(p, c, x, sc)[0]
        finally:
            L.moe_capacity = cap
        return y, out[1]
    return moe


#: contraction size of each stacked layer weight (the per-matrix fan-in)
FAN_IN = {"wq": "d", "wk": "d", "wv": "d", "wo": "hd", "w_in": "d",
          "w_gate": "d", "w_out": "f", "router": "d"}


def per_matrix_scale(torch, cfg, stacked) -> dict:
    """Each weight of the stacked layer tree ``stacked`` rescaled, in
    place, from the init's fan-in (every axis but the last: the layer and
    expert axes too) to its own contraction's, 1 / sqrt(d) for ``wq``: a
    layer's attention and experts then add to the residual stream what a
    trained model's do, not ~1e-4 of it.  Returns the factors."""
    from repro_torch.models import param as PM
    sizes = {"d": cfg.d_model, "hd": cfg.n_heads * cfg.head_dim_,
             "f": cfg.d_ff}
    factors = {}
    for path, leaf in PM.tree_items(stacked):
        name = path[-1]
        if name in FAN_IN:
            init_fan = math.prod(leaf.shape[:-1])
            factors[name] = math.sqrt(init_fan / sizes[FAN_IN[name]])
            leaf.mul_(factors[name])
    return factors


def moe_gate(torch, L, FL, Model, cfg, lp, prompt_seed: int) -> tuple:
    """The MoE gate in three parts, each held against planted faults of
    two kinds -- an expert's wrong weight (the ``w_out`` of a layer's two
    most-loaded experts swapped) and dropped slots kept
    (:func:`keeping_dropped`) -- placed where the part can see them:
    (1) layer 0's MoE on the kernel path's own input against
    :func:`moe_reference`: bit-equal routes, the output within one bf16
    rounding (faults at layer 0); (2) the kernel path's forward logits
    against the plain path's (the same forward with
    ``flash_attention_plain`` in the kernel's place) at the tokens whose
    route sets agree in every layer, within :data:`ROUTE_ROW_ROUNDINGS`
    (faults at the last layer, whose output moves no route); (3) the
    share of (token, layer) route sets that differ between the two
    paths, under :data:`ROUTE_FLIP_LIMIT` (faults at layer 0).  Beside
    part 3, the same share with SDPA in flash's place against the plain
    path (``sdpa_paths``, reported only): how far another correct bf16
    attention moves the routes.  The prompts are :func:`random_prompts`
    of ``prompt_seed``.  Returns the numbers and the checks, which the
    phase makes at its end."""
    import torch.nn.functional as F
    from repro_torch.distributed.shardings import null_ctx
    out, checks = {"prompt_seed": prompt_seed}, []
    tokens = random_prompts(torch, cfg.vocab, prompt_seed)
    batch = {"tokens": tokens}
    b, s = tokens.shape
    e, n = cfg.n_experts, cfg.n_layers
    t0 = time.perf_counter()
    model = Model(cfg)

    def sdpa(q, k, v, *, causal=True, scale=None):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              scale=scale, enable_gqa=True)

    def run(params=None, keep_at=None, plain=False, library=False):
        orig = L.moe, FL.flash_attention
        if keep_at is not None:
            L.moe = keeping_dropped(L, keep_at, n)
        if plain:
            FL.flash_attention = FL.flash_attention_plain
        if library:
            FL.flash_attention = sdpa
        try:
            with L.recording_routes() as routes:
                logits, _ = model.forward(params or lp, batch)
        finally:
            L.moe, FL.flash_attention = orig
        return logits, route_codes(torch, routes, e)

    with CaptureFirst(L, "moe") as cap:
        logits_k, codes_k = run()
    (p0, c0, x0, _), _ = cap.calls[0]
    logits_p, codes_p = run(plain=True)
    # each layer's two experts with the most kept slots
    busiest = [torch.bincount(c[c < e], minlength=e).topk(2).indices
               .tolist() for c in codes_k]
    out["busiest_experts"] = busiest

    def swapped_w_out(w_out, pair):
        order = list(range(e))
        order[pair[0]], order[pair[1]] = pair[1], pair[0]
        return w_out[..., order, :, :]

    # (1) layer 0's MoE on identical inputs
    sc = null_ctx()
    with L.recording_routes() as r0:
        got = L.moe(p0, c0, x0, sc)[0]
    want, experts, kept = moe_reference(torch, p0, c0, x0)
    out["layer0"] = {
        "routes_bit_equal": bool(torch.equal(r0[0]["experts"], experts)
                                 and torch.equal(r0[0]["kept"], kept)),
        "dropped_slots": int((~kept).sum()), "slots": int(kept.numel()),
        "moe_rms_over_input_rms": float(want.float().pow(2).mean().sqrt()
                                        / x0.float().pow(2).mean().sqrt())}
    err, excess = rounding_excess(torch, got, want, "layer-0 moe")
    out["layer0"].update(max_abs_err=err, err_over_limit=excess)
    checks.append((out["layer0"]["routes_bit_equal"],
                   "layer-0 moe: routes differ from the plain reference"))
    checks.append((excess <= 1.0, f"layer-0 moe: {excess:.3g} times the "
                   f"one-rounding limit"))
    with L.recording_routes():
        faults1 = {
            "busiest experts swapped": L.moe(
                dict(p0, w_out=swapped_w_out(p0["w_out"], busiest[0])),
                c0, x0, sc)[0],
            "dropped slots kept": keeping_dropped(L, 0, 1)(p0, c0, x0,
                                                           sc)[0]}
    out["layer0"]["faults"] = {
        k: rounding_excess(torch, v, want, f"layer-0 moe {k}")[1]
        for k, v in faults1.items()}
    for k, v in out["layer0"]["faults"].items():
        checks.append((v > 1.0, f"layer-0 moe: the gate passes the planted "
                       f"fault '{k}' ({v:.3g})"))
    del got, want, faults1, cap, x0

    # (2) and (3): the kernel path against the plain path
    def compare(logits, codes, what):
        differ = (codes != codes_p).any(-1)                 # [layers, T]
        agree = ~differ.any(0).reshape(b, s)
        # a token reads its earlier tokens through attention: where the
        # routes of every earlier token of its sequence agree too (clean),
        # it computed nothing the other path did not (reported only)
        clean = torch.cumsum((~agree).int(), dim=1) == 0
        experts_differ = (codes % e != codes_p % e).any(-1)
        in_agree, everywhere = row_excess(torch, logits, logits_p, agree)
        in_clean, _ = row_excess(torch, logits, logits_p, clean)
        return {"route_sets_differ": float(differ.float().mean()),
                "expert_sets_differ": float(experts_differ.float().mean()),
                "tokens_agreeing": int(agree.sum()),
                "tokens_clean": int(clean.sum()),
                "differ_per_layer": differ.sum(1).tolist(),
                "clean_err_roundings": in_clean,
                "agreeing_err_roundings": in_agree,
                "all_err_roundings": everywhere, "what": what}

    out["paths"] = compare(logits_k, codes_k, "flash vs its plain version")
    out["dropped_per_layer"] = [int((c >= e).sum()) for c in codes_k]
    del logits_k
    out["sdpa_paths"] = compare(*run(library=True),
                                "SDPA vs flash's plain version")
    out["route_sets_differ_kernel_sdpa"] = [
        out["paths"]["route_sets_differ"],
        out["sdpa_paths"]["route_sets_differ"]]
    checks.append((out["paths"]["tokens_agreeing"] > 0
                   and out["paths"]["agreeing_err_roundings"]
                   <= ROUTE_ROW_ROUNDINGS,
                   f"moe logits at the {out['paths']['tokens_agreeing']} "
                   f"tokens whose routes agree: "
                   f"{out['paths']['agreeing_err_roundings']:.3g} roundings "
                   f"of the row's largest logit > {ROUTE_ROW_ROUNDINGS}"))
    checks.append((out["paths"]["route_sets_differ"] <= ROUTE_FLIP_LIMIT,
                   f"moe route sets differ at "
                   f"{out['paths']['route_sets_differ']:.4g} of (token, "
                   f"layer) > {ROUTE_FLIP_LIMIT}"))

    def swapped_at(layer):
        layers = lp["layers"]["moe"]
        w = layers["w_out"].clone()
        w[layer] = swapped_w_out(w[layer], busiest[layer])
        return dict(lp, layers=dict(lp["layers"], moe=dict(layers,
                                                          w_out=w)))

    out["faults"] = {}
    for part, layer, metric in ((2, n - 1, "agreeing_err_roundings"),
                                (3, 0, "route_sets_differ")):
        limit = ROUTE_ROW_ROUNDINGS if part == 2 else ROUTE_FLIP_LIMIT
        for kind in ("busiest experts swapped", "dropped slots kept"):
            if kind == "dropped slots kept":
                res = compare(*run(keep_at=layer), kind)
            else:
                res = compare(*run(swapped_at(layer)), kind)
            out["faults"][f"part {part}: {kind} at layer {layer}"] = res
            checks.append((res[metric] > limit, f"moe part {part} passes "
                           f"the planted fault '{kind}' at layer {layer} "
                           f"({metric} {res[metric]:.4g})"))
    del logits_p
    out["gate_s"] = time.perf_counter() - t0
    log(f"[moe] gate {json.dumps(out)}")
    return out, checks


def reset_attention_counts(FL, DA) -> None:
    FL.launches = FL.launches_mma = FL.launches_cuda_cores = 0
    DA.launches = 0


def attention_counts(FL, DA) -> dict:
    return {"flash_attention_mma": FL.launches_mma,
            "flash_attention_cuda_cores": FL.launches_cuda_cores,
            "decode_attention": DA.launches}


def prefill_profile(torch, L, model, lp, tokens) -> dict:
    """A timed prefill of ``tokens`` after a warm one (wall ms, the slots
    dropped at capacity per layer), then a profiled one (device events
    only): device ms, busy share of its wall, the kernels that take most
    of the device time."""
    from torch.profiler import ProfilerActivity, profile

    def once():
        model.prefill(lp, {"tokens": tokens}, cache_len=tokens.shape[1])
        torch.cuda.synchronize()

    once()
    with L.recording_routes() as routes:
        t0 = time.perf_counter()
        once()
        timed = (time.perf_counter() - t0) * 1e3
    dropped = [int((~r["kept"]).sum()) for r in routes]
    slots = int(routes[0]["kept"].numel())
    del routes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if device_work(e)]
    dev = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"prefill_ms": timed, "dropped_per_layer": dropped,
            "slots_per_layer": slots,
            "dropped_share": sum(dropped) / (slots * len(dropped)),
            "profiled_wall_ms": wall, "device_ms": dev,
            "device_busy_share": dev / wall if wall else None,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def olmoe_serving(torch, F, CB, FL, DA, L, PM, Model, serve_llm, seed):
    """Phase 15 (a): olmoe-1b-7b at full width from the seed, served B 8 x
    2048 + 32 through ``serve_llm.generate`` (flash in prefill, decode at
    group 1), the kernels' counts reset before and read after; the
    kernel records at its shapes; the MoE gate."""
    from repro_torch.configs import get
    cfg = dataclasses.replace(get(MOE_ARCH), attn_impl="pallas")
    model = Model(cfg)
    t0 = time.perf_counter()
    lp = PM.cast_compute(model.init(seed), cfg.compute_dtype)
    scale = per_matrix_scale(torch, cfg, lp["layers"])
    torch.cuda.synchronize()
    out = {"arch": MOE_ARCH, "params": model.n_params(),
           "init_s": time.perf_counter() - t0,
           "per_matrix_scale": scale,
           "resident_gb": torch.cuda.memory_allocated() / 1e9}
    kw = dict(reduced=False, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              params=lp, attn_impl="pallas")
    serve_llm.generate(MOE_ARCH, gen=2, **kw)                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts(FL, DA)
    with L.recording_routes() as routes, \
            CaptureFirst(FL, "flash_attention") as fcap, \
            CaptureFirst(DA, "decode_attention") as dcap:
        res = serve_llm.generate(MOE_ARCH, gen=SERVE_GEN,
                                 return_logits=True, **kw)
    torch.cuda.synchronize()
    out["launches"] = attention_counts(FL, DA)
    st = res["stats"]
    out.update(prefill_ms=st.prefill_s * 1e3, decode_ms=st.decode_s * 1e3,
               decode_tokens_per_s=st.tokens_per_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    n = cfg.n_layers
    check(len(routes) == n * (1 + SERVE_GEN), f"{len(routes)} moe calls")
    out["prefill_dropped_per_layer"] = [int((~r["kept"]).sum())
                                        for r in routes[:n]]
    out["prefill_slots_per_layer"] = int(routes[0]["kept"].numel())
    out["decode_dropped"] = sum(int((~r["kept"]).sum())
                                for r in routes[n:])
    del routes
    v = cfg.padded_vocab
    check(tuple(res["prefill_logits"].shape) == (SERVE_BATCH, v)
          and tuple(res["decode_logits"].shape) == (SERVE_BATCH, SERVE_GEN,
                                                    v)
          and bool(torch.isfinite(res["decode_logits"]).all())
          and bool(torch.isfinite(res["prefill_logits"]).all()),
          "olmoe serving: logits of the wrong shape or not finite")
    check(out["launches"] == {"flash_attention_mma": n,
                              "flash_attention_cuda_cores": 0,
                              "decode_attention": n * SERVE_GEN},
          f"olmoe serving launched {out['launches']}")
    del res
    # the serving prompts are ~98 % padding; a prefill of the gate's
    # first prompts (token ids over the whole vocab) times the MoE
    # dispatch at the drops real text gives
    out["prefill_profile_random_prompts"] = prefill_profile(
        torch, L, model, lp, random_prompts(torch, cfg.vocab,
                                            seed + GATE_SEEDS[0]))
    log(f"[moe] serving {json.dumps(out)}")

    records = []
    q, k, v_ = fcap.calls[0][0][:3]
    check(tuple(q.shape) == (SERVE_BATCH, cfg.n_heads, SERVE_PROMPT,
                             cfg.head_dim_), f"olmoe flash {tuple(q.shape)}")
    # no planted faults at olmoe's inputs: its random-init attention is
    # near uniform, so a softmax scale x 0.9 stays within one rounding
    # (error/limit 0.81 on the H100); phase 6 plants them
    records.append(flash_record(torch, F, FL, q, k, v_, True,
                                "flash_attention_mma[olmoe-1b-7b]"))
    del q, k, v_, fcap
    # layer 0's first decode step: the serving cache, group 1
    q, k, v_, lengths = dcap.calls[0][0]
    check(tuple(k.shape) == (SERVE_BATCH, cfg.n_kv, SERVE_PROMPT + SERVE_GEN,
                             cfg.head_dim_)
          and bool((lengths == SERVE_PROMPT + 1).all()),
          f"olmoe cache {tuple(k.shape)}, lengths {lengths.tolist()}")
    records.append(decode_record(torch, F, CB, DA, q, k, v_, lengths,
                                 "decode_attention[olmoe-1b-7b]",
                                 faults=False))
    del q, k, v_, lengths, dcap
    torch.cuda.empty_cache()
    checks, shares = [], {}
    for off in GATE_SEEDS:
        gate, c = moe_gate(torch, L, FL, Model, cfg, lp, seed + off)
        shares[seed + off] = gate["route_sets_differ_kernel_sdpa"]
        checks += c
    log(f"[moe] route sets differing from the plain path's, [flash kernel, "
        f"SDPA] by prompt seed: {json.dumps(shares)}")
    del lp
    torch.cuda.empty_cache()
    return out, records, checks


def large_group_record(torch, F, CB, DA, c: dict, seed: int, label: str):
    """decode_record at the serving cache (B 8 x S 2080, every length
    2049) of a head layout ``c`` (hkv, group, d), inputs from the seed."""
    g = torch.Generator(device="cuda").manual_seed(seed + c["group"])
    s = SERVE_PROMPT + SERVE_GEN
    q = torch.randn(SERVE_BATCH, c["hkv"] * c["group"], c["d"],
                    generator=g, device="cuda").bfloat16()
    k = torch.randn(SERVE_BATCH, c["hkv"], s, c["d"], generator=g,
                    device="cuda").bfloat16()
    v = torch.randn(k.shape, generator=g, device="cuda").bfloat16()
    lengths = torch.full((SERVE_BATCH,), SERVE_PROMPT + 1,
                         dtype=torch.int32, device="cuda")
    return decode_record(torch, F, CB, DA, q, k, v, lengths, label)


def depth_cut_serving(torch, F, FL, DA, PM, Model, serve_llm, arch: str,
                      seed: int):
    """Phase 15 (c): ``arch`` at full width with :data:`DEPTH_CUT` layers,
    one prefill of B 8 x 2048 (and a vision config's seeded prefix) and
    :data:`DEPTH_GEN` decode steps through ``serve_llm.generate``, the
    kernels' counts reset before and read after; the prefill logits
    against the blockwise path's within the bf16 budget (the blockwise
    path against an f32 one, as phase 7)."""
    from repro_torch.configs import get
    n = DEPTH_CUT[arch]
    cfg = dataclasses.replace(get(arch), n_layers=n, attn_impl="pallas")
    model = Model(cfg)
    params = model.init(seed)
    lp = PM.cast_compute(params, cfg.compute_dtype)
    kw = dict(reduced=False, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              params=lp, attn_impl="pallas", n_layers=n, seed=seed)
    with CaptureFirst(FL, "flash_attention") as fcap:
        serve_llm.generate(arch, gen=1, **kw)                # warm-up
    reset_attention_counts(FL, DA)
    res = serve_llm.generate(arch, gen=DEPTH_GEN, return_logits=True, **kw)
    torch.cuda.synchronize()
    st = res["stats"]
    out = {"arch": arch, "layers": n, "of_layers": get(arch).n_layers,
           "params": model.n_params(),
           "launches": attention_counts(FL, DA),
           "prefill_ms": st.prefill_s * 1e3, "decode_ms": st.decode_s * 1e3,
           "decode_tokens_per_s": st.tokens_per_s}
    route = FL.route(cfg.compute_dtype, cfg.head_dim_)
    check(route == "mma", f"{arch}: bf16 at D {cfg.head_dim_} takes the "
          f"{route} kernel, not the tensor cores")
    want = {"flash_attention_mma": n, "flash_attention_cuda_cores": 0,
            "decode_attention": n * DEPTH_GEN}
    check(out["launches"] == want, f"{arch}: launched {out['launches']}, "
          f"not {want}")
    prompts = torch.as_tensor(serve_llm.synthetic_prompts(
        SERVE_BATCH, SERVE_PROMPT, cfg.vocab), device="cuda")
    batch = {"tokens": prompts}
    base = SERVE_PROMPT
    if cfg.frontend == "vision":
        batch["prefix"] = serve_llm.vision_prefix(cfg, SERVE_BATCH, seed + 1,
                                                  "cuda")
        base += cfg.frontend_len
    cache_len = base + DEPTH_GEN
    ref, _ = Model(dataclasses.replace(cfg, attn_impl="blockwise")).prefill(
        lp, batch, cache_len=cache_len)
    del lp
    exact, _ = Model(dataclasses.replace(
        cfg, attn_impl="blockwise", compute_dtype=torch.float32)).prefill(
        params, batch, cache_len=cache_len)
    noise = logit_err(torch, ref, exact, f"{arch} blockwise bf16 vs f32")
    out["blockwise_vs_f32"] = noise
    out["prefill_vs_blockwise"] = logit_err(
        torch, res["prefill_logits"], ref, f"{arch} prefill pallas vs "
        f"blockwise", noise)
    check(bool(torch.isfinite(res["decode_logits"]).all())
          and res["completions"].shape == (SERVE_BATCH, DEPTH_GEN),
          f"{arch}: decode logits not finite or completions misshapen")
    del params, ref, exact, res
    q, k, v = fcap.calls[0][0][:3]
    label = f"flash_attention_{route}[{arch}]"
    record = flash_record(torch, F, FL, q, k, v, True, label)
    record["resources"] = FL.mma_resources()[cfg.head_dim_]
    del q, k, v, fcap
    torch.cuda.empty_cache()
    log(f"[moe] {arch} {json.dumps(out)}")
    return out, record


def moe_phase(torch, seed: int) -> list:
    """Phase 15: the MoE family (olmoe-1b-7b served at full width, its
    gate), decode_attention beyond 8 heads per KV head, and starcoder2-7b
    and pixtral-12b served at full width with 4 layers; returns the kernel
    records, with the kernels' launches over the phase's main-path runs.
    The gate's checks are made at the end, after every number is logged."""
    import torch.nn.functional as F
    from repro_torch.kernels import cuda_build as CB
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FL
    from repro_torch.launch import serve_llm
    from repro_torch.models import layers as L
    from repro_torch.models import param as PM
    from repro_torch.models.modeling import Model

    t0 = time.perf_counter()
    log(f"[moe] decode_attention resources beyond 8 heads per KV head: "
        + json.dumps({f"bf16 G{c['group']} D{c['d']}": DA.resources(
            torch.bfloat16, SERVE_BATCH, c["group"], c["d"])
            for c in LARGE_GROUPS.values()}))
    olmoe, records, checks = olmoe_serving(torch, F, CB, FL, DA, L, PM,
                                           Model, serve_llm, seed)
    launches = {k: olmoe["launches"][k] for k in olmoe["launches"]}
    for arch, c in LARGE_GROUPS.items():
        records.append(large_group_record(
            torch, F, CB, DA, c, seed,
            f"decode_attention[group {c['group']}, {arch}]"))
    for arch in DEPTH_CUT:
        out, rec = depth_cut_serving(torch, F, FL, DA, PM, Model, serve_llm,
                                     arch, seed)
        records.append(rec)
        for k, n in out["launches"].items():
            launches[k] += n
    from repro_torch.configs import get
    cfg = get(SEEDED_FLASH_ARCH)
    records.append(seeded_flash_record(
        torch, F, FL, dict(b=SERVE_BATCH, h=cfg.n_heads, hkv=cfg.n_kv,
                           s=SERVE_PROMPT + cfg.frontend_len,
                           d=cfg.head_dim_),
        seed, f"flash_attention_mma[{SEEDED_FLASH_ARCH}, seeded]"))
    launches["flash_attention"] = (launches["flash_attention_mma"]
                                   + launches["flash_attention_cuda_cores"])
    for r in records:
        r["launches"] = launches[r["name"].split("[")[0]]
        check(r["launches"] > 0, f"{r['name']}: no launch in phase 15")
    log(f"[moe] phase 15 launches {json.dumps(launches)}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase "
        f"15 took {time.perf_counter() - t0:.1f} s")
    for ok, what in checks:
        check(ok, what)
    return records


# ---------------------------------------------------------------------------
# phase 16: the encdec family (seamless-m4t-large-v2 at full width)
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
#: prompt seed (an offset of the script's seed) of the prefill whose
#: layer-0 inputs the kernel records take: token ids drawn over the
#: vocab, since the serving prompts are ~98 % padding, whose identical V
#: rows would hide a fault that only reweights the keys
ENCDEC_RECORD_SEED = 103


def over_budget(err: dict, noise: dict) -> float:
    """The larger of a logit error's two ratios to the bf16 budget
    (:data:`NOISE_FACTOR` x ``noise`` + :data:`NOISE_SLACK`; above 1:
    outside it)."""
    return max(err[k] / (NOISE_FACTOR * noise[k] + NOISE_SLACK[k])
               for k in NOISE_SLACK)


def encdec_gate(torch, serve_llm, ED, L, Model, model, lp, batch, res,
                exact, cache_len: int, seed: int) -> dict:
    """Phase 16 (c): the budget (blockwise bf16 against blockwise f32
    prefill logits, ``exact``); the served prefill logits within it of
    the blockwise bf16 path's; the first decode step's logits within it
    of a forward's at that position (2 rows); and three planted faults
    that must move the kernel path's prefill logits beyond it: frames
    from another seed, the cross attention skipped in every decoder
    layer, the encoder run causally."""
    cfg = model.cfg
    ref = Model(dataclasses.replace(cfg, attn_impl="blockwise")).prefill(
        lp, batch, cache_len=cache_len)[0]
    noise = logit_err(torch, ref, exact, "seamless blockwise bf16 vs f32")
    out = {"blockwise_vs_f32": noise,
           "prefill_vs_blockwise": logit_err(
               torch, res["prefill_logits"], ref,
               "seamless prefill pallas vs blockwise")}
    rows = 2
    seq = torch.cat([batch["tokens"][:rows], torch.as_tensor(
        res["completions"][:rows, :1], device="cuda")], dim=1)
    full = model.forward(lp, {"tokens": seq,
                              "enc_embeds": batch["enc_embeds"][:rows]})[0]
    out["decode_vs_forward"] = logit_err(
        torch, res["decode_logits"][:rows, 0], full[:, SERVE_PROMPT],
        "seamless decode step 0 vs forward")
    del full
    for key in ("prefill_vs_blockwise", "decode_vs_forward"):
        out[key]["over_budget"] = over_budget(out[key], noise)

    def kernel_prefill(b=batch):
        return model.prefill(lp, b, cache_len=cache_len)[0]

    def patched(module, name, fn):
        orig = getattr(module, name)
        setattr(module, name, fn(orig))
        try:
            return kernel_prefill()
        finally:
            setattr(module, name, orig)

    frames = batch["enc_embeds"]
    bad = {
        "frames from another seed": kernel_prefill(dict(
            batch, enc_embeds=serve_llm.audio_frames(
                cfg, frames.shape[0], frames.shape[1], seed + 2, "cuda"))),
        "cross attention skipped": patched(
            ED, "_cross_attend",
            lambda orig: lambda p, c, x, k, v: torch.zeros_like(x)),
        # the encoder's self attention is the only L.attention of prefill
        "encoder causal": patched(
            L, "attention", lambda orig: lambda p, c, *a: orig(
                p, dataclasses.replace(c, causal=True), *a)),
    }
    out["faults"] = {}
    for name, logits in bad.items():
        err = logit_err(torch, logits, ref, f"seamless {name}")
        out["faults"][name] = dict(err, over_budget=over_budget(err, noise))
    del bad, ref
    log(f"[encdec] gate {json.dumps(out)}")
    for key in ("prefill_vs_blockwise", "decode_vs_forward"):
        check(out[key]["over_budget"] <= 1.0, f"seamless {key}: "
              f"{out[key]['over_budget']:.3g} of the bf16 budget {noise}")
    for name, f in out["faults"].items():
        check(f["over_budget"] > 1.0, f"seamless: the bf16 budget passes "
              f"the planted fault '{name}' ({f['over_budget']:.3g} of it)")
    return out


def encdec_records(torch, F, CB, FL, DA, model, lp, frames,
                   cache_len: int, seed: int) -> list:
    """Phase 16 (b): flash at the encoder's and the decoder's layer-0
    inputs and decode_attention at the first decode step's, from a
    kernel-path prefill of token ids drawn over the vocab and the served
    frames, each against its plain version with phase 6's planted
    faults."""
    cfg = model.cfg
    batch = {"tokens": random_prompts(torch, cfg.vocab,
                                      seed + ENCDEC_RECORD_SEED),
             "enc_embeds": frames}
    with Capture(FL, "flash_attention") as fcap:
        logits, caches = model.prefill(lp, batch, cache_len=cache_len)
    with CaptureFirst(DA, "decode_attention") as dcap:
        model.decode_step(lp, logits.argmax(-1), caches, SERVE_PROMPT)
    del logits, caches
    check(len(fcap.calls) == cfg.enc_layers + cfg.dec_layers,
          f"seamless prefill called flash {len(fcap.calls)} times")
    records = []
    for (args, kw), part, s in (
            (fcap.calls[0], "encoder", frames.shape[1]),
            (fcap.calls[cfg.enc_layers], "decoder", SERVE_PROMPT)):
        q, k, v = args
        causal = part == "decoder"
        check(kw == {"causal": causal} and tuple(q.shape) == tuple(k.shape)
              == (SERVE_BATCH, cfg.n_heads, s, cfg.head_dim_),
              f"seamless {part} flash {tuple(q.shape)}, {kw}")
        records.append(flash_record(
            torch, F, FL, q, k, v, causal,
            f"flash_attention_mma[{ENCDEC_ARCH} {part}]", faults=True))
    del fcap, q, k, v, args
    q, k, v, lengths = dcap.calls[0][0]
    check(tuple(k.shape) == (SERVE_BATCH, cfg.n_kv, cache_len,
                             cfg.head_dim_)
          and bool((lengths == SERVE_PROMPT + 1).all()),
          f"seamless cache {tuple(k.shape)}, lengths {lengths.tolist()}")
    records.append(decode_record(torch, F, CB, DA, q, k, v, lengths,
                                 f"decode_attention[{ENCDEC_ARCH}]"))
    return records


def encdec_phase(torch, seed: int) -> list:
    """Phase 16: seamless-m4t-large-v2 at full width and depth from the
    seed (each stacked layer weight at its own fan-in), its f32 blockwise
    prefill for the budget, then (a) served B 8 x 2048 + 32 greedy tokens
    through ``serve_llm.generate`` with the kernels' counts reset before
    and read after, (c) :func:`encdec_gate`, (b) :func:`encdec_records`;
    returns the kernel records with the serving run's launches."""
    import torch.nn.functional as F
    from repro_torch.configs import get
    from repro_torch.kernels import cuda_build as CB
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FL
    from repro_torch.launch import serve_llm
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    from repro_torch.models import param as PM
    from repro_torch.models.modeling import Model, enc_len_of

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get(ENCDEC_ARCH), attn_impl="pallas")
    model = Model(cfg)
    params = model.init(seed)
    scale = {t: per_matrix_scale(torch, cfg, params[t])
             for t in ("enc_layers", "dec_layers")}
    lp = PM.cast_compute(params, cfg.compute_dtype)
    enc_len = enc_len_of(cfg, SERVE_PROMPT)
    cache_len = SERVE_PROMPT + SERVE_GEN
    batch = {"tokens": torch.as_tensor(serve_llm.synthetic_prompts(
                 SERVE_BATCH, SERVE_PROMPT, cfg.vocab), device="cuda"),
             "enc_embeds": serve_llm.audio_frames(
                 cfg, SERVE_BATCH, enc_len, seed + 1, "cuda")}
    # the budget's f32 side first: the f32 masters are freed before serving
    exact = Model(dataclasses.replace(
        cfg, attn_impl="blockwise", compute_dtype=torch.float32)).prefill(
        params, batch, cache_len=cache_len)[0]
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"arch": ENCDEC_ARCH, "params": model.n_params(),
           "enc_len": enc_len, "per_matrix_scale": scale,
           "init_and_f32_prefill_s": time.perf_counter() - t0,
           "resident_gb": torch.cuda.memory_allocated() / 1e9}

    # (a) serving, the kernels' counts reset just before and read after
    kw = dict(reduced=False, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              params=lp, attn_impl="pallas", seed=seed)
    serve_llm.generate(ENCDEC_ARCH, gen=2, **kw)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts(FL, DA)
    res = serve_llm.generate(ENCDEC_ARCH, gen=SERVE_GEN, return_logits=True,
                             **kw)
    torch.cuda.synchronize()
    out["launches"] = attention_counts(FL, DA)
    st = res["stats"]
    out.update(prefill_ms=st.prefill_s * 1e3, decode_ms=st.decode_s * 1e3,
               decode_tokens_per_s=st.tokens_per_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    v = cfg.padded_vocab
    check(tuple(res["prefill_logits"].shape) == (SERVE_BATCH, v)
          and tuple(res["decode_logits"].shape) == (SERVE_BATCH, SERVE_GEN,
                                                    v)
          and bool(torch.isfinite(res["prefill_logits"]).all())
          and bool(torch.isfinite(res["decode_logits"]).all()),
          "seamless serving: logits of the wrong shape or not finite")
    want = {"flash_attention_mma": cfg.enc_layers + cfg.dec_layers,
            "flash_attention_cuda_cores": 0,
            "decode_attention": cfg.dec_layers * SERVE_GEN}
    check(out["launches"] == want, f"seamless serving launched "
          f"{out['launches']}, not {want}")
    log(f"[encdec] serving {json.dumps(out)}")

    # (c) the model gate, (b) the kernels at the path's shapes
    gate = encdec_gate(torch, serve_llm, ED, L, Model, model, lp, batch,
                       res, exact, cache_len, seed)
    del res, exact
    torch.cuda.empty_cache()
    records = encdec_records(torch, F, CB, FL, DA, model, lp,
                             batch["enc_embeds"], cache_len, seed)
    for r in records:
        r["launches"] = out["launches"][r["name"].split("[")[0]]
    del lp, batch
    torch.cuda.empty_cache()
    log(f"[encdec] phase 16 took {time.perf_counter() - t0:.1f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"prefill vs blockwise {json.dumps(gate['prefill_vs_blockwise'])}")
    return records


# ---------------------------------------------------------------------------
# phase 17: the ssm family (mamba2-130m at full width)
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-130m"
#: ``repro.models.modeling.Model(get("mamba2_130m")).n_params()`` of the
#: JAX package (``tests/test_torch_configs.py`` holds the port's equal)
JAX_SSM_N_PARAMS = 167_635_392
#: long_500k's 524 288 tokens at B 1: a prompt of 2047 chunks of 256,
#: then 256 greedy tokens (an odd length would fall to chunks of 1)
LONG_PROMPT, LONG_GEN = 524_032, 256
#: decode steps each planted fault of the gate is held over
SSM_FAULT_STEPS = 4
#: offsets of the script's seed: the gate's and long_500k's prompts, the
#: per-head decays
SSM_GATE_SEED, SSM_LONG_SEED, SSM_DECAY_SEED = 104, 105, 106
#: the layers of long_500k's profiled prefill, the decode steps of the
#: profiled serving decode (B 8)
SSM_PROFILE_LAYERS, SSM_PROFILE_STEPS = 2, 4
#: the trainer's run: 5 steps at train_4k's length, B 4
SSM_TRAIN_STEPS, SSM_TRAIN_DOCS = 5, 200


def mamba2_decays(torch, cfg, params, seed: int) -> dict:
    """The seeded weights made to behave as a trained Mamba2's, in place:
    each stacked mixer matrix rescaled from the init's fan-in (which
    counts the layer axis) to its own contraction's, and the per-head
    decays drawn as the Mamba2 reference initialises them (A uniform in
    [1, 16], dt log-uniform in [0.001, 0.1] through ``dt_bias``, the
    inverse softplus), where the spec's constant init (A 1, dt 0.69)
    forgets a token's state in a few tokens and so no chunk's state would
    reach the next.  Returns the rescale factors and the range of the
    per-token decays exp(-A dt)."""
    mixer = params["layers"]["mixer"]
    factors = {}
    for name in ("in_proj", "out_proj", "conv_w"):
        factors[name] = math.sqrt(mixer[name].shape[0])
        mixer[name].mul_(factors[name])
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = mixer["A_log"].shape
    a = 1 + 15 * torch.rand(shape, generator=g, device="cuda")
    dt = torch.exp(math.log(1e-3) + torch.rand(shape, generator=g,
                                                device="cuda")
                   * (math.log(0.1) - math.log(1e-3)))
    mixer["A_log"].copy_(torch.log(a))
    mixer["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    decay = torch.exp(-a * dt)
    return {"rescale": factors, "decay_min": float(decay.min()),
            "decay_max": float(decay.max())}


@contextlib.contextmanager
def seeded_prompts(serve_llm, seed: int):
    """``serve_llm.generate``'s prompts drawn uniformly over the vocab
    from ``seed`` while active (its own are ~30 byte tokens and padding,
    which hide faults)."""
    orig = serve_llm.synthetic_prompts
    serve_llm.synthetic_prompts = lambda batch, prompt_len, vocab: (
        np.random.default_rng(seed).integers(0, vocab, (batch, prompt_len)))
    try:
        yield
    finally:
        serve_llm.synthetic_prompts = orig


def ssm_gate(torch, SSM, TF, Model, model, params, lp, prompts, res) -> dict:
    """Phase 17 (b): the budget (a bf16 forward over prompt + completion
    against the f32 forward, at the served positions); the served prefill
    logits and every decode step's within it of the bf16 forward's; and
    three planted faults that must move the first
    :data:`SSM_FAULT_STEPS` decode steps (teacher-forced on the served
    completions) beyond it: the decay exp(a dt) skipped in every decode
    step, the conv tail taken one position early, the decode started
    from a zeroed state."""
    cfg = model.cfg
    p0 = prompts.shape[1]
    comp = torch.as_tensor(res["completions"], device="cuda")
    seq = torch.cat([prompts, comp], dim=1)
    keep = slice(p0 - 1, seq.shape[1])              # the served positions
    ref = model.forward(lp, {"tokens": seq})[0][:, keep].contiguous()
    f32 = Model(dataclasses.replace(cfg, compute_dtype=torch.float32))
    exact = f32.forward(params, {"tokens": seq})[0][:, keep].contiguous()
    noise = logit_err(torch, ref, exact, "mamba2 forward bf16 vs f32")
    del exact
    out = {"forward_bf16_vs_f32": noise,
           "prefill_vs_forward": logit_err(
               torch, res["prefill_logits"], ref[:, 0],
               "mamba2 served prefill vs forward"),
           "decode_vs_forward": logit_err(
               torch, res["decode_logits"], ref[:, 1:],
               "mamba2 served decode steps vs forward")}
    for key in ("prefill_vs_forward", "decode_vs_forward"):
        out[key]["over_budget"] = over_budget(out[key], noise)

    def forced(hook=None):
        logits, caches = model.prefill(lp, {"tokens": prompts})
        if hook:
            hook(caches)
        steps = []
        for i in range(SSM_FAULT_STEPS):
            logits, caches = model.decode_step(lp, comp[:, i], caches,
                                               p0 + i)
            steps.append(logits)
        return torch.stack(steps, 1)

    def patched(module, name, fn):
        orig = getattr(module, name)
        setattr(module, name, fn(orig))
        try:
            return forced()
        finally:
            setattr(module, name, orig)

    bad = {
        # A_log -inf makes a = -exp(A_log) zero: exp(a dt) is 1
        "decay skipped": patched(SSM, "mamba2_step", lambda orig: (
            lambda p, c, u, cache, sc: orig(
                dict(p, A_log=torch.full_like(p["A_log"], -math.inf)), c,
                u, cache, sc))),
        "conv tail one position early": patched(
            TF, "SSM_conv_tail",
            lambda orig: lambda p, c, h: orig(p, c, h[:, :-1])),
        "zeroed state": forced(
            lambda caches: caches["layers"]["state"].zero_()),
    }
    # (e) where a decode step's time goes: SSM_PROFILE_STEPS steps at B 8
    logits, caches = model.prefill(lp, {"tokens": prompts})
    out["profile_decode"] = dict(device_profile(torch, lambda: [
        model.decode_step(lp, comp[:, i], caches, p0 + i)
        for i in range(SSM_PROFILE_STEPS)]), steps=SSM_PROFILE_STEPS)
    del logits, caches
    out["faults"] = {}
    want = ref[:, 1:1 + SSM_FAULT_STEPS]
    for name, logits in bad.items():
        err = logit_err(torch, logits, want, f"mamba2 {name}")
        out["faults"][name] = dict(err, over_budget=over_budget(err, noise))
    del bad, ref, want
    log(f"[ssm] gate {json.dumps(out)}")
    for key in ("prefill_vs_forward", "decode_vs_forward"):
        check(out[key]["over_budget"] <= 1.0, f"mamba2 {key}: "
              f"{out[key]['over_budget']:.3g} of the bf16 budget {noise}")
    for name, f in out["faults"].items():
        check(f["over_budget"] > 1.0, f"mamba2: the bf16 budget passes the "
              f"planted fault '{name}' ({f['over_budget']:.3g} of it)")
    return out


def device_profile(torch, fn) -> dict:
    """One call of ``fn`` after a warm one, profiled (device events only):
    its wall ms, device ms, busy share, kernel launches and the kernels
    that take most of the device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if device_work(e)]
    dev = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"wall_ms": wall, "device_ms": dev, "device_busy_share":
            dev / wall, "launches": sum(e.count for e in kernels),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def ssm_long(torch, SSM, serve_llm, Model, model, params, lp,
             seed: int) -> dict:
    """Phase 17 (c): long_500k -- B 1, a prompt of :data:`LONG_PROMPT`
    token ids from the seed, :data:`LONG_GEN` greedy tokens through
    ``serve_llm.generate``; the last decode step's logits within the
    budget (``Model.prefill`` over prompt + completion in bf16 against
    the same in f32, 524 288 tokens, the same slabs) of the bf16
    prefill's."""
    cfg = model.cfg
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with seeded_prompts(serve_llm, seed + SSM_LONG_SEED):
        res = serve_llm.generate(SSM_ARCH, reduced=False, batch=1,
                                 prompt_len=LONG_PROMPT, gen=LONG_GEN,
                                 params=lp, seed=seed, return_logits=True)
        prompts = serve_llm.synthetic_prompts(1, LONG_PROMPT, cfg.vocab)
    torch.cuda.synchronize()
    st = res["stats"]
    n = LONG_PROMPT + LONG_GEN
    q = SSM.chunk_len(n, cfg.ssm_chunk)
    out = {"prompt": LONG_PROMPT, "gen": LONG_GEN, "tokens": n,
           "chunk": SSM.chunk_len(LONG_PROMPT, cfg.ssm_chunk),
           "slabs_per_layer": len(SSM._slabs(
               n // q, cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
               * q * q)),
           "prefill_ms": st.prefill_s * 1e3, "decode_ms": st.decode_s * 1e3,
           "decode_tokens_per_s": st.tokens_per_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card_gb": total / 1e9}
    check(res["completions"].shape == (1, LONG_GEN)
          and tuple(res["decode_logits"].shape) == (1, LONG_GEN,
                                                    cfg.padded_vocab)
          and bool(torch.isfinite(res["decode_logits"]).all()),
          "mamba2 long_500k: logits of the wrong shape or not finite")
    seq = torch.cat([torch.as_tensor(prompts, device="cuda"),
                     torch.as_tensor(res["completions"], device="cuda")], 1)
    check(tuple(seq.shape) == (1, n) and q == cfg.ssm_chunk,
          f"long_500k sequence {tuple(seq.shape)}, chunk {q}")
    t0 = time.perf_counter()
    ref = model.prefill(lp, {"tokens": seq})[0]
    torch.cuda.synchronize()
    out["prefill_524288_ms"] = (time.perf_counter() - t0) * 1e3
    # (e) where a prefill's time goes: the same sequence through the
    # first SSM_PROFILE_LAYERS layers
    from repro_torch.models import param as PM
    cut = dict(lp, layers=PM.tree_map(lambda a: a[:SSM_PROFILE_LAYERS],
                                      lp["layers"]))
    out["profile_prefill"] = dict(device_profile(
        torch, lambda: model.prefill(cut, {"tokens": seq})),
        layers=SSM_PROFILE_LAYERS)
    del cut
    exact = Model(dataclasses.replace(
        cfg, compute_dtype=torch.float32)).prefill(params,
                                                   {"tokens": seq})[0]
    noise = logit_err(torch, ref, exact, "mamba2 long_500k bf16 vs f32")
    err = logit_err(torch, res["decode_logits"][:, -1], ref,
                    "mamba2 long_500k last decode step vs prefill")
    out["prefill_bf16_vs_f32"] = noise
    out["last_decode_vs_prefill"] = dict(err,
                                         over_budget=over_budget(err, noise))
    out["peak_gb_with_checks"] = torch.cuda.max_memory_allocated() / 1e9
    del res, seq, ref, exact
    log(f"[ssm] long_500k {json.dumps(out)}")
    check(out["last_decode_vs_prefill"]["over_budget"] <= 1.0,
          f"mamba2 long_500k: the last decode step at "
          f"{out['last_decode_vs_prefill']['over_budget']:.3g} of the bf16 "
          f"budget {noise}")
    return out


def ssm_train(torch, seed: int) -> dict:
    """Phase 17 (d): :data:`SSM_TRAIN_STEPS` steps of mamba2-130m at full
    width through ``launch.train.train_loop`` at B 4 x S 4096 on
    synthetic documents (the ``compiled`` ETL); the loss finite."""
    from repro_torch.launch.train import TrainRun, train_loop
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_loop(TrainRun(
        arch=SSM_ARCH, reduced=False, steps=SSM_TRAIN_STEPS,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, warmup=2, seed=seed,
        n_docs=SSM_TRAIN_DOCS, log_every=1, device="cuda"))
    torch.cuda.synchronize()
    losses = run["losses"]
    check(len(losses) == SSM_TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"mamba2 training losses {losses}")
    step_ms = [t * 1e3 for t in run["step_s"][1:]]
    out = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
           "step_ms_first": run["step_s"][0] * 1e3,
           "step_ms": float(np.median(step_ms)),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "run_s": time.perf_counter() - t0}
    out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (out["step_ms"] / 1e3)
    log(f"[ssm] train {json.dumps(out)}")
    return out


def ssm_phase(torch, seed: int) -> None:
    """Phase 17: mamba2-130m at full width and depth from the seed
    (:func:`mamba2_decays`); (a) served B 8 x 2048 + 32 greedy tokens on
    seeded token ids through ``serve_llm.generate`` -- prefill ms, decode
    ms, tokens/s, peak bytes, the attention kernels' launches (none);
    (b) :func:`ssm_gate`; (c) :func:`ssm_long`; (d) :func:`ssm_train`;
    (e) profiles of 4 decode steps at B 8 (in the gate) and of a
    long_500k prefill through 2 layers (in ``ssm_long``).
    The attention kernels' counts are reset at its start and must read 0
    at its end: the family has no attention."""
    from repro_torch.configs import get
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FL
    from repro_torch.launch import serve_llm
    from repro_torch.models import param as PM
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TF
    from repro_torch.models.modeling import Model

    t0 = time.perf_counter()
    reset_attention_counts(FL, DA)
    cfg = get(SSM_ARCH)
    model = Model(cfg)
    params = model.init(seed)
    out = {"arch": SSM_ARCH, "params": model.n_params(),
           "jax_params": JAX_SSM_N_PARAMS,
           "init": mamba2_decays(torch, cfg, params, seed + SSM_DECAY_SEED)}
    check(out["params"] == JAX_SSM_N_PARAMS,
          f"mamba2: {out['params']} parameters, the JAX package's "
          f"{JAX_SSM_N_PARAMS}")
    lp = PM.cast_compute(params, cfg.compute_dtype)

    # (a) serving on seeded token ids, the kernels' counts reset just
    # before and read just after
    kw = dict(reduced=False, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              params=lp, seed=seed)
    with seeded_prompts(serve_llm, seed + SSM_GATE_SEED):
        serve_llm.generate(SSM_ARCH, gen=2, **kw)              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_attention_counts(FL, DA)
        res = serve_llm.generate(SSM_ARCH, gen=SERVE_GEN,
                                 return_logits=True, **kw)
        torch.cuda.synchronize()
        out["launches"] = attention_counts(FL, DA)
        prompts = torch.as_tensor(serve_llm.synthetic_prompts(
            SERVE_BATCH, SERVE_PROMPT, cfg.vocab), device="cuda")
    st = res["stats"]
    out.update(prefill_ms=st.prefill_s * 1e3, decode_ms=st.decode_s * 1e3,
               decode_tokens_per_s=st.tokens_per_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    v = cfg.padded_vocab
    check(tuple(res["prefill_logits"].shape) == (SERVE_BATCH, v)
          and tuple(res["decode_logits"].shape) == (SERVE_BATCH, SERVE_GEN,
                                                    v)
          and bool(torch.isfinite(res["prefill_logits"]).all())
          and bool(torch.isfinite(res["decode_logits"]).all()),
          "mamba2 serving: logits of the wrong shape or not finite")
    check(sum(out["launches"].values()) == 0,
          f"mamba2 serving launched attention kernels {out['launches']}")
    log(f"[ssm] serving {json.dumps(out)}")

    # (b) the gate, (c) long_500k, (d) training
    gate = ssm_gate(torch, SSM, TF, Model, model, params, lp, prompts, res)
    del res, prompts
    torch.cuda.empty_cache()
    long = ssm_long(torch, SSM, serve_llm, Model, model, params, lp, seed)
    del params, lp
    torch.cuda.empty_cache()
    train = ssm_train(torch, seed)
    torch.cuda.empty_cache()
    counts = attention_counts(FL, DA)
    check(sum(counts.values()) == 0,
          f"phase 17 launched attention kernels {counts}")
    log(f"[ssm] phase 17 took {time.perf_counter() - t0:.1f} s; serving "
        f"prefill {out['prefill_ms']:.1f} ms, {out['decode_tokens_per_s']:.1f}"
        f" tokens/s; decode at {gate['decode_vs_forward']['over_budget']:.3g}"
        f" of the budget; long_500k prefill {long['prefill_ms']:.1f} ms, "
        f"{long['decode_tokens_per_s']:.1f} tokens/s, peak "
        f"{long['peak_gb']:.2f} of {long['card_gb']:.2f} GB; train step "
        f"{train['step_ms']:.1f} ms; attention launches {json.dumps(counts)}")


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
    from repro_torch.kernels.segmented_reduce import kernel as SR

    got = SS.segmented_sum(values, codes, groups)
    want = SS.segmented_sum_plain(values, codes, groups)
    err = compare(torch, got, want, label)
    n = values.numel()
    # per row: two range comparisons and one add
    b, by = bound_ms(nbytes([values, codes, got]), 3 * n)
    lib = lambda: torch.bincount(codes, weights=values,  # noqa: E731
                                 minlength=groups)
    # bincount reads the codes' min and max on the host before it
    # launches (no graph can hold it): its kernels' device time
    lib_device, lib_events = profiled_device_ms(torch, lib)
    return dict(
        name=label, route="cuda",
        source="src/repro_torch/kernels/csrc/segmented_sum.cuh",
        replaces="src/repro/kernels/segmented_reduce/kernel.py:73",
        shape=f"{n} rows, G={groups}", launches=launches, max_abs_err=err,
        reps=SR.replicas(1, groups),
        ms=cuda_ms(torch, lambda: SS.segmented_sum(values, codes, groups)),
        device_ms=graph_ms(torch, lambda: SS.segmented_sum(values, codes,
                                                           groups)),
        plain_ms=cuda_ms(torch, lambda: SS.segmented_sum_plain(
            values, codes, groups), runs=5, warmup=1),
        bound_ms=b, bound_by=by, library_ms=cuda_ms(torch, lib),
        library_device_ms=lib_device, library_device_events=lib_events)


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

# ---------------------------------------------------------------------------
# phase 9: the heterogeneous pipelines (paper Fig. 8 / 13)
# ---------------------------------------------------------------------------

#: the points table: benchmarks/bench_ml.py's generator (4 Gaussian
#: clusters, d 8, seed 0) at a card's size; its 20 000 rows are a CPU size.
#: Under 2^24 rows per cluster, so f32 counts stay exact.
POINTS_ROWS, POINTS_D = 10_000_000, 8
#: compiled against the volcano oracle: the reference tests' limits
#: (tests/test_heterogeneous.py), with tol 0 and a fixed max_iter
ORACLE_TOL = {"kmeans": (1e-3, 1e-3), "logreg": (1e-4, 1e-5),
              "gda": (1e-3, 1e-4)}
ORACLE_ITERS = {"kmeans": 10, "logreg": 20}
#: compiled (fused) against stage (staged): the same kernel on the card
STAGED_RTOL, STAGED_ATOL = 1e-4, 1e-6


def points_table(T, n: int, d: int = POINTS_D, seed: int = 0):
    """``benchmarks/bench_ml.py``'s ``_features_table`` on the port."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5, (4, d))
    assign = rng.integers(0, 4, n)
    x = centers[assign] + rng.normal(0, 1, (n, d))
    data = {f"f{i}": x[:, i] for i in range(d)}
    data["label"] = (assign % 2).astype(np.int32)
    data["quality"] = rng.uniform(0, 1, n)
    return T.Table.from_arrays(data)


def value_fields(v) -> dict:
    """A trained kernel's result (NamedTuple or dict) as name -> array."""
    return dict(v._asdict()) if hasattr(v, "_asdict") else dict(v)


def values_close(got, want, rtol: float, atol: float, what: str,
                 padded_assignments: bool = False) -> float:
    """Every field of two trained results within ``atol + rtol |want|``;
    returns the largest abs difference.  Assignments of a padded
    (compiled) against a compacted (volcano) run are not compared."""
    err = 0.0
    for k, w in value_fields(want).items():
        if k == "assignments" and padded_assignments:
            continue
        a = np.asarray(value_fields(got)[k], np.float64)
        b = np.asarray(w, np.float64)
        check(a.shape == b.shape, f"{what}.{k}: shape {a.shape} vs {b.shape}")
        check(bool(np.isfinite(a).all()), f"{what}.{k}: non-finite")
        bad = np.abs(a - b) > atol + rtol * np.abs(b)
        check(not bad.any(), f"{what}.{k}: {a[bad][:3]} vs {b[bad][:3]}")
        if a.size:
            err = max(err, float(np.abs(a - b).max()))
    return err


def fired(lowered) -> list:
    rep = lowered.dispatch_report()
    return rep.fired_patterns() if rep is not None else []


def d2h_copies(names: list) -> int:
    return sum("DtoH" in n for n in names)


def pipeline_record(torch, name: str, df, rows: int, d: int) -> dict:
    """One pipeline fused (``compiled``) and staged (``stage``) on the card:
    equal results, host ms (median of 5), one profile of each, and the
    fired patterns of ``compiled-native`` (whose result equals compiled)."""
    fused = df.lower(engine="compiled").compile()
    staged = df.lower(engine="stage").compile()
    got, st = fused(), staged()
    trained = not isinstance(got, dict)
    if trained:
        if "iters" in value_fields(got):
            check(int(got.iters) == int(st.iters),
                  f"{name}: fused {int(got.iters)} iterations, staged "
                  f"{int(st.iters)}")
        staged_err = values_close(st, got, STAGED_RTOL, STAGED_ATOL,
                                  f"{name} staged vs fused")
    else:
        assert_close(st, got, f"{name} staged vs fused")
        staged_err = None
    native = df.lower(engine="compiled", native=True)
    if trained:
        values_close(native.compile()(), got, STAGED_RTOL, STAGED_ATOL,
                     f"{name} native vs fused")
    else:
        assert_close(native.compile()(), got, f"{name} native vs fused")
    fused_ms = host_ms(torch, fused.result)
    staged_ms = host_ms(torch, staged.result)
    events, wall, names = profiled(torch, fused.result)
    dev = sum(e.self_device_time_total for e in events) / 1e3
    s_events, s_wall, s_names = profiled(torch, staged.result)
    s_dev = sum(e.self_device_time_total for e in s_events) / 1e3
    # a trained result's iterations (gda: one closed-form pass); an
    # iteration must read the [n, d] f32 matrix twice (the distances or
    # the forward product, then the group sums or the gradient) and the
    # f32 weights once
    iters = None
    if trained:
        iters = int(got.iters) if "iters" in value_fields(got) else 1
    it_bytes = 2 * rows * d * 4 + rows * 4
    rec = {"pipeline": name, "rows": rows, "features": d,
           "fused_ms": fused_ms, "staged_ms": staged_ms,
           "staged_over_fused": staged_ms / fused_ms,
           "iters": iters,
           "fused_ms_per_iter": fused_ms / iters if iters else None,
           "iter_bound_ms": (it_bytes / H100_BYTES_PER_S * 1e3
                             if trained else None),
           "fused_device_ms": dev, "fused_wall_ms": wall,
           "fused_busy_share": dev / wall if wall else None,
           "fused_d2h_copies": d2h_copies(names),
           "fused_events": len(names),
           "staged_device_ms": s_dev, "staged_wall_ms": s_wall,
           "staged_busy_share": s_dev / s_wall if s_wall else None,
           "staged_d2h_copies": d2h_copies(s_names),
           "native_fired": fired(native), "staged_max_abs_err": staged_err,
           "fused_top": [[e.key[:50], e.self_device_time_total / 1e3,
                          e.count] for e in sorted(
               events, key=lambda e: e.self_device_time_total,
               reverse=True)[:4]]}
    log(f"[hetero] {json.dumps(rec)}")
    return rec


def oracle_check(torch, name: str, df) -> dict:
    """``df`` (tol 0, a fixed max_iter) compiled on the card against the
    volcano oracle on the host, once."""
    got = df.lower(engine="compiled").compile()()
    want, v_ms = wall_ms(lambda: df.lower(engine="volcano").compile()())
    rtol, atol = ORACLE_TOL[name]
    if "iters" in value_fields(got):
        check(int(got.iters) == int(want.iters),
              f"{name} oracle: {int(got.iters)} vs {int(want.iters)} "
              "iterations")
    err = values_close(got, want, rtol, atol, f"{name} compiled vs volcano",
                       padded_assignments=True)
    return {"pipeline": name, "oracle_max_abs_err": err, "rtol": rtol,
            "atol": atol, "volcano_ms": v_ms}


#: group counts at which phase 9 times both routes of group_by_reduce (the
#: one-hot route's [k, n] f64 matrix is 5.1 GB at k 64 and 10 M rows)
GROUP_SWEEP = (4, 8, 16, 32, 64)


def group_routes(torch, ML, x, w) -> dict:
    """``group_by_reduce``'s two routes alone at the points shape, for
    each k of ``GROUP_SWEEP`` (keys from the first k rows' nearest
    centroid): equal f64 sums and counts, CUDA-event ms each, and the
    route ``group_route`` picks."""
    n, d = x.shape
    out = {"rows": n, "features": d, "onehot_max_groups":
           ML.ONEHOT_MAX_GROUPS, "by_k": {}}
    for k in GROUP_SWEEP:
        keys = torch.argmin(ML.dist(x, x[:k]), dim=1).to(torch.int32)
        rec, sums = {}, {}
        for route, fn in ML.GROUP_ROUTES.items():
            sums[route] = fn(keys, x, w, k)
            rec[f"{route}_ms"] = cuda_ms(
                torch, lambda f=fn: f(keys, x, w, k), runs=5)
        a, b = sums["onehot"], sums["index_add"]
        check(torch.equal(a[1], b[1]),
              f"group_by_reduce counts differ by route at k {k}")
        check(bool(torch.allclose(a[0], b[0], rtol=1e-9, atol=1e-6)),
              f"group_by_reduce sums differ by route at k {k}")
        rec.update({"kept": ML.group_route(k),
                    "max_abs_diff": float((a[0] - b[0]).abs().max()),
                    "bound_ms": (n * d * 4 + 2 * n * 4 + k * (d + 1) * 8)
                    / H100_BYTES_PER_S * 1e3})
        out["by_k"][k] = rec
        del keys, sums, a, b
    log(f"[hetero] group_by_reduce {json.dumps(out)}")
    return out


def log_price(cols):
    """Fig. 8's batch UDF on lineitem: the log of the extended price."""
    import torch
    return {"log_price": torch.log1p(cols["l_extendedprice"])}


def hetero_phase(torch, ctx, seed: int) -> None:
    """Phase 9: the points pipelines at 10 M rows, then the Fig. 8 shape
    on the SF 10 context's lineitem."""
    from repro_torch.core import FlareContext, col, sum_, udf
    from repro_torch.core import ml as ML
    from repro_torch.relational import table as T

    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must run in full f32 (dist's argmin ties)")
    t0 = time.perf_counter()
    pts = FlareContext(device="cuda")
    pts.register("points", points_table(T, POINTS_ROWS, seed=seed))
    pts.preload("points")
    torch.cuda.synchronize()
    log(f"[hetero] points: {POINTS_ROWS} rows, d {POINTS_D}, seed {seed}, "
        f"{time.perf_counter() - t0:.1f} s to make and load")
    feat = [f"f{i}" for i in range(POINTS_D)]
    etl = pts.table("points").filter(col("quality") > 0.1)

    def radius(cols):
        return {"r": torch.sqrt(cols["f0"] ** 2 + cols["f1"] ** 2),
                "s": torch.tanh(cols["f0"])}

    norm = udf("float32")(lambda x, y: torch.sqrt(x * x + y * y))
    pipelines = {
        "kmeans": etl.to_matrix(*feat).train("kmeans", k=4, max_iter=50),
        "logreg": etl.train("logreg", columns=feat, label="label",
                            max_iter=100),
        "gda": etl.train("gda", columns=feat, label="label"),
        "map_batches": (etl.map_batches(radius, columns=["f0", "f1"],
                                        schema={"r": "float32",
                                                "s": "float32"})
                        .filter(col("r") < 5.0)
                        .agg(sum_(col("r"), "total"),
                             sum_(col("s"), "stot"))),
        "udf_select": etl.select(("u", norm(col("f0"), col("f1")))),
    }
    records = [pipeline_record(torch, name, df, POINTS_ROWS, POINTS_D)
               for name, df in pipelines.items()]
    u = pipelines["udf_select"].lower(engine="compiled").compile()()["u"]
    tbl = pts.catalog.table("points")
    # the filter compares the f32 device column with f32(0.1)
    keep = np.asarray(tbl["quality"]).astype(np.float32) > np.float32(0.1)
    want = np.hypot(np.asarray(tbl["f0"])[keep], np.asarray(tbl["f1"])[keep])
    check(u.shape == want.shape and bool(np.allclose(u, want, rtol=1e-5)),
          "udf_select against numpy")

    oracles = [
        oracle_check(torch, "kmeans", etl.to_matrix(*feat).train(
            "kmeans", k=4, tol=0.0, max_iter=ORACLE_ITERS["kmeans"])),
        oracle_check(torch, "logreg", etl.train(
            "logreg", columns=feat, label="label", tol=0.0,
            max_iter=ORACLE_ITERS["logreg"])),
        oracle_check(torch, "gda", pipelines["gda"])]
    log(f"[hetero] compiled vs the volcano oracle: {json.dumps(oracles)}")

    # the matrix and the weights the kernels train on
    x = torch.stack([pts.cache.get(tbl, c) for c in feat], dim=1)
    w = (pts.cache.get(tbl, "quality") > 0.1).float()
    group_routes(torch, ML, x, w)
    del x, w, pts, pipelines
    torch.cuda.empty_cache()

    fig8 = (ctx.table("lineitem")
            .filter((col("l_shipdate") >= days("1995-01-01"))
                    & (col("l_shipdate") < days("1996-01-01")))
            .map_batches(log_price, columns=["l_extendedprice"],
                         schema={"log_price": "float32"})
            .to_matrix("l_quantity", "l_discount", "l_tax", "log_price")
            .train("kmeans", k=8, max_iter=20))
    lrows = ctx.catalog.table("lineitem").num_rows
    rec = pipeline_record(torch, "fig8_lineitem", fig8, lrows, 4)
    valid = int(np.sum(ctx.table("lineitem").filter(
        (col("l_shipdate") >= days("1995-01-01"))
        & (col("l_shipdate") < days("1996-01-01")))
        .lower(engine="compiled").compile().result().mask))
    log(f"[hetero] fig8_lineitem: {valid} valid rows of {lrows}")
    check(rec["iters"] >= 1, "fig8_lineitem ran no iteration")
    torch.cuda.empty_cache()
    log(f"[hetero] phase 9 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: template serving (Compiled.batch, QueryServer)
# ---------------------------------------------------------------------------

#: the templates phase 10 serves, and the kernel each launches on
#: ``compiled-native``
SERVE_KERNELS = {"q6": "filter_agg_general", "q14": "join_probe_agg",
                 "q19": "join_probe_agg", "q22": "segmented_multi_sum"}
#: batch sizes: benchmarks/bench_serve.py's, plus the server's default
#: max_batch
SERVE_BATCHES = (1, 4, 8, 16, 64)


def serve_bindings(Q, name: str, n: int, seed: int, q22: dict) -> list:
    """``n`` bindings of template ``name`` from ``random_bindings``; q22's
    first is its scalar subquery's own value (``q22_params``)."""
    out = Q.random_bindings(name, n, seed=seed)
    if name == "q22":
        out[0] = dict(q22)
    return out


def rate_record(lat: list, wall_s: float) -> dict:
    return {"req_per_s": len(lat) / wall_s,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def one_at_a_time(torch, call, bindings):
    """Each binding through ``call`` (ends in the host result); the
    results, per-request seconds and the wall seconds of the run."""
    out, lat = [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for b in bindings:
        t0 = time.perf_counter()
        out.append(call(b).compact())
        lat.append(time.perf_counter() - t0)
    return out, lat, time.perf_counter() - t_all


def served(torch, QueryServer, ctx, name: str, bindings):
    """The bindings through a fresh ``QueryServer(ctx, engine="compiled")``:
    submit all, one flush, read every future.  Returns the results, the
    server's stats and the wall seconds."""
    server = QueryServer(ctx, engine="compiled")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [server.submit(name, **b) for b in bindings]
    server.flush()
    out = [f.result().compact() for f in futs]
    return out, server.stats, time.perf_counter() - t0


def raw_sync_free(torch, ENG, compiled, ctx, bindings) -> None:
    """A batch's ``raw`` under ``set_sync_debug_mode("error")``: any host
    sync inside it (a blocking copy, ``.item()``, ``nonzero``) raises."""
    bucket = ENG.batch_bucket(len(bindings))
    padded = bindings + [bindings[-1]] * (bucket - len(bindings))
    exe = compiled._batch_executor(bucket)
    stacked = {s.name: [b[s.name] for b in padded]
               for s in compiled.params()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exe.raw(ctx.catalog, ctx.cache, stacked)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del out


def poison_check(torch, QueryServer, ctx, Q, seed: int) -> dict:
    """A batch of 8 with one poisoned binding (an unknown parameter):
    only its future fails, the 7 others equal their sequential results."""
    bindings = Q.random_bindings("q6", 7, seed=seed)
    compiled = Q.TEMPLATES["q6"](ctx).lower(engine="compiled").compile()
    want = [compiled.result(**b).compact() for b in bindings]
    server = QueryServer(ctx, engine="compiled")
    futs = [server.submit("q6", **b) for b in bindings[:3]]
    poison = server.submit("q6", nonsense=1.0)
    futs += [server.submit("q6", **b) for b in bindings[3:]]
    server.flush()
    for i, (f, w) in enumerate(zip(futs, want)):
        assert_close(f.result().compact(), w, f"poisoned batch, binding {i}")
    try:
        poison.result()
        raise SmokeFailure("the poisoned binding's future did not fail")
    except TypeError as ex:
        check("unknown parameter" in str(ex), f"poison error: {ex}")
    st = server.stats
    check(st.bisects >= 1 and st.poisoned == 1,
          f"poison isolation: bisects {st.bisects}, poisoned {st.poisoned}")
    return {"bisects": st.bisects, "poisoned": st.poisoned,
            "batches": st.batches}


def serving_phase(torch, ctx, Q, FA, SR, JP, seed: int) -> dict:
    """Phase 10: each template's bindings served three ways -- one at a
    time on ``compiled``, one at a time by ``Compiled.submit`` on
    ``compiled-native`` (the kernels), and coalesced by the QueryServer
    (``Compiled.batch``: one vmapped call per template and bucket) --
    with equal results, one batched program per (template, bucket), a
    sync-free batch ``raw``, poison isolation, and the kernels launched
    by the native submits.  Returns the kernels' launches."""
    from repro_torch.core import engines as ENG
    from repro_torch.serve import QueryServer

    t_phase = time.perf_counter()
    mods = {"filter_agg_general": FA, "join_probe_agg": JP,
            "segmented_multi_sum": SR}
    q22 = Q.q22_params(ctx, engine="compiled")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated()
    log(f"[serve] resident before phase 10: {base_bytes} bytes; batches "
        f"{list(SERVE_BATCHES)}")
    cache = ctx.compile_cache
    for mod in mods.values():
        mod.launches = 0
    for name, kernel in SERVE_KERNELS.items():
        compiled = Q.TEMPLATES[name](ctx).lower(engine="compiled").compile()
        native = Q.TEMPLATES[name](ctx).lower(engine="compiled",
                                              native=True).compile()
        warm = serve_bindings(Q, name, 1, seed, q22)[0]
        compiled.result(**warm)   # first calls: lazy CUDA and cuBLAS setup
        native.submit(**warm).result()
        for n in SERVE_BATCHES:
            bindings = serve_bindings(Q, name, n, seed + n, q22)
            seq, seq_lat, seq_wall = one_at_a_time(
                torch, lambda b: compiled.result(**b), bindings)
            before = {k: m.launches for k, m in mods.items()}
            nat, nat_lat, nat_wall = one_at_a_time(
                torch, lambda b: native.submit(**b).result(), bindings)
            native_launches = mods[kernel].launches - before[kernel]
            check(native_launches >= n, f"{name}: {n} native submits "
                  f"launched {kernel} {native_launches} times")
            before = {k: m.launches for k, m in mods.items()}
            misses = cache.misses
            _, cold, cold_wall = served(torch, QueryServer, ctx, name,
                                        bindings)
            check(cache.misses - misses == 1,
                  f"{name} B {n}: the first batch built "
                  f"{cache.misses - misses} programs")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            misses = cache.misses
            got, st, wall = served(torch, QueryServer, ctx, name, bindings)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            check(cache.misses == misses,
                  f"{name} B {n}: a second batch built a program again")
            check({k: m.launches for k, m in mods.items()} == before,
                  f"{name}: the batched path launched a kernel")
            for i, (g, s, v) in enumerate(zip(got, seq, nat)):
                assert_close(g, s, f"{name} B {n} served vs compiled #{i}")
                assert_close(g, v, f"{name} B {n} served vs native #{i}")
            raw_sync_free(torch, ENG, compiled, ctx, bindings)
            bucket = ENG.batch_bucket(n)
            rec = {"template": name, "batch": n, "bucket": bucket,
                   "native_launches": native_launches,
                   "compiled": rate_record(seq_lat, seq_wall),
                   "native": rate_record(nat_lat, nat_wall),
                   "served": rate_record(st.latencies_s, wall),
                   "occupancy": st.batch_occupancy(),
                   "coalesce_ratio": st.coalesce_ratio(),
                   "first_batch_s": cold_wall,
                   "first_batch_build_s": cold.compile_s,
                   "peak_bytes": peak,
                   "peak_over_resident_bytes": peak - base_bytes}
            log(f"[serve] {json.dumps(rec)}")
        keys = [k for k in cache._entries
                if k[:-1] == compiled.cache_key and k[-1][0] == "batch"]
        buckets = sorted(k[-1][1] for k in keys)
        check(buckets == sorted({ENG.batch_bucket(n)
                                 for n in SERVE_BATCHES}),
              f"{name}: batched programs for buckets {buckets}")
    launches = {k: m.launches for k, m in mods.items()}
    log(f"[serve] launches in phase 10 (native submits only): "
        f"{json.dumps(launches)}")
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the serving path")
    log(f"[serve] poison: {json.dumps(poison_check(torch, QueryServer, ctx, Q, seed))}")
    torch.cuda.empty_cache()
    log(f"[serve] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: out-of-core morsel execution on the SF context
# ---------------------------------------------------------------------------

#: The kernel each phase-12 query's fragment launches, once per morsel.
MORSEL_KERNELS = {"q1": "segmented_multi_sum", "q3": "join_probe_agg",
                  "q6": "filter_agg_general", "join_micro": "join_probe_agg"}
#: Phase 12's budgets (bytes): the first holds every query whole.
MORSEL_BUDGETS = (8 << 30, 1 << 30, 256 << 20, 64 << 20)
#: The budget at which the peak of ``compiled`` must fall below the
#: monolithic peak, and the queries held to it.
MORSEL_GATE_BUDGET = 256 << 20
MORSEL_GATED = ("q1", "q6")


def morsel_queries(Q) -> dict:
    return {"q1": Q.q1, "q3": Q.q3, "q6": Q.q6, "join_micro": Q.join_micro}


def peak_over(torch, fn) -> int:
    """Peak device bytes ``fn`` allocates above what was allocated
    before it (``torch.cuda`` allocator statistics)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


#: A kernel's count slot is f32: exact while one launch counts at most
#: 2^24 rows (the kernels' integer envelope, ``native/patterns.py``).
F32_EXACT_ROWS = 1 << 24


def int_deviation(got, want) -> int:
    """Largest absolute difference over the integer columns (counts,
    keys) of two results."""
    worst = 0
    for k, y in want.items():
        y = np.atleast_1d(np.asarray(y))
        if y.dtype.kind in "iu":
            x = np.atleast_1d(np.asarray(got[k])).astype(np.int64)
            worst = max(worst, int(np.max(np.abs(x - y.astype(np.int64)),
                                          initial=0)))
    return worst


def max_rel_err(got, want) -> float:
    worst = 0.0
    for k, y in want.items():
        y = np.atleast_1d(np.asarray(y))
        if y.dtype == object:
            continue
        x = np.atleast_1d(np.asarray(got[k])).astype(np.float64)
        y = y.astype(np.float64)
        worst = max(worst, float(np.max(
            np.abs(x - y) / np.maximum(np.abs(y), 1e-30), initial=0.0)))
    return worst


def morsel_fault(torch, ctx, Q, rows: int) -> list:
    """Phase 12's fault site: ``morsel.loop`` armed ``first:1`` on q6's
    template fails its native compile; the ladder answers from
    ``compiled`` with the same loop, as the volcano oracle does."""
    from repro_torch import resilience as RZ
    from repro_torch.core import CompileCache
    from repro_torch.core import morsel as MO
    b = dict(Q.TEMPLATE_BINDINGS["q6"][0])
    with RZ.inject("morsel.loop", "first:1") as plan:
        c = Q.TEMPLATES["q6"](ctx).lower(
            engine="compiled", native=True, morsel_rows=rows).compile(
            cache=CompileCache(), persist=False)
    hops = [(d["frm"], d["to"], d["phase"], d["error_type"])
            for d in c.stats.degraded]
    check(hops == [("compiled-native", "compiled", "compile",
                    "KernelBudgetError")] and c.engine_name == "compiled",
          f"morsel.loop first:1 gave {c.engine_name} {hops}")
    check(plan.counts()["morsel.loop"]["fired"] == 1, "the site did not fire")
    node = MO.find_morsel_node(c._plan)
    check(node is not None and node.morsel_rows == rows,
          "the degraded compiled rung lost the morsel loop")
    got = c(**b)
    want = Q.TEMPLATES["q6"](ctx).lower(engine="volcano").compile()(**b)
    assert_close(got, want, "q6 template after the morsel.loop fault")
    return hops


def morsel_phase(torch, ctx, Q, FA, SR, JP, CB) -> dict:
    """Phase 12: q1, q3, q6 and ``join_micro`` on ``compiled`` and
    ``compiled-native`` under each of ``MORSEL_BUDGETS``, against their
    monolithic runs: equal results (integers exactly), the monolithic
    run's fired patterns, the fragment's kernel launched once per morsel,
    the peak bytes above the resident columns (q1's and q6's below the
    monolithic peak at 256 MiB), the ``morsel.loop`` fault site.  Returns
    the kernels' launches in the phase."""
    from repro_torch.core import lower as L
    from repro_torch.core import morsel as MO
    from repro_torch.core import parallel as PAR

    t_phase = time.perf_counter()
    mods = {"filter_agg_general": FA, "join_probe_agg": JP,
            "segmented_multi_sum": SR}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    builds = CB.builds
    log(f"[morsel] resident before phase 12: {torch.cuda.memory_allocated()} "
        f"bytes; budgets {list(MORSEL_BUDGETS)}")
    for mod in mods.values():
        mod.launches = 0
    for name, build in morsel_queries(Q).items():
        whole_plan = build(ctx).lower(engine="compiled").plan()
        spine = PAR._spine_path(whole_plan)[1]
        spine_rows = ctx.catalog.table(spine.table).num_rows
        n_cols = len(L.required_scan_columns(whole_plan,
                                             ctx.catalog)[id(spine)])
        kernel = MORSEL_KERNELS[name]
        mono = {}
        for engine in ("compiled", "compiled-native"):
            low = build(ctx).lower(engine=engine)
            c = low.compile()
            res = c()
            rep = low.dispatch_report()
            mono[engine] = dict(
                result=res,
                fired=rep.fired_patterns() if rep is not None else [],
                peak=peak_over(torch, c.result),
                ms=host_ms(torch, c.result))
        want = mono["compiled"]["result"]
        assert_close(mono["compiled-native"]["result"], want,
                     f"{name} monolithic native")
        for budget in MORSEL_BUDGETS:
            for engine in ("compiled", "compiled-native"):
                low = build(ctx).lower(engine=engine, memory_budget=budget)
                node = MO.find_morsel_node(low.plan())
                rows = node.morsel_rows if node is not None else spine_rows
                k = -(-spine_rows // rows)
                whole_fits = (MO.working_set_bytes(n_cols, spine_rows)
                              <= budget)
                check((node is None) == whole_fits,
                      f"{name} {engine} at {budget} B: MorselMerge "
                      f"{node is not None}, whole working set fits "
                      f"{whole_fits}")
                c = low.compile()
                before = {m: mod.launches for m, mod in mods.items()}
                got = c()
                torch.cuda.synchronize()
                launched = {m: mod.launches - before[m]
                            for m, mod in mods.items()}
                what = f"{name} {engine} budget {budget}"
                assert_close(got, want, what)
                # integers (counts, keys) exactly, but where a kernel's
                # f32 count slot took more than 2^24 rows in one launch
                # (monolithic native runs included): there rtol 5e-3
                dev = int_deviation(got, want)
                check(dev == 0 or (engine == "compiled-native"
                                   and rows > F32_EXACT_ROWS),
                      f"{what}: integers differ by up to {dev}")
                rec = {"query": name, "engine": engine, "budget": budget,
                       "morsel_rows": node.morsel_rows if node else None,
                       "morsels": k,
                       "working_set_bytes": MO.working_set_bytes(n_cols,
                                                                 rows),
                       "bound_columns": n_cols,
                       "max_rel_err": max_rel_err(got, want),
                       "int_deviation": dev}
                if engine == "compiled-native":
                    fired = low.dispatch_report().fired_patterns()
                    check(fired == mono[engine]["fired"],
                          f"{what}: fired {fired}, monolithic "
                          f"{mono[engine]['fired']}")
                    check(launched == {m: (k if m == kernel else 0)
                                       for m in mods},
                          f"{what}: launches {launched} for {k} morsels")
                    rec["fired"] = fired
                else:
                    check(not any(launched.values()),
                          f"{what}: compiled launched {launched}")
                rec["launches"] = launched[kernel]
                rec["peak_over_resident_bytes"] = peak_over(torch, c.result)
                rec["monolithic_peak_over_resident_bytes"] = \
                    mono[engine]["peak"]
                rec["host_ms"] = host_ms(torch, c.result)
                rec["monolithic_host_ms"] = mono[engine]["ms"]
                if (budget == MORSEL_GATE_BUDGET and engine == "compiled"
                        and name in MORSEL_GATED and node is not None):
                    check(rec["peak_over_resident_bytes"]
                          < mono[engine]["peak"],
                          f"{what}: peak {rec['peak_over_resident_bytes']} "
                          f"not below the monolithic {mono[engine]['peak']}")
                log(f"[morsel] {json.dumps(rec)}")
    launches = {m: mod.launches for m, mod in mods.items()}
    log(f"[morsel] launches in phase 12: {json.dumps(launches)}")
    for m, v in launches.items():
        check(v > 0, f"{m} was never launched on the morsel path")
    check(CB.builds == builds, f"phase 12 built {CB.builds - builds} kernel "
          "units that phase 2 did not")
    q6_rows = MO.choose_morsel_rows(4, ctx.catalog.table(
        "lineitem").num_rows, MORSEL_GATE_BUDGET)
    hops = morsel_fault(torch, ctx, Q, q6_rows)
    log(f"[morsel] fault site: morsel.loop first:1 -> {hops}, the compiled "
        f"rung kept morsel_rows {q6_rows}, result equal to volcano")
    torch.cuda.empty_cache()
    log(f"[morsel] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the sharded parallel engine on the SF context
# ---------------------------------------------------------------------------

#: Phase 13's shard counts (``benchmarks/bench_scaling.py``'s).
PARALLEL_SHARDS = (1, 2, 4, 8)
#: The kernel each phase-13 query's fragment launches, once per shard.
PARALLEL_KERNELS = {"q1": "segmented_multi_sum", "q3": "join_probe_agg",
                    "q6": "filter_agg_general", "q14": "join_probe_agg",
                    "q19": "join_probe_agg"}
#: The templates of phase 13 (two bindings each) and their kernels.
PARALLEL_TEMPLATES = {"q6": "filter_agg_general", "q14": "join_probe_agg"}
#: Queries timed (host ms, median of 5) at every shard count.
PARALLEL_TIMED = ("q1", "q3", "q6", "q19")
#: Queries whose peak device bytes are read at 1 and 8 shards.
PARALLEL_PEAKED = ("q1", "q3")
#: The out-of-core run of phase 13: native q1 at 4 shards under 256 MiB.
PARALLEL_BUDGET = 256 << 20
#: The per-shard kernel checks of phase 13: (query, wrapper module name).
PARALLEL_CHECKED = (("q6", "filter_agg_general"),
                    ("q1", "segmented_multi_sum"),
                    ("q19", "join_probe_agg"), ("q3", "join_probe_agg"))


def parallel_queries(Q) -> dict:
    return {name: Q.QUERIES[name] for name in PARALLEL_KERNELS}


def gather_query(ctx):
    """Phase 13's gather plan: a filter, then sort and limit over the
    whole spine (the shape of ``tests/test_engine_matrix.py``'s
    ``sorted_scan``, with a filter and a projection)."""
    from repro_torch.core import col, lit
    return (ctx.table("lineitem").filter(col("l_quantity") < lit(2.0))
            .select("l_orderkey", "l_partkey", "l_extendedprice")
            .sort(("l_extendedprice", False), "l_orderkey").limit(10))


def largest_shard(rows: int, n: int) -> int:
    from repro_torch.core import parallel as PAR
    return max(e - s for s, e in PAR.shard_bounds(rows, n))


def shard_kernel_checks(torch, ctx, Q, mods, mesh) -> list:
    """Each phase-13 kernel against its plain version on every shard's
    own inputs (captured from one native run at 4 shards), the views'
    pointers 16-byte aligned (the kernels' vector loads)."""
    out = []
    for qname, kname in PARALLEL_CHECKED:
        mod = mods[kname]
        with Capture(mod, kname) as cap:
            Q.QUERIES[qname](ctx).lower(engine="parallel", native=True,
                                        mesh=mesh).compile()()
        check(len(cap.calls) == mesh.shape["data"],
              f"{qname}: {len(cap.calls)} {kname} calls for "
              f"{mesh.shape['data']} shards")
        errs = []
        for args, kw in cap.calls:
            # every wrapper takes (body, columns, mask, ...): the shard's
            # views of the spine, and its mask where the plan filters
            ptrs = [t.data_ptr() for t in list(args[1]) + [args[2]]
                    if t is not None]
            check(all(p % 16 == 0 for p in ptrs),
                  f"{qname}: a shard view is not 16-byte aligned")
            got = getattr(mod, kname)(*args, **kw)
            want = getattr(mod, kname + "_plain")(*args, **kw)
            errs.append(compare(torch, got, want, f"{qname} shard {kname}"))
        out.append({"query": qname, "kernel": kname,
                    "shards": len(cap.calls),
                    "rows": [int(a[3] if kname != "segmented_multi_sum"
                                 else a[4]) for a, _ in cap.calls],
                    "max_abs_err": max(errs)})
        log(f"[parallel] kernel {json.dumps(out[-1])}")
    return out


def parallel_run(torch, ctx, mods, build, name: str, engine_native: bool,
                 n: int, make_mesh, want, params=None) -> dict:
    """One phase-13 run: lower, compile, run once with the kernels'
    launches reset to 0 just before and read just after; the result
    against ``want`` (the monolithic ``compiled`` one).  Returns the
    record, the compiled template and the lowered one."""
    from repro_torch.core import parallel as PAR
    params = params or {}
    low = build(ctx).lower(engine="parallel", native=engine_native,
                           mesh=make_mesh(n))
    node = PAR.find_shard_node(low.plan())
    check(node is not None and node.n_shards == n,
          f"{name}: no {n}-shard node in {low.explain()}")
    c = low.compile()
    for mod in mods.values():
        mod.launches = 0
    got = c(**params)
    torch.cuda.synchronize()
    launched = {m: mod.launches for m, mod in mods.items()}
    what = f"{name} parallel{' native' if engine_native else ''} x{n}"
    assert_close(got, want, what)
    rows = node.true_rows
    dev = int_deviation(got, want)
    # integers exactly, but where a native launch counted more than
    # 2^24 rows in its f32 count slot
    check(dev == 0 or (engine_native
                       and largest_shard(rows, n) > F32_EXACT_ROWS),
          f"{what}: integers differ by up to {dev}")
    rec = {"query": name, "engine": "parallel-native" if engine_native
           else "parallel", "shards": n,
           "shard_rows": [e - s for s, e in PAR.shard_bounds(rows, n)],
           "kind": type(node).__name__, "cache_hit": c.stats.cache_hit,
           "max_rel_err": max_rel_err(got, want), "int_deviation": dev,
           "launches": launched}
    return rec, c, low


def parallel_phase(torch, ctx, Q, FA, SR, JP, CB) -> dict:
    """Phase 13: q1, q3, q6, q14 and q19, the q6 and q14 templates (two
    bindings) and a gather plan on ``parallel`` and ``parallel`` with
    ``native=True`` at 1, 2, 4 and 8 shards on the SF context, against
    the monolithic ``compiled`` run: equal results (integers exactly
    where no launch counted more than 2^24 rows), phase 4's fired
    patterns, each fragment's kernel launched once per shard, one
    compile per mesh shape, no nvcc build; host ms of q1, q3, q6 and
    q19 against the monolithic runs; q1's and q3's peak bytes at 1 and
    8 shards; native q1 at 4 shards under a 256 MiB budget (shards x
    morsels launches); ``compile.xla`` armed ``first:1`` on q6's
    template (one ``parallel -> compiled`` hop).  Returns the kernels'
    launches in the phase."""
    from repro_torch import resilience as RZ
    from repro_torch.core import CompileCache
    from repro_torch.core import lower as L
    from repro_torch.core import morsel as MO
    from repro_torch.core import parallel as PAR
    from repro_torch.launch.mesh import make_data_mesh

    t_phase = time.perf_counter()
    mods = {"filter_agg_general": FA, "join_probe_agg": JP,
            "segmented_multi_sum": SR}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    builds = CB.builds
    totals = {m: 0 for m in mods}
    log(f"[parallel] resident before phase 13: "
        f"{torch.cuda.memory_allocated()} bytes; shards "
        f"{list(PARALLEL_SHARDS)} on {make_data_mesh(1).device}")
    checks = shard_kernel_checks(torch, ctx, Q, mods, make_data_mesh(4))

    def tally(rec, kernel, n):
        for m, v in rec["launches"].items():
            totals[m] += v
        if rec["engine"] == "parallel-native":
            want = {m: (n if m == kernel else 0) for m in mods}
        else:
            want = {m: 0 for m in mods}
        check(rec["launches"] == want,
              f"{rec['query']} {rec['engine']} x{n}: launches "
              f"{rec['launches']}, want {want}")

    table = {}
    for name, build in parallel_queries(Q).items():
        kernel = PARALLEL_KERNELS[name]
        mono = {}
        for native in (False, True):
            c = build(ctx).lower(engine="compiled", native=native).compile()
            res = c()
            mono[native] = dict(
                result=res,
                ms=(host_ms(torch, c.result) if name in PARALLEL_TIMED
                    else None),
                peak=(peak_over(torch, c.result) if name in PARALLEL_PEAKED
                      else None))
        want = mono[False]["result"]
        for n in PARALLEL_SHARDS:
            for native in (False, True):
                rec, c, low = parallel_run(torch, ctx, mods, build, name,
                                           native, n, make_data_mesh, want)
                tally(rec, kernel, n)
                if native:
                    fired = low.dispatch_report().fired_patterns()
                    check(fired == EXPECTED_PATTERNS[name],
                          f"{name} x{n}: fired {fired}")
                    check(len(low.dispatch_report().per_shard) == n,
                          f"{name} x{n}: per-shard report")
                    rec["fired"] = fired
                if name in PARALLEL_TIMED:
                    rec["host_ms"] = host_ms(torch, c.result)
                    rec["monolithic_host_ms"] = mono[native]["ms"]
                    rec["ratio_to_monolithic"] = (rec["host_ms"]
                                                  / mono[native]["ms"])
                    table[(name, native, n)] = rec["host_ms"]
                if name in PARALLEL_PEAKED and n in (1, 8):
                    rec["peak_over_resident_bytes"] = peak_over(torch,
                                                                c.result)
                    rec["monolithic_peak_over_resident_bytes"] = \
                        mono[native]["peak"]
                log(f"[parallel] {json.dumps(rec)}")
        del mono, want
    # templates: two bindings on one compile per mesh shape
    for tname, kernel in PARALLEL_TEMPLATES.items():
        build = Q.TEMPLATES[tname]
        for n in PARALLEL_SHARDS:
            for native in (False, True):
                hits = []
                for b in Q.TEMPLATE_BINDINGS[tname][:2]:
                    want = build(ctx).lower(engine="compiled").compile()(**b)
                    rec, c, low = parallel_run(
                        torch, ctx, mods, build, f"template:{tname}", native,
                        n, make_data_mesh, want, params=b)
                    tally(rec, kernel, n)
                    hits.append(c.stats.cache_hit)
                    if native:
                        check(low.dispatch_report().fired_patterns()
                              == EXPECTED_PATTERNS[f"template:{tname}"],
                              f"template {tname} x{n}: fired")
                check(hits == [False, True],
                      f"template {tname} x{n} native={native}: cache hits "
                      f"{hits}, want one compile per mesh shape")
                log(f"[parallel] template {tname} x{n} "
                    f"{'native ' if native else ''}two bindings, one "
                    f"compile: {json.dumps(hits)}")
    # the gather plan: nothing to merge, the shards' rows concatenated
    want = gather_query(ctx).lower(engine="compiled").compile()()
    for n in PARALLEL_SHARDS:
        for native in (False, True):
            rec, c, low = parallel_run(torch, ctx, mods, gather_query,
                                       "gather", native, n, make_data_mesh,
                                       want)
            check(rec["kind"] == "ShardGather", f"gather x{n}: {rec['kind']}")
            tally(rec, None, n)
            if n in (1, 8):
                rec["host_ms"] = host_ms(torch, c.result)
            log(f"[parallel] {json.dumps(rec)}")
    # out of core per shard: native q1 at 4 shards under 256 MiB
    whole = Q.q1(ctx).lower(engine="compiled").plan()
    spine = PAR._spine_path(whole)[1]
    rows = ctx.catalog.table(spine.table).num_rows
    n_cols = len(L.required_scan_columns(whole, ctx.catalog)[id(spine)])
    low = Q.q1(ctx).lower(engine="parallel", native=True,
                          mesh=make_data_mesh(4),
                          memory_budget=PARALLEL_BUDGET)
    inner = MO.find_morsel_node(PAR.find_shard_node(low.plan()))
    check(inner is not None, "q1 x4 under 256 MiB: no morsel loop")
    m = inner.morsel_rows
    morsels = [max(1, -(-(e - s) // m)) for s, e in PAR.shard_bounds(rows, 4)]
    check(m == MO.choose_morsel_rows(n_cols, largest_shard(rows, 4),
                                     PARALLEL_BUDGET),
          f"q1 x4 morsel_rows {m}")
    c = low.compile()
    for mod in mods.values():
        mod.launches = 0
    got = c()
    torch.cuda.synchronize()
    launched = {k: mod.launches for k, mod in mods.items()}
    for k, v in launched.items():
        totals[k] += v
    check(launched == {"filter_agg_general": 0, "join_probe_agg": 0,
                       "segmented_multi_sum": sum(morsels)},
          f"q1 x4 under 256 MiB: launches {launched}, morsels {morsels}")
    want = Q.q1(ctx).lower(engine="compiled").compile()()
    assert_close(got, want, "q1 x4 under 256 MiB")
    check(int_deviation(got, want) == 0, "q1 x4 under 256 MiB: integers")
    rec = {"query": "q1", "engine": "parallel-native", "shards": 4,
           "budget": PARALLEL_BUDGET, "morsel_rows": m,
           "morsels_per_shard": morsels, "launches": launched,
           "host_ms": host_ms(torch, c.result),
           "peak_over_resident_bytes": peak_over(torch, c.result)}
    log(f"[parallel] {json.dumps(rec)}")
    # the ladder's parallel -> compiled rung
    b = dict(Q.TEMPLATE_BINDINGS["q6"][0])
    with RZ.inject("compile.xla", "first:1") as plan:
        c = Q.TEMPLATES["q6"](ctx).lower(
            engine="parallel", native=True, mesh=make_data_mesh(4)).compile(
            cache=CompileCache(), persist=False)
    hops = [(d["frm"], d["to"], d["phase"], d["error_type"])
            for d in c.stats.degraded]
    check(hops == [("parallel", "compiled", "compile", "CompileFault")]
          and c.engine_name == "compiled"
          and plan.counts()["compile.xla"]["fired"] == 1,
          f"compile.xla first:1 on parallel gave {c.engine_name} {hops}")
    assert_close(c(**b), Q.TEMPLATES["q6"](ctx).lower(
        engine="compiled").compile()(**b), "q6 template after the hop")
    log(f"[parallel] fault site: compile.xla first:1 -> {hops}, result "
        "equal to compiled")
    log(f"[parallel] launches in phase 13: {json.dumps(totals)}")
    check(all(v > 0 for v in totals.values()),
          f"a kernel was never launched on the sharded path: {totals}")
    check(CB.builds == builds, f"phase 13 built {CB.builds - builds} kernel "
          "units that phase 2 did not")
    lines = {}
    for (name, native, n), ms in sorted(table.items()):
        lines.setdefault(f"{name} {'native' if native else 'compiled'}",
                         {})[n] = ms
    log(f"[parallel] host ms by shard count: {json.dumps(lines)}")
    log(f"[parallel] per-shard kernel checks: {json.dumps(checks)}")
    torch.cuda.empty_cache()
    log(f"[parallel] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# phase 11: runtime services (the store, the ladder, trace export, explain)
# ---------------------------------------------------------------------------

#: The restart's child: one fresh process on the card, with a store, that
#: runs the four templates and the nine queries on ``compiled-native`` and
#: writes what it saw as JSON.  Argument order: store, output, sf, seed,
#: role ("cold" or "warm").
RUNTIME_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from repro_torch.core import FlareContext
from repro_torch.kernels import cuda_build as CB
from repro_torch.kernels.filter_agg import kernel as FA
from repro_torch.kernels.join_probe import kernel as JP
from repro_torch.kernels.segmented_reduce import kernel as SR
from repro_torch.persist import ArtifactStore
from repro_torch.persist import store as PS
from repro_torch.relational import queries as Q

store_dir, out_path, sf, seed, role = (sys.argv[1], sys.argv[2],
                                       float(sys.argv[3]), int(sys.argv[4]),
                                       sys.argv[5])


def ms(t0):
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def host(res):
    return {k: np.asarray(v).tolist() for k, v in res.items()}


store = ArtifactStore(store_dir)
ctx = FlareContext(device="cuda", store=store)
t0 = time.perf_counter()
Q.register_tpch(ctx, sf=sf, seed=seed)
out = {"role": role, "build_dir": str(CB.BUILD_DIR),
       "generate_s": time.perf_counter() - t0}
torch.ones(8, device="cuda").sum().item()  # runtime bring-up, not billed
t0 = time.perf_counter()
ctx.preload()
out["preload_ms"] = ms(t0)
names = {id(ctx.catalog.table(n)): n for n in ctx.catalog.names()}
idx = ctx.cache.indexes
out["index"] = {"disk_hits": idx.disk_hits, "misses": idx.misses,
                "meta": {names[k[0]] + ":" + ",".join(k[1]):
                         e.meta.tolist() for k, (t, e) in idx._entries.items()}}
for m in (FA, SR, JP):
    m.launches = 0
results, out["templates"], out["queries"] = {}, {}, {}
for name in sorted(Q.TEMPLATES):
    b = dict(Q.TEMPLATE_BINDINGS[name][0])
    loads = CB.store_loads
    t0 = time.perf_counter()
    c = Q.TEMPLATES[name](ctx).lower(engine="compiled", native=True).compile()
    units_loaded = CB.store_loads - loads
    res = c(**b)
    first = ms(t0)
    t0 = time.perf_counter()
    again = Q.TEMPLATES[name](ctx).lower(engine="compiled",
                                         native=True).compile()
    again(**b)
    out["templates"][name] = {
        "first_ms": first, "warm_memory_ms": ms(t0),
        "disk_hit": c.stats.disk_hit, "persist": c.stats.persist,
        "units_loaded": units_loaded,
        "compile_ms": c.stats.compile_s * 1e3,
        "memory_hit": again.stats.cache_hit}
    results["template:" + name] = host(res)
if role == "cold":   # the suite's other units, one nvcc each, all at once
    t0 = time.perf_counter()
    CB.build_all([s for build in Q.QUERIES.values()
                  for s in build(ctx).lower(native=True).kernel_sources()])
    out["query_units_build_s"] = time.perf_counter() - t0
for name, build in Q.QUERIES.items():
    t0 = time.perf_counter()
    c = build(ctx).lower(engine="compiled", native=True).compile()
    results[name] = host(c())
    out["queries"][name] = {"first_ms": ms(t0), "disk_hit": c.stats.disk_hit,
                            "persist": c.stats.persist}
torch.cuda.synchronize()
out["launches"] = {"filter_agg_general": FA.launches,
                   "segmented_multi_sum": SR.launches,
                   "join_probe_agg": JP.launches}
out["builds"], out["store_loads"] = CB.builds, CB.store_loads
out["store"] = PS.live_store_stats()
out["results"] = results
if role == "warm":   # each stored index: loaded again vs built again
    rows = []
    for key, (tbl, entry) in list(idx._entries.items()):
        t0 = time.perf_counter()
        digest = PS.index_digest(tbl, key[1], key[2])
        digest_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded = idx._load_persisted(store, digest, tbl, key[1])
        load_ms = ms(t0)
        if loaded is None:
            continue
        t0 = time.perf_counter()
        built = idx._build(tbl, key[1], key[2])
        build_ms = ms(t0)
        rows.append({"index": names[key[0]] + ":" + ",".join(key[1]),
                     "rows": tbl.num_rows, "digest_ms": digest_ms,
                     "load_ms": load_ms, "device_build_ms": build_ms,
                     "equal": all(torch.equal(getattr(loaded, f),
                                              getattr(built, f))
                                  for f in ("perm", "keys", "meta"))})
    out["index_load_vs_build"] = rows
out["total_s"] = time.perf_counter() - T_START
json.dump(out, open(out_path, "w"))
"""


def fresh_checkout(dest: str) -> str:
    """A copy of the package's sources, as ``git archive`` holds them, at
    ``dest``, whose ``build/kernels/`` starts empty; returns its ``src``."""
    import shutil
    src = os.path.join(dest, "src")
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(src, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    return src


def restart_child(root: str, role: str, store_dir: str, sf: float,
                  seed: int) -> dict:
    """Run :data:`RUNTIME_CHILD` in a fresh process from a fresh copy."""
    src = fresh_checkout(os.path.join(root, role))
    out = os.path.join(root, f"{role}.json")
    env = dict(os.environ, PYTHONPATH=src)
    env.pop("FLARE_CACHE_DIR", None)
    t0 = time.perf_counter()
    code = "import time; T_START = time.perf_counter()\n" + RUNTIME_CHILD
    proc = subprocess.run([sys.executable, "-c", code, store_dir, out,
                           str(sf), str(seed), role],
                          capture_output=True, text=True, env=env,
                          cwd=os.path.join(root, role), timeout=900)
    check(proc.returncode == 0, f"the {role} process failed:\n"
          f"{proc.stderr[-3000:]}")
    with open(out) as f:
        got = json.load(f)
    got["wall_s"] = time.perf_counter() - t0
    check(got["build_dir"].startswith(os.path.join(root, role)),
          f"the {role} process built into {got['build_dir']}")
    return got


def results_equal(a: dict, b: dict, rtol: float = 1e-5) -> float:
    """The largest relative difference of two runs' results; fails on a
    column, shape or string that differs (float atomics may reorder a
    sum, so floats agree to ``rtol``)."""
    check(set(a) == set(b), f"results of {sorted(a)} vs {sorted(b)}")
    worst = 0.0
    for q in a:
        check(set(a[q]) == set(b[q]), f"{q}: columns differ")
        for k in a[q]:
            x, y = np.asarray(a[q][k]), np.asarray(b[q][k])
            check(x.shape == y.shape, f"{q}/{k}: shapes differ")
            if x.dtype.kind in "OUS" or y.dtype.kind in "OUS":
                check(x.tolist() == y.tolist(), f"{q}/{k}: strings differ")
                continue
            d = np.abs(x.astype(np.float64) - y) / np.maximum(np.abs(y), 1)
            worst = max(worst, float(d.max(initial=0.0)))
    check(worst <= rtol, f"warm results differ from cold by {worst}")
    return worst


def restart(torch, sf: float, seed: int) -> None:
    """Phase 11a: two fresh processes against one new store."""
    import shutil
    root = os.path.join(ROOT, "build", "runtime")
    shutil.rmtree(root, ignore_errors=True)
    store_dir = os.path.join(root, "store")
    torch.cuda.empty_cache()
    cold = restart_child(root, "cold", store_dir, sf, seed)
    warm = restart_child(root, "warm", store_dir, sf, seed)
    for role, r in (("cold", cold), ("warm", warm)):
        log(f"[runtime] {role}: {json.dumps({k: r[k] for k in ('wall_s', 'total_s', 'generate_s', 'preload_ms', 'builds', 'store_loads', 'launches', 'store', 'index')})}")
    log(f"[runtime] cold query units built at once in "
        f"{cold['query_units_build_s']:.1f} s")
    for name in sorted(cold["templates"]):
        c, w = cold["templates"][name], warm["templates"][name]
        log(f"[runtime] first query {json.dumps({'template': name, 'cold_ms': c['first_ms'], 'warm_disk_ms': w['first_ms'], 'warm_memory_ms': w['warm_memory_ms'], 'cold_persist': c['persist'], 'warm_persist': w['persist'], 'warm_units_loaded': w['units_loaded'], 'warm_load_ms': w['compile_ms']})}")
    log(f"[runtime] queries, first run ms cold / warm: "
        f"{json.dumps({q: [cold['queries'][q]['first_ms'], warm['queries'][q]['first_ms']] for q in cold['queries']})}")
    for row in warm["index_load_vs_build"]:
        log(f"[runtime] index {json.dumps(row)}")
    check(warm["builds"] == 0, f"the warm process ran nvcc "
          f"{warm['builds']} times")
    check(cold["builds"] > 0, "the cold process built no unit")
    check(warm["store_loads"] > 0, "the warm process loaded no unit")
    misses = [n for n, t in {**warm["templates"], **warm["queries"]}.items()
              if not t["disk_hit"] or t["persist"] != "hit:native"]
    check(not misses, f"warm: no native disk hit for {misses}")
    # "hit:native" says the compile needed units and none was built; that
    # each template's own units came off the store, its load count says
    unloaded = [n for n, t in warm["templates"].items()
                if t["units_loaded"] < 1]
    check(not unloaded, f"warm: no unit loaded from the store for "
          f"{unloaded}")
    we, wi = warm["store"]["exec"], warm["store"]["index"]
    check(we["writes"] == 0 and we["misses"] == 0,
          f"warm exec tier: {we}")
    check(wi["writes"] == 0 and wi["hits"] > 0 and
          warm["index"]["disk_hits"] > 0, f"warm index tier: {wi}")
    check(warm["index"]["meta"] == cold["index"]["meta"],
          "loaded index meta differs from the cold build's")
    check(all(r["equal"] for r in warm["index_load_vs_build"]),
          "a loaded index differs from its rebuild")
    for k, v in warm["launches"].items():
        check(v > 0, f"the warm process never launched {k}")
    worst = results_equal(cold["results"], warm["results"])
    log(f"[runtime] warm results equal cold's (max rel diff {worst})")


def ladder_checks(torch, ctx, Q, CB) -> None:
    """Phase 11b: a recoverable fault hops, typed errors raise."""
    from repro_torch import resilience as RZ
    from repro_torch.core import CompileCache
    from repro_torch.kernels import KernelBudgetError
    from repro_torch.resilience import degrade as DG
    b = dict(Q.TEMPLATE_BINDINGS["q6"][0])
    want = Q.TEMPLATES["q6"](ctx).lower(engine="compiled").compile()(**b)
    DG.clear_events()
    with RZ.inject("native.kernel", "first:1"):
        c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
            .compile(cache=CompileCache(), persist=False)
    got = c(**b)
    hops = [(d["frm"], d["to"], d["phase"], d["error_type"])
            for d in c.stats.degraded]
    check(c.engine_name == "compiled" and hops == [
        ("compiled-native", "compiled", "compile", "KernelBudgetError")],
        f"native.kernel first:1 gave {c.engine_name} {hops}")
    check(len(DG.events()) == 1, f"events {DG.events()}")
    check(all(np.array_equal(got[k], want[k]) for k in want),
          f"the degraded q6 {got} differs from compiled's {want}")
    os.environ["FLARE_DEGRADE"] = "off"
    try:
        with RZ.inject("native.kernel", "first:1"):
            Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
                .compile(cache=CompileCache(), persist=False)
        raise SmokeFailure("FLARE_DEGRADE=off did not raise")
    except KernelBudgetError:
        pass
    finally:
        del os.environ["FLARE_DEGRADE"]
    lowered = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True)
    lowered._force().kernel_sources = (
        "#error a unit that does not build\n",)
    events = len(DG.events())
    try:
        lowered.compile(cache=CompileCache(), persist=False)
        raise SmokeFailure("a unit nvcc refused was absorbed")
    except CB.UnitBuildError as ex:
        check(len(DG.events()) == events, "the build failure degraded")
        log(f"[runtime] ladder: native.kernel first:1 -> {hops}, result "
            f"equal to compiled; FLARE_DEGRADE=off raised "
            f"KernelBudgetError; the failed build raised "
            f"{type(ex).__name__}, no hop")


def kernel_range(torch, fn, name: str, kernel: str, tries: int = 5):
    """Profile one call of ``fn`` (after a warm step, as :func:`profiled`
    does) until the profile ties every device kernel whose name starts
    with ``kernel`` to the range ``name``: the runtime call that launched
    it -- the ``*LaunchKernel*`` event with the kernel's correlation id --
    starts and ends inside the range.  Other launches inside the range
    (the fragment's own torch operators) prove nothing.  The profiler
    misses events now and then, most often the first of its window, so a
    small torch kernel runs first in each step.  Returns the attempt and
    the kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    seen = []
    for attempt in range(tries):
        done = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: done.append(
                         p.profiler.kineto_results.events())) as prof:
            for _ in range(2):
                torch.ones(1, device="cuda").sum()
                fn()
                torch.cuda.synchronize()
                prof.step()
        events = done[0] if done else []
        ranges = [(e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events if e.name() == name]
        kernels = [e for e in events if e.device_type() == DeviceType.CUDA
                   and e.name().startswith(kernel)]
        launch_of = {e.correlation_id(): e for e in events
                     if e.device_type() == DeviceType.CPU
                     and "LaunchKernel" in e.name()}
        tied = [launch_of.get(k.correlation_id()) for k in kernels]
        inside = [x for x in tied if x is not None and any(
            a <= x.start_ns() and x.start_ns() + x.duration_ns() <= b
            for a, b in ranges)]
        seen.append((len(ranges), len(kernels),
                     sum(x is not None for x in tied), len(inside)))
        if kernels and len(inside) == len(kernels):
            return attempt, kernels[0].name()
    raise SmokeFailure(f"no {kernel} launch tied to a {name} range in "
                       f"{tries} profiles (ranges, kernels, kernels with "
                       f"their launch, launches inside a range: {seen})")


def observability_checks(torch, ctx, Q) -> None:
    """Phase 11c: Chrome trace, a profiled kernel range, EXPLAIN ANALYZE."""
    from repro_torch import obs
    from repro_torch.core import CompileCache
    with obs.capture() as trace:
        for name in ("q6", "q19"):
            Q.QUERIES[name](ctx).lower(engine="compiled", native=True) \
                .compile(cache=CompileCache(), persist=False)()
    path = os.path.join(ROOT, "build", "runtime", "trace.json")
    obs.dump_chrome(path, trace.spans)
    with open(path) as f:
        rebuilt = obs.Trace(obs.spans_from_chrome(json.load(f)))
    check(len(rebuilt.spans) == len(trace.spans), "spans lost in export")
    ids = {s.span_id for s in rebuilt.spans}
    check(all(s.parent_id is None or s.parent_id in ids
              for s in rebuilt.spans), "a span lost its parent")
    phases = {p: len(rebuilt.find(p)) for p in
              ("optimize", "dispatch", "lower", "compile", "execute")}
    check(all(n == 2 for n in phases.values()), f"phases {phases}")
    log(f"[runtime] chrome trace: {len(rebuilt.spans)} spans, {phases}")

    compiled = Q.QUERIES["q6"](ctx).lower(engine="compiled",
                                          native=True).compile()
    compiled()
    attempt, kernel = kernel_range(torch, compiled, "flare:filter-scalar-agg",
                                   "flare_filter_agg")
    log(f"[runtime] profile: the launch of {kernel} (by correlation id) "
        f"lies inside flare:filter-scalar-agg (profile {attempt + 1})")
    for name, pattern in (("q6", "filter-scalar-agg"),
                          ("q19", "join-probe")):
        text = Q.QUERIES[name](ctx).explain(analyze=True, native=True)
        dispatch = text.split("== Native Dispatch ==")[1].split("\n\n")[0]
        check(f"FIRED    {pattern}" in dispatch,
              f"{name}: explain names no {pattern}")
        if name == "q19":
            check("indexed  join-index" in dispatch
                  and "index_lookup" in text,
                  "q19: explain gives no index provenance")
        log(f"[runtime] explain {name}:{dispatch.rstrip()}")


def runtime_phase(torch, ctx, Q, CB, sf: float, seed: int) -> None:
    """Phase 11: the restart through the store, the ladder, trace export
    and EXPLAIN ANALYZE."""
    t0 = time.perf_counter()
    restart(torch, sf, seed)
    ladder_checks(torch, ctx, Q, CB)
    observability_checks(torch, ctx, Q)
    log(f"[runtime] phase 11 took {time.perf_counter() - t0:.1f} s")


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
             CB.fixed_unit("decode_attention.cuh"), decode_reset_unit(CB),
             FQ.unit_source(**Q6_CONSTANTS), SS.unit_source()]
    records = tpch_phases(torch, sf, seed, fixed, t_all)
    torch.cuda.empty_cache()
    lm_launches: dict = {}
    lm_records = lm_phases(torch, seed, lm_launches)
    for r in lm_records:
        r["launches"] = lm_launches[r["name"].split("[")[0]]
    torch.cuda.empty_cache()
    train_phase(torch, seed)
    torch.cuda.empty_cache()
    moe_records = moe_phase(torch, seed)
    torch.cuda.empty_cache()
    encdec_recs = encdec_phase(torch, seed)
    torch.cuda.empty_cache()
    ssm_phase(torch, seed)
    log(f"[summary] total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": records + lm_records + moe_records
                      + encdec_recs}))
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
    # phase 12's partial aggregates (avg as a sum, a synthetic count) and
    # join_micro generate units of their own
    for name, build in morsel_queries(Q).items():
        sources.update(build(ctx).lower(native=True).kernel_sources())
        sources.update(build(ctx).lower(
            native=True, memory_budget=MORSEL_BUDGETS[-1]).kernel_sources())
    # phase 13's shard-local partial aggregates (the same at any count)
    for build in list(parallel_queries(Q).values()) + [
            Q.TEMPLATES[t] for t in PARALLEL_TEMPLATES]:
        sources.update(build(ctx).lower(engine="parallel",
                                        native=True).kernel_sources())
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
    hetero_phase(torch, ctx, seed)
    serving = serving_phase(torch, ctx, Q, FA, SR, JP, seed)
    morsel = morsel_phase(torch, ctx, Q, FA, SR, JP, CB)
    parallel = parallel_phase(torch, ctx, Q, FA, SR, JP, CB)
    runtime_phase(torch, ctx, Q, CB, sf, seed)
    for r in records:
        base = r["name"].split("[")[0]
        if base in serving:
            r["serving_launches"] = serving[base]
        if base in morsel:
            r["morsel_launches"] = morsel[base]
        if base in parallel:
            r["parallel_launches"] = parallel[base]
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
