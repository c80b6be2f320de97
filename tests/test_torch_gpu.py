"""The port's CUDA kernels on an NVIDIA Hopper card (``-m gpu``).

Every test here needs an sm_90 device and skips elsewhere with the
reason; on the card run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each native fragment's kernel is held against the generic lowering of
the same query on the same card (rtol 1e-3: summation order differs).
This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; ``expr_queries`` is also used by the CPU tests.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from conftest import assert_results_equal
from repro_torch.core import FlareContext
from repro_torch.kernels.filter_agg import kernel as FA
from repro_torch.kernels.join_probe import kernel as JP
from repro_torch.kernels.segmented_reduce import kernel as SR
from repro_torch.relational import queries as Q


def expr_queries(ctx, m):
    """Queries whose fragments exercise the code generator beyond TPC-H:
    Not, IfThenElse over values and over predicates, numeric and
    dictionary isin (with an absent member), ordered comparisons against
    absent string literals, string-predicate code ranges, casts to bool,
    division, a grouped any_, and a composite join key.  ``m`` is the
    package's ``core`` module (JAX or port)."""
    col, lit, when, cast = m.col, m.lit, m.when, m.cast
    li = ctx.table("lineitem")
    part = ctx.table("part")
    return {
        "not-if-isin": li.filter(
            ~(col("l_returnflag") == "R")
            & col("l_shipmode").isin(["AIR", "MAIL", "NOT A MODE"])).agg(
            m.sum_(when(col("l_discount") > 0.05, col("l_extendedprice"),
                        col("l_tax")), "a"),
            m.avg(col("l_quantity") / (col("l_tax") + lit(0.01)), "b"),
            m.count("n")),
        "absent-literal-order": li.filter(
            (col("l_shipmode") < "MAX")
            & (col("l_shipinstruct") >= "D")
            & col("l_quantity").isin([1.0, 2.0, 3.0, 7.0])).agg(
            m.sum_(col("l_extendedprice"), "s"), m.count("n")),
        "bool-branches-cast": li.filter(
            when(col("l_quantity") > 10.0, col("l_discount") > 0.02,
                 col("l_tax") > 0.03)
            & cast(col("l_discount"), "bool")).agg(
            m.sum_(col("l_quantity"), "q"), m.count("n")),
        "grouped-any": li.filter(col("l_shipdate") > 9000).group_by(
            "l_returnflag", "l_linestatus").agg(
            m.sum_(col("l_discount") * col("l_tax"), "dt"),
            m.any_(col("l_linestatus"), "ls"),
            m.avg(col("l_extendedprice"), "p"), m.count("n")),
        "probe-strpred": li.join(part, on="l_partkey",
                                 right_on="p_partkey").filter(
            col("p_type").startswith("PROMO")
            | col("p_container").like("%BAG")
            | col("p_brand").contains("#3")).group_by("p_size").agg(
            m.sum_(col("l_quantity"), "q"), m.count("n")),
        "probe-composite-key": li.join(
            ctx.table("partsupp"), on=["l_partkey", "l_suppkey"],
            right_on=["ps_partkey", "ps_suppkey"]).agg(
            m.sum_(col("l_quantity") * col("ps_supplycost"), "cost"),
            m.count("n")),
    }


EXPR_FIRED = {"not-if-isin": ["filter-scalar-agg"],
               "absent-literal-order": ["filter-scalar-agg"],
               "bool-branches-cast": ["filter-scalar-agg"],
               "grouped-any": ["grouped-agg"],
               "probe-strpred": ["join-probe"],
               "probe-composite-key": ["join-probe"]}


@pytest.fixture
def card_ctx():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU (sm_90); the CUDA kernels "
                    "are built for sm_90a only")
    ctx = FlareContext(device="cuda")
    Q.register_tpch(ctx, sf=0.05)
    return ctx


@pytest.mark.gpu
def test_tpch_fragments_match_generic_on_card(card_ctx):
    before = (FA.launches, SR.launches, JP.launches)
    for name in ("q1", "q3", "q5", "q6", "q13", "q14"):
        native = Q.QUERIES[name](card_ctx).lower(native=True).compile()()
        plain = Q.QUERIES[name](card_ctx).lower().compile()()
        assert_results_equal(plain, native, rtol=1e-3, msg=name)
    after = (FA.launches, SR.launches, JP.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.gpu
def test_expression_forms_match_generic_on_card(card_ctx):
    import repro_torch.core as PC
    for name, df in expr_queries(card_ctx, PC).items():
        low = df.lower(engine="compiled", native=True)
        assert low.dispatch_report().fired_patterns() == EXPR_FIRED[name]
        assert_results_equal(df.lower().compile()(), low.compile()(),
                             rtol=1e-3, msg=name)


# ---------------------------------------------------------------------------
# the LM path's attention kernels against their plain versions
# ---------------------------------------------------------------------------

from repro_torch.kernels import KernelBudgetError  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as DA  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FL  # noqa: E402

#: kernel vs plain on the same inputs, per element |got - want| <= rel
#: |want| + floor max|want|: bf16 outputs differ by one rounding of the
#: f32 result (at most 2^-7 |want|), f32 ones by summation order; the
#: floor covers outputs near 0, where the sums' order shows.
ATTN_TOL = {torch.bfloat16: (2.0 ** -7, 1e-3), torch.float32: (1e-5, 1e-5)}


def assert_within_rounding(got, want, dtype):
    rel, floor = ATTN_TOL[dtype]
    got, want = got.float(), want.float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    limit = rel * want.abs() + floor * float(want.abs().max())
    assert bool((err <= limit).all()), \
        f"max abs err {float(err.max())}, {float((err / limit).max())} " \
        f"times the limit"


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU (sm_90); the CUDA kernels "
                    "are built for sm_90a only")
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


#: (b, h, hkv, s, d): the first four since the CUDA-core kernel landed;
#: then the tensor-core kernel's widths (64, 128, and pixtral's 160 with
#: its padded shared rows) at S 64 (one tile), 97 and 1000 (ragged last
#: tiles) and 300, each at GQA groups 1, 2 and 4.
MMA_WIDTHS = (64, 128, 160)
FLASH_SHAPES = [(1, 2, 1, 128, 64), (2, 4, 2, 200, 32), (1, 8, 2, 97, 128),
                (2, 16, 8, 300, 64)] + [
    (2, 2 * g, 2, s, d) for d in MMA_WIDTHS for s in (64, 97, 300, 1000)
    for g in (1, 2, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", FLASH_SHAPES)
def test_flash_kernel_matches_plain(card, dtype, causal, b, h, hkv, s, d):
    gen = torch.Generator(device=card).manual_seed(s * d + h)
    q = _randn(gen, (b, h, s, d), dtype, card)
    k = _randn(gen, (b, hkv, s, d), dtype, card)
    v = _randn(gen, (b, hkv, s, d), dtype, card)
    before = (FL.launches, FL.launches_mma, FL.launches_cuda_cores)
    got = FL.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    mma = FL.route(dtype, d) == "mma"
    assert mma == (dtype == torch.bfloat16 and d in MMA_WIDTHS)
    assert (FL.launches, FL.launches_mma, FL.launches_cuda_cores) == (
        before[0] + 1, before[1] + mma, before[2] + (not mma))
    want = FL.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert_within_rounding(got, want, dtype)


@pytest.mark.gpu
def test_flash_mma_resources_match_the_layout_mirror(card):
    """The built tensor-core kernel's dynamic shared bytes at each width
    are the mirror's (``mma_smem_bytes``, which the CPU layout test
    holds to the row layout); the D 160 build reports its registers and
    spill bytes, and its shared bytes leave room for two blocks an SM."""
    res = FL.mma_resources()
    assert sorted(res) == list(MMA_WIDTHS)
    for d in MMA_WIDTHS:
        assert res[d]["dynamic_smem"] == FL.mma_smem_bytes(d)
    r160 = res[160]
    print(f"flash_attention_mma D 160: {r160}")
    assert 0 < r160["registers"] <= 255 and r160["local_bytes"] >= 0
    # sm_90: 228 KB of shared memory an SM, 1 KB of it reserved a block
    assert 2 * (r160["dynamic_smem"] + r160["static_smem"] + 1024) \
        <= 228 * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (4, 8, 2, 1000, 64), (3, 6, 3, 96, 32), (2, 16, 8, 2080, 64),
    (1, 4, 4, 333, 128)])
def test_decode_kernel_matches_plain(card, dtype, b, h, hkv, s, d):
    gen = torch.Generator(device=card).manual_seed(s + d + h)
    q = _randn(gen, (b, h, d), dtype, card)
    k = _randn(gen, (b, hkv, s, d), dtype, card)
    v = _randn(gen, (b, hkv, s, d), dtype, card)
    lens = [0, 1, s, s // 2 + 1][:b]
    lens += [7] * (b - len(lens))
    lengths = torch.tensor(lens, dtype=torch.int32, device=card)
    before = DA.launches
    got = DA.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert DA.launches == before + 1
    want = DA.decode_attention_plain(q, k, v, lengths)
    assert_within_rounding(got, want, dtype)
    # length 0: the mean of V over the whole cache
    mean = v[0].float().mean(1).repeat_interleave(h // hkv, 0)
    assert_within_rounding(got[0], mean.to(dtype), dtype)


@pytest.mark.gpu
def test_attention_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 2, 64, 8, device=card)
    with pytest.raises(KernelBudgetError):
        FL.flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    q = torch.zeros(1, 2, 64, 32, device=card)
    kt = torch.zeros(1, 1, 32, 64, device=card).transpose(2, 3)
    with pytest.raises(KernelBudgetError):
        FL.flash_attention(q, kt, kt)
    with pytest.raises(KernelBudgetError):
        FL.flash_attention(q.half(), q.half(), q.half())
    # the tensor-core kernel: 16-byte aligned, contiguous, one dtype
    before = (FL.launches, FL.launches_mma, FL.launches_cuda_cores)
    for d in MMA_WIDTHS:
        flat = torch.zeros(2 * 64 * d + 1, device=card, dtype=torch.bfloat16)
        odd = flat[1:].view(1, 2, 64, d)          # 2 bytes off 16
        good = torch.zeros(1, 2, 64, d, device=card, dtype=torch.bfloat16)
        with pytest.raises(KernelBudgetError):
            FL.flash_attention(odd, good, good)
        with pytest.raises(KernelBudgetError):
            FL.flash_attention(good, odd, good)
        with pytest.raises(KernelBudgetError):
            FL.flash_attention(good, good.transpose(2, 3).contiguous()
                               .transpose(2, 3), good)
        with pytest.raises(KernelBudgetError):
            FL.flash_attention(good, good.float(), good)
        with pytest.raises(KernelBudgetError):
            FL.flash_attention(good, good[:, :1].contiguous(),
                               good[:, :1, :32].contiguous())
    assert (FL.launches, FL.launches_mma,
            FL.launches_cuda_cores) == before
    lengths = torch.ones(1, dtype=torch.int32, device=card)
    qd = torch.zeros(1, 2, 12, device=card)
    kd = torch.zeros(1, 1, 64, 12, device=card)
    with pytest.raises(KernelBudgetError):
        DA.decode_attention(qd, kd, kd, lengths)
    qd = torch.zeros(1, 2, 32, device=card)
    kd = torch.zeros(1, 1, 32, 64, device=card).transpose(2, 3)
    with pytest.raises(KernelBudgetError):
        DA.decode_attention(qd, kd, kd, lengths)
    kd = torch.zeros(1, 1, 64, 32, device=card)
    with pytest.raises(KernelBudgetError):
        DA.decode_attention(qd, kd, kd, lengths.long())
    # the bulk copies take 16-byte aligned rows; the batch has a cap
    flat = torch.zeros(64 * 32 + 1, device=card, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 1, 64, 32)
    good = torch.zeros(1, 1, 64, 32, device=card, dtype=torch.bfloat16)
    with pytest.raises(KernelBudgetError):
        DA.decode_attention(good[:, :, 0].repeat(1, 2, 1), good, odd,
                            lengths)
    big = DA.MAX_BATCH + 1
    with pytest.raises(KernelBudgetError):
        DA.decode_attention(torch.zeros(big, 1, 16, device=card),
                            torch.zeros(big, 1, 1, 16, device=card),
                            torch.zeros(big, 1, 1, 16, device=card),
                            torch.ones(big, dtype=torch.int32, device=card))


def _decode_inputs(card, dtype, b, h, hkv, s, d, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return (_randn(gen, (b, h, d), dtype, card),
            _randn(gen, (b, hkv, s, d), dtype, card),
            _randn(gen, (b, hkv, s, d), dtype, card))


#: (name, dtype, b, h, hkv, s, d, lengths): one sequence at S and the rest
#: at 1 (the split follows the valid keys); group 8 at D 256 in f32 (a
#: tile is 8 keys); S not a multiple of the tile (64 keys at bf16 D 64,
#: 32 at f32 D 64) with lengths on and off its edges
DECODE_EDGES = [
    ("skewed", torch.bfloat16, 8, 16, 8, 4096, 64,
     [4096] + [1] * 7),
    ("skewed f32", torch.float32, 8, 16, 8, 4096, 64,
     [1] * 7 + [4096]),
    ("group 8, D 256", torch.float32, 3, 16, 2, 300, 256, [300, 1, 0]),
    ("S off the tile", torch.bfloat16, 4, 4, 2, 1000, 64,
     [1000, 999, 65, 64]),
    ("S off the tile f32", torch.float32, 4, 4, 2, 1000, 64,
     [1000, 33, 32, -5]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,b,h,hkv,s,d,lens", DECODE_EDGES,
                         ids=[e[0] for e in DECODE_EDGES])
def test_decode_kernel_edges_match_plain(card, name, dtype, b, h, hkv, s, d,
                                         lens):
    q, k, v = _decode_inputs(card, dtype, b, h, hkv, s, d, s + d)
    lengths = torch.tensor(lens, dtype=torch.int32, device=card)
    got = DA.decode_attention(q, k, v, lengths)
    assert_within_rounding(got, DA.decode_attention_plain(q, k, v, lengths),
                           dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group,d", [(1, 16), (3, 24), (5, 72), (6, 136),
                                     (7, 200), (8, 256)])
def test_decode_kernel_odd_groups_and_widths(card, dtype, group, d):
    """Groups that are not a power of two, and rows of 16-byte vectors
    that are not (24 bf16 is 3 vectors, 200 f32 is 50)."""
    b, hkv, s = 3, 2, 333
    q, k, v = _decode_inputs(card, dtype, b, hkv * group, hkv, s, d, d)
    lengths = torch.tensor([333, 1, 170], dtype=torch.int32, device=card)
    got = DA.decode_attention(q, k, v, lengths)
    assert_within_rounding(got, DA.decode_attention_plain(q, k, v, lengths),
                           dtype)


#: (group, hkv, d): starcoder2-7b's 36 / 4 heads at D 128,
#: recurrentgemma-2b's 10 / 1 at D 256, and the unit's largest group
LARGE_GROUPS = [(9, 4, 128), (10, 1, 256), (16, 2, 64), (16, 1, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group,hkv,d", LARGE_GROUPS)
def test_decode_kernel_beyond_8_heads_per_kv_head(card, dtype, group, hkv,
                                                  d):
    """Groups above the 8 warps: each warp runs the softmax of several
    heads (the TPU kernel takes any group)."""
    b, s = 4, 2080
    q, k, v = _decode_inputs(card, dtype, b, hkv * group, hkv, s, d,
                             group * d)
    lengths = torch.tensor([2049, 1, 0, 1500], dtype=torch.int32,
                           device=card)
    before = DA.launches
    got = DA.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert DA.launches == before + 1
    assert_within_rounding(got, DA.decode_attention_plain(q, k, v, lengths),
                           dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("group,d", [(9, 128), (10, 256), (16, 256)])
def test_decode_resources_beyond_8_heads(card, group, d):
    """The variant of more than 8 heads builds, takes the shared bytes of
    the Python mirror of its layout and fits one block on an SM at
    least."""
    for dtype in (torch.bfloat16, torch.float32):
        res = DA.resources(dtype, 8, group, d)
        assert res["dynamic_smem"] == DA.shared_bytes(
            8, group, d, torch.tensor([], dtype=dtype).element_size())
        assert res["dynamic_smem"] <= DA.SMEM_OPTIN
        assert res["blocks_per_sm"] >= 1 and res["threads"] == 256
    with pytest.raises(KernelBudgetError):
        DA.decode_attention(torch.zeros(1, DA.MAX_GROUP + 1, 16, device=card),
                            torch.zeros(1, 1, 8, 16, device=card),
                            torch.zeros(1, 1, 8, 16, device=card),
                            torch.ones(1, dtype=torch.int32, device=card))


@pytest.mark.gpu
def test_decode_kernel_above_65535_pairs(card):
    """B * Hkv = 65 536: the persistent grid has no per-pair extent."""
    b, hkv = DA.MAX_BATCH, 8
    q, k, v = _decode_inputs(card, torch.bfloat16, b, hkv, hkv, 24, 16, 5)
    lengths = torch.randint(0, 30, (b,), dtype=torch.int32, device=card,
                            generator=torch.Generator(device=card)
                            .manual_seed(5))
    got = DA.decode_attention(q, k, v, lengths)
    assert_within_rounding(got, DA.decode_attention_plain(q, k, v, lengths),
                           torch.bfloat16)


#: lengths at B 8, S 2080: ragged (0, 1, S, above S, negative), the
#: serving path's (prompt + 1), and one long sequence among short ones
SCHEDULE_LENGTHS = {
    "ragged": [2049, 1, 2080, 0, 5000, 700, 64, -3],
    "serving": [2049] * 8,
    "skewed": [1] * 7 + [2080],
}


@pytest.mark.gpu
@pytest.mark.parametrize("lens", list(SCHEDULE_LENGTHS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_is_bit_identical_and_schedules_as_the_mirror(card,
                                                                    dtype,
                                                                    lens):
    """Two calls on the same inputs agree bit for bit (the tickets reset,
    the fold runs in item order), one launch each, and the schedule the
    kernel computed on the device is the Python mirror's."""
    b, h, hkv, s, d = 8, 16, 8, 2080, 64
    q, k, v = _decode_inputs(card, dtype, b, h, hkv, s, d, 11)
    lengths = torch.tensor(SCHEDULE_LENGTHS[lens], dtype=torch.int32,
                           device=card)
    before = DA.launches
    one, sched = DA.decode_attention_launch(q, k, v, lengths)
    two, _ = DA.decode_attention_launch(q, k, v, lengths)
    torch.cuda.synchronize()
    assert DA.launches == before + 2
    assert torch.equal(one, two)
    grid = DA.grid_size(q, b, h // hkv, d)
    chunk, items = DA.decode_schedule(lengths.tolist(), hkv, s, d,
                                      q.element_size(), grid)
    assert sched.tolist() == [chunk, len(items)]
    assert_within_rounding(one, DA.decode_attention_plain(q, k, v, lengths),
                           dtype)


@pytest.mark.gpu
def test_decode_kernel_replays_in_a_cuda_graph(card):
    b, h, hkv, s, d = 8, 16, 8, 2080, 64
    q, k, v = _decode_inputs(card, torch.bfloat16, b, h, hkv, s, d, 12)
    lengths = torch.full((b,), 2049, dtype=torch.int32, device=card)
    eager = DA.decode_attention(q, k, v, lengths)   # builds and caches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        DA.decode_attention(q, k, v, lengths)
        with torch.cuda.graph(graph):
            out = DA.decode_attention(q, k, v, lengths)
    torch.cuda.current_stream().wait_stream(side)
    out.zero_()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# ---------------------------------------------------------------------------
# the hand-written Q6 row and the single-value group sum
# ---------------------------------------------------------------------------

from repro_torch.kernels.filter_agg import ops as FQ  # noqa: E402
from repro_torch.kernels.segmented_reduce import ops as SS  # noqa: E402

Q6_KW = dict(date_lo=8766, date_hi=9131, disc_lo=0.05, disc_hi=0.07,
             qty_hi=24.0)
#: ragged lengths (tails of 1-3 rows past the float4 loads) and one that
#: spans many blocks
RAGGED = [1, 3, 4097, 1_000_003]


def dyadic_q6(n, dev, seed):
    """Q6 columns on which every summation order gives the same f32 sum:
    prices are multiples of 1/4 below 1, discounts 7/128 or 8/128 (both
    qualify) or 1/8 (fails), so every product is a multiple of 2^-9 and
    every partial sum stays far below 2^24 of those units."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qty = torch.randint(1, 50, (n + 1,), generator=g).float()
    price = torch.randint(0, 4, (n + 1,), generator=g).float() / 4
    disc = torch.tensor([7 / 128, 8 / 128, 1 / 8])[
        torch.randint(0, 3, (n + 1,), generator=g)]
    date = torch.randint(8700, 9200, (n + 1,), generator=g,
                         dtype=torch.int32)
    return [t.to(dev) for t in (qty, price, disc, date)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", RAGGED)
def test_filter_agg_q6_is_exact_on_dyadic_inputs(card, n):
    cols = dyadic_q6(n, card, n)
    for offset in (0, 1):      # 1: every pointer 4 bytes past 16-byte
        view = [c[offset:offset + n] for c in cols]
        before = FQ.launches
        got = FQ.filter_agg_q6(*view, **Q6_KW)
        torch.cuda.synchronize()
        assert FQ.launches == before + 1
        want = FQ.filter_agg_q6_plain(*view, **Q6_KW)
        assert got.shape == () and got.dtype == torch.float32
        assert torch.equal(got, want), (n, offset, float(got), float(want))


@pytest.mark.gpu
def test_filter_agg_q6_matches_plain_at_q6_selectivity(card):
    g = torch.Generator(device=card).manual_seed(6)
    n = 3_000_001
    qty = torch.randint(1, 51, (n,), generator=g, device=card).float()
    price = torch.rand(n, generator=g, device=card) * 9000 + 900
    disc = torch.randint(0, 11, (n,), generator=g, device=card).float() / 100
    date = torch.randint(8000, 10600, (n,), generator=g, device=card,
                         dtype=torch.int32)
    got = FQ.filter_agg_q6(qty, price, disc, date, **Q6_KW)
    want = FQ.filter_agg_q6_plain(qty, price, disc, date, **Q6_KW)
    assert float(want) > 0
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


def dyadic_codes(n, groups, dev, seed):
    """Values that are multiples of 1/4 in [-8, 8) and codes in
    [-2, G + 2): out-of-range codes must add nothing."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    values = (torch.randint(-32, 32, (n + 1,), generator=g).float() / 4)
    codes = torch.randint(-2, groups + 2, (n + 1,), generator=g,
                          dtype=torch.int32)
    return values.to(dev), codes.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 6, 48, 49, 512])
@pytest.mark.parametrize("n", RAGGED)
def test_segmented_sum_is_exact_on_dyadic_inputs(card, n, groups):
    values, codes = dyadic_codes(n, groups, card, n + groups)
    for offset in (0, 1):
        v, c = values[offset:offset + n], codes[offset:offset + n]
        before = SS.launches
        got = SS.segmented_sum(v, c, groups)
        torch.cuda.synchronize()
        assert SS.launches == before + 1
        want = SS.segmented_sum_plain(v, c, groups)
        assert got.shape == (groups,) and got.dtype == torch.float32
        assert torch.equal(got, want), (n, groups, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [513, 700])
def test_segmented_sum_above_max_groups_takes_the_scatter_path(card, groups):
    values, codes = dyadic_codes(4097, groups, card, groups)
    before = SS.launches
    got = SS.segmented_sum(values, codes, groups)
    assert SS.launches == before
    assert torch.equal(got, SS.segmented_sum_plain(values, codes, groups))


@pytest.mark.gpu
def test_q6_and_group_sum_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros(64, device=card)
    d = torch.zeros(64, dtype=torch.int32, device=card)
    with pytest.raises(KernelBudgetError):          # ragged lengths
        FQ.filter_agg_q6(x, x[:63], x, d, **Q6_KW)
    with pytest.raises(KernelBudgetError):          # strided view
        FQ.filter_agg_q6(x[::2], x[::2], x[::2], d[::2], **Q6_KW)
    with pytest.raises(KernelBudgetError):          # a column on the host
        FQ.filter_agg_q6(x, x.cpu(), x, d, **Q6_KW)
    with pytest.raises(KernelBudgetError):
        FQ.filter_agg_q6(x, x, x, d, **{**Q6_KW, "date_hi": 2 ** 31})
    with pytest.raises(KernelBudgetError):
        SS.segmented_sum(x, d[:32], 6)
    with pytest.raises(KernelBudgetError):
        SS.segmented_sum(x[::2], d[::2], 6)
    with pytest.raises(KernelBudgetError):
        SS.segmented_sum(x, d.cpu(), 6)


# ---------------------------------------------------------------------------
# join_probe_agg: the dense and search routes, the grouped modes
# ---------------------------------------------------------------------------

from repro_torch.core import engines as ENG  # noqa: E402
from repro_torch.kernels import Body  # noqa: E402
from repro_torch.relational import table as PT  # noqa: E402

#: kernel vs plain sums: the kernel adds in f32 per lane, block and (in
#: global mode) by atomics in an order that changes from run to run; the
#: plain version adds group sums in f64
PROBE_RTOL, PROBE_ATOL = 1e-3, 1e-3


def probe_call(ctx, qname, monkeypatch):
    """The arguments of the one join_probe_agg call of ``qname``."""
    calls = []
    orig = JP.join_probe_agg

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    monkeypatch.setattr(JP, "join_probe_agg", spy)
    Q.QUERIES[qname](ctx).lower(native=True).compile()()
    monkeypatch.undo()
    assert len(calls) == 1, (qname, len(calls))
    return calls[0]


def assert_probe_close(got, want, body):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    for j, op in enumerate(body.ops):
        if op == "max" and got.dim() == 2:
            assert torch.equal(got[j], want[j])
    err = (got.double() - want.double()).abs()
    assert bool((err <= PROBE_RTOL * want.double().abs() + PROBE_ATOL)
                .all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["q14", "q19"])
def test_probe_dense_and_search_routes_are_bit_identical(card_ctx, qname,
                                                         monkeypatch):
    args, kw = probe_call(card_ctx, qname, monkeypatch)
    meta = kw["meta"]
    assert kw.get("num_groups") is None
    assert meta[0].item() == 1 and meta[2].item() == 1   # dense, identity
    before = JP.launches
    dense = JP.join_probe_agg(*args, **kw)
    search = JP.join_probe_agg(*args, **{**kw, "meta": torch.zeros_like(
        meta)})
    no_meta = JP.join_probe_agg(*args, **{**kw, "meta": None})
    torch.cuda.synchronize()
    assert JP.launches == before + 3
    assert torch.equal(dense, search) and torch.equal(dense, no_meta)
    assert_probe_close(dense, JP.join_probe_agg_plain(*args, **kw), args[0])


@pytest.mark.gpu
@pytest.mark.parametrize("qname,mode", [("q5", "shared"), ("q3", "global")])
def test_probe_grouped_modes_match_plain(card_ctx, qname, mode, monkeypatch):
    args, kw = probe_call(card_ctx, qname, monkeypatch)
    body = args[0]
    assert JP.accum_mode(body.n_out, kw["num_groups"]) == mode
    want = JP.join_probe_agg_plain(*args, **kw)
    for meta in (kw["meta"], None):
        got = JP.join_probe_agg(*args, **{**kw, "meta": meta})
        assert_probe_close(got, want, body)


def chip_smoke():
    """``chip_smoke.py`` at the repo's root, for its helpers."""
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as CS
    return CS


@pytest.mark.gpu
def test_gapped_index_takes_the_search_route_in_the_kernel(card_ctx,
                                                           monkeypatch):
    """Every other part of q14's build side, shuffled: the index is
    neither dense nor identity, and the kernel (not the plain version)
    probes it by search and reads perm."""
    args, kw = probe_call(card_ctx, "q14", monkeypatch)
    gapped, meta = chip_smoke().gapped_build(torch, ENG, args, 16)
    assert meta.tolist() == [0, 0, 0]

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(JP, "join_probe_agg_plain", no_plain)
    before = JP.launches
    got = JP.join_probe_agg(*gapped, meta=meta)
    torch.cuda.synchronize()
    assert JP.launches == before + 1
    monkeypatch.undo()
    want = JP.join_probe_agg_plain(*gapped)
    assert_probe_close(got, want, args[0])
    full = JP.join_probe_agg_plain(*args)
    assert float(want[1]) < float(full[1])   # the dropped parts add nothing


#: A probe whose key is an f32 column, so that it can hold NaN, +-inf and
#: fractions: sum(price * pay) and count over matched rows.
EDGE_SRC = """
__device__ __forceinline__ float flare_probe_key(
    const FlareCols& pc, long long i) {
  return flare_ld_f32(pc.p[0], i);
}

__device__ __forceinline__ bool flare_row(
    const FlareCols& pc, const FlareCols& bc, long long i,
    long long row, bool matched, const float* __restrict__ s,
    float (&v)[FLARE_N_OUT], int* code) {
  const float price = flare_ld_f32(pc.p[1], i);
  const float pay = flare_ld_f32(bc.p[0], row);
  v[0] = matched ? price * pay : 0.0f;
  v[1] = matched ? 1.0f : 0.0f;
  return matched;
}
"""


def _edge_rows(pcols, bvals, matched, scal):
    vals = [torch.where(matched, pcols[1] * bvals[0], 0.0),
            matched.to(torch.float32)]
    return matched, vals, None


EDGE_BODY = Body(src=EDGE_SRC, rows=_edge_rows, ops=("sum", "sum"),
                 fills=(0.0, 0.0),
                 col_dtypes=(torch.float32, torch.float32),
                 build_dtypes=(torch.float32,),
                 probe_key=lambda pcols: pcols[0], key_cols=(0,))

#: build keys of each index kind and the meta they must get
EDGE_INDEXES = {
    "dense identity, base -40": (lambda rng: np.arange(-40, 160),
                                 [1, -40, 1]),
    "dense shuffled": (lambda rng: rng.permutation(np.arange(1, 201)),
                       [1, 1, 0]),
    "gapped sorted": (lambda rng: 2 * np.arange(1, 201), [0, 0, 1]),
    "gapped shuffled": (lambda rng: rng.permutation(2 * np.arange(1, 201)),
                        [0, 0, 0]),
}


def _edge_keys(rng, lo, hi, n):
    """Probe keys around ``[lo, hi]``: integers in and beyond the range,
    fractions, far keys, NaN, +-inf and signed zeros."""
    special = np.array([np.nan, -np.inf, np.inf, -0.0, 0.0, lo, hi, lo - 1,
                        hi + 1, lo + 0.5, hi - 0.5, hi + 0.25, 1e9, -1e9,
                        2.0 ** 24, -(2.0 ** 24)], np.float32)
    kind = rng.integers(0, 3, n)
    ints = rng.integers(lo - 8, hi + 9, n).astype(np.float32)
    fracs = rng.uniform(lo - 8, hi + 8, n).astype(np.float32)
    kp = np.where(kind == 0, ints, np.where(kind == 1, fracs,
                                            special[np.arange(n) % 16]))
    return kp.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("index", list(EDGE_INDEXES))
def test_probe_routes_on_edge_keys(card, index, masked):
    """Each index kind (dense or not, identity or not) on f32 probe keys
    with NaN, +-inf, fractions and keys out of range: the kernel with the
    index's meta, with meta None (the search route, perm read) and the
    plain version give the same sums bit for bit (dyadic values: every
    partial sum exact); a build mask on the shuffled kinds."""
    rng = np.random.default_rng(len(index) + masked)
    make, want_meta = EDGE_INDEXES[index]
    keys = make(rng).astype(np.int32)
    idx = ENG.IndexCache(card).get(PT.Table.from_arrays({"k": keys}),
                                   ("k",))
    assert idx.meta.tolist() == want_meta
    n, nb = 3 * JP.TILE_ROWS + 77, keys.size
    kp = _edge_keys(rng, int(keys.min()), int(keys.max()), n)
    price = rng.integers(0, 64, n).astype(np.float32) / 4
    pay = rng.integers(0, 32, nb).astype(np.float32) / 8
    pcols = [torch.from_numpy(kp).to(card), torch.from_numpy(price).to(card)]
    pvalid = (torch.from_numpy(rng.random(n) < 0.7).to(card) if masked
              else None)
    bmask = (torch.from_numpy(rng.random(nb) < 0.8).to(card)
             if "shuffled" in index else None)
    args = (EDGE_BODY, pcols, pvalid, n, idx.keys, idx.perm, bmask,
            [torch.from_numpy(pay).to(card)],
            torch.zeros(1, device=card))
    before = JP.launches
    got = JP.join_probe_agg(*args, meta=idx.meta)
    searched = JP.join_probe_agg(*args, meta=None)
    torch.cuda.synchronize()
    assert JP.launches == before + 2
    want = JP.join_probe_agg_plain(*args)
    assert torch.equal(got, searched), (got, searched)
    assert torch.equal(got, want), (got, want)
    assert 0 < float(want[1]) < n   # some rows hit, some miss


# -- the heterogeneous pipelines (paper Fig. 8 / 13) ---------------------------


def _points_ctx(device, n, d=8, seed=0):
    """benchmarks/bench_ml.py's points generator at ``n`` rows."""
    from repro_torch.relational.table import Table
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5, (4, d))
    assign = rng.integers(0, 4, n)
    x = centers[assign] + rng.normal(0, 1, (n, d))
    data = {f"f{i}": x[:, i] for i in range(d)}
    data["label"] = (assign % 2).astype(np.int32)
    data["quality"] = rng.uniform(0, 1, n)
    ctx = FlareContext(device=device)
    ctx.register("points", Table.from_arrays(data))
    return ctx


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["kmeans", "logreg", "gda"])
def test_fused_pipeline_equals_staged_on_card(card, kernel):
    """The fused ``compiled`` pipeline against the ``stage`` engine on the
    card at 1 M rows (the same iterations, fields at rtol 1e-4), and
    against the volcano oracle on the host with tol 0 and a fixed
    max_iter (the reference tests' limits)."""
    from repro_torch.core import col
    ctx = _points_ctx("cuda", 1_000_000)
    feat = [f"f{i}" for i in range(8)]
    etl = ctx.table("points").filter(col("quality") > 0.1)
    hyper = {"kmeans": dict(k=4, max_iter=50), "logreg": dict(max_iter=100),
             "gda": {}}[kernel]
    label = None if kernel == "kmeans" else "label"
    tr = etl.train(kernel, columns=feat, label=label, **hyper)
    fused = tr.lower(engine="compiled").compile()()
    staged = tr.lower(engine="stage").compile()()
    for name, got in fused._asdict().items():
        want = getattr(staged, name)
        if name == "iters":
            assert int(got) == int(want)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    limits = {"kmeans": (1e-3, 1e-3), "logreg": (1e-4, 1e-5),
              "gda": (1e-3, 1e-4)}[kernel]
    if kernel != "gda":
        hyper.update(tol=0.0, max_iter=10)
        tr = etl.train(kernel, columns=feat, label=label, **hyper)
        fused = tr.lower(engine="compiled").compile()()
    oracle = tr.lower(engine="volcano").compile()()
    for name, want in oracle._asdict().items():
        if name != "assignments":  # padded against compacted
            np.testing.assert_allclose(getattr(fused, name), want,
                                       rtol=limits[0], atol=limits[1],
                                       err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
def test_group_by_reduce_routes_agree_on_card(card, weighted):
    from repro_torch.core import ml as ML
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, d, k = 2_000_003, 8, 4
    x = torch.randn((n, d), generator=gen, device="cuda")
    keys = torch.randint(0, k, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    w = ((torch.rand(n, generator=gen, device="cuda") < 0.9).float()
         if weighted else torch.ones(n, device="cuda"))
    a = ML.GROUP_ROUTES["onehot"](keys, x, w, k)
    b = ML.GROUP_ROUTES["index_add"](keys, x, w, k)
    c = ML.GROUP_ROUTES["index_add"](keys.cpu(), x.cpu(), w.cpu(), k)
    assert torch.equal(a[1], b[1]) and torch.equal(a[1].cpu(), c[1])
    torch.testing.assert_close(a[0], b[0], rtol=1e-9, atol=1e-6)
    torch.testing.assert_close(a[0].cpu(), c[0], rtol=1e-9, atol=1e-6)
    got = ML.group_by_reduce(keys, x, k, w if weighted else None)
    torch.testing.assert_close(got[0], a[0].float(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# template serving: Compiled.batch (torch.func.vmap) and AsyncResult
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("tname", sorted(Q.TEMPLATES))
def test_batch_matches_sequential_on_card(card_ctx, tname):
    compiled = Q.TEMPLATES[tname](card_ctx).lower(engine="compiled").compile()
    bindings = Q.random_bindings(tname, 5, seed=3)
    want = [compiled.result(**b).compact() for b in bindings]
    got = compiled.batch(bindings)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_results_equal(w, g.compact(), rtol=1e-6, msg=f"{tname} #{i}")


@pytest.mark.gpu
@pytest.mark.parametrize("tname", sorted(Q.TEMPLATES))
def test_batch_raw_makes_no_host_sync(card_ctx, tname):
    """A batch's ``raw`` queues its work without waiting for the device:
    ``set_sync_debug_mode("error")`` raises on a blocking copy,
    ``.item()`` or ``nonzero`` inside it.  The tables and their join
    indexes are on the card first: ``preload`` moves the columns and
    indexes the declared-unique keys, and one run of the template builds
    any other index it probes (q22's on ``o_custkey``), once per table."""
    card_ctx.preload()
    compiled = Q.TEMPLATES[tname](card_ctx).lower(engine="compiled").compile()
    bindings = Q.random_bindings(tname, 4, seed=5)
    compiled.result(**bindings[0])
    exe = compiled._batch_executor(4)
    stacked = {s.name: [b[s.name] for b in bindings]
               for s in compiled.params()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exe.raw(card_ctx.catalog, card_ctx.cache, stacked)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for i, b in enumerate(bindings):
        assert_results_equal(compiled.result(**b).compact(),
                             exe.finalize_one(out, i).compact(), rtol=1e-6,
                             msg=f"{tname} #{i}")


@pytest.mark.gpu
def test_async_result_on_card(card_ctx):
    from repro_torch.core import stages as S
    compiled = Q.TEMPLATES["q14"](card_ctx).lower(engine="compiled").compile()
    native = Q.TEMPLATES["q14"](card_ctx).lower(engine="compiled",
                                                native=True).compile()
    b = Q.TEMPLATE_BINDINGS["q14"][0]
    launches = JP.launches
    handles = [compiled.submit(**b), native.submit(**b),
               compiled.batch([b, b, b], block=False)[2]]
    assert JP.launches == launches + 1  # the native submit's probe
    for h in handles:
        assert isinstance(h, S.AsyncResult) and h._event is not None
        assert h.block_until_ready() is h
        assert h.ready()
        res = h.result()
        assert h._out is None and h._event is None  # device refs dropped
        assert all(isinstance(v, np.ndarray) for v in res.cols.values())
        assert isinstance(res.mask, np.ndarray)
        assert_results_equal(compiled(**b), res.compact(), rtol=1e-3)


# ---------------------------------------------------------------------------
# runtime services on the card: the store's native tier and the ladder
# ---------------------------------------------------------------------------

_STORE_CHILD = """
import json, sys
from repro_torch.core import CompileCache, FlareContext
from repro_torch.kernels import cuda_build as CB
from repro_torch.kernels.filter_agg import kernel as FA
from repro_torch.persist import ArtifactStore
from repro_torch.relational import queries as Q
ctx = FlareContext(device="cuda", store=ArtifactStore(sys.argv[1]))
Q.register_tpch(ctx, sf=0.05)
c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True).compile(
    cache=CompileCache())
res = c(**dict(Q.TEMPLATE_BINDINGS["q6"][0]))
print(json.dumps({"builds": CB.builds, "store_loads": CB.store_loads,
                  "launches": FA.launches, "disk_hit": c.stats.disk_hit,
                  "persist": c.stats.persist,
                  "revenue": float(res["revenue"][0])}))
"""


@pytest.mark.gpu
def test_native_template_store_roundtrip_on_card(card, tmp_path):
    """A fresh process loads q6's kernel unit from the store written here:
    no nvcc, the library from the artifact's bytes, the kernel launched,
    the same revenue (rtol 1e-5: the same kernel on the same data)."""
    import json
    import os
    import subprocess
    from repro_torch.core import CompileCache
    from repro_torch.persist import ArtifactStore
    store = ArtifactStore(tmp_path / "store")
    ctx = FlareContext(device="cuda", store=store)
    Q.register_tpch(ctx, sf=0.05)
    c = Q.TEMPLATES["q6"](ctx).lower(engine="compiled", native=True) \
        .compile(cache=CompileCache())
    want = c(**dict(Q.TEMPLATE_BINDINGS["q6"][0]))
    assert c.stats.persist == "written"
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    env.pop("FLARE_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _STORE_CHILD,
                           str(tmp_path / "store")], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["disk_hit"] and got["persist"] == "hit:native"
    assert got["builds"] == 0 and got["store_loads"] == 1
    assert got["launches"] > 0
    np.testing.assert_allclose(got["revenue"], want["revenue"][0],
                               rtol=1e-5)


@pytest.mark.gpu
def test_unit_build_failure_is_not_absorbed_by_the_ladder(card_ctx):
    """A unit nvcc refuses, built through the compile path, raises out of
    ``compile()`` with the ladder on; nothing degrades."""
    from repro_torch.core import CompileCache
    from repro_torch.kernels import cuda_build as CB
    from repro_torch.resilience import degrade as DG
    DG.clear_events()
    lowered = Q.TEMPLATES["q6"](card_ctx).lower(engine="compiled",
                                                native=True)
    artifact = lowered._force()
    artifact.kernel_sources = ("#error a unit that does not build\n",)
    assert DG.enabled()
    with pytest.raises(CB.UnitBuildError):
        lowered.compile(cache=CompileCache(), persist=False)
    assert DG.events() == ()


@pytest.mark.gpu
@pytest.mark.parametrize("qname,rows", [("q6", 65_536), ("q1", 65_536),
                                        ("q6", 50_001), ("q1", 50_001)])
def test_morsel_runs_launch_once_per_morsel_on_card(card_ctx, qname, rows):
    """Out-of-core execution on the card: the fragment's kernel runs once
    per morsel on views of the device columns (aligned morsels, and
    morsels whose views start off any 16-byte boundary), and the result
    equals the plain versions (the generic lowering, monolithic and in
    morsels) and the monolithic kernel run."""
    from repro_torch.core import morsel as MO
    mod = {"q6": FA, "q1": SR}[qname]
    build = Q.QUERIES[qname]
    n = card_ctx.catalog.table("lineitem").num_rows
    plain = build(card_ctx).lower().compile()()
    plain_morsels = build(card_ctx).lower(morsel_rows=rows).compile()()
    whole = build(card_ctx).lower(native=True).compile()()
    low = build(card_ctx).lower(native=True, morsel_rows=rows)
    assert MO.find_morsel_node(low.plan()).morsel_rows == rows
    compiled = low.compile()
    before = (FA.launches, SR.launches, JP.launches)
    got = compiled()
    torch.cuda.synchronize()
    after = (FA.launches, SR.launches, JP.launches)
    launched = dict(zip((FA, SR, JP), (a - b for a, b in zip(after, before))))
    assert launched[mod] == -(-n // rows) > 1
    assert sum(launched.values()) == launched[mod]
    for want in (plain, plain_morsels, whole):
        assert_results_equal(want, got, rtol=1e-3, msg=qname)


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["q1", "q3", "q6", "q14", "q19"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_parallel_runs_launch_once_per_shard_on_card(card_ctx, qname,
                                                     n_shards):
    """The sharded engine on the card: the fragment's kernel runs once per
    shard on views of the device columns, and the result equals the
    generic lowering and the monolithic kernel run."""
    from repro_torch.core import parallel as PAR
    from repro_torch.launch.mesh import make_data_mesh
    mod = {"q1": SR, "q6": FA}.get(qname, JP)
    build = Q.QUERIES[qname]
    plain = build(card_ctx).lower().compile()()
    whole = build(card_ctx).lower(native=True).compile()()
    low = build(card_ctx).lower(engine="parallel", native=True,
                                mesh=make_data_mesh(n_shards))
    assert PAR.find_shard_node(low.plan()).n_shards == n_shards
    compiled = low.compile()
    before = (FA.launches, SR.launches, JP.launches)
    got = compiled()
    torch.cuda.synchronize()
    after = (FA.launches, SR.launches, JP.launches)
    launched = dict(zip((FA, SR, JP), (a - b for a, b in zip(after, before))))
    assert launched[mod] == n_shards
    assert sum(launched.values()) == launched[mod]
    for want in (plain, whole):
        assert_results_equal(want, got, rtol=1e-3, msg=qname)


# ---------------------------------------------------------------------------
# the LM train step on the card
# ---------------------------------------------------------------------------

from repro_torch.configs import get as get_arch  # noqa: E402
from repro_torch.launch.steps import (init_train_state,  # noqa: E402
                                      loss_and_grads, make_train_step)
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.models.modeling import Model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402


def _lm_batch(seq, batch, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, 512, (batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.gpu
@pytest.mark.parametrize("impl,seq,batch", [("einsum", 64, 2),
                                            ("blockwise", 2048, 1)])
def test_train_step_on_card_matches_cpu(card, impl, seq, batch):
    """One reduced (f32) train step on the card against the same step on
    the CPU from the same state: loss and grad norm at rtol 1e-4,
    gradients per leaf within 1e-4 of the leaf's largest (cuBLAS and the
    CPU sum in other orders), parameters where |g| is above 1e-3 of the
    leaf's largest (a rounding-noise gradient may flip AdamW's first move
    of +-lr) or exactly 0 on both, to 1e-5 + 1e-4 |p|."""
    cfg = get_arch("qwen3-0.6b").reduced(attn_impl=impl)
    host, dev = Model(cfg, device="cpu"), Model(cfg, device=card)
    s_cpu = init_train_state(host, 0)
    s_card = PM.tree_map(lambda t: t.to(card), s_cpu)
    b = _lm_batch(seq, batch)
    _, _, g_cpu = loss_and_grads(host, s_cpu["params"], b)
    _, _, g_card = loss_and_grads(dev, s_card["params"], b)
    opt = AdamWConfig(lr=1e-3)
    s_cpu, m_cpu = make_train_step(host, opt)(s_cpu, b)
    s_card, m_card = make_train_step(dev, opt)(s_card, b)
    for k in ("loss", "grad_norm", "nll", "tokens"):
        np.testing.assert_allclose(float(m_card[k]), float(m_cpu[k]),
                                   rtol=1e-4, err_msg=k)
    want_g = dict(PM.flatten_with_paths(g_cpu))
    want_p = dict(PM.flatten_with_paths(s_cpu["params"]))
    for name, g in PM.flatten_with_paths(g_card):
        g, wg = g.cpu(), want_g[name]
        scale = float(wg.abs().max())
        assert float((g - wg).abs().max()) <= 1e-4 * scale, name
    for name, p in PM.flatten_with_paths(s_card["params"]):
        wg = want_g[name]
        keep = (wg.abs() > 1e-3 * wg.abs().max()) | (wg == 0)
        np.testing.assert_allclose(p.cpu()[keep].numpy(),
                                   want_p[name][keep].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.gpu
def test_attention_kernels_refuse_autograd_on_card(card):
    """attn_impl="pallas" under autograd raises on the card, where the
    kernels would otherwise leave the attention weights without a
    gradient."""
    cfg = get_arch("qwen3-0.6b").reduced(attn_impl="pallas",
                                         compute_dtype=torch.bfloat16)
    model = Model(cfg, device=card)
    with pytest.raises(NotImplementedError, match="no backward pass"):
        loss_and_grads(model, model.init(0), _lm_batch(128, 2))
    q = torch.randn(2, 4, 64, device=card, requires_grad=True)
    k = torch.randn(2, 2, 128, 64, device=card)
    with pytest.raises(NotImplementedError):
        DA.decode_attention(q, k, k, torch.full((2,), 9, dtype=torch.int32,
                                                device=card))
    before = FL.launches
    with torch.no_grad():
        loss, _ = model.loss(model.init(0), {
            k_: torch.as_tensor(v, device=card)
            for k_, v in _lm_batch(128, 2).items()})
    assert FL.launches - before == cfg.n_layers
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# the encdec family on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("s", [8, 63, 65, 512, 520])
def test_flash_encoder_shape_matches_plain(card, s):
    """The encoder's attention: the tensor-core kernel non-causal at D 64
    and group 1 (seamless's 16 MHA heads of 64), at encoder lengths
    ``max(S // 4, 8)`` on and off the 64-row tile (ragged K/V rows are
    zero-filled, and a non-causal row reads every key)."""
    gen = torch.Generator(device=card).manual_seed(s)
    q, k, v = (_randn(gen, (2, 16, s, 64), torch.bfloat16, card)
               for _ in range(3))
    before = FL.launches_mma
    got = FL.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FL.launches_mma == before + 1
    assert_within_rounding(got, FL.flash_attention_plain(q, k, v,
                                                         causal=False),
                           torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_at_group_1_d_64(card, dtype):
    """The decoder's decode step: 16 KV heads, one query head each, D 64,
    over the serving cache (2048 + 32 positions)."""
    q, k, v = _decode_inputs(card, dtype, 4, 16, 16, 2080, 64, 2080)
    lengths = torch.tensor([2049, 2080, 1, 700], dtype=torch.int32,
                           device=card)
    before = DA.launches
    got = DA.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert DA.launches == before + 1
    assert_within_rounding(got, DA.decode_attention_plain(q, k, v, lengths),
                           dtype)


@pytest.mark.gpu
def test_encdec_generate_on_card_equals_blockwise(card):
    """Greedy serving of the reduced seamless-m4t-large-v2 (f32) under
    ``pallas`` -- flash in the encoder (non-causal) and the decoder's
    prefill, decode_attention in decode -- gives the completions of the
    same run under ``blockwise``, which launches neither kernel."""
    from repro_torch.launch import serve_llm
    arch, gen = "seamless-m4t-large-v2", 6
    cfg = get_arch(arch).reduced()
    params = Model(cfg, device=card).init(0)
    kw = dict(batch=2, prompt_len=40, gen=gen, device=card, params=params)
    before = (FL.launches, DA.launches)
    got = serve_llm.generate(arch, attn_impl="pallas", **kw)
    torch.cuda.synchronize()
    assert (FL.launches - before[0], DA.launches - before[1]) == (
        cfg.enc_layers + cfg.dec_layers, cfg.dec_layers * gen)
    before = (FL.launches, DA.launches)
    want = serve_llm.generate(arch, attn_impl="blockwise", **kw)
    assert (FL.launches, DA.launches) == before
    np.testing.assert_array_equal(got["completions"], want["completions"])
