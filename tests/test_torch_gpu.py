"""The port's CUDA kernels on an NVIDIA Hopper card (``-m gpu``).

Every test here needs an sm_90 device and skips elsewhere with the
reason; on the card run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each native fragment's kernel is held against the generic lowering of
the same query on the same card (rtol 1e-3: summation order differs).
This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; ``expr_queries`` is also used by the CPU tests.
"""
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
#: then the tensor-core kernel's widths at S 64 (one tile), 97 and 1000
#: (ragged last tiles) and 300, each at GQA groups 1, 2 and 4.
FLASH_SHAPES = [(1, 2, 1, 128, 64), (2, 4, 2, 200, 32), (1, 8, 2, 97, 128),
                (2, 16, 8, 300, 64)] + [
    (2, 2 * g, 2, s, d) for d in (64, 128) for s in (64, 97, 300, 1000)
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
    assert mma == (dtype == torch.bfloat16 and d in (64, 128))
    assert (FL.launches, FL.launches_mma, FL.launches_cuda_cores) == (
        before[0] + 1, before[1] + mma, before[2] + (not mma))
    want = FL.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert_within_rounding(got, want, dtype)


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
    for d in (64, 128):
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
