"""The hand-written Q6 row and the single-value group sum, on the CPU,
against the JAX package's Pallas kernels in interpret mode.

``filter_agg_q6`` and ``segmented_sum`` of the port take their plain
PyTorch versions on CPU tensors; the inputs are made with numpy from a
seed and handed to both packages.  Tolerances are those of the
reference's own sweeps (``tests/test_kernels.py``): f32 sums taken in
another order.  The CUDA units themselves are checked here only as text
(no nvcc); ``tests/test_torch_gpu.py`` runs them on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.filter_agg import ops as JFA
from repro.kernels.filter_agg.ref import filter_agg_q6_ref
from repro.kernels.segmented_reduce import ops as JSR
from repro.kernels.segmented_reduce.ref import segmented_sum_ref
from repro_torch.kernels import f32_literal
from repro_torch.kernels.filter_agg import ops as FQ
from repro_torch.kernels.segmented_reduce import ops as SS

Q6_KW = dict(date_lo=8766, date_hi=9131, disc_lo=0.05, disc_hi=0.07,
             qty_hi=24.0)


def q6_columns(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1, 50, n).astype(np.float32),
            rng.uniform(900, 10000, n).astype(np.float32),
            np.round(rng.uniform(0, 0.1, n), 2).astype(np.float32),
            rng.integers(8000, 10600, n).astype(np.int32))


@pytest.mark.parametrize("n", [7, 127, 1000, 4096, 131072 + 13])
def test_filter_agg_q6_matches_pallas(n):
    cols = q6_columns(n, n)
    want = JFA.filter_agg_q6(*map(jnp.asarray, cols), interpret=True,
                             **Q6_KW)
    before = FQ.launches
    got = FQ.filter_agg_q6(*map(torch.from_numpy, cols), **Q6_KW)
    assert FQ.launches == before          # CPU tensors: the plain version
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-2)


def test_filter_agg_q6_empty_predicate():
    n = 1024
    qty = torch.full((n,), 100.0)   # nothing passes qty < 24
    z = torch.zeros(n)
    ship = torch.full((n,), 9000, dtype=torch.int32)
    assert float(FQ.filter_agg_q6(qty, z, z, ship, **Q6_KW)) == 0.0
    assert float(JFA.filter_agg_q6(
        jnp.asarray(qty.numpy()), jnp.asarray(z.numpy()),
        jnp.asarray(z.numpy()), jnp.asarray(ship.numpy()), interpret=True,
        **Q6_KW)) == 0.0


def test_filter_agg_q6_compares_with_the_f32_thresholds():
    """Weak typing in the reference: an f32 column compares with the
    float32 rounding of 0.05 / 0.07 / 24.0, so discounts at exactly
    those f32 values qualify and their f32 neighbours outside do not."""
    lo, hi, q = (np.float32(x) for x in (0.05, 0.07, 24.0))
    disc = np.array([lo, hi, np.nextafter(lo, np.float32(0)),
                     np.nextafter(hi, np.float32(1)), hi, hi], np.float32)
    qty = np.array([1, 1, 1, 1, np.nextafter(q, np.float32(0)), q],
                   np.float32)
    price = np.array([1, 2, 4, 8, 16, 32], np.float32)
    date = np.full(6, 9000, np.int32)
    cols = (qty, price, disc, date)
    want = filter_agg_q6_ref(*map(jnp.asarray, cols), **Q6_KW)
    got = FQ.filter_agg_q6(*map(torch.from_numpy, cols), **Q6_KW)
    expect = np.float32(lo) * 1 + hi * 2 + hi * 16
    assert float(want) == pytest.approx(float(expect), rel=1e-6)
    assert float(got) == pytest.approx(float(expect), rel=1e-6)


def test_filter_agg_q6_casts_as_the_reference():
    """Columns of other dtypes are cast as ``ops.py`` casts them (f32
    values, int32 dates) before the predicate."""
    qty, price, disc, date = q6_columns(500, 1)
    got = FQ.filter_agg_q6(torch.from_numpy(qty.astype(np.float64)),
                           torch.from_numpy(price.astype(np.float64)),
                           torch.from_numpy(disc.astype(np.float64)),
                           torch.from_numpy(date.astype(np.int64)), **Q6_KW)
    want = FQ.filter_agg_q6(*map(torch.from_numpy, (qty, price, disc, date)),
                            **Q6_KW)
    assert torch.equal(got, want)


def test_q6_units_bake_exact_constants():
    src = FQ.unit_source(**Q6_KW)
    for name, x in (("DISC_LO", 0.05), ("DISC_HI", 0.07), ("QTY_HI", 24.0)):
        assert f"#define FLARE_Q6_{name} {f32_literal(x)}\n" in src
    assert "#define FLARE_Q6_DATE_LO 8766\n" in src
    assert "#define FLARE_Q6_DATE_HI 9131\n" in src
    assert float.fromhex(f32_literal(0.07)[:-1]) == float(np.float32(0.07))
    # one unit per set of constants; the same constants give the same unit
    assert FQ.unit_source(**Q6_KW) == src
    other = FQ.unit_source(**{**Q6_KW, "disc_hi": 0.08})
    assert other != src
    assert FQ.unit_source(**{**Q6_KW, "date_lo": 8767}) != src
    assert "flare_q6" in src and "flare_sum_partials" in src


def test_group_sum_unit_is_one_fixed_source():
    src = SS.unit_source()
    assert "#define FLARE_N_OUT 1\n" in src
    assert "flare_segmented_sum" in src and "flare_group_final" in src
    assert SS.unit_source() is src


@pytest.mark.parametrize("n,g", [(100, 3), (1000, 6), (8192, 64),
                                 (50000, 512), (4096, 700)])
def test_segmented_sum_matches_pallas(n, g):
    rng = np.random.default_rng(n + g)
    v = rng.uniform(-5, 5, n).astype(np.float32)
    c = rng.integers(0, g, n).astype(np.int32)
    want = JSR.segmented_sum(jnp.asarray(v), jnp.asarray(c), g,
                             interpret=True)    # g > 512: scatter path
    before = SS.launches
    got = SS.segmented_sum(torch.from_numpy(v), torch.from_numpy(c), g)
    assert SS.launches == before
    assert got.shape == (g,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-3)


def test_segmented_sum_drops_codes_outside_the_domain():
    v = np.arange(1, 9, dtype=np.float32)
    c = np.array([-1, 0, 1, 2, 3, 4, 2, -7], np.int32)
    want = segmented_sum_ref(jnp.asarray(v), jnp.asarray(c), 3)
    got = SS.segmented_sum(torch.from_numpy(v), torch.from_numpy(c), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [2, 3, 11])


@settings(max_examples=12, deadline=None)
@given(st.data())
def test_segmented_sum_matches_pallas_on_adversarial_codes(data):
    """As the reference's property test: skewed and constant codes,
    codes at the 0 and G-1 boundaries, lengths around its padding seams,
    empty groups."""
    g = data.draw(st.integers(1, 70), label="num_groups")
    n = data.draw(st.one_of(
        st.integers(1, 300),
        st.sampled_from([127, 128, 129, 1023, 1024, 1025, 8191, 8192]),
    ), label="n")
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 31 - 1)))
    kind = data.draw(st.sampled_from(
        ["uniform", "constant", "boundary", "skewed"]), label="codes")
    if kind == "uniform":
        codes = rng.integers(0, g, n)
    elif kind == "constant":
        codes = np.full(n, data.draw(st.integers(0, g - 1)))
    elif kind == "boundary":
        codes = rng.choice([0, g - 1], n)
    else:
        hot = data.draw(st.integers(0, g - 1))
        codes = np.where(rng.random(n) < 0.95, hot, rng.integers(0, g, n))
    v = np.round(rng.uniform(-100, 100, n), 2).astype(np.float32)
    c = codes.astype(np.int32)
    want = JSR.segmented_sum(jnp.asarray(v), jnp.asarray(c), g,
                             interpret=True)
    got = SS.segmented_sum(torch.from_numpy(v), torch.from_numpy(c), g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-3)


def test_segmented_sum_rejects_an_empty_domain():
    with pytest.raises(ValueError):
        SS.segmented_sum(torch.zeros(4), torch.zeros(4, dtype=torch.int32), 0)
