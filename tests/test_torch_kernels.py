"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the tensors lie
on the CPU); the JAX kernels run in Pallas interpret mode, as the JAX
package's own tests run them.  Both sides get the same numpy inputs and
the same per-row function, written once for each framework.  Tolerance:
1e-5 relative (f32 sums in different orders).  The CUDA kernels
themselves are tested on the card by ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.filter_agg import kernel as JFA
from repro.kernels.filter_agg import ops as JFA_OPS
from repro.kernels.join_probe import kernel as JJP
from repro.kernels.segmented_reduce import kernel as JSR
from repro_torch.core import FlareContext
from repro_torch.kernels import Body, KernelBudgetError, on_card
from repro_torch.kernels.filter_agg import kernel as FA
from repro_torch.kernels.join_probe import kernel as JP
from repro_torch.kernels.segmented_reduce import kernel as SR
from repro_torch.relational import queries as Q

RTOL = 1e-5
BLOCK_ROWS = 8
F32_MIN = float(np.finfo(np.float32).min)


def _pad(x, fill=0.0):
    return JFA_OPS.pad_reshape(jnp.asarray(x), BLOCK_ROWS, fill)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return {"price": rng.uniform(900, 100_000, n).astype(np.float32),
            "disc": (rng.integers(0, 11, n) / 100).astype(np.float32),
            "qty": rng.integers(1, 51, n).astype(np.float32),
            "valid": rng.random(n) < 0.9}


# -- filter_agg_general -----------------------------------------------------


def _fa_body():
    """q6-shaped: disc in [s0, s1] and qty < s2 -> sum(price*disc), count."""
    def rows(cols, ok, scal):
        price, disc, qty = cols
        pred = ok & (disc >= scal[0]) & (disc <= scal[1]) & (qty < scal[2])
        return pred, [torch.where(pred, price * disc, 0.0),
                      pred.to(torch.float32)]
    return Body(src="", rows=rows, ops=("sum", "sum"), fills=(0.0, 0.0),
                col_dtypes=(torch.float32,) * 3)


def _fa_jax(scal_ref, blocks):
    price, disc, qty, valid = blocks
    pred = (valid > 0.5) & (disc >= scal_ref[0]) & (disc <= scal_ref[1]) \
        & (qty < scal_ref[2])
    return [jnp.where(pred, price * disc, 0.0), pred.astype(jnp.float32)]


@pytest.mark.parametrize("n", [1000, 4096 + 77])
def test_filter_agg_general_matches_pallas(n):
    d = _data(n, n)
    scal = np.array([0.05, 0.07, 24.0], np.float32)
    want = JFA.filter_agg_general(
        _fa_jax, [_pad(d["price"]), _pad(d["disc"]), _pad(d["qty"]),
                  _pad(d["valid"].astype(np.float32))],
        jnp.asarray(scal), 2, BLOCK_ROWS, interpret=True)
    want = np.array([float(jnp.sum(w)) for w in want])
    got = FA.filter_agg_general(
        _fa_body(), [torch.from_numpy(d[k]) for k in ("price", "disc", "qty")],
        torch.from_numpy(d["valid"]), n, torch.from_numpy(scal))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


# -- segmented_multi_sum ----------------------------------------------------

G = 6


def _sr_body():
    """sum(price), max(qty) (an any_ slot) and count, under qty < s0."""
    def rows(cols, ok, scal):
        price, qty = cols
        pred = ok & (qty < scal[0])
        return pred, [torch.where(pred, price, 0.0),
                      torch.where(pred, qty, F32_MIN),
                      pred.to(torch.float32)]
    return Body(src="", rows=rows, ops=("sum", "max", "sum"),
                fills=(0.0, F32_MIN, 0.0), col_dtypes=(torch.float32,) * 2)


def _sr_jax(scal_ref, blocks, code_block):
    price, qty, valid = blocks
    pred = (valid > 0.5) & (qty < scal_ref[0])
    return [jnp.where(pred, price, 0.0), jnp.where(pred, qty, F32_MIN),
            pred.astype(jnp.float32)]


@pytest.mark.parametrize("out_of_range", [False, True])
def test_segmented_multi_sum_matches_pallas(out_of_range):
    n = 3000 + 45
    d = _data(n, 11)
    codes = np.random.default_rng(5).integers(0, G, n).astype(np.int32)
    if out_of_range:  # codes no group owns contribute nothing
        codes[::7] = G
        codes[3::11] = G + 40
    scal = np.array([30.0], np.float32)
    want = JSR.segmented_multi_sum(
        _sr_jax, [_pad(d["price"]), _pad(d["qty"]),
                  _pad(d["valid"].astype(np.float32))],
        _pad(codes, 0), jnp.asarray(scal), 3, G, BLOCK_ROWS,
        interpret=True, ops=("sum", "max", "sum"),
        fills=(0.0, F32_MIN, 0.0))
    got = SR.segmented_multi_sum(
        _sr_body(), [torch.from_numpy(d["price"]), torch.from_numpy(d["qty"])],
        torch.from_numpy(d["valid"]), torch.from_numpy(codes), n, G,
        torch.from_numpy(scal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_array_equal(got.numpy()[1], np.asarray(want)[1])


# -- join_probe_agg -----------------------------------------------------------


def _build_side(nb, seed, masked):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.arange(1, 2 * nb + 1, 2)).astype(np.int32)
    pay = rng.uniform(0, 10, nb).astype(np.float32)
    grp = rng.integers(0, 700, nb).astype(np.int32)  # the group key column
    mask = rng.random(nb) < 0.6 if masked else None
    return keys, pay, grp, mask


def _jp_body(grouped):
    """probe key k; pred = matched & (qty < s0) & (pay > 1);
    sum(price*pay), max(qty) (sum(qty) keyless), count; group code =
    build column grp."""
    fill = F32_MIN if grouped else 0.0
    def probe_key(pcols):
        return pcols[0]

    def rows(pcols, bvals, matched, scal):
        _, price, qty = pcols
        pay, grp = bvals
        pred = matched & (qty < scal[0]) & (pay > 1.0)
        vals = [torch.where(pred, price * pay, 0.0),
                torch.where(pred, qty, fill), pred.to(torch.float32)]
        code = torch.where(pred, grp, 0.0).to(torch.int32) if grouped \
            else None
        return pred, vals, code
    return Body(src="", rows=rows,
                ops=("sum", "max" if grouped else "sum", "sum"),
                fills=(0.0, fill, 0.0),
                col_dtypes=(torch.int32, torch.float32, torch.float32),
                build_dtypes=(torch.float32, torch.int32),
                probe_key=probe_key)


def _jp_jax(masked, grouped):
    fill = F32_MIN if grouped else 0.0

    def body(scal_ref, pblocks, barrays):
        kp, price, qty, valid = pblocks
        idx, hit = JJP.probe_sorted(barrays[0].reshape(-1), kp)
        matched = hit & (valid > 0.5)
        ai = 1
        if masked:
            matched = matched & (jnp.take(barrays[1].reshape(-1), idx,
                                          mode="clip") > 0.5)
            ai = 2
        pay = jnp.take(barrays[ai].reshape(-1), idx, mode="clip")
        grp = jnp.take(barrays[ai + 1].reshape(-1), idx, mode="clip")
        pred = matched & (qty < scal_ref[0]) & (pay > 1.0)
        vals = [jnp.where(pred, price * pay, 0.0),
                jnp.where(pred, qty, fill), pred.astype(jnp.float32)]
        codes = jnp.where(pred, grp, 0.0).astype(jnp.int32) if grouped \
            else None
        return vals, codes
    return body


@pytest.mark.parametrize("mode,masked", [
    ("keyless", False), ("keyless", True), ("onehot", True),
    ("scatter", False), ("scatter", True)])
def test_join_probe_agg_matches_pallas(mode, masked):
    n, nb = 2500 + 19, 300
    keys, pay, grp, bmask = _build_side(nb, 3, masked)
    rng = np.random.default_rng(9)
    pkeys = rng.integers(0, 2 * nb + 5, n).astype(np.int32)  # ~half hit
    d = _data(n, 4)
    scal = np.array([35.0], np.float32)
    groups = None if mode == "keyless" else (700 if mode == "scatter"
                                             else 512)
    if mode == "onehot":
        grp = grp % 512
    order = np.argsort(keys, kind="stable")
    barrays = [JJP.pad_build(jnp.asarray(keys[order], jnp.float32),
                             jnp.inf)]
    if masked:
        barrays.append(JJP.pad_build(
            jnp.asarray(bmask[order], jnp.float32), 0.0))
    barrays += [JJP.pad_build(jnp.asarray(pay[order]), 0.0),
                JJP.pad_build(jnp.asarray(grp[order], jnp.float32), 0.0)]
    pblocks = [_pad(pkeys.astype(np.float32)), _pad(d["price"]),
               _pad(d["qty"]), _pad(d["valid"].astype(np.float32))]
    body = _jp_jax(masked, groups is not None)
    if groups is None:
        outs = JJP.join_probe_agg(body, pblocks, barrays, jnp.asarray(scal),
                                  3, BLOCK_ROWS, interpret=True)
        want = np.array([float(jnp.sum(o)) for o in outs])
    else:
        want = np.asarray(JJP.join_probe_agg(
            body, pblocks, barrays, jnp.asarray(scal), 3, BLOCK_ROWS,
            num_groups=groups, ops=("sum", "max", "sum"),
            fills=(0.0, F32_MIN, 0.0), accum=mode, interpret=True))
    t_keys, t_perm = torch.sort(torch.from_numpy(keys), stable=True)
    got = JP.join_probe_agg(
        _jp_body(groups is not None),
        [torch.from_numpy(pkeys), torch.from_numpy(d["price"]),
         torch.from_numpy(d["qty"])],
        torch.from_numpy(d["valid"]), n, t_keys, t_perm.to(torch.int32),
        None if bmask is None else torch.from_numpy(bmask),
        [torch.from_numpy(pay), torch.from_numpy(grp)],
        torch.from_numpy(scal), num_groups=groups)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    if groups is not None:
        np.testing.assert_array_equal(got.numpy()[1], want[1])


def test_accum_mode_recasts_the_tpu_budgets():
    """Shared memory for small accumulators, global atomics beyond it
    (q3's l_orderkey groups at SF 10), an error past device memory."""
    assert JP.accum_mode(3, None) == "keyless"
    assert JP.accum_mode(2, 25) == "shared"
    assert JP.accum_mode(4, 15_000_001) == "global"
    with pytest.raises(KernelBudgetError):
        JP.accum_mode(4, 1 << 30)


# -- generated source and device policy ------------------------------------


@pytest.fixture(scope="module")
def cpu_ctx():
    c = FlareContext(device="cpu")
    Q.register_tpch(c, sf=0.005)
    return c


@pytest.mark.parametrize("tname", list(Q.TEMPLATES))
def test_template_bindings_share_one_cuda_source(cpu_ctx, tname):
    sources = []
    for _ in Q.TEMPLATE_BINDINGS[tname]:
        lowered = Q.TEMPLATES[tname](cpu_ctx).lower(native=True)
        (src,) = lowered.kernel_sources()
        sources.append(src)
    assert len(set(sources)) == 1
    assert "flare_row" in sources[0] and "__global__" in sources[0]
    # parameters the fragment uses are read from the scal vector, never
    # baked in (q14's and q22's sit below the join, in generic lowering)
    for p in Q.TEMPLATES[tname](cpu_ctx).params():
        assert (f":{p.name}" in sources[0]) == (tname in ("q6", "q19"))


def test_q6_and_q14_sources_differ(cpu_ctx):
    (a,) = Q.q6(cpu_ctx).lower(native=True).kernel_sources()
    (b,) = Q.q14(cpu_ctx).lower(native=True).kernel_sources()
    assert a != b
    assert "flare_probe_key" in b and "flare_probe_key" not in a


def test_cpu_tensors_never_count_a_launch():
    d = _data(500, 1)
    before = (FA.launches, SR.launches, JP.launches)
    scal = torch.tensor([0.05, 0.07, 24.0])
    assert not on_card(scal)
    FA.filter_agg_general(
        _fa_body(), [torch.from_numpy(d[k]) for k in ("price", "disc", "qty")],
        None, 500, scal)
    SR.segmented_multi_sum(
        _sr_body(), [torch.from_numpy(d["price"]), torch.from_numpy(d["qty"])],
        None, torch.zeros(500, dtype=torch.int32), 500, G, scal)
    keys, pay, grp, _ = _build_side(50, 2, False)
    t_keys, t_perm = torch.sort(torch.from_numpy(keys), stable=True)
    JP.join_probe_agg(
        _jp_body(True), [torch.from_numpy(np.arange(500, dtype=np.int32)),
                         torch.from_numpy(d["price"]),
                         torch.from_numpy(d["qty"])],
        None, 500, t_keys, t_perm.to(torch.int32), None,
        [torch.from_numpy(pay), torch.from_numpy(grp)], scal, num_groups=700)
    assert (FA.launches, SR.launches, JP.launches) == before


# -- build and launch plumbing that runs without a card ----------------------


def test_units_are_cached_by_content():
    from repro_torch.kernels import cuda_build as CB
    a = FA.unit_source(_fa_body())
    assert CB.library_path(a) == CB.library_path(str(a))
    assert CB.library_path(a) != CB.library_path(a + "\n// edit")
    assert CB.library_path(a).parent == CB.BUILD_DIR


@pytest.mark.parametrize("x", [0.05, -3.4028234663852886e38, 1e-45, 24.0,
                               float(-(2 ** 31))])
def test_f32_literals_are_exact(x):
    from repro_torch.kernels import f32_literal
    lit = f32_literal(x)
    assert lit.endswith("f")
    assert np.float32(float.fromhex(lit[:-1])) == np.float32(x)


def test_device_policy_and_argument_checks():
    from repro_torch.kernels import check_columns, check_mask
    with pytest.raises(KernelBudgetError):
        on_card(torch.empty(1, device="meta"))
    cpu = torch.device("cpu")
    with pytest.raises(KernelBudgetError, match="contiguous"):
        check_columns("k", [torch.zeros(4, dtype=torch.int64)],
                      [torch.int32], 4, cpu)
    with pytest.raises(KernelBudgetError, match="columns for a body"):
        check_columns("k", [], [torch.int32], 4, cpu)
    with pytest.raises(KernelBudgetError, match="mask"):
        check_mask("k", torch.ones(3, dtype=torch.bool), 4, cpu)
    check_columns("k", [torch.zeros(4, dtype=torch.int32)], [torch.int32],
                  4, cpu)


def test_index_cache_verifies_declared_unique_keys():
    from repro_torch.core.engines import IndexCache
    from repro_torch.relational.table import Table
    cache = IndexCache(torch.device("cpu"))
    good = Table.from_arrays({"k": np.array([3, 1, 2], np.int32)},
                             uniques=["k"])
    idx = cache.get(good, ("k",))
    assert idx.keys.tolist() == [1, 2, 3] and idx.perm.tolist() == [1, 2, 0]
    assert idx.perm.dtype == torch.int32 and idx.unique
    assert cache.get(good, ("k",)) is idx and cache.hits == 1
    bad = Table.from_arrays({"k": np.array([1, 1, 2], np.int32)},
                            uniques=["k"])
    with pytest.raises(ValueError, match="declared unique"):
        cache.get(bad, ("k",))
