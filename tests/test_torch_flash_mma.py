"""The tensor-core flash kernel's route and arithmetic, on the CPU.

``route`` is a pure function of dtype and head width; it is held here to
every (dtype, D) the configs use.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``), so its arithmetic is rehearsed here by a
torch emulation of what ``csrc/flash_attention_mma.cuh`` computes -- 64-row
Q tiles, 64-key K tiles up to the diagonal, scores scaled into the exp2
domain, masked scores -1e30 and ragged keys -inf, one rescale per tile,
P split into a bf16 high part and the bf16 rounding of the rest before
P V, f32 accumulators -- on inputs made with numpy from a seed.

Tolerances: against the JAX package's ``flash_attention`` (Pallas, interpret
mode) ``KERNEL_TOL[("flash", "bf16")]`` of ``test_torch_lm.py``, as the
JAX package holds its kernel to its reference; against the port's plain
version (f32 P) the card gate of ``chip_smoke.py`` and
``test_torch_gpu.py``: ``2^-7 |want| + 1e-3 max|want|``, one bf16 rounding
of the output.

The kernel's shared-memory row layout is held here through its Python
mirror (``mma_smem_offset``, ``mma_smem_bytes``): every (row, chunk) of a
tile has a slot of its own, and every 8-row ``ldmatrix`` read falls on 8
distinct bank groups; the card test ties the mirror's bytes to the build.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.registry import ARCHS
from repro.kernels.flash_attention import ops as JFL
from repro_torch.configs import get
from repro_torch.kernels import KernelBudgetError
from repro_torch.kernels.flash_attention import kernel as FL

FLASH_BF16_TOL = 2e-2            # KERNEL_TOL[("flash", "bf16")]
GATE_REL, GATE_FLOOR = 2.0 ** -7, 1e-3
TILE = 64
LOG2E = 1.4426950408889634

#: The kernel each config's attention takes on the card: bf16 at D 64,
#: 128, 160 or 256 goes to the tensor cores, other widths to the CUDA-core
#: kernel.
CONFIG_ROUTE = {
    "qwen3_0_6b": (64, "mma"),
    "starcoder2_7b": (128, "mma"),
    "granite_8b": (128, "mma"),
    "qwen3_14b": (128, "mma"),
    "mamba2_130m": (32, "cuda_cores"),
    "seamless_m4t_large_v2": (64, "mma"),
    "pixtral_12b": (160, "mma"),
    "dbrx_132b": (128, "mma"),
    "olmoe_1b_7b": (128, "mma"),
    "recurrentgemma_2b": (256, "mma"),
}
_TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_route_of_each_config(arch):
    cfg = jget(arch)
    d, want = CONFIG_ROUTE[arch]
    assert cfg.head_dim_ == d
    assert FL.route(_TORCH[cfg.compute_dtype], d) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_route_of_each_reduced_config(arch):
    """The smoke configs compute in f32: the CUDA-core kernel."""
    cfg = jget(arch).reduced()
    assert FL.route(_TORCH[cfg.compute_dtype], cfg.head_dim_) == \
        "cuda_cores"


def test_route_of_the_ports_config():
    cfg = get("qwen3-0.6b")
    assert (cfg.compute_dtype, cfg.head_dim_) == (torch.bfloat16, 64)
    assert FL.route(cfg.compute_dtype, cfg.head_dim_) == "mma"


@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 160, 256])
def test_route_is_by_dtype_and_width_only(d):
    assert FL.route(torch.float32, d) == "cuda_cores"
    assert FL.route(torch.bfloat16, d) == ("mma" if d in (64, 128, 160, 256)
                                           else "cuda_cores")


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               .bfloat16() for s in ((1, 4, 70, 64), (1, 2, 70, 64),
                                     (1, 2, 70, 64)))
    before = (FL.launches, FL.launches_mma, FL.launches_cuda_cores)
    got = FL.flash_attention(q, k, v, causal=True)
    assert (FL.launches, FL.launches_mma, FL.launches_cuda_cores) == before
    # the same plain function; its CPU sums may run in another order
    torch.testing.assert_close(
        got, FL.flash_attention_plain(q, k, v, causal=True))


def test_mismatched_k_and_v_are_refused():
    """The 4-D wrapper checks k against v before it reshapes them."""
    q = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(KernelBudgetError):
        FL.flash_attention(q, q[:, :1], q[:, :1, :32])


def emulate_mma_kernel(q, k, v, *, causal, scale=None, split=True):
    """What flash_attention_mma.cuh computes, in torch on the CPU.

    q ``[BH,S,D]``, k/v ``[BHkv,S,D]`` bf16 -> ``[BH,S,D]`` bf16.  The
    tensor cores multiply bf16 exactly and add in f32; so does this.
    ``split=False`` rounds P to bf16 alone (the model's rounding), which
    the kernel does not ship."""
    bh, s, d = q.shape
    group = bh // k.shape[0]
    scale_log2 = torch.tensor((d ** -0.5 if scale is None else scale)
                              * LOG2E, dtype=torch.float32)
    qf = q.float()
    kf = k.float().repeat_interleave(group, 0)
    vf = v.float().repeat_interleave(group, 0)
    out = torch.empty(bh, s, d, dtype=torch.float32)
    n_k = math.ceil(s / TILE)
    for qt in range(math.ceil(s / TILE)):
        rows = torch.arange(qt * TILE, (qt + 1) * TILE)
        qb = qf[:, qt * TILE:(qt + 1) * TILE]
        qb = torch.cat([qb, qb.new_zeros(bh, TILE - qb.shape[1], d)], 1)
        m = torch.full((bh, TILE, 1), -1e30)
        l = torch.zeros(bh, TILE, 1)
        acc = torch.zeros(bh, TILE, d)
        for j in range(min(qt + 1, n_k) if causal else n_k):
            keys = torch.arange(j * TILE, (j + 1) * TILE)
            kb = torch.zeros(bh, TILE, d)
            vb = torch.zeros(bh, TILE, d)
            n = min(s - j * TILE, TILE)        # rows past S are zero-filled
            kb[:, :n] = kf[:, j * TILE:j * TILE + n]
            vb[:, :n] = vf[:, j * TILE:j * TILE + n]
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
        out[:, qt * TILE:(qt + 1) * TILE] = o[:, :min(TILE, s - qt * TILE)]
    assert not bool(torch.isnan(out).any())
    return out.bfloat16()


def _inputs(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.as_tensor(a).bfloat16() for a in arrs])


def _emulated(tq, tk, tv, causal, split=True):
    b, h, s, d = tq.shape
    hkv = tk.shape[1]
    out = emulate_mma_kernel(tq.reshape(b * h, s, d),
                             tk.reshape(b * hkv, s, d),
                             tv.reshape(b * hkv, s, d), causal=causal,
                             split=split)
    return out.reshape(b, h, s, d)


def _gate_excess(got, want):
    got, want = got.double(), want.double()
    err = (got - want).abs()
    limit = GATE_REL * want.abs() + GATE_FLOOR * float(want.abs().max())
    return float((err / limit).max())


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 160, 256])
def test_emulated_kernel_matches_jax_and_the_plain_version(d, causal,
                                                           group):
    (jq, jk, jv), (tq, tk, tv) = _inputs(d + group + causal, 1, 2 * group,
                                         2, 200, d)
    got = _emulated(tq, tk, tv, causal)
    want_jax = np.asarray(jnp.asarray(
        JFL.flash_attention(jq, jk, jv, causal=causal), jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want_jax,
                               rtol=FLASH_BF16_TOL, atol=FLASH_BF16_TOL)
    want = FL.flash_attention_plain(tq, tk, tv, causal=causal)
    assert _gate_excess(got, want) <= 1.0


@pytest.mark.parametrize("s", [1, 63, 65, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_emulated_kernel_on_ragged_tiles(s, causal):
    """A last tile with 1..63 keys (zero-filled rows, -inf scores) adds
    nothing and lets no NaN into m or l; a single key gives V itself."""
    _, (tq, tk, tv) = _inputs(s, 1, 4, 2, s, 64)
    got = _emulated(tq, tk, tv, causal)
    want = FL.flash_attention_plain(tq, tk, tv, causal=causal)
    assert _gate_excess(got, want) <= 1.0
    if s == 1:
        assert torch.equal(got, tv.repeat_interleave(2, 1))


def _ragged_against_plain_and_jax(s, causal, d):
    (jq, jk, jv), (tq, tk, tv) = _inputs(s + d, 1, 4, 2, s, d)
    got = _emulated(tq, tk, tv, causal)
    want = FL.flash_attention_plain(tq, tk, tv, causal=causal)
    assert _gate_excess(got, want) <= 1.0
    want_jax = np.asarray(jnp.asarray(
        JFL.flash_attention(jq, jk, jv, causal=causal), jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want_jax,
                               rtol=FLASH_BF16_TOL, atol=FLASH_BF16_TOL)
    if s == 1:
        assert torch.equal(got, tv.repeat_interleave(2, 1))


@pytest.mark.parametrize("s", [1, 63, 65, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_emulated_kernel_on_ragged_tiles_at_d160(s, causal):
    """The same at pixtral's head width, 20 chunks a row: against the
    plain version and the JAX package's kernel (Pallas, interpret
    mode)."""
    _ragged_against_plain_and_jax(s, causal, 160)


@pytest.mark.parametrize("s", [1, 63, 65, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_emulated_kernel_on_ragged_tiles_at_d256(s, causal):
    """The same at recurrentgemma-2b's head width, 32 chunks a row, where
    the kernel re-reads Q from shared memory and holds one K and one V
    stage: the arithmetic, and so the emulation, is that of every other
    width."""
    _ragged_against_plain_and_jax(s, causal, 256)


def _ldmatrix_reads(d):
    """The (row, chunk) each of the 32 lanes reads in every ldmatrix.x4
    of one block (4 warps) of ``flare_flash_mma_kernel``: the Q
    fragments, K's B fragments and V's transposed B fragments."""
    ks = d // 16
    for warp in range(4):
        for kc in range(ks):
            yield [(warp * 16 + (ln & 15), 2 * kc + (ln >> 4))
                   for ln in range(32)]
    for np_ in range(TILE // 16):
        for kc in range(ks):
            yield [(np_ * 16 + (ln & 7) + ((ln >> 4) << 3),
                    2 * kc + ((ln >> 3) & 1)) for ln in range(32)]
    for kk in range(TILE // 16):
        for dn in range(ks):
            yield [(kk * 16 + (ln & 7) + (((ln >> 3) & 1) << 3),
                    2 * dn + (ln >> 4)) for ln in range(32)]


@pytest.mark.parametrize("d", [64, 128, 160, 256])
def test_shared_row_layout_has_a_slot_per_chunk_and_no_bank_conflict(d):
    """The mirror of ``fm_swz<D>``: a 64-row tile's (row, chunk) pairs
    take distinct 16-byte slots inside the tile, the tiles (Q, and two
    stages of K and V up to D 160, one at D 256) fit ``mma_smem_bytes``,
    and each 8-lane matrix of every ldmatrix read hits 8 distinct bank
    groups (16-byte units mod 128 bytes).  At D 64 and 128 it is the XOR
    swizzle the kernel has had since it landed; D 256 takes it too (32
    chunks a row)."""
    chunks = d // 8
    row_bytes = FL.mma_row_chunks(d) * 16
    tile_bytes = TILE * row_bytes
    assert tile_bytes % 128 == 0          # every tile starts on bank 0
    assert FL.mma_stages(d) == (1 if d == 256 else 2)
    assert FL.mma_smem_bytes(d) == (1 + 2 * FL.mma_stages(d)) * tile_bytes
    slots = {}
    for r in range(TILE):
        for c in range(chunks):
            off = FL.mma_smem_offset(d, r, c) * 2
            assert off % 16 == 0 and 0 <= off and off + 16 <= tile_bytes
            assert slots.setdefault(off // 16, (r, c)) == (r, c)
            if d in (64, 128, 256):
                assert FL.mma_smem_offset(d, r, c) == \
                    r * d + ((c ^ (r % 8)) << 3)
    assert len(slots) == TILE * chunks
    n_reads = 0
    for lanes in _ldmatrix_reads(d):
        n_reads += 1
        for m in range(4):
            group = lanes[8 * m:8 * m + 8]
            assert all(0 <= r < TILE and 0 <= c < chunks for r, c in group)
            banks = {FL.mma_smem_offset(d, r, c) * 2 // 16 % 8
                     for r, c in group}
            assert len(banks) == 8, (d, group)
    assert n_reads == 4 * (d // 16) * 3


def _wide_lane(row, c, i):
    """The byte offset ``fm_wide_lane`` gives a lane for ``kc % 4 == i``
    in a D 256 tile."""
    return row * 512 + (((2 * i) ^ c ^ (row & 7)) << 4)


def test_wide_lane_addresses_are_the_row_layout():
    """At D 256 the kernel reads Q, K and V through per-lane offsets by
    kc % 4 plus immediates (``fm_wide_lane``): each is the offset the
    row layout gives the (row, chunk) that the D 64-160 code reads for
    the same lane, k16 step and key group."""
    d, ks = 256, 256 // 16
    for ln in range(32):
        for kc in range(ks):
            # Q: rows warp * 16 + lane % 16, chunk 2 kc + lane / 16
            for warp in range(4):
                r = warp * 16 + (ln & 15)
                assert _wide_lane(r, ln >> 4, kc & 3) + 128 * (kc >> 2) == \
                    FL.mma_smem_offset(d, r, 2 * kc + (ln >> 4)) * 2
            # K: key groups of 16 rows
            for np_ in range(TILE // 16):
                r0 = (ln & 7) + ((ln >> 4) << 3)
                got = (_wide_lane(r0, (ln >> 3) & 1, kc & 3)
                       + np_ * 16 * 512 + 128 * (kc >> 2))
                assert got == FL.mma_smem_offset(
                    d, np_ * 16 + r0, 2 * kc + ((ln >> 3) & 1)) * 2
        # V (transposed): k16 steps of P V over the n8 pairs dn
        for kk in range(TILE // 16):
            for dn in range(ks):
                got = (_wide_lane(ln & 15, ln >> 4, dn & 3)
                       + kk * 16 * 512 + 128 * (dn >> 2))
                assert got == FL.mma_smem_offset(
                    d, kk * 16 + (ln & 15), 2 * dn + (ln >> 4)) * 2


@pytest.mark.parametrize("causal,d", [(True, 64), (False, 64),
                                      (True, 256), (False, 256)],
                         ids=["True", "False", "True-d256", "False-d256"])
def test_split_p_lands_closer_to_f32_p_than_bf16_p(causal, d):
    """The high + low split keeps P at f32 grade: on the same inputs its
    error against the f32-P plain version stays below that of P rounded
    to bf16 alone, the variant that misses the card gate on the LM path's
    non-causal layer-0 inputs (PERF.md); at D 64 and at D 256."""
    _, (tq, tk, tv) = _inputs(11, 1, 8, 2, 512, d)
    want = FL.flash_attention_plain(tq, tk, tv, causal=causal)
    split = _gate_excess(_emulated(tq, tk, tv, causal), want)
    bf16_p = _gate_excess(_emulated(tq, tk, tv, causal, split=False), want)
    assert split < bf16_p
