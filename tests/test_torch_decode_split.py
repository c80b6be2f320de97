"""The decode_attention kernel's schedule and fold, on the CPU.

The CUDA kernel (``csrc/decode_attention.cuh``) splits each sequence's
valid keys into work items of whole tiles, on the device; each block
walks a contiguous run of items, its items of one (sequence, KV head)
end in one partial, and the partials are folded in order in the same
launch.  Here the Python mirror of that schedule (``decode_schedule``,
``block_runs``) is checked for coverage and bounds, and a plain-torch
emulation of the split, the per-tile online softmax, the fold and the
direct write of a whole pair is held against ``decode_attention_plain``
and the JAX package's ``decode_attention`` (Pallas interpret mode), in f32
at rtol 1e-5 and atol 1e-6: the three differ only in the order of their
f32 sums.  The card tests (``tests/test_torch_gpu.py``) hold the device
schedule to this mirror.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as JDA
from repro_torch.kernels.decode_attention import kernel as DA

RTOL, ATOL = 1e-5, 1e-6

#: (lengths, hkv, S, D, element bytes, grid); the grids are blocks per SM
#: (1 to 3) times the H100's 132 SMs, and 1
SCHEDULES = {
    "serving": ([2049] * 8, 8, 2080, 64, 2, 396),
    "serving, 2 blocks per SM": ([2049] * 8, 8, 2080, 64, 2, 264),
    "decode_32k-like": (list(np.random.default_rng(0).integers(
        1, 32769, 8)), 8, 32768, 64, 2, 396),
    "ragged edges": ([0, 1, 100, 105, -3, 7, 64, 65], 2, 100, 64, 4, 132),
    "f32 D 256 (8-key tiles)": ([0, 9, 17, 200, 8], 1, 200, 256, 4, 264),
    "D 24 (170-key tiles)": ([1, 170, 171, 1000, 0], 3, 1000, 24, 2, 132),
    "one block": ([5, 300, 0], 2, 300, 16, 2, 1),
    "one long sequence": ([1 << 20, 1, 1], 1, 1 << 20, 128, 2, 396),
    "B x Hkv above 65 535": ([1] * 8192, 8, 16, 16, 2, 264),
}


def segments(items, grid):
    """Each block's segments, as the kernel ends them: (block, pair,
    first item, end item) for every run of a block's items of one pair."""
    out = []
    for x, (lo, hi) in enumerate(DA.block_runs(len(items), grid)):
        for i in range(lo, hi):
            pair = items[i][:2]
            if i == lo or items[i - 1][:2] != pair:
                out.append([x, pair, i, i + 1])
            else:
                out[-1][3] = i + 1
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_covers_every_valid_row_once(name):
    lengths, hkv, s, d, elem, grid = SCHEDULES[name]
    chunk, items = DA.decode_schedule(lengths, hkv, s, d, elem, grid)
    kt = DA.keys_per_tile(d, elem)
    assert kt == 8192 // (d * elem) and kt * d * elem <= 8192
    assert chunk % kt == 0                             # whole tiles
    assert chunk >= min(2 * kt, -(-s // kt) * kt)
    assert len(items) <= DA.ITEMS_PER_BLOCK * grid + len(lengths) * hkv
    covered = {}
    last = (-1, -1, -1)
    for b, h, start, end in items:
        assert (b, h, start) > last                    # (b, head, chunk)
        last = (b, h, start)
        assert start % chunk == 0 and 0 < end - start <= chunk
        covered.setdefault((b, h), []).append((start, end))
    for b, length in enumerate(lengths):
        n = min(max(int(length), 0), s) or s           # 0 reads all S
        for h in range(hkv):
            spans = covered[(b, h)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(e == s2 for (_, e), (s2, _) in zip(spans, spans[1:]))
    assert set(covered) == {(b, h) for b in range(len(lengths))
                            for h in range(hkv)}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_block_runs_share_the_items_and_their_partials_fit(name):
    lengths, hkv, s, d, elem, grid = SCHEDULES[name]
    _, items = DA.decode_schedule(lengths, hkv, s, d, elem, grid)
    runs = DA.block_runs(len(items), grid)
    assert len(runs) == min(grid, len(items))
    assert runs[0][0] == 0 and runs[-1][1] == len(items)
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(runs, runs[1:]))
    sizes = [hi - lo for lo, hi in runs]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    segs = segments(items, grid)
    pairs = len(lengths) * hkv
    slots = [x + b * hkv + h for x, (b, h), _, _ in segs]
    assert len(set(slots)) == len(slots)               # one row each
    assert max(slots) < DA.partial_slots(len(lengths), hkv, grid)
    assert len(segs) <= len(runs) + pairs


@pytest.mark.parametrize("lengths,hkv,s,d,elem,grid,want", [
    ([2049] * 8, 8, 2080, 64, 2, 396, (128, 64 * 17)),
    ([2049] * 8, 8, 2080, 64, 2, 264, (128, 64 * 17)),
    ([32768] * 8, 8, 32768, 64, 2, 396, (704, 64 * 47)),
    ([7], 1, 7, 64, 2, 396, (64, 1)),
    ([0, 0], 1, 50, 256, 4, 1, (16, 8)),
])
def test_schedule_chunk_and_items(lengths, hkv, s, d, elem, grid, want):
    chunk, items = DA.decode_schedule(lengths, hkv, s, d, elem, grid)
    assert (chunk, len(items)) == want


def test_scratch_holds_the_tickets_and_every_partial():
    b, hkv, group, d, grid = 8, 8, 2, 64, 396
    words = DA.scratch_words(b, hkv, group, d, grid)
    head = b * hkv + 4
    assert words == head + (grid + b * hkv) * group * (d + 2)
    # any lengths: every segment's partial row lies in the buffer
    rng = np.random.default_rng(1)
    for _ in range(20):
        lengths = rng.integers(-5, 3000, b)
        _, items = DA.decode_schedule(lengths, hkv, 2080, d, 2, grid)
        for x, (bi, h), _, _ in segments(items, grid):
            assert x + bi * hkv + h < DA.partial_slots(b, hkv, grid)


def emulate_split(q, k, v, lengths, grid, scale=None):
    """What the kernel computes, in plain torch: each block's segments
    (its items of one pair) with the online-softmax update per tile; per
    (sequence, KV head), the direct write of a single segment or the fold
    of its segments' partials in block order.  Returns the output and the
    number of partials folded."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if scale is None else scale
    kt = DA.keys_per_tile(d, q.element_size())
    _, items = DA.decode_schedule(lengths.tolist(), hkv, s, d,
                                  q.element_size(), grid)
    parts = {}
    for _, (bi, hi), i0, i1 in segments(items, grid):
        none_valid = int(lengths[bi]) <= 0
        qg = q[bi, hi * group:(hi + 1) * group].float()
        m = torch.full((group,), -float("inf"))
        l = torch.zeros(group)
        acc = torch.zeros(group, d)
        for _, _, start, end in items[i0:i1]:
            for r0 in range(start, end, kt):
                kk = k[bi, hi, r0:min(r0 + kt, end)].float()
                vv = v[bi, hi, r0:min(r0 + kt, end)].float()
                sc = (torch.full((group, kk.shape[0]), DA.NEG_INF)
                      if none_valid else (qg @ kk.T) * scale)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[:, None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + p @ vv
                m = m_new
        parts.setdefault((bi, hi), []).append((m, l, acc))
    out = torch.empty(b, hkv, group, d)
    folded = 0
    for (bi, hi), ps in parts.items():
        if len(ps) == 1:                               # the direct write
            m, l, acc = ps[0]
            out[bi, hi] = acc / l.clamp_min(1e-30)[:, None]
            continue
        folded += len(ps)
        mm = torch.stack([p[0] for p in ps])           # [partials, G]
        big_m = mm.amax(0)
        w = torch.exp(mm - big_m)
        big_l = (torch.stack([p[1] for p in ps]) * w).sum(0)
        big_a = (torch.stack([p[2] for p in ps]) * w[:, :, None]).sum(0)
        out[bi, hi] = big_a / big_l.clamp_min(1e-30)[:, None]
    return out.reshape(b, h, d).to(q.dtype), folded


@pytest.mark.parametrize("b,h,hkv,s,d,lens,grid", [
    (6, 4, 2, 300, 32, [0, 1, 300, 400, -4, 137], 40),
    (3, 16, 8, 256, 64, [256, 65, 1], 30),
    (4, 8, 1, 64, 256, [64, 9, 8, 0], 12),
    (2, 6, 3, 300, 16, [300, 299], 9),
    (2, 2, 2, 400, 24, [400, 3], 5),
    # beyond 8 query heads per KV head: starcoder2-7b's group 9,
    # recurrentgemma-2b's 10, and the unit's largest, 16
    (3, 36, 4, 300, 128, [300, 1, 177], 20),
    (2, 10, 1, 200, 256, [200, 0], 6),
    (2, 32, 2, 1100, 16, [1100, 600], 7),
])
def test_split_and_fold_match_plain_and_jax(b, h, hkv, s, d, lens, grid):
    rng = np.random.default_rng(b * 100 + s + d)
    qa = rng.standard_normal((b, h, d)).astype(np.float32)
    ka = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    va = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    lengths = torch.tensor(lens, dtype=torch.int32)
    q, k, v = (torch.as_tensor(x) for x in (qa, ka, va))
    got, folded = emulate_split(q, k, v, lengths, grid)
    assert folded > 0                  # these grids split pairs over blocks
    want = DA.decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    jwant = np.asarray(JDA.decode_attention(
        jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(np.array(lens, np.int32))))
    np.testing.assert_allclose(got.numpy(), jwant, rtol=RTOL, atol=ATOL)


def test_whole_pairs_write_the_output_directly():
    """At a grid of one block, every pair is one segment: the emulation
    is the direct write alone."""
    rng = np.random.default_rng(3)
    b, h, hkv, s, d = 2, 4, 2, 640, 32
    q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, h, d), (b, hkv, s, d), (b, hkv, s, d)))
    lengths = torch.tensor([640, 10], dtype=torch.int32)
    got, folded = emulate_split(q, k, v, lengths, grid=1)
    assert folded == 0
    torch.testing.assert_close(got, DA.decode_attention_plain(q, k, v,
                                                              lengths),
                               rtol=RTOL, atol=ATOL)


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(4)
    q = torch.as_tensor(rng.standard_normal((2, 4, 32)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((2, 2, 40, 32)).astype(
        np.float32))
    lengths = torch.tensor([40, 0], dtype=torch.int32)
    before = DA.launches
    got = DA.decode_attention(q, k, k, lengths)
    assert DA.launches == before
    torch.testing.assert_close(got, DA.decode_attention_plain(q, k, k,
                                                              lengths))


def test_shared_memory_fits_every_shape_the_kernel_takes():
    """The Python mirror of the unit's layout: every group up to
    ``MAX_GROUP`` at every head width and the largest batch fits the
    227 KB a block may take on sm_90, so the wrapper's shared-memory
    check refuses none of them; a group above ``MAX_GROUP`` is refused."""
    assert DA.MAX_GROUP >= 16
    for group in range(1, DA.MAX_GROUP + 1):
        for d in range(DA.MIN_D, DA.MAX_D + 1, 8):
            for elem in (2, 4):
                assert DA.shared_bytes(DA.MAX_BATCH, group, d, elem) \
                    <= DA.SMEM_OPTIN, (group, d, elem)
    # the serving shapes of starcoder2-7b (group 9, D 128) and
    # recurrentgemma-2b (group 10, D 256) pass the card's checks
    for h, hkv, d in ((36, 4, 128), (10, 1, 256)):
        q = torch.zeros(8, h, d, dtype=torch.bfloat16)
        k = torch.zeros(8, hkv, 64, d, dtype=torch.bfloat16)
        DA._check_card(q, k, k, torch.ones(8, dtype=torch.int32))
    q = torch.zeros(1, DA.MAX_GROUP + 1, 16)
    k = torch.zeros(1, 1, 8, 16)
    with pytest.raises(DA.KernelBudgetError, match="query heads per KV"):
        DA._check_card(q, k, k, torch.ones(1, dtype=torch.int32))
