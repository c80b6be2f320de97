"""``decode_attention``: one query token per sequence over its KV cache.

Replaces the Pallas kernel ``decode_attention`` of
``src/repro/kernels/decode_attention/kernel.py`` (and its 4-D wrapper in
``ops.py``).  The op is bound by the bytes of the cache it streams, so the
CUDA kernel (``csrc/decode_attention.cuh``) is built around that stream,
in one launch:

* a persistent grid (:func:`grid_size`: blocks per SM from the occupancy
  query, cached) splits the keys each sequence really has into work
  items of whole 8 KB tiles, a schedule every block computes on the
  device from ``lengths`` (the host never reads the lengths), and each
  block walks a contiguous run of them.  :func:`decode_schedule` and
  :func:`block_runs` mirror that schedule in Python for the tests, which
  hold the device's (:func:`decode_attention_launch`) to it;
* each block streams its K and V tiles through a 4-stage ring in shared
  memory, filled by bulk copies that complete on mbarriers;
* a block's items of one (sequence, KV head) accumulate in registers and
  end in one partial, or in the output when they are the whole pair; the
  block that takes a pair's last ticket folds its partials in order
  (bit-identical from run to run).

Keys at or beyond a sequence's length add exactly nothing once one key is
valid, so they are not read; a length of 0 gives the mean of V over all
``S``, as the TPU kernel and its reference do.

Bound on the H100: bytes, the K and V rows below each sequence's length
(all of them for a length of 0) plus q and the output, over 3.35 TB/s.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import KernelBudgetError, on_card
from repro_torch.kernels import cuda_build as CB

#: Kernel launches by :func:`decode_attention` (one per call).
launches = 0

NEG_INF = -1e30

_UNIT = "decode_attention.cuh"


def _unit_constants() -> dict:
    """The integer ``#define DA_*`` constants of the CUDA unit, read from
    its source: the schedule is defined there alone."""
    return {m[1]: int(m[2]) for m in re.finditer(
        r"^#define DA_(\w+) (\d+)$", CB.fixed_unit(_UNIT), re.M)}


_CONST = _unit_constants()

#: What the CUDA kernel takes: head widths (a multiple of 8, so a key row
#: is whole 16-byte copies), query heads per KV head, and sequences (the
#: schedule's prefix over the batch lives in shared memory).
MIN_D, MAX_D, MAX_GROUP, MAX_BATCH = 16, 256, 8, _CONST["MAX_BATCH"]

#: The schedule's constants, from the unit: bytes of K (and of V) in one
#: tile, and the work items aimed for per block (the chunk is the valid
#: rows over that many items per block).
TILE_BYTES = _CONST["TILE_BYTES"]
ITEMS_PER_BLOCK = _CONST["ITEMS_PER_BLOCK"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: argtypes of the unit's C entry points
_SIGNATURES = {
    "flare_decode_attention": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "flare_decode_prepare": [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "flare_decode_attention_attrs": [ctypes.c_int] * 4 + [ctypes.c_void_p],
}

#: One work item: (sequence, KV head, first key, end key).
Item = Tuple[int, int, int, int]


def keys_per_tile(d: int, elem_bytes: int) -> int:
    """Keys in one tile: as many rows of ``d`` elements as fit 8 KB."""
    return TILE_BYTES // (d * elem_bytes)


def partial_slots(b: int, hkv: int, grid: int) -> int:
    """Rows of the partial buffer: block x's segment of pair j (its items
    of one sequence and KV head) keeps its partial in row x + j."""
    return grid + b * hkv


def decode_schedule(lengths: Sequence[int], hkv: int, s: int, d: int,
                    elem_bytes: int, grid: int) -> Tuple[int, List[Item]]:
    """The kernel's schedule, computed as every block computes it: the
    chunk (keys per item: whole tiles, at least two, at most S rounded
    up) and the items in their order (sequence, KV head, chunk).  A
    length clamps to [0, S]; 0 reads all S rows (every score is masked:
    the mean of V)."""
    kt = keys_per_tile(d, elem_bytes)
    n = [min(max(int(x), 0), s) or s for x in lengths]
    rows = hkv * sum(n)
    target = ITEMS_PER_BLOCK * grid
    chunk = -(-rows // target)
    chunk = max(2 * kt, -(-chunk // kt) * kt)
    chunk = min(chunk, -(-s // kt) * kt)
    items = [(b, h, start, min(start + chunk, nb))
             for b, nb in enumerate(n) for h in range(hkv)
             for start in range(0, nb, chunk)]
    return chunk, items


def block_runs(n_items: int, grid: int) -> List[Tuple[int, int]]:
    """The items each block walks, ``[lo, hi)``: contiguous runs of the
    same count to within one, over ``min(grid, n_items)`` blocks."""
    g = min(grid, n_items)
    return [(x * n_items // g, (x + 1) * n_items // g) for x in range(g)]


def scratch_words(b: int, hkv: int, group: int, d: int, grid: int) -> int:
    """int32 words of the kernel's one scratch buffer: the tickets and
    the schedule, then the f32 partials (acc, m, l) of
    :func:`partial_slots`."""
    head = -(-(b * hkv + 4) // 4) * 4
    return head + partial_slots(b, hkv, grid) * group * (d + 2)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch: f32 logits, positions at or
    beyond ``lengths[b]`` masked with -1e30, acc / max(l, 1e-30)."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, hkv, group, d).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < \
        lengths.to(q.device)[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(b, h, d).to(q.dtype)


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise KernelBudgetError(
            f"decode_attention: q [B,H,D] and k/v [B,Hkv,S,D] expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 \
            or h % k.shape[1]:
        raise KernelBudgetError(
            f"decode_attention: cache {tuple(k.shape)} does not fit q "
            f"{tuple(q.shape)} (H must be a multiple of Hkv)")
    if lengths.shape != (b,):
        raise KernelBudgetError(f"decode_attention: lengths must be [{b}], "
                                f"got {tuple(lengths.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise KernelBudgetError(
            f"decode_attention: q/k/v must share a dtype in "
            f"{sorted(map(str, _DTYPES))}, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}")


def _check_card(q, k, v, lengths) -> None:
    b, h, d = q.shape
    if not MIN_D <= d <= MAX_D or d % 8:
        raise KernelBudgetError(f"decode_attention: head dim {d} must be a "
                                f"multiple of 8 in [{MIN_D}, {MAX_D}]")
    if h // k.shape[1] > MAX_GROUP:
        raise KernelBudgetError(f"decode_attention: {h // k.shape[1]} query "
                                f"heads per KV head > {MAX_GROUP}")
    if b > MAX_BATCH:
        raise KernelBudgetError(f"decode_attention: {b} sequences > "
                                f"{MAX_BATCH} (the schedule's prefix lives "
                                f"in shared memory)")
    if k.shape[2] > 2 ** 30 or b * k.shape[1] > 2 ** 24:
        raise KernelBudgetError(f"decode_attention: cache {tuple(k.shape)} "
                                f"beyond S <= 2^30 and B * Hkv <= 2^24")
    if lengths.dtype != torch.int32:
        raise KernelBudgetError(f"decode_attention: lengths must be int32, "
                                f"got {lengths.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            raise KernelBudgetError(f"decode_attention: {name} must be a "
                                    f"contiguous tensor on {q.device}")
        if name != "lengths" and t.data_ptr() % 16:
            raise KernelBudgetError(f"decode_attention: {name} must start "
                                    f"on a 16-byte boundary (rows are "
                                    f"copied in 16-byte units)")


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """C entry point ``name`` of the unit (built and loaded on first use)."""
    return CB.entry(CB.fixed_unit(_UNIT), name, _SIGNATURES[name])


@functools.lru_cache(maxsize=None)
def _prepared(device: int, dtype: int, b: int, group: int,
              d: int) -> Tuple[int, int]:
    """(blocks per SM, shared bytes per block) of the kernel variant, from
    the occupancy query, once per device and shape class."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = _entry("flare_decode_prepare")(
            dtype, b, group, d, ctypes.cast(out, ctypes.c_void_p))
    CB.raise_on(err, "decode_attention occupancy")
    return out[0], out[1]


def grid_size(q: torch.Tensor, b: int, group: int, d: int) -> int:
    """Blocks of the persistent grid on ``q``'s device: blocks per SM
    times SMs."""
    dev = q.device.index or 0
    blocks, _ = _prepared(dev, _DTYPES[q.dtype], b, group, d)
    return blocks * CB.sm_count(q)


def resources(dtype: torch.dtype, b: int, group: int, d: int) -> dict:
    """Registers and local (spill) bytes per thread, static and dynamic
    shared bytes per block and threads per block of the kernel variant
    for this shape (the unit is built and loaded on first use), with its
    blocks per SM on the current device."""
    vals = (ctypes.c_int * 5)()
    CB.raise_on(_entry("flare_decode_attention_attrs")(
        _DTYPES[dtype], b, group, d, ctypes.cast(vals, ctypes.c_void_p)),
        "decode_attention attributes")
    out = dict(zip(("registers", "local_bytes", "static_smem",
                    "dynamic_smem", "threads"), list(vals)))
    out["blocks_per_sm"] = _prepared(torch.cuda.current_device(),
                                     _DTYPES[dtype], b, group, d)[0]
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor, scale: Optional[float]):
    """One launch on CUDA tensors: the output and the scratch buffer."""
    global launches
    _check(q, k, v, lengths)
    _check_card(q, k, v, lengths)
    CB.check_device(q)
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    grid = grid_size(q, b, group, d)
    scratch = torch.empty(scratch_words(b, hkv, group, d, grid),
                          dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    err = _entry("flare_decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, hkv, group, s, d,
        d ** -0.5 if scale is None else float(scale), _DTYPES[q.dtype], grid,
        scratch.data_ptr(), CB.stream(q))
    launches += 1
    CB.raise_on(err, "decode_attention")
    return out, scratch


def decode_attention_launch(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel once on CUDA tensors: the output and the
    schedule the kernel computed, int32 ``[chunk, items]`` on the device
    (what :func:`decode_schedule` gives on the host)."""
    out, scratch = _launch(q, k, v, lengths, scale)
    pairs = k.shape[0] * k.shape[1]
    return out, scratch[pairs:pairs + 2]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B,H,D]``; k/v cache ``[B,Hkv,S,D]``; lengths ``[B]`` ->
    ``[B,H,D]`` in q's dtype (the JAX package's ``ops.decode_attention``).
    CPU tensors take the plain version.  On the card: one launch, no host
    sync (a call can be captured in a CUDA graph)."""
    if not on_card(q):
        _check(q, k, v, lengths)
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    return _launch(q, k, v, lengths, scale)[0]
