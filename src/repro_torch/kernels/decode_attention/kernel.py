"""``decode_attention``: one query token per sequence over its KV cache.

Replaces the Pallas kernel ``decode_attention`` of
``src/repro/kernels/decode_attention/kernel.py`` (and its 4-D wrapper in
``ops.py``).  The op is bound by the bytes of the cache it streams, and
``B * Hkv`` (64 at the serving shapes) is fewer than the card's 132 SMs,
so the CUDA kernel (``csrc/decode_attention.cuh``) splits the cache over
warps -- each warp owns :func:`keys_per_part` keys of one (sequence, KV
head) and all the query heads of its group -- and a second pass folds the
per-warp (m, l, acc).  Keys at or beyond a sequence's length add exactly
nothing once one key is valid, so they are not read; a length of 0 gives
the mean of V over all ``S``, as the TPU kernel and its reference do.

Bound on the H100: bytes, the K and V rows below each sequence's length
(all of them for a length of 0) plus q and the output, over 3.35 TB/s.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import KernelBudgetError, on_card
from repro_torch.kernels import cuda_build as CB

#: Kernel launches by :func:`decode_attention`.
launches = 0

NEG_INF = -1e30

#: What the CUDA kernel takes: head widths (a multiple of 8, so a key row
#: is whole 16-byte loads) and query heads per KV head.
MIN_D, MAX_D, MAX_GROUP = 16, 256, 8

#: Warps the split aims for on each SM, to keep enough loads in flight.
WARPS_PER_SM = 32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p]


def keys_per_part(bhkv: int, s: int, sms: int) -> int:
    """Keys one warp streams: a multiple of 32, so that the whole split
    gives about :data:`WARPS_PER_SM` warps per SM."""
    want = -(-bhkv * s // (WARPS_PER_SM * sms))
    return max(32, min(4096, -(-want // 32) * 32))


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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B,H,D]``; k/v cache ``[B,Hkv,S,D]``; lengths ``[B]`` ->
    ``[B,H,D]`` in q's dtype (the JAX package's ``ops.decode_attention``).
    CPU tensors take the plain version."""
    _check(q, k, v, lengths)
    if not on_card(q):
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    global launches
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    if not MIN_D <= d <= MAX_D or d % 8:
        raise KernelBudgetError(f"decode_attention: head dim {d} must be a "
                                f"multiple of 8 in [{MIN_D}, {MAX_D}]")
    if group > MAX_GROUP:
        raise KernelBudgetError(f"decode_attention: {group} query heads per "
                                f"KV head > {MAX_GROUP}")
    if b * hkv > 65535:
        raise KernelBudgetError(f"decode_attention: {b * hkv} (sequence, KV "
                                f"head) pairs > 65535 (the grid's y extent)")
    if lengths.dtype != torch.int32:
        raise KernelBudgetError(f"decode_attention: lengths must be int32, "
                                f"got {lengths.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            raise KernelBudgetError(f"decode_attention: {name} must be a "
                                    f"contiguous tensor on {q.device}")
    if k.data_ptr() % 16:
        raise KernelBudgetError("decode_attention: the key cache must be "
                                "16-byte aligned (rows are read in 16-byte "
                                "loads)")
    if scale is None:
        scale = d ** -0.5
    CB.check_device(q)
    bhkv = b * hkv
    kpp = keys_per_part(bhkv, s, CB.sm_count(q))
    n_parts = -(-s // kpp)
    part_m = torch.empty(bhkv * n_parts * group, dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(bhkv * n_parts * group * d, dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    fn = CB.entry(CB.fixed_unit("decode_attention.cuh"),
                  "flare_decode_attention", _ARGS)
    err = fn(CB.ptr(q), CB.ptr(k), CB.ptr(v), CB.ptr(lengths), CB.ptr(out),
             bhkv, hkv, group, s, d, float(scale), _DTYPES[q.dtype], kpp,
             CB.ptr(part_m), CB.ptr(part_l), CB.ptr(part_acc), CB.stream(q))
    launches += 1
    CB.raise_on(err, "decode_attention")
    return out
