"""``flash_attention``: blocked online-softmax attention with native GQA.

Replaces the Pallas kernel ``flash_attention`` of
``src/repro/kernels/flash_attention/kernel.py`` (and its 4-D wrapper in
``ops.py``) with two CUDA kernels of the same function, chosen by
:func:`route` from the dtype and the head width alone:

* ``"mma"`` (``csrc/flash_attention_mma.cuh``): bf16 at D 64, 128 or
  160, the widths of every bf16 config but recurrentgemma (256).  Both
  products run on the tensor cores (``mma.sync`` m16n8k16 bf16, f32
  accumulators; P split into bf16 high and low parts, so it keeps f32
  grade) and K/V tiles stream through shared memory by ``cp.async``,
  in the row layout that :func:`mma_smem_offset` mirrors;
* ``"cuda_cores"`` (``csrc/flash_attention.cuh``): f32, and bf16 at any
  other D in [16, 256]; the dots run in f32 on the CUDA cores.

Each gives one thread block to a (query head, 64-row Q tile); the block
walks the K/V tiles of its KV head (``h // group``: K and V are never
repeated) and keeps the running max, denominator and accumulator in f32
registers.  Any ``S`` is taken (the last tiles are masked), and under
``causal`` the tiles above the diagonal are skipped, which is exact.  The
TPU kernel's block sizes are not carried over.

Bound on the H100: operations, ``4 * S^2 * D`` flops per query head (half
under ``causal``) at the bf16 tensor-core rate.  The times, bounds and
plain times of both kernels are in ``PERF.md``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import (KernelBudgetError, on_card,
                                 refuse_autograd)
from repro_torch.kernels import cuda_build as CB

#: Kernel launches by :func:`flash_attention_core`: all of them, and by
#: route (:func:`route`).
launches = 0
launches_mma = 0
launches_cuda_cores = 0

NEG_INF = -1e30

#: The head widths the CUDA-core kernel takes, and those of the
#: tensor-core kernel (bf16 only).
MIN_D, MAX_D = 16, 256
MMA_D = (64, 128, 160)
#: The tensor-core kernel's tiles: Q rows a block, K/V rows a stage.
MMA_BQ = MMA_BK = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_MMA_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head width takes:
    ``"mma"`` (tensor cores) or ``"cuda_cores"``."""
    return "mma" if dtype == torch.bfloat16 and d in MMA_D else "cuda_cores"


def mma_row_chunks(d: int) -> int:
    """16-byte chunks in one shared row of the tensor-core kernel at head
    width ``d`` (``fm_row<D>::stride / 8``): D / 8, or the next odd count
    when D / 8 is not a multiple of 8 (D 160: 21)."""
    chunks = d // 8
    return chunks if chunks % 8 == 0 else chunks | 1


def mma_smem_offset(d: int, row: int, chunk: int) -> int:
    """Element offset of (row, 16-byte chunk) in a shared tile of the
    tensor-core kernel (``fm_swz<D>``): rows of :func:`mma_row_chunks`
    chunks; when that count is a multiple of 8, chunk ``c`` of row ``r``
    sits at chunk ``c ^ (r % 8)``, else at chunk ``c``."""
    chunks = mma_row_chunks(d)
    if chunks % 8 == 0:
        chunk ^= row & 7
    return (row * chunks + chunk) * 8


def mma_smem_bytes(d: int) -> int:
    """Dynamic shared bytes of a block of the tensor-core kernel
    (``fm_smem_bytes<D>``): a Q tile and two stages of K and V tiles,
    bf16 rows of :func:`mma_row_chunks` chunks."""
    return (MMA_BQ + 4 * MMA_BK) * mma_row_chunks(d) * 16


def mma_resources() -> dict:
    """Registers and local (spill) bytes per thread, static and dynamic
    shared bytes per block of the tensor-core kernel at each width (the
    unit is built and loaded on first use)."""
    fn = CB.entry(CB.fixed_unit("flash_attention_mma.cuh"),
                  "flare_flash_attention_mma_attrs",
                  [ctypes.c_int, ctypes.c_void_p])
    out = {}
    for d in MMA_D:
        vals = (ctypes.c_int * 4)()
        CB.raise_on(fn(d, ctypes.cast(vals, ctypes.c_void_p)),
                    "flash_attention_mma attributes")
        out[d] = dict(zip(("registers", "local_bytes", "static_smem",
                           "dynamic_smem"), list(vals)))
    return out


def _check_shapes(q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise KernelBudgetError(
            f"flash_attention: q [BH,S,D] and k/v [BHkv,S,D] expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    if k.shape[1:] != (s, d) or k.shape[0] == 0 or bh % k.shape[0]:
        raise KernelBudgetError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q "
            f"{tuple(q.shape)} (BH must be a multiple of BHkv)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise KernelBudgetError(
            f"flash_attention: q/k/v must share a dtype in "
            f"{sorted(map(str, _DTYPES))}, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}")


def flash_attention_core_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch: q ``[BH,S,D]``, k/v
    ``[BHkv,S,D]``; f32 logits, masked with -1e30, acc / max(l, 1e-30)."""
    bh, s, d = q.shape
    bhkv = k.shape[0]
    group = bh // bhkv
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(bhkv, group, s, d).float()
    logits = torch.einsum("kgqd,ksd->kgqs", qg, k.float()) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("kgqs,ksd->kgqd", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(bh, s, d).to(q.dtype)


def flash_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q ``[BH,S,D]``; k/v ``[BHkv,S,D]`` with BH % BHkv == 0 -> ``[BH,S,D]``
    in q's dtype.  CPU tensors take the plain version.  Under autograd
    (an input requiring grad) it raises ``NotImplementedError``: there is
    no backward pass (:func:`repro_torch.kernels.refuse_autograd`)."""
    refuse_autograd("flash_attention", q, k, v)
    _check_shapes(q, k, v)
    if not on_card(q):
        return flash_attention_core_plain(q, k, v, causal=causal,
                                          scale=scale)
    global launches, launches_mma, launches_cuda_cores
    bh, s, d = q.shape
    if not MIN_D <= d <= MAX_D:
        raise KernelBudgetError(f"flash_attention: head dim {d} outside "
                                f"[{MIN_D}, {MAX_D}]")
    if bh > 65535:
        raise KernelBudgetError(f"flash_attention: {bh} query heads > 65535 "
                                f"(the grid's y extent)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise KernelBudgetError(f"flash_attention: {name} must be a "
                                    f"contiguous tensor on {q.device}")
    if scale is None:
        scale = d ** -0.5
    CB.check_device(q)
    out = torch.empty_like(q)
    if route(q.dtype, d) == "mma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise KernelBudgetError(
                    f"flash_attention: {name} must start on a 16-byte "
                    f"boundary (the tensor-core kernel copies 16-byte "
                    f"chunks)")
        fn = CB.entry(CB.fixed_unit("flash_attention_mma.cuh"),
                      "flare_flash_attention_mma", _MMA_ARGS)
        err = fn(CB.ptr(q), CB.ptr(k), CB.ptr(v), CB.ptr(out), bh,
                 k.shape[0], s, d, int(causal), float(scale), CB.stream(q))
        launches_mma += 1
    else:
        fn = CB.entry(CB.fixed_unit("flash_attention.cuh"),
                      "flare_flash_attention", _ARGS)
        err = fn(CB.ptr(q), CB.ptr(k), CB.ptr(v), CB.ptr(out), bh,
                 k.shape[0], s, d, int(causal), float(scale),
                 _DTYPES[q.dtype], CB.stream(q))
        launches_cuda_cores += 1
    launches += 1
    CB.raise_on(err, "flash_attention")
    return out


def _check_4d(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or q.shape[0] != k.shape[0] \
            or k.shape != v.shape:
        raise KernelBudgetError(
            f"flash_attention: q [B,H,S,D] and k/v [B,Hkv,S,D] expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if on_card(q):
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise KernelBudgetError(f"flash_attention: {name} must be "
                                        f"contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B,H,S,D]``; k/v ``[B,Hkv,S,D]`` -> ``[B,H,S,D]`` (the JAX
    package's ``ops.flash_attention``)."""
    _check_4d(q, k, v)
    b, h, s, d = q.shape
    hkv = k.shape[1]
    out = flash_attention_core(q.reshape(b * h, s, d),
                               k.reshape(b * hkv, s, d),
                               v.reshape(b * hkv, s, d), causal=causal,
                               scale=scale)
    return out.reshape(b, h, s, d)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The 4-D API's plain version, on any device."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    out = flash_attention_core_plain(q.reshape(b * h, s, d),
                                     k.reshape(b * hkv, s, d),
                                     v.reshape(b * hkv, s, d),
                                     causal=causal, scale=scale)
    return out.reshape(b, h, s, d)
