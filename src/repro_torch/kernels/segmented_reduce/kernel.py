"""``segmented_multi_sum``: grouped multi-aggregate ``out[j, g]``.

Replaces the Pallas kernel ``segmented_multi_sum`` of
``src/repro/kernels/segmented_reduce/kernel.py``, which turns the scatter
into a one-hot matmul on the TPU's matrix unit.  On the H100 the scatter
stays a scatter, into shared memory: each block holds copies of the
``[n_out, G]`` accumulator (initialised to 0, or ``fills[j]`` for "max"
slots) -- one per thread, updated without atomics, when they fit, else
up to 32 lane copies (lane ``l`` updates copy ``l % reps``: at 32 copies
the lanes of a warp hit distinct banks), with shared atomics -- and
flushes a per-block partial that a second pass folds over blocks
(``csrc/segmented_reduce.cuh``).

Bound on the H100: the streamed column bytes plus the int32 codes over
3.35 TB/s; the design keeps every atomic in shared memory, so device
memory sees only the stream and ``n_blocks * n_out * G`` partials.  The
accumulator must fit :data:`repro_torch.kernels.SMEM_BUDGET_BYTES`.
Codes outside ``[0, G)`` contribute nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import (SMEM_BUDGET_BYTES, Body, KernelBudgetError,
                                 check_columns, check_mask, on_card,
                                 prologue)
from repro_torch.kernels import cuda_build as CB

#: Kernel launches by :func:`segmented_multi_sum`.
launches = 0

#: Largest group domain the grouped-agg pattern sends here.  The card's
#: own limit is the shared-memory budget below; this cap keeps the
#: dispatch decisions those of the JAX package, whose one-hot tile sets
#: it (TPC-H q13's per-customer count stays on the generic lowering).
MAX_GROUPS = 512

#: Threads per block (``FLARE_THREADS`` in csrc/).
THREADS = 256

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def fits_shared(n_out: int, num_groups: int) -> bool:
    return n_out * num_groups * 4 <= SMEM_BUDGET_BYTES


def replicas(n_out: int, num_groups: int,
             budget: int = SMEM_BUDGET_BYTES) -> int:
    """Accumulator copies per block: one per thread (no atomics) when
    that many fit ``budget`` bytes, else the most lane copies that fit --
    a power of two up to 32, lane ``l`` of every warp updating copy
    ``l % reps`` with shared atomics (csrc/flare_grouped.cuh) -- and at
    least one."""
    per_copy = n_out * num_groups * 4
    if THREADS * per_copy <= budget:
        return THREADS
    reps = 32
    while reps > 1 and reps * per_copy > budget:
        reps //= 2
    return reps


@functools.lru_cache(maxsize=256)
def _unit(body: Body) -> str:
    return unit_source(body)


def unit_source(body: Body) -> str:
    return CB.unit_source(prologue(body), body.src, "segmented_reduce.cuh")


def group_reduce_plain(vals: Sequence[torch.Tensor], pred: torch.Tensor,
                       codes: torch.Tensor, num_groups: int,
                       ops: Sequence[str], fills: Sequence[float]
                       ) -> torch.Tensor:
    """``out[j, g]``: sum (or max) of ``vals[j]`` over the rows with
    ``pred`` and code ``g``; codes outside ``[0, G)`` are dropped."""
    ok = pred & (codes >= 0) & (codes < num_groups)
    idx = torch.where(ok, codes, torch.zeros_like(codes)).long()
    rows = []
    for v, op, fill in zip(vals, ops, fills):
        if op == "sum":
            # f64: a CUDA index_add_ adds row by row, and an f32 sum of
            # millions of rows in one group would stop growing
            acc = torch.zeros(num_groups, dtype=torch.float64,
                              device=v.device)
            acc.index_add_(0, idx, torch.where(ok, v, 0.0).double())
            acc = acc.to(torch.float32)
        else:
            acc = torch.full((num_groups,), fill, dtype=torch.float32,
                             device=v.device)
            acc.scatter_reduce_(0, idx, torch.where(ok, v, fill), "amax")
        rows.append(acc)
    return torch.stack(rows)


def segmented_multi_sum_plain(body: Body, cols: Sequence[torch.Tensor],
                              valid: Optional[torch.Tensor],
                              codes: torch.Tensor, n: int,
                              num_groups: int,
                              scal: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch."""
    ok = valid if valid is not None else torch.ones(
        n, dtype=torch.bool, device=scal.device)
    pred, vals = body.rows([c.float() for c in cols], ok, scal)
    return group_reduce_plain(vals, pred, codes, num_groups, body.ops,
                              body.fills)


def segmented_multi_sum(body: Body, cols: Sequence[torch.Tensor],
                        valid: Optional[torch.Tensor], codes: torch.Tensor,
                        n: int, num_groups: int,
                        scal: torch.Tensor) -> torch.Tensor:
    """Grouped multi-aggregate over ``n`` rows: returns ``[n_out, G]`` f32.

    ``codes`` is the int32 group code of each row; the other arguments
    are those of :func:`repro_torch.kernels.filter_agg.kernel.
    filter_agg_general`.  On CPU tensors this is the plain version.
    """
    if not on_card(scal):
        return segmented_multi_sum_plain(body, cols, valid, codes, n,
                                         num_groups, scal)
    global launches
    if not fits_shared(body.n_out, num_groups):
        raise KernelBudgetError(
            f"segmented_multi_sum: a [{body.n_out}, {num_groups}] f32 "
            f"accumulator exceeds {SMEM_BUDGET_BYTES} bytes of shared memory")
    dev = scal.device
    check_columns("segmented_multi_sum", cols, body.col_dtypes, n, dev)
    check_columns("segmented_multi_sum codes", [codes], [torch.int32], n,
                  dev)
    check_mask("segmented_multi_sum", valid, n, dev)
    CB.check_device(scal)
    fn = CB.entry(_unit(body), "flare_segmented", _ARGS)
    blocks = CB.n_blocks(scal, n)
    partials = torch.empty(blocks * body.n_out * num_groups,
                           dtype=torch.float32, device=dev)
    out = torch.empty(body.n_out, num_groups, dtype=torch.float32,
                      device=dev)
    err = fn(CB.ptr_array(cols), len(cols), CB.ptr(valid), CB.ptr(codes),
             n, num_groups, replicas(body.n_out, num_groups), CB.ptr(scal),
             CB.ptr(partials), CB.ptr(out), blocks, CB.stream(scal))
    launches += 1
    CB.raise_on(err, "segmented_multi_sum")
    return out
