"""``filter_agg_general``: fused filter + ``n_out`` masked sums.

Replaces the Pallas kernel ``filter_agg_general`` of
``src/repro/kernels/filter_agg/kernel.py``.  The CUDA skeleton is
``csrc/filter_agg.cuh``: a grid-stride loop with one register accumulator
per output slot, a warp-shuffle block reduction into per-block partials,
and a second pass that folds the partials in block order (deterministic).
The per-row predicate and values are the fragment's generated body.

Bound on the H100: the bytes of the streamed columns (each read once)
over 3.35 TB/s.  Columns stream in their own dtype (int32, f32 or bool)
and convert in registers, so no cast pass precedes the kernel; rows
beyond ``n`` are never touched, where the TPU layout padded to
``[rows, 128]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import (MAX_OUT, Body, KernelBudgetError,
                                 check_columns, check_mask, on_card,
                                 prologue)
from repro_torch.kernels import cuda_build as CB

#: Kernel launches by :func:`filter_agg_general` (not by the plain version).
launches = 0

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p]


@functools.lru_cache(maxsize=256)
def _unit(body: Body) -> str:
    return unit_source(body)


def unit_source(body: Body) -> str:
    return CB.unit_source(prologue(body), body.src, "filter_agg.cuh")


def filter_agg_general_plain(body: Body, cols: Sequence[torch.Tensor],
                             valid: Optional[torch.Tensor], n: int,
                             scal: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: ``[n_out]`` f32 sums of the
    body's values (rows it excludes carry 0)."""
    dev = scal.device
    ok = valid if valid is not None else torch.ones(n, dtype=torch.bool,
                                                    device=dev)
    _, vals = body.rows([c.float() for c in cols], ok, scal)
    return torch.stack([v.sum() for v in vals]).to(torch.float32)


def filter_agg_general(body: Body, cols: Sequence[torch.Tensor],
                       valid: Optional[torch.Tensor], n: int,
                       scal: torch.Tensor) -> torch.Tensor:
    """Fused filter + ``n_out`` sums over ``n`` rows.

    ``cols`` are 1-D contiguous columns in ``body.col_dtypes``,
    ``valid`` the stream's bool mask (None: every row valid), ``scal``
    the f32 vector of query parameters in the body's order.  Returns
    ``[n_out]`` f32.  On CPU tensors this is the plain version.
    """
    if not on_card(scal):
        return filter_agg_general_plain(body, cols, valid, n, scal)
    global launches
    if body.n_out > MAX_OUT or any(op != "sum" for op in body.ops):
        raise KernelBudgetError(f"filter_agg_general: {body.ops} slots; "
                                f"at most {MAX_OUT} sums")
    dev = scal.device
    check_columns("filter_agg_general", cols, body.col_dtypes, n, dev)
    check_mask("filter_agg_general", valid, n, dev)
    CB.check_device(scal)
    fn = CB.entry(_unit(body), "flare_filter_agg", _ARGS)
    blocks = CB.n_blocks(scal, n)
    partials = torch.empty(blocks * body.n_out, dtype=torch.float32,
                           device=dev)
    out = torch.empty(body.n_out, dtype=torch.float32, device=dev)
    err = fn(CB.ptr_array(cols), len(cols), CB.ptr(valid), n,
             CB.ptr(scal), CB.ptr(partials), CB.ptr(out), blocks,
             CB.stream(scal))
    launches += 1
    CB.raise_on(err, "filter_agg_general")
    return out
