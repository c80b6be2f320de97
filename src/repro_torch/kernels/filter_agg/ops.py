"""``filter_agg_q6``: TPC-H Q6 revenue with the query constants baked in.

Replaces the Pallas kernel ``filter_agg_q6`` of
``src/repro/kernels/filter_agg/kernel.py`` (reached through its
``ops.py`` wrapper): the paper's hand-written C loop of Fig. 3, the
row the whole-query engines are measured against.  The CUDA source is
``csrc/filter_agg_q6.cuh``; the constants go into each unit's prologue,
so one set of constants is one unit, built once (cached by content).

The f32 thresholds are written as exact hex literals of their float32
rounding: the JAX package compares its f32 columns with Python floats
under weak typing, i.e. with ``float32(0.07)``, not the double 0.07, and
a row whose discount is exactly ``float32(0.07)`` must fall on the same
side of the predicate here.  The plain version compares against the
same float32 values.

Bound on the H100: 16 bytes per row (each column read once) over
3.35 TB/s.  The TPU's ``[rows, 128]`` lane layout and its padding are
not carried over: the kernel takes 1-D columns of any length.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import (KernelBudgetError, check_columns,
                                 f32_literal, on_card)
from repro_torch.kernels import cuda_build as CB

#: Kernel launches by :func:`filter_agg_q6` (not by the plain version).
launches = 0

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p]
_DTYPES = (torch.float32, torch.float32, torch.float32, torch.int32)


def _constants(date_lo, date_hi, disc_lo, disc_hi, qty_hi):
    """The query constants as the kernel compares them: int32 dates and
    the float32 roundings of the thresholds (as Python floats)."""
    dates = (int(date_lo), int(date_hi))
    for d in dates:
        if not -2 ** 31 <= d < 2 ** 31:
            raise KernelBudgetError(f"filter_agg_q6: date {d} is not int32")
    return dates + tuple(float(np.float32(x))
                         for x in (disc_lo, disc_hi, qty_hi))


@functools.lru_cache(maxsize=64)
def unit_source(date_lo: int, date_hi: int, disc_lo: float, disc_hi: float,
                qty_hi: float) -> str:
    """The kernel unit of one set of Q6 constants."""
    d_lo, d_hi, c_lo, c_hi, q_hi = _constants(date_lo, date_hi, disc_lo,
                                              disc_hi, qty_hi)
    prologue = (f"#define FLARE_Q6_DATE_LO {d_lo}\n"
                f"#define FLARE_Q6_DATE_HI {d_hi}\n"
                f"#define FLARE_Q6_DISC_LO {f32_literal(c_lo)}\n"
                f"#define FLARE_Q6_DISC_HI {f32_literal(c_hi)}\n"
                f"#define FLARE_Q6_QTY_HI {f32_literal(q_hi)}\n")
    return "\n".join([CB.header("flare_common.cuh"), prologue,
                      CB.header("filter_agg_q6.cuh")])


def filter_agg_q6_plain(quantity: torch.Tensor, price: torch.Tensor,
                        discount: torch.Tensor, shipdate: torch.Tensor, *,
                        date_lo: int, date_hi: int, disc_lo: float,
                        disc_hi: float, qty_hi: float) -> torch.Tensor:
    """The same function in plain PyTorch (a 0-d f32 tensor)."""
    d_lo, d_hi, c_lo, c_hi, q_hi = _constants(date_lo, date_hi, disc_lo,
                                              disc_hi, qty_hi)
    qty, price, disc, date = _cast(quantity, price, discount, shipdate)
    pred = ((date >= d_lo) & (date < d_hi) & (disc >= c_lo)
            & (disc <= c_hi) & (qty < q_hi))
    return torch.where(pred, price * disc, 0.0).sum(dtype=torch.float32)


def _cast(quantity, price, discount, shipdate):
    # no-ops for the device cache's columns (f32 values, int32 dates)
    return (quantity.to(torch.float32), price.to(torch.float32),
            discount.to(torch.float32), shipdate.to(torch.int32))


def filter_agg_q6(quantity: torch.Tensor, price: torch.Tensor,
                  discount: torch.Tensor, shipdate: torch.Tensor, *,
                  date_lo: int, date_hi: int, disc_lo: float, disc_hi: float,
                  qty_hi: float) -> torch.Tensor:
    """Q6 revenue over 1-D columns of any length: the sum of
    ``price * discount`` over the rows with ``date_lo <= shipdate <
    date_hi``, ``disc_lo <= discount <= disc_hi`` and ``quantity <
    qty_hi``.  Returns a 0-d f32 tensor.  On CPU tensors this is the
    plain version."""
    kw = dict(date_lo=date_lo, date_hi=date_hi, disc_lo=disc_lo,
              disc_hi=disc_hi, qty_hi=qty_hi)
    if not on_card(quantity):
        return filter_agg_q6_plain(quantity, price, discount, shipdate, **kw)
    global launches
    cols = _cast(quantity, price, discount, shipdate)
    n = cols[0].shape[0] if cols[0].dim() == 1 else -1
    check_columns("filter_agg_q6", cols, _DTYPES, n, quantity.device)
    CB.check_device(quantity)
    fn = CB.entry(unit_source(*_constants(**kw)), "flare_q6", _ARGS)
    blocks = CB.n_blocks(quantity, n)
    dev = quantity.device
    partials = torch.empty(blocks, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    err = fn(*[CB.ptr(c) for c in cols], n, CB.ptr(partials), CB.ptr(out),
             blocks, CB.stream(quantity))
    launches += 1
    CB.raise_on(err, "filter_agg_q6")
    return out
