"""``segmented_sum``: single-value group sums ``out[g]``.

Replaces the Pallas kernel ``segmented_sum`` of
``src/repro/kernels/segmented_reduce/kernel.py`` (reached through its
``ops.py`` wrapper), a one-hot matmul on the TPU's matrix unit.  On the
H100 it is a histogram in shared memory (``csrc/segmented_sum.cuh``, a
fixed unit over ``csrc/flare_grouped.cuh`` with one output row): one
accumulator copy per thread when the copies fit
:data:`repro_torch.kernels.SMEM_BUDGET_BYTES` (G <= 48), else lane
copies with shared atomics (G 512: 16 copies of 2 KB, lanes l and l + 16
sharing one, so at most two lanes of a warp share a bank).  Bound on the
H100: 8 bytes per row (f32 value, int32 code) over 3.35 TB/s.

The routing is the reference's own: a group domain above
:data:`MAX_GROUPS` takes the scatter path (the plain version, on the
tensor's device), as ``ops.py`` of the JAX package sends it to
``jax.ops.segment_sum``.  Codes outside ``[0, G)`` contribute nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import check_columns, f32_literal, on_card
from repro_torch.kernels import cuda_build as CB
from repro_torch.kernels.segmented_reduce.kernel import (MAX_GROUPS,
                                                         group_reduce_plain,
                                                         replicas)

#: Kernel launches by :func:`segmented_sum` (not by the plain version or
#: the scatter path).
launches = 0

#: The unit's prologue: one output row, a sum with fill 0.
PROLOGUE = ("#define FLARE_N_OUT 1\n"
            "__constant__ int flare_op_max[FLARE_N_OUT] = {0};\n"
            f"__constant__ float flare_fill[FLARE_N_OUT] = "
            f"{{{f32_literal(0.0)}}};\n")

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def unit_source() -> str:
    """The fixed kernel unit (no generated body)."""
    return CB.unit_source(PROLOGUE, "", "segmented_sum.cuh")


def segmented_sum_plain(values: torch.Tensor, codes: torch.Tensor,
                        num_groups: int) -> torch.Tensor:
    """The same function in plain PyTorch: ``[G]`` f32 group sums."""
    v, c = values.to(torch.float32), codes.to(torch.int32)
    ok = torch.ones(v.shape, dtype=torch.bool, device=v.device)
    return group_reduce_plain([v], ok, c, num_groups, ("sum",), (0.0,))[0]


def segmented_sum(values: torch.Tensor, codes: torch.Tensor,
                  num_groups: int) -> torch.Tensor:
    """Group sums of 1-D ``values`` by 1-D int ``codes`` in ``[0, G)``:
    returns ``[G]`` f32.  On CPU tensors, and for ``G > MAX_GROUPS``,
    this is the plain version."""
    if num_groups < 1:
        raise ValueError(f"segmented_sum: {num_groups} groups")
    if not on_card(values) or num_groups > MAX_GROUPS:
        return segmented_sum_plain(values, codes, num_groups)
    global launches
    v, c = values.to(torch.float32), codes.to(torch.int32)
    n = v.shape[0] if v.dim() == 1 else -1
    check_columns("segmented_sum", [v, c], [torch.float32, torch.int32], n,
                  values.device)
    CB.check_device(values)
    fn = CB.entry(unit_source(), "flare_segmented_sum", _ARGS)
    blocks = CB.n_blocks(values, n)
    dev = values.device
    partials = torch.empty(blocks * num_groups, dtype=torch.float32,
                           device=dev)
    out = torch.empty(num_groups, dtype=torch.float32, device=dev)
    err = fn(CB.ptr(v), CB.ptr(c), n, num_groups, replicas(1, num_groups),
             CB.ptr(partials), CB.ptr(out), blocks, CB.stream(values))
    launches += 1
    CB.raise_on(err, "segmented_sum")
    return out
