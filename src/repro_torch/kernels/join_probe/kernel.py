"""``join_probe_agg``: fused N:1 join probe + gather + filter + aggregate.

Replaces the Pallas kernel ``join_probe_agg`` of
``src/repro/kernels/join_probe/kernel.py``.  Per probe row the CUDA
skeleton (``csrc/join_probe.cuh``) builds the combined key with the
generated ``flare_probe_key``, binary-searches the cached index's sorted
int32 keys (lower bound, clipped to the last key, as ``probe_sorted``
does), tests the hit and the build-side mask, and hands the base-table
row ``perm[pos]`` to the generated ``flare_row``, which reads the build
payload there and computes predicate, values and group code.

Accumulation (:func:`accum_mode`): keyless sums as in ``filter_agg``;
grouped in shared memory as in ``segmented_reduce`` when the accumulator
fits :data:`repro_torch.kernels.SMEM_BUDGET_BYTES`; otherwise global
atomics into an ``[n_out, G]`` tensor that this wrapper allocates (TPC-H
q3 groups by l_orderkey: 15 M groups at SF 10), bounded by
:data:`SCATTER_BUDGET_BYTES`.  Global atomics add in an order that
changes from run to run.

Bound on the H100: the probe column bytes over 3.35 TB/s.  The build
side is read in place through the permutation, not gathered into sorted
order per query; its binary search is ``log2(nb)`` dependent loads per
row, served from L2 for the small TPC-H build tables.  The TPU kernel's
paged build slabs exist for its VMEM and are not mirrored.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import (MAX_OUT, SMEM_BUDGET_BYTES, Body,
                                 KernelBudgetError, check_columns,
                                 check_mask, on_card, prologue)
from repro_torch.kernels import cuda_build as CB
from repro_torch.kernels.segmented_reduce.kernel import (group_reduce_plain,
                                                         replicas)

#: Kernel launches by :func:`join_probe_agg`.
launches = 0

#: Device memory the global-atomic accumulator may take: 1 GiB, one
#: eightieth of the H100's 80 GB (q3 at SF 10 needs 4 x 15 M x 4 B).
SCATTER_BUDGET_BYTES = 1 << 30

_MODES = {"keyless": 0, "shared": 1, "global": 2}

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def accum_mode(n_out: int, num_groups: Optional[int]) -> str:
    """"keyless", "shared" or "global" for this accumulator; raises
    :class:`KernelBudgetError` when even device memory is over budget."""
    if num_groups is None:
        return "keyless"
    nbytes = n_out * num_groups * 4
    if nbytes <= SMEM_BUDGET_BYTES:
        return "shared"
    if nbytes <= SCATTER_BUDGET_BYTES:
        return "global"
    raise KernelBudgetError(
        f"join_probe_agg: a [{n_out}, {num_groups}] f32 accumulator "
        f"exceeds {SCATTER_BUDGET_BYTES} bytes of device memory")


@functools.lru_cache(maxsize=256)
def _unit(body: Body, num_groups: Optional[int]) -> str:
    return unit_source(body, num_groups)


def unit_source(body: Body, num_groups: Optional[int]) -> str:
    mode = _MODES[accum_mode(body.n_out, num_groups)]
    return CB.unit_source(prologue(body, f"#define FLARE_ACCUM {mode}\n"),
                          body.src, "join_probe.cuh")


def join_probe_agg_plain(body: Body, probe_cols: Sequence[torch.Tensor],
                         probe_valid: Optional[torch.Tensor], n: int,
                         keys: torch.Tensor, perm: torch.Tensor,
                         build_mask: Optional[torch.Tensor],
                         build_cols: Sequence[torch.Tensor],
                         scal: torch.Tensor,
                         num_groups: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch."""
    dev = scal.device
    pcols = [c.float() for c in probe_cols]
    ok = probe_valid if probe_valid is not None else torch.ones(
        n, dtype=torch.bool, device=dev)
    kb = keys.float()
    kp = body.probe_key(pcols)
    pos = torch.searchsorted(kb, kp).clamp_(max=kb.shape[0] - 1)
    matched = (kb[pos] == kp) & ok
    row = perm[pos].long()
    if build_mask is not None:
        matched = matched & build_mask[row]
    bvals = [b[row].float() for b in build_cols]
    pred, vals, codes = body.rows(pcols, bvals, matched, scal)
    if num_groups is None:
        return torch.stack([v.sum() for v in vals]).to(torch.float32)
    return group_reduce_plain(vals, pred, codes, num_groups, body.ops,
                              body.fills)


def join_probe_agg(body: Body, probe_cols: Sequence[torch.Tensor],
                   probe_valid: Optional[torch.Tensor], n: int,
                   keys: torch.Tensor, perm: torch.Tensor,
                   build_mask: Optional[torch.Tensor],
                   build_cols: Sequence[torch.Tensor], scal: torch.Tensor,
                   num_groups: Optional[int] = None) -> torch.Tensor:
    """Probe ``n`` rows into the cached index (``keys`` sorted int32,
    ``perm`` int32 base-table rows) and aggregate.

    ``build_mask`` is the build side's bool filter mask over base-table
    rows (None: unfiltered), ``build_cols`` its payload columns in
    ``body.build_dtypes``.  Returns ``[n_out]`` f32 sums (keyless) or the
    ``[n_out, G]`` group accumulator.  On CPU tensors this is the plain
    version.
    """
    if not on_card(scal):
        return join_probe_agg_plain(body, probe_cols, probe_valid, n, keys,
                                    perm, build_mask, build_cols, scal,
                                    num_groups)
    global launches
    mode = accum_mode(body.n_out, num_groups)
    if mode == "keyless" and (body.n_out > MAX_OUT
                              or any(op != "sum" for op in body.ops)):
        raise KernelBudgetError(f"join_probe_agg: keyless slots {body.ops}")
    dev = scal.device
    nb = keys.shape[0]
    if nb == 0:
        raise KernelBudgetError("join_probe_agg: empty build side")
    check_columns("join_probe_agg probe", probe_cols, body.col_dtypes, n, dev)
    check_columns("join_probe_agg build", build_cols, body.build_dtypes, nb,
                  dev)
    check_columns("join_probe_agg index", [keys, perm],
                  [torch.int32, torch.int32], nb, dev)
    check_mask("join_probe_agg probe", probe_valid, n, dev)
    check_mask("join_probe_agg build", build_mask, nb, dev)
    CB.check_device(scal)
    fn = CB.entry(_unit(body, num_groups), "flare_join_probe",
                 _ARGS)
    blocks = CB.n_blocks(scal, n)
    groups = 1 if num_groups is None else num_groups
    reps = replicas(body.n_out, groups) if mode == "shared" else 1
    if mode == "keyless":
        partials = torch.empty(blocks * body.n_out, dtype=torch.float32,
                               device=dev)
        out = torch.empty(body.n_out, dtype=torch.float32, device=dev)
    elif mode == "shared":
        partials = torch.empty(blocks * body.n_out * groups,
                               dtype=torch.float32, device=dev)
        out = torch.empty(body.n_out, groups, dtype=torch.float32,
                          device=dev)
    else:
        partials = None
        out = torch.tensor(body.fills, dtype=torch.float32,
                           device=dev)[:, None].repeat(1, groups)
    err = fn(CB.ptr_array(probe_cols), len(probe_cols),
             CB.ptr_array(build_cols), len(build_cols), CB.ptr(probe_valid),
             n, CB.ptr(keys), CB.ptr(perm), CB.ptr(build_mask), nb, groups,
             reps, CB.ptr(scal), CB.ptr(partials), CB.ptr(out), blocks,
             CB.stream(scal))
    launches += 1
    CB.raise_on(err, "join_probe_agg")
    return out
