"""``join_probe_agg``: fused N:1 join probe + gather + filter + aggregate.

Replaces the Pallas kernel ``join_probe_agg`` of
``src/repro/kernels/join_probe/kernel.py``.  The CUDA skeleton
(``csrc/join_probe.cuh``) works the probe stream in warp tiles of
:data:`TILE_ROWS` rows: it reads the probe mask 32 rows a lane at a time,
compacts the valid rows, and only for those builds the combined key with the
generated ``flare_probe_key``, finds its position in the cached index,
tests the hit and the build-side mask, and -- for matched rows only --
hands the base-table row to the generated ``flare_row``, which reads the
build payload there and computes predicate, values and group code.

The position has two routes in the one kernel, chosen on the device by
the index's ``meta`` (``[dense, base, identity]``, int32, built once by
``repro_torch.core.engines.IndexCache``; ``None`` means neither): on a
dense index (unique keys filling ``[base, base + nb)``, as every
single-column TPC-H primary key) it is computed, else a binary search over
the sorted keys finds the lower bound clipped to the last key, as
``probe_sorted`` does; on an identity index (keys stored sorted) the
base-table row is the position itself, else ``perm[pos]``.  The plain
version ignores ``meta`` and keeps ``torch.searchsorted``.

Accumulation (:func:`accum_mode`): keyless sums as in ``filter_agg``;
grouped in shared memory as in ``segmented_reduce`` when the accumulator
fits :data:`repro_torch.kernels.SMEM_BUDGET_BYTES`; otherwise global
atomics into an ``[n_out, G]`` tensor (TPC-H q3 groups by l_orderkey: 15
M groups at SF 10), bounded by :data:`SCATTER_BUDGET_BYTES`, where lanes
holding the same group code fold their slots before one atomic per run.
Global atomics add in an order that changes from run to run.  The
kernel's tile lists take :func:`list_bytes` of static shared memory, so
the shared accumulator's copies get the rest of the budget; a single
copy above that is launched with the dynamic limit raised.

Bound on the H100: bytes -- the probe mask, the probe-column sectors
that hold a valid row, the build rows that match.  The TPU kernel's
paged build slabs exist for its VMEM and are not mirrored.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import Optional, Sequence

import torch

from repro_torch.kernels import (MAX_OUT, SMEM_BUDGET_BYTES, Body,
                                 KernelBudgetError, check_columns,
                                 check_mask, on_card, prologue)
from repro_torch.kernels import cuda_build as CB
from repro_torch.kernels.segmented_reduce.kernel import (THREADS,
                                                         group_reduce_plain,
                                                         replicas)

#: Kernel launches by :func:`join_probe_agg`.
launches = 0

#: Device memory the global-atomic accumulator may take: 1 GiB, one
#: eightieth of the H100's 80 GB (q3 at SF 10 needs 4 x 15 M x 4 B).
SCATTER_BUDGET_BYTES = 1 << 30

#: Rows of a warp tile (``FLARE_PROBE_TILE`` in csrc/join_probe.cuh): 32
#: lanes times the ``FLARE_PROBE_ROWS`` rows of a lane's mask load, read
#: from the kernel's source.
TILE_ROWS = 32 * int(re.search(r"#define FLARE_PROBE_ROWS (\d+)",
                               CB.header("join_probe.cuh")).group(1))


def list_bytes() -> int:
    """Static shared memory of the kernel's tile lists: one list of
    :data:`TILE_ROWS` two-byte row offsets per warp."""
    return THREADS // 32 * TILE_ROWS * 2

_MODES = {"keyless": 0, "shared": 1, "global": 2}

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


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


_ATTR_ARGS = [ctypes.c_longlong, ctypes.c_void_p]


@functools.lru_cache(maxsize=256)
def _attrs(src: str, smem: int, device: int) -> tuple:
    """(registers, local bytes per thread, static shared bytes, blocks per
    SM) of a unit's kernel with ``smem`` dynamic shared bytes, from the
    runtime's attribute and occupancy queries."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        CB.raise_on(CB.entry(src, "flare_join_probe_attrs", _ATTR_ARGS)(
            smem, ctypes.cast(out, ctypes.c_void_p)),
            "join_probe_agg attributes")
    return tuple(out)


def _smem(body: Body, num_groups: Optional[int]) -> int:
    """Dynamic shared bytes of a launch: the shared accumulator's copies."""
    if accum_mode(body.n_out, num_groups) != "shared":
        return 0
    return shared_replicas(body.n_out, num_groups) * body.n_out \
        * num_groups * 4


def resources(body: Body, num_groups: Optional[int] = None) -> dict:
    """Registers and local (spill) bytes per thread, static and dynamic
    shared bytes per block, and resident blocks per SM of the fragment's
    kernel on the current device (the unit is built on first use)."""
    smem = _smem(body, num_groups)
    vals = _attrs(_unit(body, num_groups), smem,
                  torch.cuda.current_device())
    return dict(registers=vals[0], local_bytes=vals[1], static_smem=vals[2],
                dynamic_smem=smem, blocks_per_sm=vals[3])


def shared_replicas(n_out: int, num_groups: int) -> int:
    """Copies of a shared-memory accumulator: the tile lists take
    :func:`list_bytes` of the budget."""
    return replicas(n_out, num_groups, SMEM_BUDGET_BYTES - list_bytes())


@functools.lru_cache(maxsize=256)
def _unit(body: Body, num_groups: Optional[int]) -> str:
    return unit_source(body, num_groups)


def unit_source(body: Body, num_groups: Optional[int]) -> str:
    mode = _MODES[accum_mode(body.n_out, num_groups)]
    return CB.unit_source(
        prologue(body, f"#define FLARE_ACCUM {mode}\n"),
        body.src, "join_probe.cuh")


def join_probe_agg_plain(body: Body, probe_cols: Sequence[torch.Tensor],
                         probe_valid: Optional[torch.Tensor], n: int,
                         keys: torch.Tensor, perm: torch.Tensor,
                         build_mask: Optional[torch.Tensor],
                         build_cols: Sequence[torch.Tensor],
                         scal: torch.Tensor,
                         num_groups: Optional[int] = None,
                         meta: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The same function in plain PyTorch (by ``torch.searchsorted``
    whatever ``meta`` says)."""
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
                   num_groups: Optional[int] = None,
                   meta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Probe ``n`` rows into the cached index (``keys`` sorted int32,
    ``perm`` int32 base-table rows, ``meta`` int32 ``[dense, base,
    identity]`` or None) and aggregate.

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
    if meta is not None:
        check_columns("join_probe_agg index meta", [meta], [torch.int32], 3,
                      dev)
    check_mask("join_probe_agg probe", probe_valid, n, dev)
    check_mask("join_probe_agg build", build_mask, nb, dev)
    CB.check_device(scal)
    src = _unit(body, num_groups)
    fn = CB.entry(src, "flare_join_probe", _ARGS)
    # a persistent grid: as many blocks as stay resident, fewer when n
    # rows fill fewer tiles
    per_sm = _attrs(src, _smem(body, num_groups), scal.device.index or 0)[3]
    blocks = max(1, min(-(-n // (8 * TILE_ROWS)),
                        per_sm * CB.sm_count(scal)))
    groups = 1 if num_groups is None else num_groups
    reps = shared_replicas(body.n_out, groups) if mode == "shared" else 1
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
        partials = None   # the unit fills out with the slots' fills
        out = torch.empty(body.n_out, groups, dtype=torch.float32,
                          device=dev)
    err = fn(CB.ptr_array(probe_cols), len(probe_cols),
             CB.ptr_array(build_cols), len(build_cols), CB.ptr(probe_valid),
             n, CB.ptr(keys), CB.ptr(perm), CB.ptr(meta), CB.ptr(build_mask),
             nb, groups, reps, CB.ptr(scal), CB.ptr(partials), CB.ptr(out),
             blocks, CB.stream(scal))
    launches += 1
    CB.raise_on(err, "join_probe_agg")
    return out
