"""Out-of-core morsel execution: whole-query programs in bounded memory.

The ``compiled`` engine's whole-query function streams every bound
column of the spine table at once, and every temporary of the plan is
as long as the table.  This module bounds that working set morsel-style
(the Umbra/HyPer term): the scan streams through the plan's row-parallel
section in fixed-size row ranges ("morsels"), each morsel computes a
partial aggregate, and the partials merge under the recomposition rules
of the sharded engine's per-shard partials
(:func:`repro_torch.core.parallel._partial_of`: ``avg`` computed as a
sum and recomposed from the merged sum and count, ``min``/``max``/``any``
merged by their own extremum, the group mask recovered from the merged
count).

The rewrite is a plan-level wrap: :func:`plan_morsels` finds the deepest
spine aggregate whose prologue is row-parallel (Filter / Project /
Join probe / MapBatches, the sharded engine's ``_SPINE_SAFE``) and
replaces it with a :class:`MorselMerge` whose ``lower_stream`` runs the
partial aggregate once per morsel on views of the spine columns and
merges the results.  Everything composes:

* the native dispatch pass annotates the partial aggregate inside the
  loop, so a fragment's CUDA kernel launches once per morsel, on
  morsel-long views of the device columns;
* ``Compiled.batch`` vmaps the loop like any other part of the function
  (every merge is out of place);
* the morsel size is part of the plan fingerprint, so templates lowered
  for different budgets never share a compile-cache entry.

:func:`plan_morsels` picks the morsel size from a declared
``memory_budget`` (bytes): a morsel's working set is modelled as
``bound columns x 4 bytes x morsel rows x 2``, the largest
``ROW_ALIGN``-aligned morsel that fits wins, and a plan that fits whole
is left as it is.  The arithmetic is the JAX package's, so one budget
picks the same morsel in both packages.  A budget too small for one
aligned morsel, or a plan with no distributive aggregate to merge
behind, raises :class:`MemoryBudgetError` instead of running out of
budget.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import lower as L
from repro_torch.core import parallel as PAR
from repro_torch.core import plan as P

#: Morsel sizes are multiples of 128 rows: each morsel's bool mask then
#: starts on a 128-byte line and each 32-bit column on a 512-byte
#: boundary, so the kernels' 16-byte vector loads of a morsel view stay
#: aligned (``flare_mask_bits`` in ``kernels/csrc/join_probe.cuh`` takes
#: its ``uint4`` path only on a 16-byte-aligned mask).
ROW_ALIGN = 128

#: Device columns are 32-bit (``repro_torch.core.lower.TORCH_OF``).
BYTES_PER_VALUE = 4

#: The JAX package doubles the streamed bytes for the next morsel's
#: prefetch.  Here morsels run one after another with no prefetch, and
#: the factor covers the temporaries the morsel's body allocates beside
#: its column views (masks, computed values, the partial aggregate).
WORKSPACE_FACTOR = 2


class MemoryBudgetError(ValueError):
    """The declared ``memory_budget`` cannot be met: no morsel size fits,
    or the plan has no distributive aggregate to merge morsel partials
    behind."""


# ---------------------------------------------------------------------------
# the merge node
# ---------------------------------------------------------------------------


def _fill(op: str, t: torch.Tensor) -> torch.Tensor:
    """The neutral element of merge ``op`` in ``t``'s dtype and shape."""
    if op in ("sum", "count"):
        return torch.zeros_like(t)
    if op == "min":
        return torch.full_like(t, L.type_max(t.dtype))
    return torch.full_like(t, L.type_min(t.dtype))  # max / any


def _merge(op: str, acc: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    # out of place: torch.func.vmap batches a param-dependent partial
    # into an accumulator that starts unbatched
    if op in ("sum", "count"):
        return acc + part
    if op == "min":
        return torch.minimum(acc, part)
    return torch.maximum(acc, part)


@dataclasses.dataclass(eq=False)
class MorselMerge(P.Plan):
    """Merge point of the out-of-core section: ``child`` is the partial
    aggregate (annotated by the native dispatch pass where a pattern
    fires), and lowering runs it over the spine one morsel at a time,
    merging the per-morsel group vectors with the sharded engine's
    recomposition rules.  Implements the custom-lowering protocol of
    ``repro_torch.core.lower``, so ``build_callable`` runs the loop
    inside the same whole-query function as the surrounding operators.
    """

    child: P.Plan
    original: P.Aggregate             # pre-rewrite aggregate (schema truth)
    merges: Tuple[Tuple[str, str], ...]  # (partial column, agg op)
    avg_names: Tuple[str, ...]        # columns to recompose as sum/count
    count_name: Optional[str]         # merged count used for avg + mask
    synthetic: Optional[str]          # added count column to drop
    morsel_rows: int
    spine: Any = dataclasses.field(default=None, repr=False)  # Scan node

    def children(self) -> Tuple[P.Plan, ...]:
        return (self.child,)

    def with_children(self, kids):
        return dataclasses.replace(self, child=kids[0])

    def infer_schema(self, catalog):
        return self.original.schema(catalog)

    def describe(self):
        return (f"MorselMerge[m={self.morsel_rows}] "
                + ", ".join(f"{n}:{op}" for n, op in self.merges))

    def fingerprint(self):
        # the morsel size IS part of the template identity: functions
        # lowered for different budgets run different loops and must not
        # share a compile-cache entry
        return (f"morsel[{self.morsel_rows}]"
                f"({self.child.fingerprint()};"
                f"{self.original.fingerprint()})")

    # -- repro_torch.core.lower custom-lowering protocol ---------------------

    def static_info_hook(self, catalog) -> L.StaticInfo:
        return L.static_info(self.original, catalog)

    def required_columns_hook(self, rec, needed) -> None:
        rec(self.child, needed)

    def _run_morsel(self, catalog, scans, params, sstream: L.Stream,
                    start: int, rows: int) -> Dict[str, torch.Tensor]:
        """The partial aggregate over spine rows ``[start, start+rows)``:
        the spine's columns and mask enter as views, never copies."""
        end = start + rows
        mscans = dict(scans)
        mscans[id(self.spine)] = L.Stream(
            {k: v[start:end] for k, v in sstream.cols.items()},
            None if sstream.mask is None else sstream.mask[start:end],
            L.StaticInfo(sstream.info.cols, rows), sstream.device)
        return dict(L.lower_node(self.child, catalog, mscans, params).cols)

    def lower_stream(self, catalog, scans, params) -> L.Stream:
        # the fault site ``morsel.loop`` fires where the template compiles
        # (repro_torch.core.stages), not here: this runs on every call
        sstream = scans.get(id(self.spine))
        if sstream is None:
            raise KeyError(f"morsel spine scan {self.spine.table!r} not "
                           "bound")
        m, n = self.morsel_rows, sstream.n
        keys = self.original.keys
        acc: Optional[Dict[str, torch.Tensor]] = None
        part: Dict[str, torch.Tensor] = {}
        # no padding copy: the last morsel is just shorter
        for start in range(0, n, m):
            part = self._run_morsel(catalog, scans, params, sstream, start,
                                    min(m, n - start))
            if acc is None:  # dtypes and shapes from the first morsel
                acc = {name: _fill(op, part[name])
                       for name, op in self.merges}
            acc = {name: _merge(op, acc[name], part[name])
                   for name, op in self.merges}
        if acc is None:
            # an empty spine: one zero-length morsel gives the partials'
            # dtypes and shapes, and the result is the neutral elements
            part = self._run_morsel(catalog, scans, params, sstream, 0, 0)
            acc = {name: _fill(op, part[name]) for name, op in self.merges}
        cnt = acc[self.count_name] if self.count_name else None
        # group keys decode the group index: the same in every morsel
        out = {k: part[k] for k in keys}
        for name, _ in self.merges:
            if name == self.synthetic:
                continue
            v = acc[name]
            if name in self.avg_names:
                v = v / torch.clamp(cnt, min=1).to(v.dtype)
            out[name] = v
        mask = (cnt > 0) if keys and cnt is not None else None
        return L.Stream(out, mask, L.static_info(self.original, catalog),
                        sstream.device)


def find_morsel_node(p: P.Plan) -> Optional[MorselMerge]:
    """The (single) MorselMerge of a morsel-planned plan, or None."""
    if isinstance(p, MorselMerge):
        return p
    for c in p.children():
        found = find_morsel_node(c)
        if found is not None:
            return found
    return None


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def working_set_bytes(n_cols: int, rows: int) -> int:
    """Modelled working set of streaming ``n_cols`` bound spine columns
    over ``rows`` rows: 32-bit values, times ``WORKSPACE_FACTOR``."""
    return n_cols * BYTES_PER_VALUE * rows * WORKSPACE_FACTOR


def choose_morsel_rows(n_cols: int, spine_rows: int, memory_budget: int
                       ) -> int:
    """Largest ``ROW_ALIGN``-aligned morsel whose working set fits the
    budget (capped at the aligned spine length: bigger buys nothing)."""
    per_row = n_cols * BYTES_PER_VALUE * WORKSPACE_FACTOR
    m = (memory_budget // per_row) // ROW_ALIGN * ROW_ALIGN
    if m <= 0:
        raise MemoryBudgetError(
            f"memory budget {memory_budget} B cannot hold one "
            f"{ROW_ALIGN}-row morsel of {n_cols} bound column(s) "
            f"({per_row * ROW_ALIGN} B needed)")
    return min(m, -(-spine_rows // ROW_ALIGN) * ROW_ALIGN)


def morselize_aggregate(agg: P.Aggregate, spine: P.Scan,
                        catalog: P.Catalog, n_cols: int, spine_rows: int,
                        memory_budget: Optional[int],
                        morsel_rows: Optional[int]) -> P.Plan:
    """Wrap ``agg`` in a :class:`MorselMerge` sized for the budget, or
    return it unchanged when the whole working set already fits (and no
    explicit ``morsel_rows`` forces the loop)."""
    if morsel_rows is None:
        if working_set_bytes(n_cols, spine_rows) <= memory_budget:
            return agg
        morsel_rows = choose_morsel_rows(n_cols, spine_rows, memory_budget)
    if morsel_rows <= 0:
        raise MemoryBudgetError(f"morsel_rows={morsel_rows} must be >= 1")
    partial, merges, avg_names, count_name, synthetic = \
        PAR._partial_of(agg)
    return MorselMerge(child=partial, original=agg, merges=merges,
                       avg_names=avg_names, count_name=count_name,
                       synthetic=synthetic, morsel_rows=morsel_rows,
                       spine=spine)


def plan_morsels(p: P.Plan, catalog: P.Catalog,
                 memory_budget: Optional[int] = None,
                 morsel_rows: Optional[int] = None) -> P.Plan:
    """Rewrite an optimized plan for bounded-memory execution.

    No-op when neither knob is given, or when ``memory_budget`` holds the
    whole-table working set.  Otherwise the deepest spine aggregate
    becomes a :class:`MorselMerge` over its partial form; raises
    :class:`MemoryBudgetError` when the plan has no such aggregate to
    merge behind (a plan that does not aggregate returns its whole
    output: there is nothing to recompose).
    """
    if memory_budget is None and morsel_rows is None:
        return p
    if isinstance(p, P.IterativeKernel):
        raise MemoryBudgetError(
            "morsel execution does not support IterativeKernel roots: "
            "the training kernel consumes the whole gathered matrix; "
            "lower the relational half separately or raise the budget")
    try:
        path, spine = PAR._spine_path(p)
    except PAR.UnsupportedParallelPlan as ex:
        raise MemoryBudgetError(str(ex)) from ex
    spine_rows = catalog.table(spine.table).num_rows
    n_cols = len(L.required_scan_columns(p, catalog).get(id(spine), ())) or 1

    barrier_i = None
    for i, node in enumerate(path):
        if not isinstance(node, PAR._SPINE_SAFE):
            barrier_i = i  # keep the last hit: the DEEPEST barrier

    if barrier_i is None or not isinstance(path[barrier_i], P.Aggregate):
        if (morsel_rows is None
                and working_set_bytes(n_cols, spine_rows) <= memory_budget):
            return p  # fits whole: nothing to stream
        found = (path[barrier_i].describe() if barrier_i is not None
                 else "a plain row pipeline")
        raise MemoryBudgetError(
            f"memory budget needs a distributive aggregate on the spine "
            f"to merge morsel partials behind; deepest barrier is "
            f"{found}")

    agg = path[barrier_i]
    node = morselize_aggregate(agg, spine, catalog, n_cols, spine_rows,
                               memory_budget, morsel_rows)
    if node is agg:
        return p
    return PAR._rebuild(path, barrier_i, node)
