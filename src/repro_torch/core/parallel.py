"""The sharded ``parallel`` engine: whole-query execution split into
row-range shards of the spine, merged after the parallel section (paper
section 4.3).

Flare parallelises operators *internally*: a parallel scan fans work out
to threads, each computes a partial aggregate, and the partials merge
after the parallel section.  The JAX package maps that onto a device
mesh (``shard_map``: the spine table row-partitioned along a mesh axis,
build sides replicated, collectives merging the per-shard partials).
The port keeps the plan-level design and runs it on one torch device:

* the *spine* -- the path from the root down to the leftmost scan --
  holds operators in :data:`_SPINE_SAFE` that act row by row (Filter,
  Project, a Join probing a whole build side, MapBatches), so any row
  range of the spine computes exactly its slice of their output;
* a shard is a contiguous row range of the spine (:func:`shard_bounds`:
  ``ceil(rows / n)`` rounded up to ``morsel.ROW_ALIGN`` rows, so every
  shard's views start on a 128-row boundary and the kernels' vector
  loads stay aligned; the last shards may be shorter or empty).  The
  JAX package pads the spine to ``n * ceil(rows / n)`` rows instead;
  the rows per shard differ, the results do not;
* :class:`ShardMerge` runs the shard-local partial aggregate once per
  shard on views of the spine's columns (never copies) and folds the
  partials shard by shard (:data:`_MERGE_OPS`: sums and counts by sum,
  min by min, max and any by max), recomposing ``avg`` from the merged
  sum and count (:func:`_partial_of`);
* :class:`ShardGather` runs its child once per shard and concatenates
  the shards' columns and masks in shard order -- the original row
  order -- for operators that need the whole relation (sort, limit).

With ``native=True`` the dispatch pass annotates the partial aggregate
inside the shard node, so a fragment's CUDA kernel launches once per
shard, on shard-long views of the device columns.

Shard planning (:func:`shard_plan`) splits the optimized plan at the
deepest spine operator that cannot run shard-locally:

====================  =====================================================
spine shape            strategy
====================  =====================================================
... -> Aggregate       merge: the shard-local partial aggregate, merged
                       shard by shard; the operators above it (sort,
                       limit, project) run once on the merged result
... -> Sort/Limit      gather: the row-parallel prefix runs per shard, the
                       shards' streams are concatenated, the rest runs
                       once
plain chains           gather at the root
====================  =====================================================

The rewrite happens at ``lower()`` time, so the mesh axis, shard count
and device are part of the plan fingerprint: one template per mesh
shape, shared across ``param()`` bindings.

Surface::

    mesh     = make_data_mesh(4, device="cpu")     # repro_torch.launch.mesh
    lowered  = df.lower(engine="parallel", mesh=mesh, axis="data")
    compiled = lowered.compile()
    compiled(**bindings)

``mesh=None`` takes the context's device with the default shard count
(:func:`repro_torch.launch.mesh.make_data_mesh`).  The shards run one
after another on one device; nothing here uses ``torch.distributed``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import expr as E
from repro_torch.core import lower as L
from repro_torch.core import plan as PL
from repro_torch.core import stages as S
from repro_torch.native import registry as R


class UnsupportedParallelPlan(TypeError):
    """Plan shape the parallel engine cannot shard: no spine scan below
    the root, or an ``IterativeKernel`` root (asserted explicitly in the
    tests rather than skipped)."""


#: Spine operators that are row-parallel: they act per probe-side row
#: (Join probes against a whole build side), so a row range of the spine
#: computes exactly its slice of the full operator output.
_SPINE_SAFE = (PL.Filter, PL.Project, PL.Join, PL.MapBatches)

#: Merge per aggregate op, named after the JAX package's collectives;
#: ``morsel._merge(op, ...)`` folds two partials by it.  ``avg`` is never
#: merged directly: shard planning rewrites it to a sum partial and
#: recomposes it from the merged sum and count.
_MERGE_OPS = {"sum": "psum", "count": "psum", "min": "pmin",
              "max": "pmax", "any": "pmax"}

_SYNTH_COUNT = "__pcount"


def _mesh_device_ids(mesh: Any) -> Tuple[str, ...]:
    """Device identity of a mesh, for template fingerprints: the device
    of every shard.  Meshes of one shape on different devices must not
    share a compile-cache entry."""
    if mesh is None:
        return ()
    return tuple(str(d) for d in mesh.devices)


def shard_rows(rows: int, n_shards: int) -> int:
    """Rows of a full shard: ``ceil(rows / n_shards)`` rounded up to
    ``morsel.ROW_ALIGN``."""
    from repro_torch.core import morsel as MO
    per = -(-rows // n_shards)
    return -(-per // MO.ROW_ALIGN) * MO.ROW_ALIGN


def shard_bounds(rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """``[start, end)`` of each shard of a ``rows``-row spine, in shard
    order: contiguous, ``ROW_ALIGN``-aligned starts, the last shards
    shorter or empty."""
    step = shard_rows(rows, n_shards)
    return [(min(i * step, rows), min((i + 1) * step, rows))
            for i in range(n_shards)]


def range_scans(scans: Dict[Any, Any], spine: PL.Scan, sstream: L.Stream,
                start: int, end: int) -> Dict[Any, Any]:
    """``scans`` with the spine bound to rows ``[start, end)``: views of
    its columns and mask, never copies (a shard here, a morsel in
    :mod:`repro_torch.core.morsel`)."""
    out = dict(scans)
    out[id(spine)] = L.Stream(
        {k: v[start:end] for k, v in sstream.cols.items()},
        None if sstream.mask is None else sstream.mask[start:end],
        L.StaticInfo(sstream.info.cols, end - start), sstream.device)
    return out


def recompose(node, acc: Dict[str, torch.Tensor],
              part: Dict[str, torch.Tensor], catalog,
              device: torch.device) -> L.Stream:
    """The output of a merge node (``ShardMerge`` or ``morsel.
    MorselMerge``) from its merged partials ``acc``: ``avg`` from the
    merged sum and count, the synthetic count dropped, the group keys
    decoded from the group index (the same in every range, so taken from
    the last partial ``part``), the group mask ``count > 0``."""
    cnt = acc[node.count_name] if node.count_name else None
    keys = node.original.keys
    out = {k: part[k] for k in keys}
    for name, _ in node.merges:
        if name == node.synthetic:
            continue
        v = acc[name]
        if name in node.avg_names:
            v = v / torch.clamp(cnt, min=1).to(v.dtype)
        out[name] = v
    mask = (cnt > 0) if keys else None
    return L.Stream(out, mask, L.static_info(node.original, catalog),
                    device)


def _spine_stream(node, scans) -> L.Stream:
    sstream = scans.get(id(node.spine))
    if sstream is None:
        raise KeyError(f"shard spine scan {node.spine.table!r} not bound")
    return sstream


# ---------------------------------------------------------------------------
# shard-plan IR: the merge / gather nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class ShardMerge(PL.Plan):
    """Merge point of the parallel section: ``child`` is the shard-local
    partial aggregate (possibly annotated with a kernel, possibly a
    morsel loop); lowering runs it once per shard and folds the dense
    group vectors, then recomposes ``avg`` from the merged sum and count.
    Implements the custom-lowering protocol of ``repro_torch.core.lower``,
    so ``build_callable`` runs the shards inside the same whole-query
    function as the surrounding operators.
    """

    child: PL.Plan
    original: PL.Aggregate            # pre-rewrite aggregate (schema truth)
    merges: Tuple[Tuple[str, str], ...]  # (partial column, agg op)
    avg_names: Tuple[str, ...]        # columns to recompose as sum/count
    count_name: Optional[str]         # merged count used for avg + mask
    synthetic: Optional[str]          # added count column to drop
    axis: str
    n_shards: int
    shard_rows: int                   # rows of a full shard (aligned)
    true_rows: int                    # spine rows
    mesh: Any = dataclasses.field(default=None, repr=False)
    spine: Any = dataclasses.field(default=None, repr=False)  # Scan node

    def children(self) -> Tuple[PL.Plan, ...]:
        return (self.child,)

    def with_children(self, kids):
        return dataclasses.replace(self, child=kids[0])

    def infer_schema(self, catalog):
        return self.original.schema(catalog)

    def describe(self):
        return (f"ShardMerge[{self.axis}x{self.n_shards}] "
                + ", ".join(f"{n}:{op}" for n, op in self.merges))

    def fingerprint(self):
        # axis + shard count + device ARE the template identity, plus the
        # pre-rewrite aggregate, since two originals -- avg vs sum --
        # share one partial form
        return (f"shardmerge[{self.axis}:{self.n_shards}:"
                f"{_mesh_device_ids(self.mesh)}]"
                f"({self.child.fingerprint()};"
                f"{self.original.fingerprint()})")

    # -- repro_torch.core.lower custom-lowering protocol ---------------------

    def static_info_hook(self, catalog) -> L.StaticInfo:
        return L.static_info(self.original, catalog)

    def required_columns_hook(self, rec, needed) -> None:
        rec(self.child, needed)

    def lower_stream(self, catalog, scans, params) -> L.Stream:
        from repro_torch.core import morsel as MO
        sstream = _spine_stream(self, scans)
        acc: Optional[Dict[str, torch.Tensor]] = None
        part: Dict[str, torch.Tensor] = {}
        # fold shard by shard: at most the accumulator, one shard's
        # partial and their merge are alive at once (q3's partials are
        # [15 000 001] vectors); every merge is out of place.  The first
        # shard's partial seeds the accumulator: merging it into the
        # neutral fill (morsel._fill) gives it back unchanged.  An empty
        # shard's partial is the neutral element of each merge.
        for start, end in shard_bounds(sstream.n, self.n_shards):
            sscans = range_scans(scans, self.spine, sstream, start, end)
            part = dict(L.lower_node(self.child, catalog, sscans,
                                     params).cols)
            if acc is None:
                acc = {name: part[name] for name, _ in self.merges}
                continue
            acc = {name: MO._merge(op, acc[name], part[name])
                   for name, op in self.merges}
        return recompose(self, acc, part, catalog, sstream.device)


@dataclasses.dataclass(eq=False)
class ShardGather(PL.Plan):
    """Gather point: ``child`` runs once per shard (a row range of the
    spine), then the shards' columns and validity masks are concatenated
    in shard order, so downstream operators (sort/limit, non-distributive
    finishes) see the whole relation -- the paper's "gather and finish on
    the master" for sections that cannot merge."""

    child: PL.Plan
    axis: str
    n_shards: int
    shard_rows: int
    true_rows: int
    mesh: Any = dataclasses.field(default=None, repr=False)
    spine: Any = dataclasses.field(default=None, repr=False)

    def children(self) -> Tuple[PL.Plan, ...]:
        return (self.child,)

    def with_children(self, kids):
        return dataclasses.replace(self, child=kids[0])

    def infer_schema(self, catalog):
        return self.child.schema(catalog)

    def describe(self):
        return f"ShardGather[{self.axis}x{self.n_shards}]"

    def fingerprint(self):
        return (f"shardgather[{self.axis}:{self.n_shards}:"
                f"{_mesh_device_ids(self.mesh)}]"
                f"({self.child.fingerprint()})")

    # -- repro_torch.core.lower custom-lowering protocol ---------------------

    def static_info_hook(self, catalog) -> L.StaticInfo:
        # the child is row-parallel: its length is the spine's, which the
        # shards together cover exactly (no padding rows)
        return L.static_info(self.child, catalog)

    def required_columns_hook(self, rec, needed) -> None:
        rec(self.child, needed)

    def lower_stream(self, catalog, scans, params) -> L.Stream:
        sstream = _spine_stream(self, scans)
        outs = [L.lower_node(self.child, catalog,
                             range_scans(scans, self.spine, sstream, s, e),
                             params)
                for s, e in shard_bounds(sstream.n, self.n_shards)]
        info = L.StaticInfo(outs[0].info.cols, sum(o.n for o in outs))
        if len(outs) == 1:  # nothing to concatenate: no copy
            return L.Stream(dict(outs[0].cols), outs[0].mask, info,
                            sstream.device)
        # shard-major concatenation == the original row order
        cols = {k: torch.cat([L.as_column(o.cols[k], o) for o in outs])
                for k in outs[0].cols}
        mask = torch.cat([o.the_mask() for o in outs])
        return L.Stream(cols, mask, info, sstream.device)


def find_shard_node(p: PL.Plan) -> Optional[PL.Plan]:
    """The (single) ShardMerge/ShardGather of a shard-planned plan."""
    if isinstance(p, (ShardMerge, ShardGather)):
        return p
    for c in p.children():
        found = find_shard_node(c)
        if found is not None:
            return found
    return None


# ---------------------------------------------------------------------------
# per-shard dispatch telemetry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedDispatchReport(R.DispatchReport):
    """Dispatch report of a native parallel template.  Every shard runs
    the same annotated plan, so the decisions are the same for each;
    :attr:`per_shard` names them shard by shard."""

    n_shards: int = 1
    axis: str = "data"

    @property
    def per_shard(self) -> List[R.DispatchReport]:
        return [R.DispatchReport(decisions=list(self.decisions))
                for _ in range(self.n_shards)]

    def __str__(self) -> str:
        base = R.DispatchReport.__str__(self)
        return (f"{base}\n  (SPMD: x{self.n_shards} shards along "
                f"'{self.axis}')")


# ---------------------------------------------------------------------------
# shard planning
# ---------------------------------------------------------------------------


def _spine_path(p: PL.Plan) -> Tuple[List[PL.Plan], PL.Scan]:
    """Nodes from the root down to the spine (leftmost) scan."""
    path: List[PL.Plan] = []
    node = p
    while not isinstance(node, PL.Scan):
        path.append(node)
        if isinstance(node, PL.Join):
            node = node.left
        elif node.children():
            node = node.children()[0]
        else:
            raise UnsupportedParallelPlan(
                f"no spine scan below {node.describe()}")
    return path, node


def _rebuild(path: List[PL.Plan], idx: int, new_node: PL.Plan) -> PL.Plan:
    """Replace the spine node at ``path[idx]`` (or the spine scan when
    ``idx == len(path)``) and rebuild its ancestors."""
    cur = new_node
    for node in reversed(path[:idx]):
        kids = list(node.children())
        kids[0] = cur  # the spine is always the first child (child/left)
        cur = node.with_children(kids)
    return cur


def _partial_of(agg: PL.Aggregate) -> Tuple[PL.Aggregate, Tuple, Tuple,
                                            Optional[str], Optional[str]]:
    """The per-range partial form of ``agg`` and its merge recipe:
    ``(partial, merges, avg_names, count_name, synthetic)``.

    ``merges`` lists ``(partial column, op)``; ``avg`` partials are sums
    (``avg_names``), recomposed from the merged sum and ``count_name``
    after the merge; a grouped aggregate (or one with an ``avg``) without
    a count of its own gets the ``synthetic`` count column, dropped from
    the output.  Shared with the morsel loop
    (:mod:`repro_torch.core.morsel`), which merges per-morsel partials by
    the same rules.
    """
    count_name = next((a.name for a in agg.aggs if a.op == "count"), None)
    need_count = bool(agg.keys) or any(a.op == "avg" for a in agg.aggs)
    synthetic = None
    if need_count and count_name is None:
        synthetic = count_name = _SYNTH_COUNT
    partials: List[PL.AggSpec] = []
    merges: List[Tuple[str, str]] = []
    avg_names: List[str] = []
    for a in agg.aggs:
        if a.op == "avg":
            partials.append(PL.AggSpec(a.name, "sum", a.arg))
            merges.append((a.name, "sum"))
            avg_names.append(a.name)
        else:
            partials.append(a)
            merges.append((a.name, a.op))
    if synthetic is not None:
        partials.append(PL.AggSpec(synthetic, "count", None))
        merges.append((synthetic, "count"))
    partial = PL.Aggregate(agg.child, agg.keys, tuple(partials))
    return (partial, tuple(merges), tuple(avg_names), count_name, synthetic)


def shard_plan(p: PL.Plan, catalog: PL.Catalog, mesh: Any = None,
               axis: str = "data", native: bool = False,
               join_index: bool = True,
               memory_budget: Optional[int] = None,
               morsel_rows: Optional[int] = None
               ) -> Tuple[PL.Plan, Optional[ShardedDispatchReport]]:
    """Rewrite an optimized plan for sharded execution on ``mesh``.

    Returns the shard-planned plan (containing exactly one
    :class:`ShardMerge` or :class:`ShardGather`) and, when
    ``native=True``, the per-shard dispatch report of the native
    dispatch pass that ran over the sharded plan (on ``mesh.device``).

    ``memory_budget``/``morsel_rows`` compose out-of-core execution
    with sharding: each shard's partial aggregate is wrapped in a
    :class:`repro_torch.core.morsel.MorselMerge`, so every shard streams
    its own slice of the spine in bounded-memory morsels before the
    cross-shard merge.  The budget is per shard, and the largest shard
    decides the morsel size.
    """
    if mesh is None:
        from repro_torch.launch.mesh import make_data_mesh
        mesh = make_data_mesh(axis=axis)
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in mesh axes "
                         f"{tuple(mesh.axis_names)}")
    n_shards = mesh.shape[axis]
    if isinstance(p, PL.IterativeKernel):
        raise UnsupportedParallelPlan(
            "IterativeKernel roots are not supported on the parallel "
            "engine: the training kernel consumes the whole gathered "
            "matrix on every shard; use engine='compiled' for "
            "heterogeneous pipelines")

    path, spine = _spine_path(p)
    true_rows = catalog.table(spine.table).num_rows
    full = shard_rows(true_rows, n_shards)
    largest = min(full, true_rows)  # rows of the largest shard
    common = dict(axis=axis, n_shards=n_shards, shard_rows=full,
                  true_rows=true_rows, mesh=mesh, spine=spine)

    barrier_i = None
    for i, node in enumerate(path):
        if not isinstance(node, _SPINE_SAFE):
            barrier_i = i  # keep the last hit: the DEEPEST barrier

    out_of_core = memory_budget is not None or morsel_rows is not None
    merge_barrier = (barrier_i is not None
                     and isinstance(path[barrier_i], PL.Aggregate))
    if out_of_core:
        from repro_torch.core import morsel as MO
        n_cols = len(L.required_scan_columns(p, catalog)
                     .get(id(spine), ())) or 1
    if out_of_core and not merge_barrier:
        # gather-planned spine: no partials to merge, so a budget can
        # only pass through when the shard-local working set fits whole
        if (morsel_rows is not None
                or MO.working_set_bytes(n_cols, largest) > memory_budget):
            raise MO.MemoryBudgetError(
                "memory budget needs a distributive aggregate on the "
                "spine to merge morsel partials behind; this sharded "
                "plan gathers instead of merging")
        out_of_core = False
    if merge_barrier:
        agg = path[barrier_i]
        partial, merges, avg_names, count_name, synthetic = _partial_of(agg)
        if out_of_core:
            # morselize the shard-local partial: _partial_of is
            # idempotent on it (no avg left, count already present), so
            # the inner MorselMerge hands ShardMerge exactly the partial
            # columns it expects, un-recomposed
            partial = MO.morselize_aggregate(
                partial, spine, catalog, n_cols, largest, memory_budget,
                morsel_rows)
        node = ShardMerge(child=partial, original=agg, merges=merges,
                          avg_names=avg_names, count_name=count_name,
                          synthetic=synthetic, **common)
        sharded = _rebuild(path, barrier_i, node)
    elif barrier_i is not None:
        ti = barrier_i + 1
        target = path[ti] if ti < len(path) else spine
        sharded = _rebuild(path, ti, ShardGather(child=target, **common))
    else:
        sharded = ShardGather(child=p, **common)

    report = None
    if native:
        from repro_torch.native import dispatch as ND
        # annotation AFTER shard planning: the partial aggregate (not
        # the original avg form) is what each shard's kernel computes
        sharded, base = ND.rewrite_plan(sharded, catalog, mesh.device,
                                        join_index=join_index)
        report = ShardedDispatchReport(decisions=list(base.decisions),
                                       n_shards=n_shards, axis=axis)
    return sharded, report


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class ParallelEngine(S.WholeQueryEngine):
    """Sharded whole-query execution behind the stages API.

    ``lower`` expects a shard-planned plan (``stages.lower_plan`` runs
    :func:`shard_plan` for ``engine="parallel"``; a direct caller gets
    the default mesh) and builds ONE whole-query function over it with
    ``lower.build_callable``: the shards run inside
    :class:`ShardMerge` / :class:`ShardGather`, and every scan column,
    join index and binding is an argument as on ``compiled``.
    ``compile`` (the whole-query engine's) fires ``morsel.loop``
    (per-shard morsel loops), then ``native.kernel`` once per kernel
    fragment of an annotated plan, then ``compile.xla``, and builds the
    fragments' kernel units on a CUDA device.
    """

    name = "parallel"
    site_attrs = {"engine": "parallel"}

    def lower(self, p: PL.Plan, catalog: PL.Catalog,
              param_specs: Tuple[E.Param, ...]):
        if find_shard_node(p) is None:  # direct Engine-protocol use
            p, _ = shard_plan(p, catalog)
        return super().lower(p, catalog, param_specs)


S.register_engine(ParallelEngine())


# ---------------------------------------------------------------------------
# one-shot entry point
# ---------------------------------------------------------------------------


def execute_parallel(p: PL.Plan, catalog: PL.Catalog, mesh: Any,
                     axis: str = "data") -> L.Result:
    """One-shot sharded execution on ``mesh`` (its device's columns come
    from a fresh device cache).  Prepared queries should hold on to
    ``lower_plan(..., engine="parallel", mesh=mesh).compile()``."""
    from repro_torch.core import engines as ENG
    cache = ENG.DeviceCache(mesh.device)
    return S.lower_plan(p, catalog, cache, S.CompileCache(),
                        engine="parallel", mesh=mesh,
                        axis=axis).compile().result()
