"""Plan-level helpers of the sharded engine: the row-parallel spine and
the partial form of a distributive aggregate.

The JAX package's ``repro.core.parallel`` splits a plan into a
row-partitioned parallel section and a merge (or gather) finish.  Two of
its ideas do not depend on shards and serve out-of-core execution as
well (:mod:`repro_torch.core.morsel`, which streams row ranges of the
spine where the parallel engine shards them):

* the *spine* -- the path from the root down to the leftmost scan,
  whose operators in :data:`_SPINE_SAFE` act row by row, so any row
  range of the spine computes exactly its slice of their output;
* the *partial form* of an aggregate (:func:`_partial_of`): per row
  range, ``avg`` becomes a sum (recomposed from the merged sum and count
  after the merge), and a grouped aggregate always carries a count, so
  the merged group mask (``count > 0``) is exact.

This module holds only those helpers.  ``ShardMerge``, ``ShardGather``,
``_MERGE_OPS``, ``shard_plan`` and the ``parallel`` engine itself come
with the port of the sharded engine; no ``parallel`` engine is
registered yet.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core import plan as PL


class UnsupportedParallelPlan(TypeError):
    """Plan shape that cannot be split by rows of its spine (no spine
    scan below the root)."""


#: Spine operators that are row-parallel: they act per probe-side row
#: (Join probes against a whole build side), so a row range of the spine
#: computes exactly its slice of the full operator output.
_SPINE_SAFE = (PL.Filter, PL.Project, PL.Join, PL.MapBatches)

_SYNTH_COUNT = "__pcount"


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
    the output.
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
