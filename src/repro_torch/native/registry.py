"""The kernel-pattern registry: plan fragments -> CUDA kernels.

The paper's headline claim (sections 1, 4.1) is that Flare generates
*specialized native operators* for hot plan fragments instead of
stitching generic library calls.  A :class:`KernelPattern` is a *matcher*
over plan fragments, an *eligibility* predicate (supported aggregate ops
and expression forms, f32-exactness of the streamed columns, the
kernels' shared- and device-memory budgets) and an *emitter* that
replaces the fragment's generic lowering with a kernel call.  The
dispatch pass (``repro_torch.native.dispatch``) records every decision in
a :class:`DispatchReport`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import expr as E
from repro_torch.core import lower as L
from repro_torch.core import plan as P


@dataclasses.dataclass
class Fragment:
    """A matched plan fragment: an Aggregate root plus its Filter/Project
    prologue, rebased onto the *boundary* node whose stream the kernel
    consumes.  All expressions are substituted into boundary-column
    terms, so the emitter can compile them straight into the kernel body.
    """

    root: P.Aggregate
    boundary: P.Plan
    preds: Tuple[E.Expr, ...]                 # prologue filter conjuncts
    agg_args: Tuple[Optional[E.Expr], ...]    # per AggSpec (None = count)
    key_exprs: Tuple[E.Expr, ...]             # group keys, boundary terms
    masked: bool                              # boundary may carry a mask
    binfo: L.StaticInfo                       # boundary static info
    # memo slots for the patterns' analyses (computed once, shared by
    # eligibility and emitter); the join-probe layout differs, so it has
    # its own slot
    analysis: Any = dataclasses.field(default=None, repr=False)
    probe_analysis: Any = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class KernelPattern:
    """A registry entry: name + matcher + eligibility + emitter factory.

    ``matcher(node, catalog, frag)`` returns a :class:`Fragment` or None
    (the dispatch pass walks each Aggregate's fragment once and passes
    it as ``frag``); ``eligibility(fragment, catalog)`` returns ``(ok,
    reason)``; ``emitter(fragment, catalog)`` builds the emitter.  An
    emitter is called as ``emitter(boundary_stream, params)``, or, with
    ``custom_lower``, as ``emitter(catalog, scans, params)`` and lowers
    its operand streams itself.  Every emitter has ``sources()``: the
    kernel units it launches.
    """

    name: str
    matcher: Callable[..., Optional[Fragment]]
    eligibility: Callable[[Fragment, P.Catalog], Tuple[bool, str]]
    emitter: Callable[[Fragment, P.Catalog], Any]
    #: the pattern probes a cached build-side join index (``join-probe``):
    #: skipped entirely when lowering with ``join_index=False``
    requires_index: bool = False
    custom_lower: bool = False


_REGISTRY: Dict[str, KernelPattern] = {}


def register_pattern(pattern: KernelPattern) -> KernelPattern:
    """Register ``pattern`` (last registration wins on name collision).
    Patterns are tried in registration order; first eligible match wins.
    """
    _REGISTRY[pattern.name] = pattern
    return pattern


def get_pattern(name: str) -> KernelPattern:
    return _REGISTRY[name]


def patterns() -> List[KernelPattern]:
    return list(_REGISTRY.values())


def available_patterns() -> List[str]:
    return list(_REGISTRY)


# ---------------------------------------------------------------------------
# dispatch telemetry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Decision:
    """One dispatch decision for one plan fragment."""

    pattern: str   # pattern name ("" when no pattern was eligible)
    node: str      # fragment root, human-readable (plan.describe())
    fired: bool
    mode: str      # "cuda" | "torch" (plain version on CPU) | "" (fallback)
    reason: str    # "ok" or why the fragment fell back to generic lowering

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DispatchReport:
    """Per-query dispatch report: which patterns fired, which fragments
    fell back to the generic lowering, and why.  ``index_decisions`` has
    one entry per join: whether its build side probes the cached
    base-table index (``fired``) or sorts in the program, and why."""

    decisions: List[Decision] = dataclasses.field(default_factory=list)
    index_decisions: List[Decision] = dataclasses.field(
        default_factory=list)

    def add(self, d: Decision) -> None:
        self.decisions.append(d)

    @property
    def fired(self) -> List[Decision]:
        return [d for d in self.decisions if d.fired]

    @property
    def fallbacks(self) -> List[Decision]:
        return [d for d in self.decisions if not d.fired]

    def fired_patterns(self) -> List[str]:
        return [d.pattern for d in self.fired]

    @property
    def joins_cached(self) -> List[Decision]:
        return [d for d in self.index_decisions if d.fired]

    @property
    def joins_rebuilt(self) -> List[Decision]:
        return [d for d in self.index_decisions if not d.fired]

    def to_dict(self) -> Dict[str, Any]:
        return {"fired": [d.to_dict() for d in self.fired],
                "fallbacks": [d.to_dict() for d in self.fallbacks],
                "joins_cached": [d.to_dict() for d in self.joins_cached],
                "joins_rebuilt": [d.to_dict() for d in self.joins_rebuilt]}

    def __str__(self) -> str:
        if not self.decisions and not self.index_decisions:
            return "native dispatch: no dispatchable fragments"
        lines = ["native dispatch:"] if self.decisions else []
        for d in self.decisions:
            if d.fired:
                lines.append(f"  + {d.node} -> {d.pattern} [{d.mode}]")
            else:
                lines.append(f"  - {d.node} -> generic fallback ({d.reason})")
        if self.index_decisions:
            lines.append("join index cache:")
            for d in self.index_decisions:
                if d.fired:
                    lines.append(f"  + {d.node} -> cached index")
                else:
                    lines.append(f"  - {d.node} -> in-program sort "
                                 f"({d.reason})")
        return "\n".join(lines)
