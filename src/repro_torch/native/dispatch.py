"""The dispatch pass: annotate matched fragments, hook into lowering.

Runs after the optimizer (``repro_torch.core.stages.lower_plan`` with
``native=True`` or the ``compiled-native`` engine name): every
dispatchable fragment is wrapped in a :class:`NativeOp` carrying its
pattern's emitter; everything else keeps its generic lowering.
``NativeOp`` implements the custom-lowering protocol of
``repro_torch.core.lower`` (``lower_stream`` / ``static_info_hook`` /
``required_columns_hook``), so the kernel call runs inside the same
whole-query function as the surrounding operators.

The report's ``mode`` says where the fragment runs: "cuda" (the kernel,
on a CUDA device) or "torch" (its plain version, on the CPU).

Each match attempt bumps the JAX package's dispatch counters
(``dispatch.rewrites``, ``dispatch.fired[.<pattern>]``,
``dispatch.fallback[.<pattern>]``; ``obs.metrics.dispatch_section``) and
the pass leaves ``dispatch`` / ``dispatch.match`` spans.  Every launch of
a fragment runs inside ``obs.export.kernel_scope("flare:<pattern>")``, so
a profile shows each kernel under its pattern name.  The fault site
``native.kernel`` fires once per fragment where an annotated template
compiles (``stages.WholeQueryEngine.compile``: ``compiled-native`` and
``parallel`` with ``native=True``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from repro_torch.core import lower as L
from repro_torch.core import plan as P
from repro_torch.core import stages as S
from repro_torch.native import patterns as PAT
from repro_torch.native import registry as R
from repro_torch.obs import export as OX
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT


@dataclasses.dataclass(eq=False)
class NativeOp(P.Plan):
    """Annotation node: ``child`` (the matched fragment root, subtree
    intact) lowers through ``emitter`` onto a kernel instead of the
    generic path.  Transparent for schema/static-info/column analysis;
    pattern-tagged in fingerprints, so native templates never share a
    compile-cache entry with plain compiled ones."""

    child: P.Plan
    pattern: str
    emitter: Any
    mode: str
    custom_lower: bool = False

    def children(self) -> Tuple[P.Plan, ...]:
        return (self.child,)

    def with_children(self, kids):
        return NativeOp(kids[0], self.pattern, self.emitter, self.mode,
                        self.custom_lower)

    def infer_schema(self, catalog):
        return self.child.schema(catalog)

    def describe(self):
        return f"NativeKernel[{self.pattern}/{self.mode}]"

    def fingerprint(self):
        return f"native[{self.pattern}:{self.mode}]({self.child.fingerprint()})"

    def kernel_sources(self) -> List[str]:
        return self.emitter.sources()

    # -- repro_torch.core.lower custom-lowering protocol ---------------------

    def static_info_hook(self, catalog) -> L.StaticInfo:
        return L.static_info(self.child, catalog)

    def required_columns_hook(self, rec, needed) -> None:
        rec(self.child, needed)

    def lower_stream(self, catalog, scans, params) -> L.Stream:
        with OX.kernel_scope(f"flare:{self.pattern}",
                             nvtx=self.mode == "cuda"):
            if self.custom_lower:
                return self.emitter(catalog, scans, params)
            boundary = PAT.boundary_of(self.child)
            bstream = L.lower_node(boundary, catalog, scans, params)
            return self.emitter(bstream, params)


def has_native_ops(p: P.Plan) -> bool:
    """True when any fragment of ``p`` is annotated with a kernel."""
    if isinstance(p, NativeOp):
        return True
    return any(has_native_ops(c) for c in p.children())


def rewrite_plan(p: P.Plan, catalog: P.Catalog, device: torch.device,
                 join_index: bool = True
                 ) -> Tuple[P.Plan, R.DispatchReport]:
    """Pattern-match the optimized plan bottom-up; wrap every eligible
    fragment in a :class:`NativeOp`.  Returns the annotated plan and the
    per-query :class:`repro_torch.native.registry.DispatchReport`.

    ``join_index=False`` skips patterns that need a cached build-side
    index (``join-probe``): without it there is nothing to search."""
    mode = "cuda" if device.type == "cuda" else "torch"
    report = R.DispatchReport()
    OM.REGISTRY.inc("dispatch.rewrites")

    def rule(n: P.Plan):
        if not isinstance(n, P.Aggregate):
            return None
        with OT.span("dispatch.match", node=n.describe()) as sp:
            reasons = []
            # one fragment walk per node, shared by the sibling matchers
            shared = PAT.match_fragment(n, catalog)
            for pat in R.patterns():
                if pat.requires_index and not join_index:
                    continue
                frag = pat.matcher(n, catalog, shared)
                if frag is None:
                    continue
                ok, reason = pat.eligibility(frag, catalog)
                if not ok:
                    reasons.append(f"{pat.name}: {reason}")
                    continue
                report.add(R.Decision(pattern=pat.name, node=n.describe(),
                                      fired=True, mode=mode, reason="ok"))
                OM.REGISTRY.inc("dispatch.fired")
                OM.REGISTRY.inc(f"dispatch.fired.{pat.name}")
                sp.set(fired=pat.name, mode=mode)
                return NativeOp(n, pat.name, pat.emitter(frag, catalog),
                                mode, custom_lower=pat.custom_lower)
            why = "; ".join(reasons) if reasons else "no pattern matched"
            report.add(R.Decision(pattern="", node=n.describe(),
                                  fired=False, mode="", reason=why))
            OM.REGISTRY.inc("dispatch.fallback")
            for r in reasons:
                OM.REGISTRY.inc("dispatch.fallback." + r.split(":", 1)[0])
            sp.set(fired="", reason=why)
        return None

    with OT.span("dispatch", mode=mode) as dsp:
        out = P.transform(p, rule)
        dsp.set(fired=len(report.fired), fallbacks=len(report.fallbacks),
                patterns=",".join(report.fired_patterns()) or "none")
    return out, report


class NativeWholeQueryEngine(S.WholeQueryEngine):
    """The whole-query engine under the name ``compiled-native``: it
    lowers a plan the dispatch pass has annotated (``stages.lower_plan``
    runs the pass before it looks the engine up), and its compile checks
    the fault site ``native.kernel`` once per fragment."""

    name = "compiled-native"


S.register_engine(NativeWholeQueryEngine())
