"""The process-wide metrics registry behind ``obs.snapshot()``.

:class:`MetricsRegistry` folds the port's telemetry behind one
:func:`snapshot`:

* live stat-bearing objects (the compile, device and index caches, query
  servers) register into weak-ref domains at construction
  (``engines.register_cache`` is a shim over :data:`REGISTRY`);
* point events with no owning object (native dispatch decisions, served
  requests rejected or poisoned, faults fired, degradations) bump named
  counters via :meth:`MetricsRegistry.inc`;
* :func:`snapshot` composes the aggregate view, with the JAX package's
  sections (``repro.obs.metrics``): the ``engines.cache_stats()`` dict
  under ``"caches"``, the persist tiers under ``"disk"``, dispatch
  fire/fallback counts under ``"dispatch"``, every live server's
  ServeStats under ``"serve"``, raw counters, the armed fault plan and
  the degradation events under ``"resilience"``, and the tracer state.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List

from repro_torch.obs import trace as OT


class MetricsRegistry:
    """Named counters + weak-ref'd domains of live stat-bearing objects."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._domains: Dict[str, "weakref.WeakSet[Any]"] = {}

    # -- counters -------------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset_counters(self) -> None:
        with self._lock:
            self._counters.clear()

    # -- live-object domains --------------------------------------------------

    def register(self, domain: str, obj: Any) -> Any:
        with self._lock:
            self._domains.setdefault(domain, weakref.WeakSet()).add(obj)
        return obj

    def objects(self, domain: str) -> List[Any]:
        with self._lock:
            return list(self._domains.get(domain, ()))


REGISTRY = MetricsRegistry()


def cache_section() -> Dict[str, Dict[str, Any]]:
    """The ``engines.cache_stats()`` aggregate: per cache ``kind`` the
    live-cache count, total entries, summed hits/misses and combined hit
    rate, with the persist store tiers nested under ``disk`` for compile
    and index."""
    from repro_torch.persist import store as PS  # lazy: persist imports obs
    out: Dict[str, Dict[str, Any]] = {}
    for cache in REGISTRY.objects("cache"):
        kind = getattr(type(cache), "kind", "other")
        agg = out.setdefault(kind, {"caches": 0, "entries": 0,
                                    "hits": 0, "misses": 0})
        agg["caches"] += 1
        agg["entries"] += len(cache)
        agg["hits"] += getattr(cache, "hits", 0)
        agg["misses"] += getattr(cache, "misses", 0)
    for agg in out.values():
        total = agg["hits"] + agg["misses"]
        agg["hit_rate"] = round(agg["hits"] / total, 4) if total else 0.0
    disk = PS.live_store_stats()
    if "compile" in out:
        out["compile"]["disk"] = disk["exec"]
    if "index" in out:
        out["index"]["disk"] = disk["index"]
    return out


def dispatch_section() -> Dict[str, Any]:
    """Cumulative native-dispatch decisions (bumped per pattern match
    attempt in ``repro_torch.native.dispatch.rewrite_plan``)."""
    counters = REGISTRY.counters()
    patterns: Dict[str, Dict[str, int]] = {}
    for name, n in counters.items():
        for verdict in ("fired", "fallback"):
            prefix = f"dispatch.{verdict}."
            if name.startswith(prefix):
                pat = name[len(prefix):]
                patterns.setdefault(pat, {"fired": 0, "fallback": 0})
                patterns[pat][verdict] += n
    return {"fired": counters.get("dispatch.fired", 0),
            "fallbacks": counters.get("dispatch.fallback", 0),
            "rewrites": counters.get("dispatch.rewrites", 0),
            "patterns": patterns}


def serve_section() -> List[Dict[str, Any]]:
    """One ServeStats dict per live :class:`repro_torch.serve.QueryServer`."""
    out = []
    for server in REGISTRY.objects("serve"):
        stats = getattr(server, "stats", None)
        if stats is not None:
            out.append(stats.to_dict())
    return out


def snapshot() -> Dict[str, Any]:
    """The one process-wide telemetry view (superset of
    ``engines.cache_stats()``, which returns this dict's ``caches``)."""
    from repro_torch.persist import store as PS  # lazy: persist imports obs
    from repro_torch.resilience import degrade as DG  # lazy: imports obs
    from repro_torch.resilience import faults as FZ
    plan = FZ.active()
    return {
        "caches": cache_section(),
        "disk": PS.live_store_stats(),
        "dispatch": dispatch_section(),
        "serve": serve_section(),
        "counters": REGISTRY.counters(),
        "resilience": {
            "faults": plan.counts() if plan is not None else {},
            "degrade": DG.stats(),
        },
        "trace": {**OT.TRACER.stats(),
                  "phases": OT.Trace(OT.TRACER.spans()).phase_totals()},
    }
