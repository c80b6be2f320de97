"""Deterministic fault injection at named trust boundaries.

Every place the engine crosses into something that can fail for reasons
outside the query's control -- the disk artifact store, the program and
kernel-unit build, a native fragment's preparation, the join-index
builder, a coalesced serve dispatch -- calls :func:`fault_point` with its
site name.  With no plan armed that call is a single module-global load
(the same near-free discipline as ``repro_torch.obs.trace``); with a plan
armed, the site consults its schedule and raises the site's
characteristic error type, so the failure takes the real recovery path
(store quarantine, degradation ladder, serve bisection) rather than a
synthetic one.

Arming::

    from repro_torch import resilience as RZ
    with RZ.inject("native.kernel", "first:1"):
        df.lower(native=True).compile()   # the native compile fails

or for subprocesses::

    FLARE_FAULTS="persist.load:every:2,compile.xla:p:0.25" \\
        python workload.py

Schedules are deterministic: ``first:N`` fires the first N checks,
``every:N`` every Nth check, ``p:<prob>`` flips a per-site coin seeded
from ``(seed, site)`` -- the same seed replays the same failure
sequence, in this package and in the JAX package (``repro.resilience.
faults``) alike.  Every arm/fire is counted in the MetricsRegistry
(``faults.armed.<site>`` / ``faults.fired.<site>``) and each fire drops
a ``fault`` trace span.

The sites carry the JAX package's names and error types:

* ``persist.load`` / ``persist.save`` -- reading and writing a store
  artifact (``repro_torch.persist.store``);
* ``compile.xla`` -- where the port builds a template's program: a single
  binding's (``stages.WholeQueryEngine.compile``, before the nvcc build of
  its units) and a batched one (``stages.compile_batch_executor``).  The
  port has no XLA; the name is kept so that a ``FLARE_FAULTS`` spec means
  the same in both packages;
* ``native.kernel`` -- once per native fragment, where the compile of a
  ``compiled-native`` template prepares its kernels
  (``native.dispatch.NativeWholeQueryEngine.compile``).  The JAX package
  checks it while tracing the fragment, inside its compile; the port's
  fragments lower on every call, so the site sits at compile time;
* ``index.build`` -- a join-index build (``core.engines.IndexCache``);
* ``serve.dispatch`` -- one coalesced dispatch of the query server;
* ``morsel.loop`` -- once per morsel loop of a template
  (``core.morsel.MorselMerge``), where the template compiles: ahead of
  ``native.kernel`` in ``stages.WholeQueryEngine.compile`` and ahead of
  ``compile.xla`` in ``stages.compile_batch_executor``.  The JAX package
  fires it while tracing the loop, inside its compile; the port runs the
  loop on every call, so a site in the loop would fire at execute time,
  where the ladder does not take ``KernelBudgetError``.
"""
from __future__ import annotations

import os
import random
import threading
from typing import Callable, Dict, Optional

from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT


class CompileFault(RuntimeError):
    """Injected failure of a template's program build (site
    ``compile.xla``, the JAX package's ``XlaCompileFault``).  The
    degradation ladder treats it as a failed build of this rung."""


class IndexBuildError(RuntimeError):
    """Join-index construction failed (injected or infrastructural).

    Distinct from :class:`repro_torch.core.engines.UnindexableKeyError`,
    which is a *data* property (int32 overflow) and is never injected
    here.
    """


class DispatchFault(RuntimeError):
    """Injected failure of one coalesced serve dispatch.

    The serve layer isolates it by bisection, so only the poisoned
    request's future fails.
    """


def _store_corrupt(site: str) -> Exception:
    from repro_torch.persist.store import StoreCorrupt
    return StoreCorrupt(f"injected fault at {site}")


def _os_error(site: str) -> Exception:
    return OSError(f"injected fault at {site}")


def _kernel_budget(site: str) -> Exception:
    from repro_torch.kernels import KernelBudgetError
    return KernelBudgetError(f"injected fault at {site}")


#: site name -> factory for the site's characteristic error.  The error
#: type matches what the real failure would raise, so injection
#: exercises the production recovery path at each boundary.
SITES: Dict[str, Callable[[str], Exception]] = {
    "persist.load": _store_corrupt,
    "persist.save": _os_error,
    "compile.xla": lambda s: CompileFault(f"injected fault at {s}"),
    "native.kernel": _kernel_budget,
    "index.build": lambda s: IndexBuildError(f"injected fault at {s}"),
    "serve.dispatch": lambda s: DispatchFault(f"injected fault at {s}"),
    "morsel.loop": _kernel_budget,
}


class _Schedule:
    """One site's deterministic firing schedule."""

    __slots__ = ("kind", "n", "prob", "rng", "count", "fired")

    def __init__(self, spec: str, site: str, seed: int):
        self.count = 0
        self.fired = 0
        self.prob = 0.0
        self.n = 0
        self.rng: Optional[random.Random] = None
        if spec.startswith("first:"):
            self.kind, self.n = "first", int(spec[6:])
        elif spec.startswith("every:"):
            self.kind, self.n = "every", int(spec[6:])
            if self.n < 1:
                raise ValueError(f"every:N needs N >= 1, got {spec!r}")
        elif spec.startswith("p:"):
            self.kind, self.prob = "p", float(spec[2:])
            if not 0.0 <= self.prob <= 1.0:
                raise ValueError(f"p:<prob> needs 0..1, got {spec!r}")
            # seeded per (seed, site): str seeding is stable across
            # processes (no PYTHONHASHSEED dependence)
            self.rng = random.Random(f"{seed}:{site}")
        else:
            raise ValueError(
                f"unknown fault schedule {spec!r}; expected first:N, "
                f"every:N or p:<prob>")

    def fires(self) -> bool:
        self.count += 1
        if self.kind == "first":
            hit = self.count <= self.n
        elif self.kind == "every":
            hit = self.count % self.n == 0
        else:
            hit = self.rng.random() < self.prob
        if hit:
            self.fired += 1
        return hit


class FaultPlan:
    """A set of armed fault sites with deterministic schedules.

    ``sites`` maps site name -> spec string (``first:N`` / ``every:N``
    / ``p:<prob>``).  Thread-safe: serving workers and the submitting
    thread share one plan.
    """

    def __init__(self, sites: Dict[str, str], seed: int = 0):
        unknown = sorted(set(sites) - set(SITES))
        if unknown:
            raise ValueError(
                f"unknown fault site(s) {unknown}; registered sites: "
                f"{sorted(SITES)}")
        self.seed = seed
        self._lock = threading.Lock()
        self._sched = {site: _Schedule(spec, site, seed)
                       for site, spec in sites.items()}

    def check(self, site: str) -> Optional[Exception]:
        sched = self._sched.get(site)
        if sched is None:
            return None
        with self._lock:
            hit = sched.fires()
        if not hit:
            return None
        return SITES[site](site)

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Per-site ``{checked, fired}`` counts (for tests/telemetry)."""
        with self._lock:
            return {site: {"checked": s.count, "fired": s.fired}
                    for site, s in self._sched.items()}

    def __repr__(self):
        arms = ", ".join(f"{k}:{v.kind}" for k, v in self._sched.items())
        return f"FaultPlan({arms}, seed={self.seed})"


#: the active plan; None (the common case) keeps fault_point() at a
#: single global load + None check.
_PLAN: Optional[FaultPlan] = None


def _arm(plan: Optional[FaultPlan]) -> None:
    global _PLAN
    _PLAN = plan
    if plan is not None:
        for site in plan._sched:
            OM.REGISTRY.inc(f"faults.armed.{site}")


def fault_point(site: str, **ctx) -> None:
    """Raise the site's characteristic error if an armed schedule says
    so; free (one global load) when nothing is armed."""
    plan = _PLAN
    if plan is None:
        return
    err = plan.check(site)
    if err is None:
        return
    OM.REGISTRY.inc("faults.fired")
    OM.REGISTRY.inc(f"faults.fired.{site}")
    with OT.span("fault", site=site, error=type(err).__name__, **ctx):
        pass
    raise err


class inject:
    """Context manager arming a :class:`FaultPlan` for its scope.

    ``inject("serve.dispatch", "first:1")`` for one site, or
    ``inject({"serve.dispatch": "every:2", "compile.xla": "p:0.5"},
    seed=7)`` for several.  Restores the previous plan (usually None)
    on exit, even on error.
    """

    def __init__(self, site_or_map, spec: Optional[str] = None,
                 seed: int = 0):
        if isinstance(site_or_map, FaultPlan):
            self.plan = site_or_map
        elif isinstance(site_or_map, dict):
            self.plan = FaultPlan(site_or_map, seed=seed)
        else:
            if spec is None:
                raise TypeError("inject(site, spec) needs a schedule spec")
            self.plan = FaultPlan({site_or_map: spec}, seed=seed)
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        self._prev = _PLAN
        _arm(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        _arm_quiet(self._prev)


def _arm_quiet(plan: Optional[FaultPlan]) -> None:
    """Restore a previous plan without re-counting its arms."""
    global _PLAN
    _PLAN = plan


def parse_env(value: str, seed: int = 0) -> Optional[FaultPlan]:
    """Parse ``FLARE_FAULTS`` syntax: ``site:spec[,site:spec...]``.

    The spec itself contains colons (``serve.dispatch:first:1``), so the
    site is everything before the first colon.  An optional trailing
    ``seed:N`` entry seeds the probabilistic schedules.
    """
    value = value.strip()
    if not value:
        return None
    sites: Dict[str, str] = {}
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, spec = part.partition(":")
        if site == "seed":
            seed = int(spec)
            continue
        if not spec:
            raise ValueError(
                f"malformed FLARE_FAULTS entry {part!r}; expected "
                f"site:first:N | site:every:N | site:p:<prob>")
        sites[site] = spec
    if not sites:
        return None
    return FaultPlan(sites, seed=seed)


def refresh_from_env() -> Optional[FaultPlan]:
    """Re-read ``FLARE_FAULTS`` (tests and forked workers)."""
    _arm(parse_env(os.environ.get("FLARE_FAULTS", "")))
    return _PLAN


def active() -> Optional[FaultPlan]:
    return _PLAN


# arm from the environment at import so subprocess chaos lanes need no
# code changes in the workload under test
if os.environ.get("FLARE_FAULTS"):
    refresh_from_env()
