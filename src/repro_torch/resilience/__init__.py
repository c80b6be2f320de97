"""Resilience layer: deterministic fault injection + engine degradation.

Two cooperating pieces, with the JAX package's names
(``repro.resilience``):

* :mod:`repro_torch.resilience.faults` -- a registry of named fault sites
  at the port's trust boundaries (persist load/save, program build,
  native kernel preparation, index build, serve dispatch).  Arm a
  :class:`FaultPlan` with the :func:`inject` context manager or the
  ``FLARE_FAULTS`` env var and the named sites raise on a deterministic
  ``first:N`` / ``every:N`` / seeded ``p:<prob>`` schedule.

* :mod:`repro_torch.resilience.degrade` -- the graceful-degradation
  ladder ``compiled-native -> compiled -> stage -> volcano``.  A closed
  allowlist of recoverable error types, none of which can stand for a
  failed kernel build or launch, triggers a re-lower on the next rung
  with a recorded :class:`DegradeEvent`; anything outside the allowlist
  still raises.  Policy knob: ``FLARE_DEGRADE=off|auto``.

Injected faults and degradations are counted in the
:class:`repro_torch.obs.metrics.MetricsRegistry` and visible as trace
spans.
"""
from repro_torch.resilience.faults import (  # noqa: F401
    SITES,
    CompileFault,
    DispatchFault,
    FaultPlan,
    IndexBuildError,
    fault_point,
    inject,
    refresh_from_env,
)
from repro_torch.resilience.degrade import (  # noqa: F401
    LADDER,
    DegradeEvent,
    clear_events,
    enabled,
    events,
    recoverable,
)

__all__ = [
    "SITES", "FaultPlan", "inject", "fault_point", "refresh_from_env",
    "CompileFault", "IndexBuildError", "DispatchFault",
    "LADDER", "DegradeEvent", "recoverable", "enabled", "events",
    "clear_events",
]
