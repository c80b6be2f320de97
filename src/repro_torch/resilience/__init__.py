"""Resilience layer: deterministic fault injection.

:mod:`repro_torch.resilience.faults` holds the named fault sites this
package crosses (``serve.dispatch``, ``compile.xla``).  Arm a
:class:`FaultPlan` with the :func:`inject` context manager or the
``FLARE_FAULTS`` env var and the named sites raise on a deterministic
``first:N`` / ``every:N`` / seeded ``p:<prob>`` schedule.

The JAX package's degradation ladder (``repro.resilience.degrade``) is
not ported: without it, ``Compiled.batch`` and ``submit`` raise where
the JAX package with ``FLARE_DEGRADE=off`` raises.
"""
from repro_torch.resilience.faults import (  # noqa: F401
    SITES,
    CompileFault,
    DispatchFault,
    FaultPlan,
    fault_point,
    inject,
    refresh_from_env,
)

__all__ = ["SITES", "FaultPlan", "inject", "fault_point",
           "refresh_from_env", "CompileFault", "DispatchFault"]
