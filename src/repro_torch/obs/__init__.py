"""repro_torch.obs -- tracing and metrics for the query lifecycle.

* :mod:`repro_torch.obs.trace` -- nested :func:`span` context managers
  around lower, compile and execute and the serving layer.  Off by
  default; near-free when off; enabled by ``FLARE_TRACE=1`` or a scoped
  :func:`capture`.
* :mod:`repro_torch.obs.metrics` -- the process-wide :func:`snapshot`
  over every live cache and server and the named counters.

The JAX package's Chrome-trace export and EXPLAIN ANALYZE
(``repro.obs.export``, ``repro.obs.analyze``) are not ported yet.
"""
from repro_torch.obs.trace import (NULL_SPAN, TRACER, Trace,  # noqa: F401
                                   capture, current_span, disable, enable,
                                   enabled, span)
from repro_torch.obs.metrics import REGISTRY, snapshot  # noqa: F401
