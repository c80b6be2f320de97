"""repro_torch.obs -- observability for the whole query lifecycle, with
the JAX package's names (``repro.obs``):

* :mod:`repro_torch.obs.trace` -- nested :func:`span` context managers
  around optimize, dispatch, lower, compile, persist and execute, the
  caches, the store and the serving layer.  Off by default; near-free
  when off; enabled by ``FLARE_TRACE=1`` or a scoped :func:`capture`.
* :mod:`repro_torch.obs.metrics` -- the process-wide :func:`snapshot`
  over every live cache, store, server and dispatch counter.
* :mod:`repro_torch.obs.export` -- Chrome-trace JSON (Perfetto-loadable)
  via :func:`dump_chrome` / ``$FLARE_TRACE_OUT``, plus
  ``torch.profiler.record_function`` / NVTX ranges naming query
  executions and native kernels in device profiles.
* :mod:`repro_torch.obs.analyze` -- the ``df.explain(analyze=True)``
  report.
"""
from repro_torch.obs.trace import (NULL_SPAN, TRACER, Trace,  # noqa: F401
                                   capture, current_span, disable, enable,
                                   enabled, span)
from repro_torch.obs.metrics import REGISTRY, snapshot  # noqa: F401
from repro_torch.obs.export import (device_annotation,  # noqa: F401
                                    dump_chrome, install_atexit_dump,
                                    kernel_scope, spans_from_chrome,
                                    to_chrome)
from repro_torch.obs.analyze import explain_analyze  # noqa: F401

# honour $FLARE_TRACE_OUT as soon as observability is imported
install_atexit_dump()
