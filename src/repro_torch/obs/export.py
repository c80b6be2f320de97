"""Trace export: Chrome-trace-event JSON + device-profile annotations.

:func:`to_chrome` serialises spans into the Chrome trace event format
(``{"traceEvents": [...]}``, complete "X" duration events), which loads
directly in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``::

    FLARE_TRACE=1 PYTHONPATH=src python my_workload.py
    # then, at exit or any point:
    from repro_torch import obs
    obs.dump_chrome("flare_trace.json")

or ``FLARE_TRACE_OUT=flare_trace.json``, which dumps the whole buffer at
process exit (:func:`install_atexit_dump`).  Span attributes become the
event ``args`` (with ``span_id``/``parent_id`` preserved, so
:func:`spans_from_chrome` rebuilds the span tree from the JSON alone).
The schema is the JAX package's (``repro.obs.export``).

Device-side naming: :func:`device_annotation` wraps a traced execution
in ``torch.profiler.record_function``, so query executions show up named
in ``torch.profiler`` traces; :func:`kernel_scope` wraps each native
fragment's launch in a ``record_function`` range and, on a CUDA device,
an NVTX range (``torch.cuda.nvtx``), so the profile shows each kernel
under its pattern name ("flare:filter-scalar-agg").
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs import trace as OT


def _json_safe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [_json_safe(x) for x in v]
    return str(v)


def to_chrome(spans: Optional[Iterable[OT.Span]] = None,
              process_name: str = "flare") -> Dict[str, Any]:
    """Chrome trace event dict for ``spans`` (default: the whole tracer
    buffer).  Timestamps are microseconds on the ``perf_counter`` clock;
    every span becomes one complete ("X") duration event."""
    if spans is None:
        spans = OT.TRACER.spans()
    pid = os.getpid()
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for sp in spans:
        args = {str(k): _json_safe(v) for k, v in sp.attrs.items()}
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        events.append({
            "name": sp.name,
            "ph": "X",
            "ts": sp.t0 * 1e6,
            "dur": max(0.0, sp.t1 - sp.t0) * 1e6,
            "pid": pid,
            "tid": sp.tid % (1 << 31),  # chrome wants a small-ish int
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome(path: str,
                spans: Optional[Iterable[OT.Span]] = None) -> str:
    """Write Chrome-trace JSON for ``spans`` (default: whole buffer)."""
    doc = to_chrome(spans)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def spans_from_chrome(doc: Dict[str, Any]) -> List[OT.Span]:
    """Rebuild :class:`repro_torch.obs.trace.Span` objects (hence a
    :class:`repro_torch.obs.trace.Trace` tree) from Chrome-trace JSON --
    the inverse of :func:`to_chrome`."""
    out: List[OT.Span] = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        span_id = args.pop("span_id", None)
        parent_id = args.pop("parent_id", None)
        sp = OT.Span(ev.get("name", "?"), span_id or 0, parent_id,
                     ev.get("tid", 0), args)
        sp.t0 = float(ev.get("ts", 0.0)) / 1e6
        sp.t1 = sp.t0 + float(ev.get("dur", 0.0)) / 1e6
        out.append(sp)
    return out


# ---------------------------------------------------------------------------
# device-profile naming hooks
# ---------------------------------------------------------------------------


def device_annotation(name: str):
    """``torch.profiler.record_function`` context manager: names a
    host-side dispatch window in ``torch.profiler`` traces."""
    import torch
    return torch.profiler.record_function(name)


def kernel_scope(name: str, nvtx: bool = False):
    """The range ``name`` around one native fragment's launch: a
    ``torch.profiler.record_function`` range while a profiler records
    (what ``torch.profiler`` shows around the kernel it encloses) and,
    with ``nvtx=True`` (the fragment runs on a CUDA device), an NVTX range
    of the same name for NVTX-aware tools.  With neither it is a shared
    no-op: ``record_function`` costs microseconds per call even when no
    profiler records."""
    import torch
    profiling = torch.autograd._profiler_enabled()
    if not (profiling or nvtx):
        return _NO_SCOPE
    return _scope(name, profiling, nvtx)


_NO_SCOPE = contextlib.nullcontext()


@contextlib.contextmanager
def _scope(name: str, profiling: bool, nvtx: bool):
    import torch
    with (torch.profiler.record_function(name) if profiling
          else contextlib.nullcontext()):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


# ---------------------------------------------------------------------------
# atexit dump: FLARE_TRACE_OUT=/path/to/trace.json
# ---------------------------------------------------------------------------

OUT_ENV = "FLARE_TRACE_OUT"
_atexit_registered = False
_atexit_lock = threading.Lock()


def install_atexit_dump(path: Optional[str] = None) -> Optional[str]:
    """Arrange for a Chrome-trace dump of the whole buffer at process
    exit.  Called on package import when ``$FLARE_TRACE_OUT`` is set;
    idempotent."""
    global _atexit_registered
    path = path or os.environ.get(OUT_ENV)
    if not path:
        return None
    with _atexit_lock:
        if _atexit_registered:
            return path
        import atexit
        atexit.register(lambda: dump_chrome(path))
        _atexit_registered = True
    return path
