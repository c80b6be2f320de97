"""The span tracer: one correlated timeline for the whole query lifecycle.

Every phase the engine pipeline goes through -- optimize, dispatch,
lower, compile, persist, execute, plus the cache/index lookups and the
serving layer's coalescing -- opens a :func:`span` around its work:

    with OT.span("compile", engine="compiled") as sp:
        ...
        sp.set(cache="miss", disk="hit:native")

Spans nest through a per-thread stack (a span opened inside another
becomes its child), carry free-form attributes, and land in one
process-wide buffer; :func:`Trace.tree_str` renders a captured window as
a tree.  The span names are the JAX package's (``repro.obs.trace``), so
one tool reads the traces of both packages.

Tracing is OFF by default and must cost nearly nothing when off: with
``$FLARE_TRACE`` unset, :func:`span` is a single attribute check
returning a shared no-op context manager -- no allocation, no clock
read, no lock.  Enable with ``FLARE_TRACE=1`` (process-wide, read at
import) or scoped via :func:`enable`/:func:`disable` or the
:func:`capture` context manager (which also collects the spans recorded
in its window -- the mechanism behind ``Compiled.last_trace()``).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

ENV_VAR = "FLARE_TRACE"
#: Buffer cap: oldest spans are dropped past this (a long-lived traced
#: server must not grow without bound).  Override via env.
MAX_SPANS = int(os.environ.get("FLARE_TRACE_MAX_SPANS", "500000"))

_OFF_VALUES = ("", "0", "false", "off", "no")


def _env_enabled() -> bool:
    return os.environ.get(ENV_VAR, "").strip().lower() not in _OFF_VALUES


class Span:
    """One timed phase: name, wall-clock window, attributes, tree links.

    Context manager: ``__enter__`` stamps ``t0`` and pushes onto the
    thread's span stack (so nested spans record this one as parent);
    ``__exit__`` stamps ``t1``, pops, and appends to the tracer buffer.
    ``set(**attrs)`` attaches provenance (cache hits, dispatch reasons,
    row counts) to the open span.
    """

    __slots__ = ("name", "span_id", "parent_id", "tid", "t0", "t1",
                 "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 tid: int, attrs: Dict[str, Any]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid
        self.t0 = 0.0
        self.t1 = 0.0
        self.attrs = attrs

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "tid": self.tid,
                "t0": self.t0, "t1": self.t1,
                "duration_s": self.duration_s, "attrs": dict(self.attrs)}

    # -- context manager ------------------------------------------------------

    def __enter__(self) -> "Span":
        stack = TRACER._stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = time.perf_counter()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        stack = TRACER._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate out-of-order exits
            stack.remove(self)
        TRACER._record(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, "
                f"{self.attrs})")


class _NullSpan:
    """The shared disabled-mode span: every operation is a no-op."""

    __slots__ = ()
    name = ""
    attrs: Dict[str, Any] = {}
    duration_s = 0.0

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-wide span collector (singleton :data:`TRACER`).

    ``on`` is a plain attribute so the disabled-path check in
    :func:`span` is one dict-free attribute read.  Enabling stacks: the
    ``$FLARE_TRACE`` env var counts as one standing enable, and
    :func:`enable`/:func:`capture` add scoped ones.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._env = _env_enabled()
        self._manual = 0
        self._dropped = 0
        self.on = self._env

    # -- enable/disable -------------------------------------------------------

    def _refresh(self) -> None:
        self.on = self._env or self._manual > 0

    def enable(self) -> None:
        with self._lock:
            self._manual += 1
            self._refresh()

    def disable(self) -> None:
        with self._lock:
            self._manual = max(0, self._manual - 1)
            self._refresh()

    def refresh_from_env(self) -> bool:
        """Re-read ``$FLARE_TRACE`` (tests monkeypatch the env)."""
        with self._lock:
            self._env = _env_enabled()
            self._refresh()
        return self.on

    # -- span plumbing --------------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)
            if len(self._spans) > MAX_SPANS:
                drop = len(self._spans) - MAX_SPANS
                del self._spans[:drop]
                self._dropped += drop

    def start(self, name: str, attrs: Dict[str, Any]) -> Span:
        return Span(name, next(self._ids), None,
                    threading.get_ident(), attrs)

    # -- buffer access --------------------------------------------------------

    def watermark(self) -> int:
        """A fence id: spans recorded after this call have
        ``span_id >= watermark()``."""
        return self._peek_id()

    def _peek_id(self) -> int:
        # itertools.count has no peek; burn one id as the fence.
        return next(self._ids)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def since(self, mark: int, tid: Optional[int] = None) -> List[Span]:
        with self._lock:
            out = [s for s in self._spans if s.span_id >= mark]
        if tid is not None:
            out = [s for s in out if s.tid == tid]
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"enabled": self.on, "buffered_spans": len(self._spans),
                    "dropped_spans": self._dropped}


TRACER = Tracer()


def span(name: str, **attrs: Any):
    """Open a span (context manager).  Near-free when tracing is off."""
    if not TRACER.on:
        return NULL_SPAN
    return TRACER.start(name, attrs)


def current_span():
    """The innermost open span of this thread (NULL_SPAN when none or
    disabled) -- lets helpers attach provenance to their caller's span
    without threading the object through."""
    if not TRACER.on:
        return NULL_SPAN
    stack = TRACER._stack()
    return stack[-1] if stack else NULL_SPAN


def enabled() -> bool:
    return TRACER.on


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


# ---------------------------------------------------------------------------
# captured traces
# ---------------------------------------------------------------------------


class Trace:
    """A finished collection of spans (one capture window or one query).

    Offers the tree view: :meth:`roots`, :meth:`children`,
    :meth:`find`, :meth:`tree_str`, :meth:`phase_totals`.
    """

    def __init__(self, spans: List[Span]):
        self.spans = list(spans)
        self._by_id = {s.span_id: s for s in self.spans}

    def __len__(self) -> int:
        return len(self.spans)

    def __iter__(self) -> Iterator[Span]:
        return iter(self.spans)

    def roots(self) -> List[Span]:
        return sorted(
            (s for s in self.spans
             if s.parent_id is None or s.parent_id not in self._by_id),
            key=lambda s: (s.t0, s.span_id))

    def children(self, sp: Span) -> List[Span]:
        return sorted((s for s in self.spans
                       if s.parent_id == sp.span_id),
                      key=lambda s: (s.t0, s.span_id))

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def first(self, name: str) -> Optional[Span]:
        hits = self.find(name)
        return min(hits, key=lambda s: s.t0) if hits else None

    def descendant_names(self, sp: Span) -> set:
        out = set()
        frontier = [sp]
        while frontier:
            node = frontier.pop()
            for c in self.children(node):
                out.add(c.name)
                frontier.append(c)
        return out

    def phase_totals(self) -> Dict[str, Dict[str, Any]]:
        """Per-span-name aggregate: count + total seconds."""
        out: Dict[str, Dict[str, Any]] = {}
        for s in self.spans:
            agg = out.setdefault(s.name, {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += s.duration_s
        for agg in out.values():
            agg["total_s"] = round(agg["total_s"], 6)
        return out

    def tree_str(self, attrs: bool = True, indent: int = 2) -> str:
        lines: List[str] = []

        def fmt(sp: Span, depth: int) -> None:
            pad = " " * (depth * indent)
            ms = sp.duration_s * 1e3
            line = f"{pad}{sp.name:<{max(1, 24 - depth * indent)}}" \
                   f"{ms:>10.3f} ms"
            if attrs and sp.attrs:
                kv = " ".join(f"{k}={_short(v)}"
                              for k, v in sp.attrs.items())
                line += f"  {kv}"
            lines.append(line)
            for c in self.children(sp):
                fmt(c, depth + 1)

        for root in self.roots():
            fmt(root, 0)
        return "\n".join(lines)

    def to_dicts(self) -> List[Dict[str, Any]]:
        return [s.to_dict() for s in self.spans]


def _short(v: Any, limit: int = 48) -> str:
    s = str(v)
    return s if len(s) <= limit else s[:limit - 3] + "..."


class _Capture:
    """``with capture() as trace:`` -- force-enable tracing for the
    block and collect every span finished inside it (all threads)."""

    def __init__(self):
        self.trace = Trace([])
        self._mark = 0

    def __enter__(self) -> Trace:
        TRACER.enable()
        self._mark = TRACER._peek_id()
        return self.trace

    def __exit__(self, exc_type, exc, tb) -> bool:
        spans = TRACER.since(self._mark)
        TRACER.disable()
        self.trace.spans = spans
        self.trace._by_id = {s.span_id: s for s in spans}
        return False


def capture() -> _Capture:
    return _Capture()
