"""The query server: admission -> coalesce -> vmap execute -> deferred sync.

Flare section 5 deploys compiled queries as a server inside Spark; this
module is that posture for the stages API.  A :class:`QueryServer`
registers prepared templates (``relational/queries.py:TEMPLATES`` by
default), builds each once per (engine, batch bucket), and serves
concurrent requests by *coalescing*: every ``flush`` drains the
admission queue, groups same-template requests, and executes each group
as ONE vmapped call through :meth:`repro_torch.core.stages.
Compiled.batch`.  Requests get :class:`ServeFuture` handles immediately;
the wait for the device and the copy to the host are deferred until a
requester reads its own result, never paid per batch.  The counterpart
of the JAX package's ``repro.serve.server``.

    server = QueryServer(ctx)
    futs = [server.submit("q6", **b) for b in bindings]
    server.flush()                       # one dispatch per template group
    rows = [f.result().compact() for f in futs]
    server.stats                         # occupancy / coalesce / p50/p99

``start()`` runs the same flush loop on a background thread for callers
that want fire-and-forget submission.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core import engines as ENG
from repro_torch.core import stages as S
from repro_torch.core.dataframe import FlareContext
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.resilience import faults as FZ
from repro_torch.serve.stats import ServeStats

#: Template registries map a name to a factory ``ctx -> DataFrame`` whose
#: plan carries ``param()`` placeholders; resolved lazily so importing the
#: server never forces query construction.
TemplateFactory = Callable[[FlareContext], Any]


class QueueFullError(RuntimeError):
    """Admission refused: the submit queue is at ``max_queue``.

    Typed backpressure -- the caller sheds load or retries after a
    flush instead of the queue growing without bound.
    """


class NotDispatchedError(TimeoutError):
    """``ServeFuture.result(timeout)`` expired while the request was
    still queued: no flush ran in time.  The request is still pending;
    call ``QueryServer.flush()`` (or ``start()`` a worker) and read the
    future again."""


class SyncTimeoutError(TimeoutError):
    """``ServeFuture.result(timeout)`` expired AFTER dispatch: the
    batch executed but the device had not produced this request's
    value within the budget.  The computation is still in flight;
    reading the future again with a longer timeout can succeed."""


class DeadlineExceededError(TimeoutError):
    """The request's ``deadline_s`` passed before its batch dispatched;
    the server cancelled it at flush without executing anything."""


class ServeFuture:
    """A request's handle: resolves to the request's own slice of a
    coalesced batch.

    ``result()`` blocks until the server has dispatched the request's
    batch AND the device value is materialised -- the sync happens here,
    per request, not in the server's flush loop.  The recorded latency
    spans submit -> first materialisation, so batched serving is judged
    by what each requester observed.
    """

    def __init__(self, stats: ServeStats, submit_t: float,
                 deadline_t: Optional[float] = None):
        self._dispatched = threading.Event()
        self._handle: Optional[S.AsyncResult] = None
        self._error: Optional[BaseException] = None
        self._stats = stats
        self._submit_t = submit_t
        #: absolute ``perf_counter`` admission deadline (None = none):
        #: the server cancels the request at flush if it passes
        self._deadline_t = deadline_t
        self._latency_recorded = False
        self._lock = threading.Lock()

    def _assign(self, handle: S.AsyncResult) -> None:
        self._handle = handle
        self._dispatched.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._dispatched.set()

    def dispatched(self) -> bool:
        """True once the server has executed this request's batch (the
        result may still be an un-synced device value)."""
        return self._dispatched.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """The request's :class:`repro_torch.core.lower.Result` (blocks).

        ``timeout`` covers the whole wait and the failure mode is
        typed by *phase*: :class:`NotDispatchedError` when no flush
        dispatched the request in time (nothing ran; flush and retry),
        :class:`SyncTimeoutError` when the batch executed but the
        device had not delivered this request's value yet (still in
        flight; a later read can succeed).  Both subclass
        ``TimeoutError``.
        """
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        if not self._dispatched.wait(timeout):
            raise NotDispatchedError(
                f"request not dispatched within {timeout}s; call "
                f"QueryServer.flush() or start() a worker")
        if self._error is not None:
            raise self._error
        t_sync = time.perf_counter()
        with OT.span("serve.sync"):
            if deadline is None:
                out = self._handle.result()
            else:
                out = self._sync_before(deadline)
        with self._lock:
            if not self._latency_recorded:
                self._latency_recorded = True
                now = time.perf_counter()
                self._stats.record_latency(now - self._submit_t)
                self._stats.record_sync(now - t_sync)
        return out

    def _sync_before(self, deadline: float) -> Any:
        """Materialise within the remaining budget: poll the handle's
        readiness probe (a CUDA event query, non-blocking) and only pay
        the copy once the device value exists."""
        step = 0.0005
        while not self._handle.ready():
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                raise SyncTimeoutError(
                    "request dispatched but device sync did not "
                    "complete in time; the batch is still in flight -- "
                    "read the future again with a longer timeout")
            time.sleep(min(step, remaining))
            step = min(step * 2, 0.01)
        return self._handle.result()

    def compact(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        return self.result(timeout).compact()

    def __repr__(self):
        if not self._dispatched.is_set():
            return "ServeFuture<queued>"
        return "ServeFuture<failed>" if self._error else "ServeFuture<dispatched>"


class _Request:
    __slots__ = ("name", "params", "future")

    def __init__(self, name: str, params: Dict[str, Any],
                 future: ServeFuture):
        self.name = name
        self.params = params
        self.future = future


class QueryServer:
    """Multi-tenant prepared-query server over a :class:`FlareContext`.

    ``templates`` maps names to template factories (defaults to the
    TPC-H ``TEMPLATES`` registry).  Each template compiles lazily on
    first use and is cached in the context's :class:`CompileCache` --
    base executor under the template fingerprint, batched programs
    under ``fingerprint + ("batch", bucket)`` -- so restarting the
    server against the same context rebuilds nothing.

    ``max_batch`` caps coalescing (a full queue splits into chunks);
    ``engine`` must support vmap batching (see
    ``stages._BATCHABLE_ENGINES``).

    ``max_queue`` bounds admission: a submit against a full queue
    raises :class:`QueueFullError` (typed backpressure -- counted in
    ``stats.rejected``) instead of letting the queue grow without
    bound; None disables the bound.  Requests can carry a
    ``deadline_s``; a request whose deadline passes while still queued
    is cancelled cleanly at the next flush
    (:class:`DeadlineExceededError` on its future, nothing executed).

    A failing coalesced dispatch is bisected: the server retries ever
    smaller halves until the poison request(s) are isolated, so one bad
    binding fails only its own :class:`ServeFuture` instead of every
    waiter in the batch (``stats.bisects``/``poisoned``).
    """

    def __init__(self, ctx: FlareContext,
                 templates: Optional[Dict[str, TemplateFactory]] = None,
                 engine: str = "compiled", max_batch: int = 64,
                 join_index: Optional[bool] = None,
                 warm_start: bool = False,
                 max_queue: Optional[int] = 10_000):
        if templates is None:
            from repro_torch.relational.queries import TEMPLATES
            templates = TEMPLATES
        self.ctx = ctx
        self.engine = engine
        self.max_batch = max(1, int(max_batch))
        self.max_queue = max_queue if max_queue is None else int(max_queue)
        self.join_index = join_index
        self.templates = dict(templates)
        self.stats = ServeStats()
        self._compiled: Dict[str, S.Compiled] = {}
        self._queue: List[_Request] = []
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        OM.REGISTRY.register("serve", self)
        if warm_start:
            self.preload()

    # -- template management -------------------------------------------------

    def compiled_for(self, name: str) -> S.Compiled:
        """The (cached) :class:`Compiled` serving template ``name``."""
        got = self._compiled.get(name)
        if got is None:
            try:
                factory = self.templates[name]
            except KeyError:
                raise KeyError(f"unknown template {name!r}; registered: "
                               f"{sorted(self.templates)}") from None
            kwargs = {} if self.join_index is None else {
                "join_index": self.join_index}
            got = factory(self.ctx).lower(engine=self.engine,
                                          **kwargs).compile()
            self._compiled[name] = got
        return got

    def warmup(self, buckets: Iterable[int] = (1,)) -> None:
        """Pre-compile every template for the given batch buckets, so
        serving traffic never pays a compile."""
        for name in self.templates:
            compiled = self.compiled_for(name)
            if not compiled.params():
                continue
            for b in buckets:
                compiled._batch_executor(ENG.batch_bucket(b))

    def preload(self, buckets: Iterable[int] = (1,)) -> int:
        """Ready the whole template set at startup: :meth:`warmup` with
        its startup telemetry attached.  ``stats.preloaded`` and
        ``preload_s`` record what happened (``QueryServer(ctx,
        warm_start=True)`` runs this from the constructor).  Returns the
        number of templates readied.

        ``stats.disk_hits`` counts programs served from a persistent
        store; the port has none yet, so it stays 0 -- what the JAX
        package counts with no ``$FLARE_CACHE_DIR``.
        """
        t0 = time.perf_counter()
        for name in sorted(self.templates):
            compiled = self.compiled_for(name)
            if compiled.params():
                for b in buckets:
                    compiled._batch_executor(ENG.batch_bucket(b))
            self.stats.preloaded += 1
        self.stats.preload_s += time.perf_counter() - t0
        return self.stats.preloaded

    # -- admission -----------------------------------------------------------

    def submit(self, name: str, deadline_s: Optional[float] = None,
               **params: Any) -> ServeFuture:
        """Admit one request; returns immediately with a future.

        Raises :class:`QueueFullError` when the queue is at
        ``max_queue``.  ``deadline_s`` (seconds from now) bounds how
        long the request may sit queued: past it, the next flush
        cancels the request instead of dispatching it.  ``deadline_s``
        is reserved (like ``block`` on ``Compiled.__call__``); a
        template parameter of that name must bind through
        :meth:`serve`.
        """
        return self._admit(name, params, deadline_s)

    def _admit(self, name: str, params: Dict[str, Any],
               deadline_s: Optional[float]) -> ServeFuture:
        now = time.perf_counter()
        fut = ServeFuture(self.stats, now,
                          None if deadline_s is None else now + deadline_s)
        req = _Request(name, params, fut)
        with OT.span("serve.submit", template=name) as sp:
            with self._lock:
                if (self.max_queue is not None
                        and len(self._queue) >= self.max_queue):
                    self.stats.rejected += 1
                    OM.REGISTRY.inc("serve.rejected")
                    sp.set(outcome="rejected")
                    raise QueueFullError(
                        f"admission queue full ({self.max_queue} "
                        f"requests); flush() or shed load")
                self._queue.append(req)
                self.stats.submitted += 1
                depth = len(self._queue)
                if depth > self.stats.max_queue_depth:
                    self.stats.max_queue_depth = depth
            sp.set(queue_depth=depth)
        return fut

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- coalesced execution -------------------------------------------------

    def flush(self) -> int:
        """Drain the queue: same-template requests coalesce into one
        vmapped dispatch each (chunked at ``max_batch``).  Returns the
        number of requests dispatched.  Safe to call concurrently with
        ``submit``; requests admitted mid-flush wait for the next one.
        """
        with self._lock:
            batch, self._queue = self._queue, []
        if not batch:
            return 0
        now = time.perf_counter()
        live: List[_Request] = []
        for req in batch:
            dl = req.future._deadline_t
            if dl is not None and now > dl:
                # cancel cleanly: nothing dispatched, nothing shared
                self.stats.deadline_expired += 1
                OM.REGISTRY.inc("serve.deadline_expired")
                req.future._fail(DeadlineExceededError(
                    f"deadline expired {now - dl:.3f}s before dispatch "
                    f"of template {req.name!r}"))
            else:
                live.append(req)
        if not live:
            return 0
        with OT.span("serve.flush", drained=len(batch)) as sp:
            groups: Dict[str, List[_Request]] = {}
            for req in live:
                groups.setdefault(req.name, []).append(req)
            sp.set(groups=len(groups))
            for name, reqs in groups.items():
                for i in range(0, len(reqs), self.max_batch):
                    self._dispatch(name, reqs[i:i + self.max_batch])
        return len(live)

    def _dispatch(self, name: str, reqs: List[_Request]) -> None:
        now = time.perf_counter()
        for r in reqs:  # admission-queue wait, from the request's seat
            self.stats.record_queue(now - r.future._submit_t)
        self._dispatch_isolating(name, reqs)

    def _dispatch_isolating(self, name: str, reqs: List[_Request]) -> None:
        """Dispatch one group; on failure, bisect to isolate poison.

        A coalesced vmapped dispatch fails as a unit, but one bad
        binding must not fail every waiter: the failing group is split
        in half and each half retried, recursively, until the poison
        request(s) stand alone -- every healthy request completes
        normally, every poisoned one gets the typed error on its OWN
        future.  log2(batch) extra dispatches in the worst case, zero
        on the happy path.
        """
        try:
            with OT.span("serve.dispatch", template=name,
                         requests=len(reqs)) as sp:
                FZ.fault_point("serve.dispatch", template=name)
                compiled = self.compiled_for(name)
                c0 = compiled.stats.compile_s
                handles = compiled.batch([r.params for r in reqs],
                                         block=False)
                bucket = (ENG.batch_bucket(len(reqs))
                          if compiled.params() else len(reqs))
                sp.set(bucket=bucket,
                       occupancy=round(len(reqs) / max(1, bucket), 4))
            self.stats.record_batch(len(reqs), bucket,
                                    compiled.stats.compile_s - c0,
                                    compiled.stats.run_s)
        except Exception as err:
            if len(reqs) == 1:  # isolated: fail ONLY this waiter
                self.stats.poisoned += 1
                OM.REGISTRY.inc("serve.poisoned")
                reqs[0].future._fail(err)
                return
            self.stats.bisects += 1
            OM.REGISTRY.inc("serve.bisect")
            with OT.span("serve.bisect", template=name,
                         requests=len(reqs), error=type(err).__name__):
                pass
            mid = len(reqs) // 2
            self._dispatch_isolating(name, reqs[:mid])
            self._dispatch_isolating(name, reqs[mid:])
            return
        for r, h in zip(reqs, handles):
            r.future._assign(h)

    def serve(self, requests: Iterable[Tuple[str, Dict[str, Any]]],
              block: bool = True) -> List[Any]:
        """Admit ``(name, params)`` pairs, flush once, and return one
        result (or un-materialised future, ``block=False``) per request
        in submission order.  Params bind verbatim here (no reserved
        names), so a template parameter called ``deadline_s`` is only
        bindable through this path."""
        futs = [self._admit(name, dict(params), None)
                for name, params in requests]
        self.flush()
        return [f.result() for f in futs] if block else futs

    # -- background worker ---------------------------------------------------

    def start(self, interval_s: float = 0.001) -> "QueryServer":
        """Run the flush loop on a daemon thread every ``interval_s``;
        ``submit`` alone then suffices for callers."""
        if self._worker is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.flush()
                self._stop.wait(interval_s)
            self.flush()  # drain whatever arrived before stop

        self._worker = threading.Thread(target=loop, daemon=True,
                                        name="repro-torch-serve-flush")
        self._worker.start()
        return self

    def stop(self) -> None:
        if self._worker is None:
            return
        self._stop.set()
        self._worker.join()
        self._worker = None

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- telemetry -----------------------------------------------------------

    def telemetry(self) -> Dict[str, Any]:
        """One snapshot: serve counters, process-wide cache aggregates
        (:func:`repro_torch.core.engines.cache_stats`), and per-template
        compile/dispatch state."""
        templates = {}
        for name, compiled in self._compiled.items():
            st = compiled.stats
            entry = {
                "engine": compiled.engine_name,
                "compile_s": round(st.compile_s, 6),
                "cache_hit": st.cache_hit,
            }
            report = st.dispatch
            if report is not None:
                entry["dispatch"] = {
                    "fired": [d.pattern for d in report.fired],
                    "index": [(d.pattern, d.fired)
                              for d in report.index_decisions],
                }
            templates[name] = entry
        return {
            "serve": self.stats.to_dict(),
            "caches": ENG.cache_stats(),
            "templates": templates,
        }

    def __repr__(self):
        return (f"QueryServer(templates={sorted(self.templates)}, "
                f"engine={self.engine!r}, queued={self.queue_depth()}, "
                f"served={self.stats.completed})")
