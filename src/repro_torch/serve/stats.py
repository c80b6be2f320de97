"""Serving telemetry: the numbers that justify coalescing.

Flare's deployment mode (paper section 5) lives or dies on amortisation:
compile once, batch many.  :class:`ServeStats` measures exactly that --
how full the coalesced batches ran (occupancy), how many device
dispatches the queue saved (coalesce ratio), what the requests actually
observed (p50/p99 latency), and where the time went (compile vs run).
A copy of the JAX package's ``repro.serve.stats``: the same counters and
percentiles on the same lists.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (no numpy dependency at import time:
    stats must stay readable from a monitoring thread)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = min(len(ordered) - 1, max(0, int(round(q / 100.0 * (len(ordered) - 1)))))
    return ordered[rank]


@dataclasses.dataclass
class ServeStats:
    """Counters for one :class:`repro_torch.serve.QueryServer`.

    ``submitted``/``completed`` count requests; ``batches`` counts
    device dispatches (one vmapped program per batch); ``occupancy_sum``
    accumulates per-batch ``len(batch)/bucket`` so
    :meth:`batch_occupancy` reports how much of each compiled bucket was
    live work rather than ragged padding.  Latencies are recorded per
    request at first result materialisation (submit -> host value), so
    the deferred-sync path is measured from the requester's seat.

    The resilience counters measure behavior under failure:
    ``rejected`` (admissions refused by the bounded queue),
    ``deadline_expired`` (requests cancelled at flush, never
    dispatched), ``bisects`` (failing coalesced dispatches split to
    isolate poison) and ``poisoned`` (requests whose OWN dispatch
    failed after isolation -- the only ones that see an error).

    ``preloaded``/``disk_hits``/``preload_s`` describe startup: how many
    templates :meth:`repro_torch.serve.QueryServer.preload` readied, how
    many executables came from a persistent store instead of being built
    (0 until the port has one), and what the warm start cost.
    """

    submitted: int = 0
    completed: int = 0
    batches: int = 0
    occupancy_sum: float = 0.0
    max_queue_depth: int = 0
    compile_s: float = 0.0
    run_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    #: Per-request admission-queue wait: submit -> batch dispatch.
    queue_s: List[float] = dataclasses.field(default_factory=list)
    #: Per-request deferred-sync cost: first ``result()`` -> host value.
    sync_s: List[float] = dataclasses.field(default_factory=list)
    preloaded: int = 0
    disk_hits: int = 0
    preload_s: float = 0.0
    rejected: int = 0
    deadline_expired: int = 0
    bisects: int = 0
    poisoned: int = 0

    def record_batch(self, size: int, bucket: int,
                     compile_s: float, run_s: float) -> None:
        self.batches += 1
        self.occupancy_sum += size / max(1, bucket)
        self.compile_s += compile_s
        self.run_s += run_s

    def record_latency(self, seconds: float) -> None:
        self.completed += 1
        self.latencies_s.append(seconds)

    def record_queue(self, seconds: float) -> None:
        self.queue_s.append(seconds)

    def record_sync(self, seconds: float) -> None:
        self.sync_s.append(seconds)

    # -- derived -------------------------------------------------------------

    def coalesce_ratio(self) -> float:
        """Fraction of submitted requests that did NOT need their own
        device dispatch: ``1 - batches/submitted``.  0.0 means purely
        sequential serving; 8 requests coalesced into one batch give
        0.875."""
        if self.submitted == 0:
            return 0.0
        return 1.0 - self.batches / self.submitted

    def batch_occupancy(self) -> float:
        """Mean live fraction of the compiled batch buckets (1.0 means
        no ragged padding ever ran)."""
        if self.batches == 0:
            return 0.0
        return self.occupancy_sum / self.batches

    def p50_s(self) -> float:
        return percentile(self.latencies_s, 50)

    def p95_s(self) -> float:
        return percentile(self.latencies_s, 95)

    def p99_s(self) -> float:
        return percentile(self.latencies_s, 99)

    @staticmethod
    def _pcts_ms(values: List[float]) -> Dict[str, float]:
        return {f"p{q}_ms": round(percentile(values, q) * 1e3, 3)
                for q in (50, 95, 99)}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "batches": self.batches,
            "coalesce_ratio": round(self.coalesce_ratio(), 4),
            "batch_occupancy": round(self.batch_occupancy(), 4),
            "max_queue_depth": self.max_queue_depth,
            "compile_s": round(self.compile_s, 6),
            "run_s": round(self.run_s, 6),
            "p50_ms": round(self.p50_s() * 1e3, 3),
            "p95_ms": round(self.p95_s() * 1e3, 3),
            "p99_ms": round(self.p99_s() * 1e3, 3),
            # request-seat latency decomposition: admission-queue wait
            # and deferred device sync, each with its own percentiles
            "queue": self._pcts_ms(self.queue_s),
            "sync": self._pcts_ms(self.sync_s),
            "preloaded": self.preloaded,
            "disk_hits": self.disk_hits,
            "preload_s": round(self.preload_s, 6),
            "rejected": self.rejected,
            "deadline_expired": self.deadline_expired,
            "bisects": self.bisects,
            "poisoned": self.poisoned,
        }

    def __repr__(self):
        d = self.to_dict()
        body = ", ".join(f"{k}={v}" for k, v in d.items())
        return f"ServeStats({body})"
