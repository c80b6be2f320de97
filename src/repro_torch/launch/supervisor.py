"""Supervisor: restart-from-checkpoint on failure + straggler watchdog.

A copy of the JAX package's module (pure Python).

Production posture (DESIGN.md section 5): at 512+ chips, "faults are
improbable" (the paper's single-machine assumption) no longer holds, so
the training path keeps full fault tolerance even though the
relational/serving path (per the paper) runs without it.

* ``run_supervised`` wraps the train loop: on any exception it restores
  the latest verified checkpoint and resumes, up to ``max_restarts``.
  Fault injection (``fault_prob``) exercises this path in tests and the
  end-to-end example.
* ``StepWatchdog`` tracks a robust step-time median; a step slower than
  ``threshold x median`` is flagged as a straggler event.  On a real pod
  the handler would trigger the elastic re-mesh path
  (``checkpoint.elastic``) to evict the slow host; here the hook
  records the event and (optionally) calls a user handler.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


class FaultInjected(RuntimeError):
    pass


class StepWatchdog:
    def __init__(self, threshold: float = 3.0, warmup: int = 5):
        self.threshold = threshold
        self.warmup = warmup
        self.times: List[float] = []
        self.events: List[Dict] = []

    def observe(self, step: int, dt: float,
                on_straggler: Optional[Callable] = None) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        hist = sorted(self.times[:-1])
        median = hist[len(hist) // 2]
        if dt > self.threshold * median:
            ev = {"step": step, "dt": dt, "median": median}
            self.events.append(ev)
            if on_straggler is not None:
                on_straggler(ev)
            return True
        return False


def run_supervised(train_once: Callable[[], None],
                   max_restarts: int = 3,
                   on_restart: Optional[Callable[[int, Exception], None]]
                   = None) -> int:
    """Run ``train_once`` to completion, restarting on failure.

    ``train_once`` must be resumable (it restores its own checkpoint).
    Returns the number of restarts consumed."""
    restarts = 0
    while True:
        try:
            train_once()
            return restarts
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 -- any step failure
            restarts += 1
            if on_restart is not None:
                on_restart(restarts, e)
            if restarts > max_restarts:
                raise
            print(f"[supervisor] restart {restarts}/{max_restarts} "
                  f"after {type(e).__name__}: {e}", flush=True)
            time.sleep(0.05)
