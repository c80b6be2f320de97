"""Graceful engine degradation: a fault costs latency, never a wrong
answer or availability.

When the compilation or execution of a template fails with an error on
the closed *recoverable allowlist*, the template is re-lowered on the
next rung of the ladder::

    compiled-native -> compiled -> stage -> volcano

Each hop records a :class:`DegradeEvent` -- an obs counter
(``degrade.events`` + per-transition), a ``degrade`` trace span, and a
provenance entry on ``CompileStats.degraded`` -- so a degraded answer is
never silent.  The re-lower starts from the pre-rewrite plan the front
end handed to ``lower_plan`` (stashed as ``_degrade_src``), so native
annotation is redone for the weaker rung rather than patched around.
The JAX package's ``parallel -> compiled`` rung arrives with
``core/parallel.py``.

The allowlist is the port's own, and it is closed (:func:`recoverable`).
It must not hide a kernel: a hop from ``compiled-native`` to ``compiled``
on a failed kernel would answer correctly from the generic lowering while
the kernel never ran.  So it holds only errors raised *before* any
launch, by checks that a weaker rung does not need:

* :class:`repro_torch.kernels.KernelBudgetError`, in the compile phase
  only -- an eligibility or geometry check refused a fragment while the
  template was prepared; the generic lowering computes the same answer.
  At execute time the same type comes from a kernel wrapper's argument
  checks at launch (``check_columns``, ``check_mask`` and their kin),
  which means the port handed a prepared kernel wrong tensors: that is
  a fault of the port, and it raises, so the kernel cannot quietly stop
  running;
* :class:`repro_torch.resilience.faults.CompileFault` -- the build of
  this rung's program failed at its fault site;
* :class:`repro_torch.resilience.faults.IndexBuildError` -- the join-index
  infrastructure failed; weaker rungs sort in the program;
* persist ``StoreCorrupt`` / ``StoreVersionMiss`` -- a disk artifact is
  untrustworthy; rebuilding from the plan is always correct.

Off the list, so they raise typed with the ladder on: an nvcc failure
(:class:`repro_torch.kernels.cuda_build.UnitBuildError`), a CUDA launch
error, any ``torch.cuda`` error (after an illegal address the CUDA
context is unusable anyway), :class:`repro_torch.kernels.
UnsupportedDeviceError` (no kernel for the device), and every
wrong-answer class -- binding ``TypeError``s, ``ValueError``s, assertion
and arithmetic errors.  :class:`repro_torch.core.morsel.MemoryBudgetError`
stays off too: a memory budget is the caller's request, which a rung
without it would ignore.  The JAX package's ``XlaRuntimeError`` entry, its
real compile or runtime failure, has no counterpart on the list.

Policy knob: ``FLARE_DEGRADE=off`` disables the ladder (faults raise
typed errors); ``auto`` (default) enables it.  The knob is read
per-failure, so tests can flip it without re-importing.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.resilience.faults import CompileFault, IndexBuildError

#: engine -> next (weaker) rung.  volcano is the floor: it interprets the
#: logical plan on the host with no kernels, no device and no store.
LADDER: Dict[str, str] = {
    "compiled-native": "compiled",
    "compiled": "stage",
    "stage": "volcano",
}


def enabled() -> bool:
    """``FLARE_DEGRADE=off`` disables the ladder; ``auto`` (default, any
    other value) enables it.  Read per-failure."""
    return os.environ.get("FLARE_DEGRADE", "auto").lower() != "off"


def recoverable(err: BaseException, phase: str = "compile") -> bool:
    """Membership in the closed allowlist of errors the ladder may
    absorb in ``phase`` ("compile" or "execute").  Anything else
    propagates typed.  ``KernelBudgetError`` is on the list only while a
    template compiles: at execute time it is a kernel wrapper refusing
    its arguments at launch."""
    from repro_torch.kernels import KernelBudgetError
    from repro_torch.persist.store import StoreCorrupt, StoreVersionMiss
    if isinstance(err, KernelBudgetError):
        return phase == "compile"
    return isinstance(err, (CompileFault, IndexBuildError,
                            StoreCorrupt, StoreVersionMiss))


@dataclasses.dataclass
class DegradeEvent:
    """One recorded hop down the ladder."""

    frm: str
    to: str
    phase: str            # "compile" | "execute"
    error_type: str
    message: str
    wall_time: float

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_LOCK = threading.Lock()
_EVENTS: deque = deque(maxlen=256)


def events() -> Tuple[DegradeEvent, ...]:
    """Recent degradation events, oldest first (bounded ring)."""
    with _LOCK:
        return tuple(_EVENTS)


def clear_events() -> None:
    with _LOCK:
        _EVENTS.clear()


def _record(frm: str, to: str, phase: str,
            err: BaseException) -> DegradeEvent:
    ev = DegradeEvent(frm=frm, to=to, phase=phase,
                      error_type=type(err).__name__,
                      message=str(err)[:200], wall_time=time.time())
    with _LOCK:
        _EVENTS.append(ev)
    OM.REGISTRY.inc("degrade.events")
    OM.REGISTRY.inc(f"degrade.{frm}->{to}")
    OM.REGISTRY.inc(f"degrade.error.{ev.error_type}")
    with OT.span("degrade", frm=frm, to=to, phase=phase,
                 error=ev.error_type):
        pass
    return ev


def _rung_kwargs(src: Dict[str, Any], rung: str) -> Dict[str, Any]:
    """Re-lower kwargs for a weaker rung: native annotation is shed (that
    is what degrading means); the morsel budget survives onto the
    ``compiled`` rung only (the stage and interpreted rungs take no
    budget); the context's device and compile caches and the join-index
    preference carry over."""
    out_of_core = rung == "compiled"
    return dict(engine=rung, device_cache=src["device_cache"],
                compile_cache=src["compile_cache"], native=False,
                join_index=src.get("join_index", True),
                memory_budget=(src.get("memory_budget") if out_of_core
                               else None),
                morsel_rows=src.get("morsel_rows") if out_of_core else None)


def next_lowered(src: Optional[Dict[str, Any]], frm: str,
                 err: BaseException, phase: str):
    """The fallback ``Lowered`` for a failure of engine ``frm``, or
    ``(None, None)`` when the ladder must not engage (policy off, error
    not on the allowlist, no re-lower source, or floor reached).

    Descends past rungs whose own re-lower fails recoverably; a
    non-recoverable re-lower failure abandons degradation so the caller
    re-raises the original error.
    """
    if src is None or not enabled() or not recoverable(err, phase):
        return None, None
    from repro_torch.core import stages as S
    rung = frm
    while True:
        nxt = LADDER.get(rung)
        if nxt is None:
            return None, None
        try:
            low = S.lower_plan(src["plan"], src["catalog"],
                               **_rung_kwargs(src, nxt))
        except Exception as relow_err:
            if recoverable(relow_err):
                rung = nxt
                continue
            return None, None
        return low, _record(frm, nxt, phase, err)


def stats() -> Dict[str, Any]:
    """Degradation telemetry for ``obs.snapshot()``."""
    evs = events()
    transitions: Dict[str, int] = {}
    for ev in evs:
        k = f"{ev.frm}->{ev.to}"
        transitions[k] = transitions.get(k, 0) + 1
    return {
        "enabled": enabled(),
        "events": len(evs),
        "transitions": transitions,
        "recent": [ev.to_dict() for ev in evs[-8:]],
    }
