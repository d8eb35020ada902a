"""Continuous-batching window controller (the adaptive dispatch tier); a
copy of ``srnn_tpu/serve/controller.py``.

A fixed-window dispatcher sleeps a FIXED ``--batch-window-s`` (250ms) before
every drain, so at light load p50 is window-bound and throughput
freezes at the window's rate no matter how fast the executors get.
This module closes that control loop: the signals already exist — the per-ticket ``serve_ticket_{queue,window,
dispatch}_seconds`` breakdown and the SLO counter the
``serve_slo_burn`` alert rate-watches — and the controller turns them
into the one knob the dispatcher owns, the batching window.

Control law (per scheduler group — the static spelling IS the batching
domain, so each spelling earns its own window):

  * a group's window STARTS at the floor: the first tickets of a
    spelling dispatch near-immediately (continuous batching — first-
    ticket latency is dispatch-bound, not window-bound);
  * every retired dispatch reports its SLO-violation count (the same
    per-ticket ``latency > --slo-p95-ms`` predicate that feeds
    ``serve_slo_violations_total``, i.e. the burn rule's
    numerator).  A burning round SHRINKS the window multiplicatively
    (halve, clamp at the floor): under SLO pressure, stop waiting for
    stackmates and ship;
  * a clean round GROWS the window multiplicatively toward the
    ``--batch-window-s`` CEILING: headroom against the SLO is spent on
    wider stacks (amortization), and a service idling back to quiet
    recovers its full stacking window one clean round at a time.

Determinism contract: the controller's state is a pure fold over the
observed ``(group, violations)`` dispatch-retire sequence — no clocks,
no randomness — so the same ticket arrival trace (same admissions, same
measured outcomes) yields the same window sequence, replayable by the
chaos harness like every other recovery ladder.

The fixed-window dispatcher remains available as the A/B oracle
(``--no-adaptive``): with the controller off, the serve tier runs
exactly the fixed-window code path and reproduces its results bitwise — the
``--no-spans``/``--no-costs``/``--no-export`` discipline, asserted in
``tests/test_torch_serve_scale.py``.
"""

import threading
from typing import Dict, Hashable, Optional, Sequence

#: multiplicative shrink on a burning round: halving reaches the floor
#: from any ceiling in <10 rounds, fast enough that a burst's tail does
#: not keep paying the window that made its head violate
SHRINK = 0.5

#: multiplicative growth on a clean round: gentler than the shrink
#: (MIMD-style — back off hard, recover gently) so one clean round
#: cannot bounce the window straight back into burn territory
GROW = 1.5

#: the smallest window the controller will ask the dispatcher to sleep:
#: below ~1ms the sleep syscall itself is the wait, and 0 would turn the
#: dispatch loop into a spin between back-to-back singleton dispatches
DEFAULT_FLOOR_S = 1e-3

#: per-group state cap: group keys are static spellings, so a long-lived
#: service fed ever-fresh configs could otherwise grow without bound;
#: past the cap the OLDEST group's state evicts (deterministic — and a
#: re-seen group simply restarts at the floor, the cold-start behavior)
MAX_GROUPS = 256


class AdaptiveWindowController:
    """Per-group adaptive batching windows for one dispatch loop.

    Thread-safety: ``window_s`` / ``observe_dispatch`` run on the
    dispatch thread; ``snapshot`` is read from stats/watch handler
    threads — the lock keeps the state dict consistent, not the law
    (which only ever folds on the dispatch thread)."""

    def __init__(self, ceiling_s: float, slo_p95_ms: float = 0.0,
                 floor_s: float = DEFAULT_FLOOR_S,
                 shrink: float = SHRINK, grow: float = GROW):
        self.ceiling_s = max(0.0, float(ceiling_s))
        self.slo_p95_ms = max(0.0, float(slo_p95_ms))
        self.floor_s = min(max(0.0, float(floor_s)), self.ceiling_s) \
            if self.ceiling_s > 0 else 0.0
        self.shrink = float(shrink)
        self.grow = float(grow)
        self._lock = threading.Lock()
        self._windows: Dict[Hashable, float] = {}

    def _get(self, group: Hashable) -> float:
        if group not in self._windows:
            while len(self._windows) >= MAX_GROUPS:
                self._windows.pop(next(iter(self._windows)))
            self._windows[group] = self.floor_s
        return self._windows[group]

    def window_s(self, groups: Sequence[Hashable]) -> float:
        """The wait the dispatcher performs before the next drain: the
        MINIMUM over the pending groups' windows — one group under SLO
        pressure must not sit out a calmer group's stacking window (the
        drain dispatches every group either way; the wait only bounds
        how long the tightest group's tickets age before it)."""
        with self._lock:
            if not groups:
                return self.floor_s
            return min(self._get(g) for g in groups)

    def observe_dispatch(self, group: Hashable, violations: int,
                         completed: int) -> float:
        """Fold one retired dispatch into the group's window and return
        the new value.  ``violations`` is the dispatch's share of the
        SLO counter (the burn rule's numerator); with no SLO target it
        is always 0 and the window simply grows to the ceiling — the
        fixed-window behavior, reached instead of configured."""
        with self._lock:
            w = self._get(group)
            if violations > 0:
                w = max(self.floor_s, w * self.shrink)
            elif completed > 0:
                w = min(self.ceiling_s, max(self.floor_s, w * self.grow))
            self._windows[group] = w
            return w

    def snapshot(self) -> dict:
        """Stats/watch view: group count plus the min/max live windows
        (the per-group keys are config objects — summarized, not
        serialized)."""
        with self._lock:
            ws = list(self._windows.values())
        return {"adaptive": True,
                "ceiling_s": self.ceiling_s,
                "floor_s": self.floor_s,
                "slo_p95_ms": self.slo_p95_ms or None,
                "groups": len(ws),
                "window_min_s": round(min(ws), 6) if ws else None,
                "window_max_s": round(max(ws), 6) if ws else None}


def make_controller(batch_window_s: float, slo_p95_ms: float,
                    adaptive: bool = True) \
        -> Optional[AdaptiveWindowController]:
    """The ``__main__``/bench construction helper: ``adaptive=False``
    (the ``--no-adaptive`` oracle) returns None and the dispatcher runs
    the fixed-window path verbatim."""
    if not adaptive:
        return None
    return AdaptiveWindowController(ceiling_s=batch_window_s,
                                    slo_p95_ms=slo_p95_ms)
