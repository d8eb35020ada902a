"""Deterministic, schedule-driven fault injection for the run supervisor;
port of ``srnn_tpu/resilience/chaos.py`` for one process on one card.

``ChaosMonkey`` arms a fixed schedule of faults that fire at exact,
reproducible points of a mega run:

  * ``device_loss@G`` -- raise, at the top of the chunk starting at
    generation ``G``, the exception a CUDA runtime failure surfaces as
    (``torch.AcceleratorError`` where torch has it, else a
    ``RuntimeError`` reading "CUDA error: ..."), so that the supervisor's
    own ``classify_fault`` reads it as ``device_loss``.  Nothing touches
    the card: the CUDA context stays usable, the supervisor's card probe
    passes, and the run restarts in-process.
  * ``stall@G[:HOLD_S]`` -- condemn the finisher of the chunk covering
    generation ``G``: it blocks (an hour by default) until the supervisor
    aborts it, so that the armed ``--stall-timeout-s`` deadline raises the
    real ``StallError``.  The condemned finisher never runs.
  * ``writer@N`` -- poison the ``N``-th job submitted to the background
    writer (1-based, counted per attempt) with a permanent ``EIO``.
  * ``sigterm@G`` -- ``kill(self, SIGTERM)`` at the chunk boundary: the
    real signal, handler and graceful drain.
  * ``sigkill@G`` -- ``kill(self, SIGKILL)``: no cleanup of any kind.

The experiment service's events (``serve``; the service arms them with
its ``--chaos`` flag and calls :meth:`ChaosMonkey.note_submit` /
:meth:`ChaosMonkey.serve_dispatch` from its admission and dispatch
paths):

  * ``serve_kill@N`` -- ``kill(self, SIGKILL)`` at the top of the
    ``N``-th dispatch attempt (1-based): the admitted tickets are
    journaled but unfinished, the drill a restart replays.
  * ``serve_dispatch_fault@N:kind`` -- raise the classified fault
    ``kind`` (one of :data:`SERVE_FAULT_KINDS`: ``device_loss`` as a CUDA
    runtime error, ``io`` as an ``EIO`` ``OSError``, ``stall`` as a
    ``StallError``) at the ``N``-th dispatch attempt, which the service
    retries.
  * ``serve_poison_tenant@N`` -- the ``N``-th admitted ticket (1-based;
    journal replays are admitted first) is poisoned: every dispatch
    attempt that holds it raises a deterministic (fatal) error, so the
    service's bisection must isolate it.

Every event fires once per process; an in-process restart keeps the
consumed schedule.  The schedule is not saved into ``config.json``.
:func:`parse_schedule` reads the JAX package's grammar (``kind@N[:arg]``,
comma-separated) and refuses what waits for multi-GPU runs, naming the
ROADMAP.md item: the survivor count ``device_loss@G:S`` and the slice
events ``host_loss`` / ``coordinator_timeout`` (A.6).
"""

from __future__ import annotations

import errno
import os
import signal
import threading
from typing import Callable, List, Optional

KINDS = ("device_loss", "stall", "writer", "sigterm", "sigkill",
         "serve_kill", "serve_dispatch_fault", "serve_poison_tenant")

#: the ``serve_dispatch_fault`` menu: retryable kinds by the supervisor's
#: taxonomy
SERVE_FAULT_KINDS = ("device_loss", "io", "stall")

#: the JAX package's kinds that wait for other tiers, with the ROADMAP.md
#: item that brings them
WAITING = {
    "host_loss": "A.6 (multi-GPU runs: slice groups)",
    "coordinator_timeout": "A.6 (multi-GPU runs: the coordinator)",
}

#: events whose ordinal ``N`` is 1-based
_ONE_BASED = ("writer", "serve_kill", "serve_dispatch_fault",
              "serve_poison_tenant")

#: how long a condemned finisher holds before giving up on an abort
DEFAULT_STALL_HOLD_S = 3600.0


class ChaosEvent:
    __slots__ = ("kind", "at", "arg", "fired")

    def __init__(self, kind: str, at: int, arg=None):
        self.kind = kind
        self.at = int(at)   # generation (writer / serve_*: 1-based ordinal)
        self.arg = arg      # float, a serve fault kind, or None
        self.fired = False

    def __repr__(self):
        if isinstance(self.arg, float):
            suffix = f":{self.arg:g}"
        elif self.arg is not None:
            suffix = f":{self.arg}"
        else:
            suffix = ""
        return (f"ChaosEvent({self.kind}@{self.at}{suffix}"
                + (" fired" if self.fired else "") + ")")


def parse_schedule(spec: str) -> List[ChaosEvent]:
    """Parse ``kind@N[:arg],...`` (module docstring), sorted by ``N``.
    Raises ``ValueError`` on an unknown kind, a malformed entry, or an
    event that waits for another tier (naming its ROADMAP.md item)."""
    events = []
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        kind = entry.split("@", 1)[0]
        if kind in WAITING:
            raise ValueError(
                f"chaos kind {kind!r} is not ported yet: it waits for "
                f"ROADMAP.md {WAITING[kind]}")
        try:
            kind, rest = entry.split("@", 1)
            arg = None
            if ":" in rest:
                rest, args_ = rest.split(":", 1)
                try:
                    arg = float(args_)
                except ValueError:
                    # string args are the serve fault menu's spelling
                    # (serve_dispatch_fault@N:io); validated below
                    arg = args_
            at = int(rest)
        except ValueError:
            raise ValueError(
                f"bad chaos entry {entry!r} (want kind@N or kind@N:arg)")
        if kind not in KINDS:
            raise ValueError(
                f"unknown chaos kind {kind!r} (one of {', '.join(KINDS)})")
        if isinstance(arg, str) and kind != "serve_dispatch_fault":
            raise ValueError(
                f"non-numeric argument in chaos entry {entry!r} (string "
                "args belong to serve_dispatch_fault@N:kind only)")
        if kind == "serve_dispatch_fault":
            arg = "io" if arg is None else arg
            if not isinstance(arg, str) or arg not in SERVE_FAULT_KINDS:
                raise ValueError(
                    f"serve_dispatch_fault kind must be one of "
                    f"{', '.join(SERVE_FAULT_KINDS)}: {entry!r}")
        if at < 0 or (isinstance(arg, float) and arg < 0):
            raise ValueError(f"negative value in chaos entry {entry!r}")
        if kind in _ONE_BASED and at < 1:
            raise ValueError(
                f"{kind} ordinals are 1-based: {entry!r} would never "
                f"fire (the first countable event is {kind}@1)")
        if kind == "device_loss" and arg is not None:
            raise ValueError(
                f"{entry!r}: the surviving-device count of device_loss@G:S "
                "re-ramps a sharded run, which waits for ROADMAP.md A.6 "
                "(multi-GPU runs); use device_loss@G")
        if kind in ("writer", "sigterm", "sigkill", "serve_kill",
                    "serve_poison_tenant") and arg is not None:
            raise ValueError(f"{kind} takes no argument: {entry!r}")
        events.append(ChaosEvent(kind, at, arg))
    events.sort(key=lambda e: e.at)
    return events


def _raise_serve_fault(kind: str, attempt: int) -> None:
    """Raise the classified fault ``kind`` as production raises it, so the
    service's supervised dispatch routes it through the supervisor's own
    ``classify_fault``."""
    if kind == "io":
        raise OSError(errno.EIO,
                      f"chaos: injected io fault in serve dispatch "
                      f"attempt {attempt}")
    if kind == "stall":
        from ..utils.pipeline import StallError

        raise StallError(f"chaos: injected dispatch stall in serve "
                         f"dispatch attempt {attempt}")
    _raise_device_loss(attempt)


def _raise_device_loss(gen: int) -> None:
    """Raise the type a CUDA runtime failure surfaces as, with a message
    the supervisor's production patterns read as a device loss."""
    import torch

    msg = (f"CUDA error: chaos: simulated device loss at generation {gen} "
           "(an injected exception; the card was not touched)")
    err = getattr(torch, "AcceleratorError", None)
    if isinstance(err, type):
        raise err(msg)
    raise RuntimeError(msg)


class ChaosMonkey:
    """The armed schedule and the hooks the mega loops call
    (``chunk_start`` / ``wrap_finisher`` / ``attach_writer``)."""

    def __init__(self, events: List[ChaosEvent]):
        self.events = list(events)
        # one release event per condemned finisher, so that a second stall
        # event after a recovery still holds
        self._holds: List[threading.Event] = []
        self._holds_lock = threading.Lock()
        #: tickets poisoned by serve_poison_tenant@N: the poison outlives
        #: its arming event (every attempt holding the ticket raises)
        self.poisoned_tickets = set()
        self._serve_submits = 0    # admitted tickets seen (1-based)
        self._serve_attempts = 0   # dispatch attempts (1-based)

    @classmethod
    def from_args(cls, args) -> Optional["ChaosMonkey"]:
        """Build from the ``--chaos`` spec (None when unset); a schedule
        that cannot fire as written exits at once."""
        spec = getattr(args, "chaos", None)
        if not spec:
            return None
        try:
            events = parse_schedule(spec)
        except ValueError as e:
            raise SystemExit(f"--chaos: {e}")
        if not events:
            raise SystemExit("--chaos: empty schedule")
        if any(e.kind == "stall" for e in events) \
                and not getattr(args, "stall_timeout_s", 0.0):
            raise SystemExit("--chaos stall@N needs --stall-timeout-s > 0 "
                             "(nothing would convert the injected hang "
                             "into a StallError)")
        return cls(events)

    # -- injection hooks ---------------------------------------------------

    def chunk_start(self, gen: int) -> None:
        """Fire every due generation-keyed event; called at the top of each
        chunk, before its launches."""
        for ev in self.events:
            if ev.fired or gen < ev.at or ev.kind in (
                    "writer", "stall", "serve_kill", "serve_dispatch_fault",
                    "serve_poison_tenant"):
                continue
            ev.fired = True
            if ev.kind == "device_loss":
                _raise_device_loss(gen)
            elif ev.kind == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            elif ev.kind == "sigkill":  # pragma: no cover - kills the proc
                os.kill(os.getpid(), signal.SIGKILL)

    def wrap_finisher(self, finish: Callable[[], None],
                      gen_end: int) -> Callable[[], None]:
        """Condemn the finisher of the chunk ending at ``gen_end`` when a
        stall event is due: the replacement blocks until the supervisor
        aborts it (or the hold elapses) and never runs the real one."""
        ev = next((e for e in self.events
                   if e.kind == "stall" and not e.fired and e.at <= gen_end),
                  None)
        if ev is None:
            return finish
        ev.fired = True
        hold = ev.arg if ev.arg else DEFAULT_STALL_HOLD_S
        release = threading.Event()
        with self._holds_lock:
            self._holds.append(release)

        def stalled():
            release.wait(hold)

        return stalled

    def attach_writer(self, writer) -> None:
        """Arm the next pending ``writer@N`` on a fresh
        ``utils.pipeline.BackgroundWriter``: its ``N``-th job is replaced
        by one that raises a permanent ``EIO`` naming the job."""
        ev = next((e for e in self.events
                   if e.kind == "writer" and not e.fired), None)
        if ev is None or writer is None:
            return
        orig = writer.submit
        count = [0]

        def submit(fn, *a, **k):
            count[0] += 1
            if count[0] == ev.at and not ev.fired:
                ev.fired = True
                label = getattr(fn, "__name__", repr(fn))
                ordinal = count[0]

                def chaos_poisoned_job(*_a, **_k):
                    raise OSError(
                        errno.EIO,
                        f"chaos: injected permanent writer fault in place "
                        f"of job {ordinal} ({label})")

                return orig(chaos_poisoned_job)
            return orig(fn, *a, **k)

        writer.submit = submit

    def note_submit(self, ticket: str) -> None:
        """Serve admission hook: count the admitted tickets (journal
        replays are admitted first, in journal order) and poison the
        ``N``-th one for any due ``serve_poison_tenant@N``."""
        self._serve_submits += 1
        for ev in self.events:
            if ev.kind == "serve_poison_tenant" and not ev.fired \
                    and self._serve_submits >= ev.at:
                ev.fired = True
                self.poisoned_tickets.add(ticket)

    def serve_dispatch(self, requests) -> None:
        """Serve dispatch hook, called at the top of every dispatch
        attempt (retries and bisection halves included).  An attempt that
        holds a poisoned ticket raises a deterministic error first; then
        the attempt counter advances and a due ``serve_kill`` /
        ``serve_dispatch_fault`` fires once."""
        bad = sorted(r.ticket for r in requests
                     if r.ticket in self.poisoned_tickets)
        if bad:
            raise RuntimeError(
                "chaos: poisoned tenant config for ticket(s) "
                + ",".join(bad) + " (deterministic; survives retries)")
        self._serve_attempts += 1
        for ev in self.events:
            if ev.fired or ev.kind not in ("serve_kill",
                                           "serve_dispatch_fault") \
                    or self._serve_attempts < ev.at:
                continue
            ev.fired = True
            if ev.kind == "serve_kill":  # pragma: no cover - kills us
                os.kill(os.getpid(), signal.SIGKILL)
            else:
                _raise_serve_fault(str(ev.arg), self._serve_attempts)

    def abort_pending(self) -> None:
        """Release the condemned finisher threads (the supervisor calls
        this before restarting)."""
        with self._holds_lock:
            holds, self._holds = self._holds, []
        for h in holds:
            h.set()

    @property
    def pending(self) -> List[ChaosEvent]:
        return [e for e in self.events if not e.fired]
