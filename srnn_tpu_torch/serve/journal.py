"""Durable ticket journal: the service's crash-recovery log; a copy of
``srnn_tpu/serve/journal.py``, in the same file format, so a journal
written by either package is read by the other.

The soup inside the service is self-healing by construction (divergent
and collapsed particles respawn every generation); this module makes the
service *around* it hold the same contract — Chang & Lipson's quine
framing: does the system reproduce its own state after perturbation?
Concretely: every admitted submit is APPENDED AND FSYNCED here before
its ticket id is acknowledged to the client, every completion appends a
matching ``done`` record, and a restarted service REPLAYS every submit
without a matching done.  A ``kill -9`` mid-load therefore loses no
admitted work, and because the executors are deterministic functions of
the journaled params, the replayed results are bitwise-equal to an
uninterrupted run (asserted end-to-end in
``tests/test_torch_serve_resilience.py`` and ``chip_smoke.py``'s
experiment-service drills).

Format: JSON-lines, one record per line::

  {"e": "submit", "ticket": "t000001", "kind": "soup", "params": {...},
   "tenant": "a", "key": "idem-1", "deadline_wall": null, "wall": ...}
  {"e": "done", "ticket": "t000001", "status": "done"}
  {"e": "mark", "next_ticket": 9}

``mark`` is the ticket-counter watermark the recovery compaction writes:
without it, compacting a fully-finished journal would discard every
issued id and a later restart would hand out ``t000001`` again —
colliding with earlier runs' telemetry rows and with stale clients
still holding old tickets.

Durability discipline: a log APPENDS with per-record fsync (the
tmp+fsync+rename sequence of ``utils.atomicio`` is for whole-file
publish, not appends); the atomic-publish half lives in the recovery
compaction, which rewrites the journal down to its unfinished suffix via
:func:`~srnn_tpu_torch.utils.atomicio.atomic_write_text` — a crash
mid-compaction leaves the complete old journal, never a torn new one.
A torn TAIL (the one partial line a kill -9 mid-append can leave) is
skipped on read and counted; its record was by definition never
acknowledged, so skipping it is exactly the admission contract.

``deadline_wall`` is the wall-clock absolute deadline (submit wall time
plus the client's ``deadline_s``): monotonic stamps do not survive a
process, so replay re-derives the remaining budget from the wall clock —
a ticket whose deadline elapsed while the service was down expires at
replay instead of occupying a stack slot.
"""

import json
import os
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from ..utils.atomicio import atomic_write_text

JOURNAL_NAME = "journal.jsonl"


class JournalEntry(NamedTuple):
    """One journaled admission (the replayable half of a ticket)."""
    ticket: str
    kind: str
    params: dict
    tenant: str
    key: Optional[str]            # client idempotency key, if any
    deadline_wall: Optional[float]  # absolute wall-clock deadline
    wall: float                   # wall-clock admission stamp
    #: propagated trace context (fleet tracing): the distributed trace
    #: this admission belongs to and the parent span on the far side of
    #: the hop.  None on pre-tracing journals — replay behavior is
    #: identical either way (the fields only label telemetry rows).
    trace_id: Optional[str] = None
    parent_span: Optional[int] = None
    #: record fields THIS reader does not know (a journal written by a
    #: newer version) — preserved verbatim through recovery compaction,
    #: so downgrade-then-upgrade never strips them
    extra: Optional[dict] = None


#: the submit-record keys this reader interprets; anything else rides in
#: ``JournalEntry.extra`` and survives compaction untouched
_KNOWN_SUBMIT_KEYS = frozenset({
    "e", "ticket", "kind", "params", "tenant", "key", "deadline_wall",
    "wall", "trace_id", "parent_span"})


def _submit_row(e: JournalEntry) -> dict:
    """One entry back to its wire form (compaction): the fixed fields,
    the trace context only when present (pre-tracing journals compact
    byte-identically), and every unknown field merged back in."""
    row = {"e": "submit", "ticket": e.ticket, "kind": e.kind,
           "params": e.params, "tenant": e.tenant, "key": e.key,
           "deadline_wall": e.deadline_wall, "wall": e.wall}
    if e.trace_id is not None:
        row["trace_id"] = e.trace_id
    if e.parent_span is not None:
        row["parent_span"] = e.parent_span
    if e.extra:
        row.update(e.extra)
    return row


def _ticket_number(ticket: str) -> int:
    """The numeric part of a ``t%06d`` ticket id (0 for foreign ids)."""
    if ticket.startswith("t") and ticket[1:].isdigit():
        return int(ticket[1:])
    return 0


def read_journal(path: str) -> Tuple[List[JournalEntry], int, int]:
    """Read ``path`` -> (unfinished entries in admission order,
    torn/corrupt line count, next free ticket number).

    A line that fails to parse is skipped and counted — the torn tail a
    kill -9 mid-append leaves is the expected case; a torn line anywhere
    else still only loses that one record.  ``done`` records without a
    surviving submit (compacted away earlier) are ignored.
    """
    entries: Dict[str, JournalEntry] = {}
    done: Dict[str, str] = {}
    order: List[str] = []
    torn = 0
    max_ticket = 0
    if not os.path.exists(path):
        return [], 0, 1
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
                event = row["e"]
                if event == "mark":
                    # counter watermark: ids up to next_ticket-1 were
                    # issued before the last compaction
                    max_ticket = max(max_ticket,
                                     int(row.get("next_ticket", 1)) - 1)
                    continue
                ticket = row["ticket"]
            except (ValueError, KeyError, TypeError):
                torn += 1
                continue
            max_ticket = max(max_ticket, _ticket_number(str(ticket)))
            if event == "submit":
                try:
                    unknown = {k: v for k, v in row.items()
                               if k not in _KNOWN_SUBMIT_KEYS}
                    trace_id = row.get("trace_id")
                    parent_span = row.get("parent_span")
                    entry = JournalEntry(
                        ticket=str(ticket), kind=str(row["kind"]),
                        params=dict(row.get("params") or {}),
                        tenant=str(row.get("tenant") or ticket),
                        key=row.get("key"),
                        deadline_wall=row.get("deadline_wall"),
                        wall=float(row.get("wall", 0.0)),
                        trace_id=(None if trace_id is None
                                  else str(trace_id)),
                        parent_span=(None if parent_span is None
                                     else int(parent_span)),
                        extra=unknown or None)
                except (ValueError, KeyError, TypeError):
                    torn += 1
                    continue
                if ticket not in entries:
                    order.append(str(ticket))
                entries[str(ticket)] = entry
            elif event == "done":
                done[str(ticket)] = str(row.get("status", "done"))
    unfinished = [entries[t] for t in order if t not in done]
    return unfinished, torn, max_ticket + 1


class TicketJournal:
    """Append-only fsynced journal handle for one service root.

    Thread-safe: admissions append from handler threads (under the
    service's admission lock) while completions append from the dispatch
    thread — every append takes the journal's own lock and fsyncs before
    returning, so a record that has been acknowledged is durable."""

    def __init__(self, root: str):
        self.path = os.path.join(root, JOURNAL_NAME)
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")

    # -- appends (durable before return) --------------------------------

    def _append(self, rows: Sequence[dict]) -> None:
        payload = "".join(json.dumps(r) + "\n" for r in rows)
        with self._lock:
            self._f.write(payload)
            self._f.flush()
            os.fsync(self._f.fileno())

    def record_submit(self, *, ticket: str, kind: str, params: dict,
                      tenant: str, key: Optional[str] = None,
                      deadline_wall: Optional[float] = None,
                      wall: float, trace_id: Optional[str] = None,
                      parent_span: Optional[int] = None) -> None:
        row = {"e": "submit", "ticket": ticket, "kind": kind,
               "params": params, "tenant": tenant, "key": key,
               "deadline_wall": deadline_wall, "wall": wall}
        # trace context only when propagated: traceless submits journal
        # byte-identically to pre-tracing builds
        if trace_id is not None:
            row["trace_id"] = trace_id
        if parent_span is not None:
            row["parent_span"] = parent_span
        self._append([row])

    def record_done(self, tickets: Sequence[str], status: str) -> None:
        """One fsync for a whole dispatch group's completions."""
        if tickets:
            self._append([{"e": "done", "ticket": t, "status": status}
                          for t in tickets])

    # -- recovery --------------------------------------------------------

    def recover(self) -> Tuple[List[JournalEntry], int, int]:
        """Read the journal, COMPACT it down to its unfinished suffix
        (atomic publish — a crash mid-compaction keeps the old file),
        and return ``(unfinished, torn, next_ticket_number)``.  The
        compaction keeps the journal bounded across restarts: finished
        submit/done pairs do not accumulate forever."""
        with self._lock:
            unfinished, torn, next_ticket = read_journal(self.path)
            self._f.close()
            # the watermark leads the compacted file: an idle restart
            # cycle must never reset the counter into reused ids
            atomic_write_text(
                self.path,
                json.dumps({"e": "mark", "next_ticket": next_ticket})
                + "\n"
                + "".join(json.dumps(_submit_row(e)) + "\n"
                          for e in unfinished))
            self._f = open(self.path, "a", encoding="utf-8")
        return unfinished, torn, next_ticket

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()
