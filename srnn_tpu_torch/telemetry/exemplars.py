"""Tail-based exemplar retention for fleet traces; a copy of
``srnn_tpu/telemetry/exemplars.py``.

Distributed tracing's storage problem in miniature: keeping every span
of every ticket forever turns events.jsonl into the product, while
sampling heads (keep 1-in-N at admission) systematically loses exactly
the traces an operator opens the tooling for — the slow one, the one
that died with its worker, the one bisection quarantined.  This module
is the TAIL-sampling answer at self-replicator scale: the serve tier
decides at ticket RESOLUTION what to keep — a ticket that violated the
SLO, failed, was quarantined, or was replayed across a worker death
retains its full span family; every other ticket retains only its root
span (enough for rate/latency accounting, one line).

Records land in a bounded ``exemplars.jsonl`` ring next to the run's
``events.jsonl``.  The ring is append-mostly: writes are plain appends
(one open/write/close per retained ticket, off the dispatch thread via
the service's BackgroundWriter), and when the file exceeds twice its
capacity it compacts down to the newest ``capacity`` records through
``atomic_write_text`` — the same publish discipline as the ticket
journal, so a crash mid-compaction leaves the complete old ring, never
a torn new one.  A torn TAIL line (kill -9 mid-append) is skipped on
read; the record it would have held described an already-resolved
ticket, so nothing operational is lost.

Deliberately torch-free: the pool front (``serve.pool``) keeps its own
ring for replayed tickets and imports this without loading torch.
"""

import json
import os
import threading
from typing import List, Optional

from ..utils.atomicio import atomic_write_text

EXEMPLARS_NAME = "exemplars.jsonl"

#: records kept after a compaction; the file itself may grow to twice
#: this between compactions (amortized O(1) rewrite per append)
DEFAULT_CAPACITY = 256


def read_exemplars(path: str) -> List[dict]:
    """All readable records in ``path``, oldest first; torn/corrupt
    lines are skipped (the expected kill -9 tail case)."""
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if isinstance(row, dict):
                out.append(row)
    return out


def find_exemplar(path: str, ticket: str) -> Optional[dict]:
    """The NEWEST record for ``ticket`` (by ticket id or trace id), or
    None.  Newest wins so a replayed ticket's post-replay record — the
    one with the full span family — shadows its pre-death root."""
    found = None
    for row in read_exemplars(path):
        if row.get("ticket") == ticket or row.get("trace_id") == ticket:
            found = row
    return found


class ExemplarRing:
    """Bounded append-mostly jsonl ring of retained trace records.

    Thread-safe; every :meth:`add` is one append, and past
    ``2 * capacity`` lines the ring compacts (atomic publish) down to
    the newest ``capacity`` records.  Restart-safe: an existing file's
    line count is adopted, so a long-lived root dir never grows
    unboundedly across service generations either."""

    def __init__(self, path: str, capacity: int = DEFAULT_CAPACITY):
        self.path = path
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._count = self._count_existing()

    def _count_existing(self) -> int:
        try:
            with open(self.path, "r", encoding="utf-8",
                      errors="replace") as f:
                return sum(1 for _ in f)
        except OSError:
            return 0

    def add(self, record: dict) -> None:
        """Append one retained-trace record; fail-soft (retention must
        never take down the dispatch path it describes)."""
        try:
            line = json.dumps(record)
        except (TypeError, ValueError):
            return
        with self._lock:
            try:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
                self._count += 1
                if self._count > 2 * self.capacity:
                    self._compact_locked()
            except OSError:
                pass

    def _compact_locked(self) -> None:
        rows = read_exemplars(self.path)[-self.capacity:]
        atomic_write_text(self.path,
                          "".join(json.dumps(r) + "\n" for r in rows))
        self._count = len(rows)
