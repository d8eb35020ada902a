"""Metric history: bounded in-memory rings and the append-only
``metrics_history.jsonl`` stream; port of
``srnn_tpu/telemetry/timeseries.py``.

The registry's sinks are cumulative snapshots, right for post-mortems and
wrong for trajectories ("is gens/s degrading?").  :class:`MetricHistory`
samples a registry once a chunk into a bounded per-series ring (newest
wins, oldest drops) and optionally appends each sample as one JSON row to
``metrics_history.jsonl`` (flushed per row; readers skip unparseable
lines), in the JAX package's format, so its ``report`` and ``watch`` read
it.

Clocks: ring stamps are monotonic seconds since the history was made;
each jsonl row also carries the wall stamp.  Lookups address metrics by
their bare registry name and fold every label set of that name by sum.
The fleet-wide reader of the JAX package (several processes' files) waits
for multi-GPU runs (ROADMAP.md, A.6): :func:`load_history_rows` reads one
process's file.
"""

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

#: sparkline glyphs, one per level (a flat series renders all-bottom)
_SPARK = "▁▂▃▄▅▆▇█"

#: the series the renderers surface by default -- bare registry names,
#: summed across labels
DEFAULT_RENDER_SERIES = ("gens_per_sec", "soup_generations_total",
                         "serve_queue_depth", "serve_requests_total",
                         "soup_alerts_active")


def sparkline(values, width: int = 32) -> str:
    """A numeric series as a unicode sparkline (its last ``width`` points;
    the empty string for an empty series)."""
    vals = [float(v) for v in values][-max(1, int(width)):]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))]
                   for v in vals)


class MetricHistory:
    """Bounded per-series history of one registry.

    >>> h = MetricHistory(registry, capacity=512,
    ...                   path=run_dir + "/metrics_history.jsonl")
    >>> h.sample()                      # once a chunk
    >>> h.rate("soup_generations_total", window_s=60.0)

    Each series keeps its newest ``capacity`` points; evicted points count
    in ``dropped_points``.  The jsonl stream is append-only.  ``sample``
    runs on the run's writer thread while exporter handler threads read
    ``latest_sum`` / ``age_s``: one lock covers the rings.
    """

    def __init__(self, registry, capacity: int = 512,
                 path: Optional[str] = None):
        self.registry = registry
        self.capacity = max(2, int(capacity))
        self.path = path
        self._file = None
        self._rings: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.samples_total = 0
        self.dropped_points = 0

    def now(self) -> float:
        return time.monotonic() - self._t0

    # -- producer --------------------------------------------------------

    def sample(self, t: Optional[float] = None, **extra) -> dict:
        """Take one snapshot of the registry: every series' current value
        to its ring and (given ``path``) one ``{"kind":
        "metrics_history"}`` row to the stream.  ``t`` overrides the
        monotonic stamp (tests)."""
        t = self.now() if t is None else float(t)
        rows = self.registry.rows()
        with self._lock:
            for key, value in rows.items():
                ring = self._rings.get(key)
                if ring is None:
                    ring = self._rings[key] = deque(maxlen=self.capacity)
                if len(ring) == self.capacity:
                    self.dropped_points += 1
                ring.append((t, float(value)))
            self.samples_total += 1
        row = {"kind": "metrics_history", "t": round(t, 3),
               "wall": round(time.time(), 3), "metrics": rows}
        row.update(extra)
        if self.path is not None:
            if self._file is None:
                self._file = open(self.path, "a")
            self._file.write(json.dumps(row) + "\n")
            self._file.flush()
        return row

    # -- readers (bare-name lookups, label sets folded by sum) -----------

    def _matching(self, name: str) -> List[deque]:
        prefix = name if name.startswith("srnn_") else f"srnn_{name}"
        return [ring for key, ring in self._rings.items()
                if key == prefix or key.startswith(prefix + "{")]

    def series(self, name: str) -> List[Tuple[float, float]]:
        """The summed (t, value) trajectory of ``name`` across its label
        sets, on the union of sample stamps."""
        with self._lock:
            rings = [list(r) for r in self._matching(name)]
        folded: Dict[float, float] = {}
        for ring in rings:
            for t, v in ring:
                folded[t] = folded.get(t, 0.0) + v
        return sorted(folded.items())

    def latest_sum(self, name: str) -> Optional[float]:
        """Sum of each matching series' newest point (None: never
        sampled)."""
        with self._lock:
            rings = [r for r in self._matching(name) if r]
        if not rings:
            return None
        return sum(r[-1][1] for r in rings)

    def age_s(self, name: str, now: Optional[float] = None) -> Optional[float]:
        """Seconds since ``name`` was last sampled (None: never)."""
        with self._lock:
            rings = [r for r in self._matching(name) if r]
        if not rings:
            return None
        now = self.now() if now is None else float(now)
        return now - max(r[-1][0] for r in rings)

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second rate of ``name`` over the trailing window (summed
        first-to-last delta of the in-window points over their span);
        ``None`` until two in-window points exist."""
        now = self.now() if now is None else float(now)
        cutoff = now - max(1e-9, float(window_s))
        pts = [(t, v) for t, v in self.series(name) if t >= cutoff]
        if len(pts) < 2:
            return None
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        return (pts[-1][1] - pts[0][1]) / span

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


# ---------------------------------------------------------------------------
# metrics_history.jsonl readers
# ---------------------------------------------------------------------------


def load_rows(path: str, tail_bytes: Optional[int] = None) -> List[dict]:
    """The JSON object rows of one jsonl file, skipping unparseable lines
    (a killed run's torn tail costs its last row, never the reader);
    ``tail_bytes`` reads only the file's end, dropping its first, possibly
    clipped, line.  A missing file reads as no rows."""
    try:
        with open(path, "rb") as f:
            if tail_bytes:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail_bytes))
                data = f.read()
                if size > tail_bytes:
                    data = data.split(b"\n", 1)[-1]
            else:
                data = f.read()
    except OSError:
        return []
    rows = []
    for line in data.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(row, dict):
            rows.append(row)
    return rows


def load_history_rows(path: str, tail_bytes: Optional[int] = None
                      ) -> List[dict]:
    """The ``metrics_history`` rows of one ``metrics_history.jsonl``."""
    return [r for r in load_rows(path, tail_bytes=tail_bytes)
            if r.get("kind") == "metrics_history"
            and isinstance(r.get("metrics"), dict)]


def _row_sum(row: dict, name: str) -> Optional[float]:
    prefix = f"srnn_{name}"
    vals = [v for k, v in row["metrics"].items()
            if (k == prefix or k.startswith(prefix + "{"))
            and isinstance(v, (int, float))]
    return sum(vals) if vals else None


def summarize_history(path: str, names=DEFAULT_RENDER_SERIES,
                      tail_bytes: Optional[int] = None) -> Optional[dict]:
    """Digest one history stream: sample count, span, and per selected
    series first / last / min / max and a sparkline (and the first-to-last
    per-second rate of a ``_total`` counter).  ``None`` when the file is
    absent or empty."""
    rows = load_history_rows(path, tail_bytes=tail_bytes)
    if not rows:
        return None
    t_first, t_last = rows[0].get("t", 0.0), rows[-1].get("t", 0.0)
    span = max(0.0, float(t_last) - float(t_first))
    series = {}
    for name in names:
        pts = [(r.get("t", 0.0), v) for r in rows
               for v in [_row_sum(r, name)] if v is not None]
        if not pts:
            continue
        vals = [v for _t, v in pts]
        d = {"first": round(vals[0], 3), "last": round(vals[-1], 3),
             "min": round(min(vals), 3), "max": round(max(vals), 3),
             "points": len(vals), "spark": sparkline(vals)}
        if name.endswith("_total") and len(pts) >= 2:
            pspan = pts[-1][0] - pts[0][0]
            if pspan > 0:
                d["rate_per_s"] = round((vals[-1] - vals[0]) / pspan, 3)
        series[name] = d
    return {"samples": len(rows), "span_s": round(span, 1),
            "series": series}
