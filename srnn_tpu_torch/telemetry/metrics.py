"""Host-side metrics registry and sinks.

A small, dependency-free implementation of the standard training-stack
metric kinds — :class:`Counter` (monotone totals), :class:`Gauge` (last
value wins), :class:`Histogram` (cumulative buckets + sum/count) — with
label support and two sinks:

  * structured ``events.jsonl`` rows through the existing
    ``Experiment.event`` channel (:meth:`MetricsRegistry.flush_events`):
    one ``{"kind": "metrics", "metrics": {name{labels}: value}}`` record
    per flush, cumulative values so the LAST row of a (possibly killed)
    run is the whole story;
  * a Prometheus textfile exposition (:meth:`MetricsRegistry.write_textfile`)
    for node-exporter-style scraping of long mega runs — written
    atomically (tmp + rename) so a scraper never reads a torn file.

``RUNTIME`` is the process-wide default registry used for host-side
runtime metrics (the JAX package's AOT compile counters and span
wall-clock; in this package, whatever a caller puts there); run loops
create their own registry per run so per-run sinks stay isolated.

All metric names are prefixed ``srnn_`` on export; values live under the
bare name in-process.  This module is a copy of the JAX package's
``telemetry/metrics.py`` and imports only the standard library: given the
same updates, both packages' sinks write byte-identical files.  The
soup-science interpretation of device carries lives in
:mod:`srnn_tpu_torch.telemetry.soup_metrics`.
"""

import json
import math
import os
import tempfile
import threading
from typing import Dict, Iterable, List, Optional, Tuple

_NAMESPACE = "srnn"

LabelKey = Tuple[Tuple[str, str], ...]


def _fsync_dir(path: str) -> None:
    # rename alone
    # leaves the directory entry unsynced, so a power loss could
    # resurrect a STALE metrics.prom beside a newer events.jsonl.
    # Fail-soft on filesystems that refuse directory fsync.
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_value(v: str) -> str:
    # text-format 0.0.4 label escaping: one malformed series makes a
    # textfile collector drop the WHOLE metrics.prom, so arbitrary
    # caller-supplied values (span notes, type names) must be sanitized
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _label_suffix(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_label_value(v)}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self._values: Dict[LabelKey, float] = {}
        # async-safe: the pipeline's background writer resolves registry
        # updates and renders sinks while the run loop keeps recording, so
        # every mutation and snapshot takes the metric's lock
        self._lock = threading.RLock()

    @property
    def full_name(self) -> str:
        return f"{_NAMESPACE}_{self.name}"

    def samples(self) -> Iterable[Tuple[str, float]]:
        """(exposition-suffix, value) pairs, one per label set."""
        with self._lock:
            items = sorted(self._values.items())
        for key, value in items:
            yield _label_suffix(key), value

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.full_name} {self.help}".rstrip(),
                 f"# TYPE {self.full_name} {self.kind}"]
        for suffix, value in self.samples():
            lines.append(f"{self.full_name}{suffix} {_fmt(value)}")
        return lines


def _fmt(v: float) -> str:
    if isinstance(v, float) and v.is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(v)


class Counter(_Metric):
    """Monotone total; ``inc`` only (negative increments are a bug)."""
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Last-write-wins instantaneous value."""
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)


#: span/compile wall-clock buckets: 100us .. ~2 min, roughly x4 apart
DEFAULT_BUCKETS = (1e-4, 5e-4, 2e-3, 1e-2, 5e-2, 0.25, 1.0, 4.0, 15.0,
                   60.0, 120.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations <= its bound; ``+Inf`` == count)."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "", unit: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, unit)
        self.buckets = tuple(sorted(buckets))
        # per label set: [bucket_counts..., +Inf count, sum]
        self._hist: Dict[LabelKey, List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            h = self._hist.setdefault(key,
                                      [0] * (len(self.buckets) + 1) + [0.0])
            for i, b in enumerate(self.buckets):
                if value <= b:
                    h[i] += 1
            h[len(self.buckets)] += 1  # +Inf
            h[-1] += value

    def count(self, **labels) -> int:
        with self._lock:
            h = self._hist.get(_label_key(labels))
            return int(h[len(self.buckets)]) if h else 0

    def quantile(self, q: float) -> Optional[float]:
        """Upper-bound q-quantile across ALL label sets (bucket merge):
        the smallest bucket bound whose cumulative count covers ``q`` of
        the observations, or ``None`` while empty / when the quantile
        falls in the ``+Inf`` bucket.  Conservative by construction —
        the serve SLO view wants "p95 is at most X", not an
        interpolated guess."""
        with self._lock:
            hists = list(self._hist.values())
        if not hists:
            return None
        total = sum(h[len(self.buckets)] for h in hists)
        if total <= 0:
            return None
        need = q * total
        for i, b in enumerate(self.buckets):
            if sum(h[i] for h in hists) >= need:
                return float(b)
        return None

    def sum(self, **labels) -> float:
        with self._lock:
            h = self._hist.get(_label_key(labels))
            return float(h[-1]) if h else 0.0

    def _snapshot(self):
        with self._lock:
            return sorted((k, list(h)) for k, h in self._hist.items())

    def samples(self):
        # suffix BEFORE the label braces (``name_sum{labels}``) so
        # rows()/flush_events name each series exactly as to_prometheus()
        # exposes it — the two sinks must correlate
        for key, h in self._snapshot():
            yield "_sum" + _label_suffix(key), h[-1]
            yield "_count" + _label_suffix(key), h[len(self.buckets)]

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.full_name} {self.help}".rstrip(),
                 f"# TYPE {self.full_name} {self.kind}"]
        for key, h in self._snapshot():
            for i, b in enumerate(self.buckets):
                lab = _label_suffix(key + (("le", repr(float(b))),))
                lines.append(f"{self.full_name}_bucket{lab} {_fmt(h[i])}")
            inf_lab = _label_suffix(key + (("le", "+Inf"),))
            lines.append(
                f"{self.full_name}_bucket{inf_lab} "
                f"{_fmt(h[len(self.buckets)])}")
            lines.append(f"{self.full_name}_sum{_label_suffix(key)} "
                         f"{_fmt(h[-1])}")
            lines.append(f"{self.full_name}_count{_label_suffix(key)} "
                         f"{_fmt(h[len(self.buckets)])}")
        return lines


class MetricsRegistry:
    """Named, typed metric registry — get-or-create accessors, flat
    snapshot rows, and the two sinks (events.jsonl / Prometheus file)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.RLock()  # async-safe get-or-create

    def _get(self, cls, name: str, help: str, unit: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, unit=unit, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get(Gauge, name, help, unit)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, unit, buckets=buckets)

    # -- snapshots and sinks ---------------------------------------------

    def rows(self) -> Dict[str, float]:
        """Flat ``{exposition-name: value}`` snapshot (cumulative values;
        histograms contribute their ``_sum``/``_count`` series)."""
        out: Dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for suffix, value in m.samples():
                out[m.full_name + suffix] = value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4) of every metric."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def write_textfile(self, path: str) -> str:
        """Atomically write the exposition to ``path`` (tmp + fsync +
        rename + parent-directory fsync, so a concurrent scraper never
        sees a torn file and a power loss cannot resurrect a STALE
        snapshot beside a newer events.jsonl — the checkpoint-marker
        discipline).  Returns ``path``."""
        body = self.to_prometheus()
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".prom_")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(d)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return path

    def flush_events(self, exp, **extra) -> Dict[str, float]:
        """Emit one cumulative-snapshot record through ``exp.event`` (the
        structured ``events.jsonl`` channel).  Returns the snapshot."""
        snap = self.rows()
        exp.event(kind="metrics", metrics=snap, **extra)
        return snap

    def dumps(self) -> str:
        return json.dumps(self.rows(), sort_keys=True)


def quantile_from_times(times, q: float) -> float:
    """Tiny helper for report-side summaries: q-quantile of a list by
    nearest-rank (no numpy dependency in the CLI path)."""
    if not times:
        return math.nan
    xs = sorted(times)
    i = min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))
    return xs[i]


#: process-wide default registry for host-side RUNTIME metrics.  Run loops
#: make their own.
RUNTIME = MetricsRegistry()
