"""Flight recorder: a bounded per-chunk health ring, the anomaly watchdog
and triage bundles; port of ``srnn_tpu/telemetry/flightrec.py``.

  * :class:`FlightRecorder` -- a bounded ring of per-chunk summaries
    (health sentinels from the device carry, class counts, gens/sec,
    overlap attribution), cheap enough to be always on.
  * :class:`Watchdog` -- trip rules over each chunk's row (NaN/zero
    fraction, respawn rate, gens/sec regression against the ring median).
    A trip writes a triage bundle and arms a ``torch.profiler`` trace
    window over the next chunk.
  * :func:`write_triage_bundle` -- trip.json (reasons, row, thresholds,
    torch / CUDA metadata), the ring as ring.jsonl, a config.json copy, a
    metrics snapshot and, given a population snapshot and a ``save_fn``
    (``experiment.save_checkpoint``), a checkpoint ``ckpt-gen<N>``.
  * :class:`StallSentinel` -- a dead-man's switch: a daemon timer thread
    fires ``on_stall`` once if no :meth:`~StallSentinel.mark` lands within
    the deadline.

With the watchdog off nothing here runs; on, a chunk costs a dict append
and a few float comparisons.  The device half is
:mod:`srnn_tpu_torch.telemetry.device` (the ``health=True`` carry).
:func:`record_recovery` folds a supervised run's restarts
(``resilience.supervisor``) into the registry and the ring.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .device import (HEALTH_BUCKET_LO, HEALTH_BUCKET_STEP, N_HEALTH_BUCKETS,
                     HealthStats, host)

# ---------------------------------------------------------------------------
# health-carry interpretation
# ---------------------------------------------------------------------------


def _bucket_mid(i: int) -> float:
    """Geometric midpoint of log2 bucket ``i`` (the sketch's quantile
    resolution is one bucket: HEALTH_BUCKET_STEP powers of two)."""
    return float(2.0 ** (HEALTH_BUCKET_LO + (i + 0.5) * HEALTH_BUCKET_STEP))


def _hist_quantile(hist: np.ndarray, q: float) -> float:
    total = int(hist.sum())
    if total == 0:
        return math.nan
    target = max(1, int(math.ceil(q * total)))
    cum = np.cumsum(hist)
    i = int(np.searchsorted(cum, target))
    return _bucket_mid(min(i, N_HEALTH_BUCKETS - 1))


def health_summary(h: HealthStats, n_particles: int) -> Dict[str, Any]:
    """Flatten one flushed device carry into the JSON-ready row the ring
    stores: fractions over ``n_particles``, window peaks, and the
    weight-norm min/p50/max read off the log2 sketch."""
    h = HealthStats(*(host(x) for x in h))
    hist = h.norm_hist
    n = max(1, int(n_particles))
    nmin, nmax = float(h.norm_min), float(h.norm_max)
    return {
        "generations": int(h.checks),
        "n_particles": int(n_particles),
        "nonfinite": int(h.nonfinite),
        "nonfinite_peak": int(h.nonfinite_peak),
        "nan_frac": int(h.nonfinite) / n,
        "nan_frac_peak": int(h.nonfinite_peak) / n,
        "zero": int(h.zero),
        "zero_peak": int(h.zero_peak),
        "zero_frac": int(h.zero) / n,
        "zero_frac_peak": int(h.zero_peak) / n,
        "norm_min": nmin if math.isfinite(nmin) else None,
        "norm_p50": _hist_quantile(hist, 0.5),
        "norm_max": nmax if math.isfinite(nmax) else None,
    }


def combined_health_summary(parts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Whole-population view of per-type summaries (disjoint
    subpopulations of the same window): counts sum, fractions re-derive
    over the total, norm extrema fold.  ``norm_p50`` is not recombinable
    from summaries alone and reports the per-type median range instead."""
    if not parts:
        return {}
    n = sum(p["n_particles"] for p in parts)
    out = {
        "generations": max(p["generations"] for p in parts),
        "n_particles": n,
        "nonfinite": sum(p["nonfinite"] for p in parts),
        "nonfinite_peak": sum(p["nonfinite_peak"] for p in parts),
        "zero": sum(p["zero"] for p in parts),
        "zero_peak": sum(p["zero_peak"] for p in parts),
    }
    n = max(1, n)
    out["nan_frac"] = out["nonfinite"] / n
    out["nan_frac_peak"] = out["nonfinite_peak"] / n
    out["zero_frac"] = out["zero"] / n
    out["zero_frac_peak"] = out["zero_peak"] / n
    mins = [p["norm_min"] for p in parts if p.get("norm_min") is not None]
    maxs = [p["norm_max"] for p in parts if p.get("norm_max") is not None]
    p50s = [p["norm_p50"] for p in parts
            if p.get("norm_p50") is not None
            and not (isinstance(p["norm_p50"], float)
                     and math.isnan(p["norm_p50"]))]
    out["norm_min"] = min(mins) if mins else None
    out["norm_max"] = max(maxs) if maxs else None
    out["norm_p50"] = (min(p50s), max(p50s)) if p50s else None
    return out


def update_health_gauges(registry, summary: Dict[str, Any],
                         type_name: Optional[str] = None) -> None:
    """Export one chunk's health summary as registry gauges, so the
    Prometheus sink scrapes the same sentinels the ring records."""
    labels = {"type": type_name} if type_name else {}
    g = registry.gauge
    g("soup_health_nonfinite_particles",
      help="NaN/Inf particles at the last flush").set(
          summary["nonfinite"], **labels)
    g("soup_health_zero_particles",
      help="zero-collapsed particles at the last flush").set(
          summary["zero"], **labels)
    g("soup_health_nan_frac",
      help="NaN/Inf particle fraction at the last flush").set(
          round(summary["nan_frac"], 6), **labels)
    g("soup_health_zero_frac",
      help="zero-collapsed particle fraction at the last flush").set(
          round(summary["zero_frac"], 6), **labels)
    for k, name in (("norm_min", "soup_health_weight_norm_min"),
                    ("norm_max", "soup_health_weight_norm_max")):
        v = summary.get(k)
        if isinstance(v, (int, float)) and math.isfinite(v):
            g(name, help="population weight-norm extremum "
              "(max-|w| per particle) over the flush window").set(v, **labels)


def record_recovery(registry, recorder: "FlightRecorder", ctx) -> None:
    """Fold a supervised attempt's recovery history into the run's
    telemetry: the restart counter and the per-recovery seconds histogram
    on ``registry``, and one ``kind="restart"`` row in the flight-recorder
    ring, so that a later triage bundle shows when the run was patched
    back together.

    ``ctx`` is the supervisor's ``AttemptContext`` (``restarts``,
    ``attempt``, ``recoveries``).  Each attempt builds
    a fresh registry, so folding the cumulative history keeps the exported
    counters monotone across restarts.  No-op on the first attempt and for
    unsupervised runs.  (The re-ramp counters of the JAX package's
    in-process re-ramp wait for that item, ROADMAP.md A.6: a lost host
    here is re-ramped by the launcher, in a new process.)"""
    if ctx is None or not getattr(ctx, "restarts", 0):
        return
    registry.counter("soup_restarts_total",
                     help="supervised in-process restarts").inc(ctx.restarts)
    hist = registry.histogram("soup_recovery_seconds",
                              help="seconds from fault to restarted "
                                   "attempt (incl. backoff)",
                              unit="seconds")
    for r in ctx.recoveries:
        # "seconds" spans the catch to the restart and holds the backoff
        hist.observe(float(r.get("seconds", 0.0)))
    if recorder is not None:
        recorder.record({"kind": "restart", "attempt": ctx.attempt,
                         "restarts": ctx.restarts,
                         "recoveries": list(ctx.recoveries)})


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of per-chunk summary rows — the run's black box.

    Rows are plain JSON-able dicts; :meth:`record` stamps a monotone
    ``seq`` and wall-clock ``t``.  Thread-safe: run loops record from
    (possibly deferred) chunk finishers while a stall handler may dump the
    ring from the producing thread.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._rows: "deque[dict]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, row: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            row = dict(row)
            row["seq"] = self._seq
            row.setdefault("t", round(time.time(), 3))
            self._seq += 1
            self._rows.append(row)
        return row

    def rows(self) -> List[dict]:
        with self._lock:
            return list(self._rows)

    def tail(self, n: int) -> List[dict]:
        with self._lock:
            return list(self._rows)[-max(0, int(n)):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def write(self, path: str) -> str:
        """Dump the ring as jsonl (oldest first)."""
        with open(path, "w") as f:
            for row in self.rows():
                f.write(json.dumps(row, default=str) + "\n")
        return path


# ---------------------------------------------------------------------------
# triage bundles
# ---------------------------------------------------------------------------


def _backend_metadata() -> Dict[str, Any]:
    """torch and CUDA provenance for trip.json.  Fail-soft: triage must
    work even when the card is the thing that broke."""
    out: Dict[str, Any] = {}
    try:
        import torch

        out["torch_version"] = torch.__version__
        out["cuda_version"] = torch.version.cuda
        out["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
        count = torch.cuda.device_count() if out["backend"] == "cuda" else 0
        out["device_count"] = count
        out["local_devices"] = [torch.cuda.get_device_name(i)
                                for i in range(min(count, 8))]
        if count:
            out["device_kind"] = out["local_devices"][0]
    except Exception as e:  # pragma: no cover - a wedged card
        out["backend_error"] = f"{type(e).__name__}: {e}"
    try:
        from .metrics import RUNTIME

        out["runtime_metrics"] = RUNTIME.rows()
    except Exception:
        pass
    return out


def write_triage_bundle(
    run_dir: str,
    reasons: List[str],
    row: Optional[Dict[str, Any]],
    recorder: Optional[FlightRecorder] = None,
    snapshot_state: Any = None,
    save_fn: Optional[Callable[[str, Any], str]] = None,
    registry=None,
    thresholds: Optional[Dict[str, Any]] = None,
    generation: Optional[int] = None,
) -> str:
    """Write one self-contained triage bundle under ``run_dir`` and return
    its path.

    Layout (everything best-effort except trip.json, which always lands):

    * ``trip.json`` — reasons, the tripping row, thresholds, backend and
      compile metadata, ring length.
    * ``ring.jsonl`` — the full flight-recorder ring, oldest first.
    * ``config.json`` — copied from the run dir, so the bundle resumes
      with the run's own dynamics.
    * ``metrics.json`` — cumulative registry snapshot at trip time.
    * ``ckpt-gen<N>/`` — ``save_fn(path, snapshot_state)`` (e.g.
      ``experiment.save_checkpoint`` and the chunk's state), named with the
      run-dir checkpoint convention.
    * ``trace/`` — created by the watchdog's armed ``torch.profiler``
      window over the NEXT chunk (absent for stall bundles: the device is
      presumed hung).
    """
    gen = int(generation if generation is not None
              else (row or {}).get("gen", 0) or 0)
    slug = "-".join(reasons)[:48].replace("/", "_") or "trip"
    base = os.path.join(run_dir, f"triage-gen{gen:08d}-{slug}")
    bundle = base
    i = 1
    while os.path.exists(bundle):
        bundle = f"{base}.{i}"
        i += 1
    os.makedirs(bundle)

    trip: Dict[str, Any] = {
        "reasons": list(reasons),
        "generation": gen,
        "time": time.time(),
        "row": row,
        "thresholds": dict(thresholds or {}),
        "ring_len": len(recorder) if recorder is not None else 0,
        "backend": _backend_metadata(),
    }
    errors: Dict[str, str] = {}
    if recorder is not None:
        try:
            recorder.write(os.path.join(bundle, "ring.jsonl"))
        except OSError as e:
            errors["ring"] = str(e)
    cfg_src = os.path.join(run_dir, "config.json")
    if os.path.exists(cfg_src):
        try:
            shutil.copy(cfg_src, os.path.join(bundle, "config.json"))
        except OSError as e:
            errors["config"] = str(e)
    if registry is not None:
        try:
            with open(os.path.join(bundle, "metrics.json"), "w") as f:
                json.dump(registry.rows(), f, indent=1, sort_keys=True)
        except Exception as e:
            errors["metrics"] = f"{type(e).__name__}: {e}"
    if snapshot_state is not None and save_fn is not None:
        try:
            trip["snapshot"] = os.path.basename(
                save_fn(os.path.join(bundle, f"ckpt-gen{gen:08d}"),
                        snapshot_state))
        except Exception as e:
            errors["snapshot"] = f"{type(e).__name__}: {e}"
    if errors:
        trip["errors"] = errors
    with open(os.path.join(bundle, "trip.json"), "w") as f:
        json.dump(trip, f, indent=1, default=str)
    return bundle


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


class Watchdog:
    """Per-chunk anomaly rules over flight-recorder rows.

    Thresholds (``None``/``<= 0`` disables a rule):

    * ``nan_frac`` — trip when a chunk's end-of-window NaN/Inf particle
      fraction exceeds it (catches sustained NaN presence when respawn is
      off, or a storm faster than respawn).
    * ``zero_frac`` — same for the zero-collapse fraction (the
      whole-population zero-fixpoint collapse mode).
    * ``respawn_frac`` — trip when the chunk's respawns exceed this
      fraction of its particle-generations (a respawn storm: divergence
      being cleaned up as fast as it appears — invisible to ``nan_frac``).
    * ``gens_regress`` — trip when the chunk's gens/sec falls below
      ``(1 - gens_regress)`` of the ring's median (needs
      ``min_history`` prior rows; 0 disables — wall-clock on shared
      hosts is noisy, so this rule is opt-in).

    ``max_bundles`` bounds how many bundles one run writes (a NaN storm
    trips every chunk; two bundles tell the story, two hundred fill the
    disk).  After a trip the watchdog arms a ``torch.profiler`` trace into
    the bundle (``trace/trace.json``, written when the window stops); the
    run loop calls :meth:`chunk_boundary` at the next finisher so the
    window covers roughly one chunk, and :meth:`stop_trace` in its
    teardown.
    """

    RULES = ("nan_frac", "zero_frac", "respawn_frac", "gens_regress")

    def __init__(self, recorder: FlightRecorder,
                 nan_frac: Optional[float] = 0.02,
                 zero_frac: Optional[float] = 0.9,
                 respawn_frac: Optional[float] = 0.25,
                 gens_regress: Optional[float] = 0.0,
                 max_bundles: int = 2,
                 min_history: int = 3,
                 profile_trips: bool = True):
        self.recorder = recorder
        self.nan_frac = nan_frac
        self.zero_frac = zero_frac
        self.respawn_frac = respawn_frac
        self.gens_regress = gens_regress
        self.max_bundles = max(0, int(max_bundles))
        self.min_history = max(1, int(min_history))
        self.profile_trips = profile_trips
        self.bundles: List[str] = []
        self.trips = 0
        self._trace = None

    def thresholds(self) -> Dict[str, Any]:
        return {r: getattr(self, r) for r in self.RULES}

    # -- rules -----------------------------------------------------------

    @staticmethod
    def _on(threshold: Optional[float]) -> bool:
        return threshold is not None and threshold > 0

    def check(self, row: Dict[str, Any]) -> List[str]:
        """Evaluate every rule against one chunk row (the row's ``health``
        is a :func:`health_summary` dict; ``respawns``/``particle_gens``
        come from the metrics carry).  Returns the tripped rule names."""
        reasons = []
        health = row.get("health") or {}
        if self._on(self.nan_frac) \
                and health.get("nan_frac", 0) > self.nan_frac:
            reasons.append("nan_frac")
        if self._on(self.zero_frac) \
                and health.get("zero_frac", 0) > self.zero_frac:
            reasons.append("zero_frac")
        if self._on(self.respawn_frac) and row.get("particle_gens"):
            if row.get("respawns", 0) / row["particle_gens"] \
                    > self.respawn_frac:
                reasons.append("respawn_frac")
        if self._on(self.gens_regress) and row.get("gens_per_sec"):
            prior = [r["gens_per_sec"] for r in self.recorder.rows()
                     if r.get("gens_per_sec") and r.get("seq") != row.get("seq")]
            if len(prior) >= self.min_history:
                prior.sort()
                median = prior[len(prior) // 2]
                if row["gens_per_sec"] < (1.0 - self.gens_regress) * median:
                    reasons.append("gens_regress")
        return reasons

    # -- trips and the armed profiler window -----------------------------

    def trip(self, reasons: List[str], row: Optional[Dict[str, Any]],
             run_dir: str, snapshot_state: Any = None,
             save_fn: Optional[Callable] = None, registry=None,
             generation: Optional[int] = None) -> Optional[str]:
        """Record a trip; write a bundle unless ``max_bundles`` is spent.
        Returns the bundle path (or None when rate-limited)."""
        self.trips += 1
        if len(self.bundles) >= self.max_bundles:
            return None
        bundle = write_triage_bundle(
            run_dir, reasons, row, recorder=self.recorder,
            snapshot_state=snapshot_state, save_fn=save_fn,
            registry=registry, thresholds=self.thresholds(),
            generation=generation)
        self.bundles.append(bundle)
        if self.profile_trips:
            self._start_trace(os.path.join(bundle, "trace"))
        return bundle

    def _start_trace(self, path: str) -> None:
        if self._trace is not None:
            return
        try:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            self._trace = (prof, path)
        except Exception:
            pass  # a broken profiler must never break the run

    def stop_trace(self) -> None:
        """Stop an armed trace window and write it (idempotent,
        fail-soft)."""
        if self._trace is None:
            return
        prof, path = self._trace
        self._trace = None
        try:
            prof.stop()
            os.makedirs(path, exist_ok=True)
            prof.export_chrome_trace(os.path.join(path, "trace.json"))
        except Exception:
            pass

    def chunk_boundary(self) -> None:
        """Called by the run loop at each chunk finisher BEFORE evaluating
        rules: closes a trace window armed by the previous chunk's trip, so
        the captured window spans roughly the next chunk after the trip."""
        self.stop_trace()


# ---------------------------------------------------------------------------
# the dead-man's switch
# ---------------------------------------------------------------------------


class StallSentinel:
    """Fire ``on_stall(last_mark, elapsed_s)`` once if no progress mark
    lands within ``deadline_s``.

    Built for code that can wedge below Python (a hung card, a build that
    never returns): the timer runs on a daemon thread (a blocking C call
    releases the GIL), so the sentinel still fires and can write a
    host-only triage bundle while the main thread hangs.  It is a daemon
    on purpose: it owns no buffered I/O, and a non-daemon timer would keep
    a wedged process alive forever.
    ``on_stall`` errors are swallowed — the sentinel is forensic, never
    load-bearing.
    """

    def __init__(self, deadline_s: float, on_stall: Callable[[str, float], None],
                 name: str = "srnn-stall-sentinel"):
        from ..utils.pipeline import spawn_thread

        self.deadline_s = float(deadline_s)
        self.on_stall = on_stall
        self.fired = False
        self._mark = "armed"
        self._t_mark = time.monotonic()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = spawn_thread(self._run, name=name, daemon=True)

    def mark(self, note: str = "") -> None:
        """Record progress: resets the deadline."""
        with self._lock:
            self._mark = note or "mark"
            self._t_mark = time.monotonic()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                waited = time.monotonic() - self._t_mark
            remaining = self.deadline_s - waited
            if remaining <= 0:
                self.fired = True
                try:
                    self.on_stall(self._mark, waited)
                except Exception:
                    pass
                return
            self._stop.wait(min(remaining, 1.0))
