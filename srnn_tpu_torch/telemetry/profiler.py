"""Continuous profiling plane: always-on host sampling, the utilization
decomposition, and anomaly-triggered capture; port of
``srnn_tpu/telemetry/profiler.py``.

  * :class:`SamplingProfiler` -- a stdlib sampling profiler: one daemon
    thread walks ``sys._current_frames()`` at ``--profile-hz`` (50 Hz by
    default) and folds each thread's stack into a bounded per-thread table
    keyed by thread name; a ring keeps the last ``ring_s`` seconds of raw
    samples.  ``flush()`` publishes the cumulative folded output
    (``profile.folded``, flamegraph-ready ``stack count`` lines, and
    ``profile.jsonl``) through the run's ``BackgroundWriter``.  It is
    host-side: ``--no-profile`` never builds it, and a run's results are
    bitwise the same either way.
  * :func:`utilization_from_pipeline` -- a chunk's device-busy /
    host-blocked / idle fractions from the ``OverlapMeter`` row (the
    ``soup_utilization_*`` gauges).  Device-busy is the host-observed
    lower bound (the device-wait share of the wall).
  * :class:`AnomalyCapture` -- on the alert engine's firing edge, an
    atomically published ``anomaly/<rule>-<seq>/`` bundle: the sample
    ring's last seconds, a thread dump, a registry snapshot, the run's
    exemplars if any, and a ``torch.profiler`` trace window (on a card)
    that the next sample turn closes; FIFO retention past ``max_bundles``.

The sampler thread is a daemon on purpose: it observes threads that may be
wedged and owns no buffered I/O (its flushes ride the run's writer).
Nothing here reads a tensor: a capture costs milliseconds even when the
card is the thing that broke.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
from collections import Counter, deque
from typing import Any, Dict, List, Optional

#: run-directory artifact names (cumulative, rewritten atomically per flush)
PROFILE_FOLDED_NAME = "profile.folded"
PROFILE_JSONL_NAME = "profile.jsonl"
#: bundle directory under the run directory
ANOMALY_DIR = "anomaly"
#: the request exemplars a bundle copies when the run has them (the JAX
#: package's ``telemetry.exemplars.EXEMPLARS_NAME``)
EXEMPLARS_NAME = "exemplars.jsonl"


def _frame_token(frame) -> str:
    """One fold-stable frame label: ``file.func`` (no line numbers; the
    thread dump keeps them)."""
    code = frame.f_code
    base = os.path.basename(code.co_filename)
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}.{code.co_name}"


def _fold_stack(frame, max_depth: int) -> str:
    """Root-first ``;``-joined folded stack of one frame chain; a deeper
    chain is cut root-side behind a ``...`` marker."""
    tokens: List[str] = []
    while frame is not None:
        tokens.append(_frame_token(frame))
        frame = frame.f_back
    tokens.reverse()
    if len(tokens) > max_depth:
        tokens = ["..."] + tokens[-max_depth:]
    return ";".join(tokens)


def _raw_stack(frame) -> List[str]:
    """Leaf-first frame list with file:line, the thread-dump view."""
    out: List[str] = []
    while frame is not None:
        code = frame.f_code
        out.append(f"{code.co_name} "
                   f"({os.path.basename(code.co_filename)}:"
                   f"{frame.f_lineno})")
        frame = frame.f_back
    return out


def thread_dump() -> Dict[str, Any]:
    """Every live thread's current stack (leaf first, with file:line), its
    daemon-ness, and whether the ``spawn_thread`` registry accounts for
    it.  Host reads only."""
    from ..utils.pipeline import live_threads

    registered = {id(t) for t in live_threads()}
    frames = sys._current_frames()
    threads = []
    for t in threading.enumerate():
        threads.append({
            "name": t.name,
            "ident": t.ident,
            "daemon": t.daemon,
            "alive": t.is_alive(),
            "registered": id(t) in registered,
            "stack": _raw_stack(frames.get(t.ident)),
        })
    return {"t": round(time.time(), 3), "n_threads": len(threads),
            "threads": sorted(threads, key=lambda d: d["name"])}


class SamplingProfiler:
    """The always-on host sampler.

    >>> prof = SamplingProfiler(hz=50.0, ring_s=30.0).start()
    >>> prof.flush(run_dir, writer)   # cumulative folded output
    >>> prof.stop()

    Each thread's table holds at most ``max_stacks`` distinct stacks
    (overflow folds into ``<overflow>`` and counts ``stacks_dropped``); the
    raw ring holds ``hz * ring_s`` ticks.
    """

    THREAD_NAME = "srnn-profiler"

    def __init__(self, hz: float = 50.0, ring_s: float = 30.0,
                 max_stacks: int = 512, max_depth: int = 48):
        self.hz = max(1.0, float(hz))
        self.ring_s = max(1.0, float(ring_s))
        self.max_stacks = max(16, int(max_stacks))
        self.max_depth = max(4, int(max_depth))
        self._interval = 1.0 / self.hz
        self._lock = threading.Lock()
        self._tables: Dict[str, Counter] = {}
        self._ring: "deque[dict]" = deque(
            maxlen=max(1, int(self.hz * self.ring_s)))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()
        self.samples = 0
        self.overruns = 0
        self.stacks_dropped = 0
        # update_gauges advances the registry counters by delta
        self._counted = {"samples": 0, "overruns": 0, "stacks_dropped": 0}

    # -- the sampling loop ------------------------------------------------

    def start(self) -> "SamplingProfiler":
        """Spawn the sampler daemon thread (idempotent)."""
        if self._thread is not None:
            return self
        from ..utils.pipeline import spawn_thread

        self._thread = spawn_thread(self._run, name=self.THREAD_NAME,
                                    daemon=True)
        return self

    def _run(self) -> None:
        own = threading.get_ident()
        next_tick = time.perf_counter()
        while not self._stop.is_set():
            next_tick += self._interval
            self._sample_once(own)
            delay = next_tick - time.perf_counter()
            if delay <= 0:
                # the tick overran its budget: resynchronise
                with self._lock:
                    self.overruns += 1
                next_tick = time.perf_counter()
                continue
            self._stop.wait(delay)

    def _sample_once(self, own_ident: int) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        stacks: Dict[str, str] = {}
        for ident, frame in frames.items():
            if ident == own_ident:
                continue
            name = names.get(ident, f"thread-{ident}")
            stacks[name] = _fold_stack(frame, self.max_depth)
        row = {"t": round(time.time(), 4), "stacks": stacks}
        with self._lock:
            self.samples += 1
            self._ring.append(row)
            for name, folded in stacks.items():
                table = self._tables.setdefault(name, Counter())
                if folded not in table and len(table) >= self.max_stacks:
                    self.stacks_dropped += 1
                    table["<overflow>"] += 1
                else:
                    table[folded] += 1

    def stop(self) -> None:
        """Stop sampling and join the sampler thread (idempotent; the join
        is bounded)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(1.0, 4 * self._interval))

    def __enter__(self) -> "SamplingProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- reads ------------------------------------------------------------

    def tables(self) -> Dict[str, Dict[str, int]]:
        """Per-thread folded-stack counts (copies)."""
        with self._lock:
            return {name: dict(c) for name, c in self._tables.items()}

    def ring_tail(self, seconds: Optional[float] = None) -> List[dict]:
        """Raw tick rows of the last ``seconds`` (default: the whole ring),
        oldest first."""
        with self._lock:
            rows = list(self._ring)
        if seconds is None:
            return rows
        cutoff = time.time() - max(0.0, float(seconds))
        return [r for r in rows if r["t"] >= cutoff]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "hz": self.hz,
                "uptime_s": round(time.time() - self._t0, 3),
                "samples": self.samples,
                "overruns": self.overruns,
                "stacks_dropped": self.stacks_dropped,
                "threads": len(self._tables),
                "stacks": sum(len(c) for c in self._tables.values()),
                "ring_rows": len(self._ring),
            }

    # -- metrics and flushes ----------------------------------------------

    def update_gauges(self, registry) -> None:
        """Fold the sampler's accounting into a run registry (the
        ``soup_profile_*`` family); counters advance by delta."""
        s = self.stats()
        for key, name, help_ in (
                ("samples", "soup_profile_samples_total",
                 "profiler stack-sample ticks taken"),
                ("overruns", "soup_profile_overruns_total",
                 "sampler ticks that missed their deadline"),
                ("stacks_dropped", "soup_profile_stacks_dropped_total",
                 "stack folds past the bounded per-thread table")):
            delta = s[key] - self._counted[key]
            self._counted[key] = s[key]
            registry.counter(name, help=help_).inc(max(0, delta))
        registry.gauge("soup_profile_threads",
                       help="threads with folded-stack tables").set(
                           s["threads"])
        registry.gauge("soup_profile_stacks",
                       help="distinct folded stacks tracked").set(
                           s["stacks"])

    def folded_lines(self) -> List[str]:
        """The flamegraph exchange format: ``thread;frame;... count``."""
        lines = []
        for name, table in sorted(self.tables().items()):
            for folded, n in sorted(table.items(),
                                    key=lambda kv: (-kv[1], kv[0])):
                lines.append(f"{name};{folded} {n}")
        return lines

    def write_files(self, run_dir: str) -> None:
        """Atomically rewrite the cumulative profile artifacts."""
        from ..experiment import atomic_write_text

        atomic_write_text(os.path.join(run_dir, PROFILE_FOLDED_NAME),
                          "\n".join(self.folded_lines()) + "\n")
        rows = [json.dumps({"kind": "profile_meta", **self.stats()})]
        for name, table in sorted(self.tables().items()):
            for folded, n in sorted(table.items(),
                                    key=lambda kv: (-kv[1], kv[0])):
                rows.append(json.dumps(
                    {"thread": name, "stack": folded, "count": n}))
        atomic_write_text(os.path.join(run_dir, PROFILE_JSONL_NAME),
                          "\n".join(rows) + "\n")

    def flush(self, run_dir: str, writer=None, registry=None) -> None:
        """One flush turn: fold the profiler gauges inline and ride the
        artifact rewrite on the run's writer."""
        from ..utils.pipeline import submit_or_run

        if registry is not None:
            self.update_gauges(registry)
        submit_or_run(writer, self.write_files, run_dir)


# ---------------------------------------------------------------------------
# utilization decomposition
# ---------------------------------------------------------------------------


def utilization_from_pipeline(row: Dict[str, Any]) -> Dict[str, float]:
    """Device-busy / host-blocked / idle fractions of one chunk from its
    ``OverlapMeter`` row (``wall_s`` / ``device_wait_s`` / ``host_io_s``):
    ``device_busy`` the device-wait share of the wall (a lower bound),
    ``host_blocked`` the host-I/O share not hidden behind device work
    (``min(host_io, wall - device_wait) / wall``), ``idle`` the rest (an
    upper bound on idleness).  The three sum to 1."""
    wall = float(row.get("wall_s", 0.0) or 0.0)
    if wall <= 0:
        return {"device_busy": 0.0, "host_blocked": 0.0, "idle": 0.0}
    wait = max(0.0, float(row.get("device_wait_s", 0.0) or 0.0))
    io = max(0.0, float(row.get("host_io_s", 0.0) or 0.0))
    busy = min(1.0, wait / wall)
    blocked = min(min(io, max(0.0, wall - wait)) / wall, 1.0 - busy)
    idle = max(0.0, 1.0 - busy - blocked)
    return {"device_busy": round(busy, 4),
            "host_blocked": round(blocked, 4),
            "idle": round(idle, 4)}


def update_utilization_gauges(registry,
                              pipeline_row: Dict[str, Any]
                              ) -> Dict[str, float]:
    """One chunk's decomposition as the ``soup_utilization_*`` gauges;
    returns the fractions."""
    u = utilization_from_pipeline(pipeline_row)
    g = registry.gauge
    g("soup_utilization_device_busy",
      help="device-busy fraction of the last chunk (host-observed "
           "lower bound: device-wait share of wall)").set(
          u["device_busy"])
    g("soup_utilization_host_blocked",
      help="host-blocked fraction of the last chunk (host I/O not "
           "hidden behind device compute)").set(u["host_blocked"])
    g("soup_utilization_idle",
      help="idle fraction of the last chunk (upper bound on device "
           "idleness: 1 - busy - blocked)").set(u["idle"])
    return u


# ---------------------------------------------------------------------------
# anomaly-triggered capture
# ---------------------------------------------------------------------------


class AnomalyCapture:
    """Capture on the alert engine's firing edge.

    Each ``state == "firing"`` transition publishes one bundle under
    ``<run_dir>/anomaly/<rule>-<seq>/``: ``capture.json`` (the transition,
    profiler stats, torch / CUDA metadata; always lands), ``samples.jsonl``
    (the ring's last ``ring_s`` seconds), ``threads.json``,
    ``metrics.json``, ``exemplars.jsonl`` (a copy, where the run has one),
    and ``trace/trace.json``: a ``torch.profiler`` window armed on a card,
    closed by the next sample turn (:meth:`turn`).  The bundle is made in
    a dot-tmp sibling and renamed into place; past ``max_bundles`` the
    oldest is removed.  Fail-soft throughout."""

    def __init__(self, run_dir: str, profiler: Optional[SamplingProfiler]
                 = None, registry=None, max_bundles: int = 4,
                 ring_s: float = 30.0, device_trace: bool = True):
        self.run_dir = run_dir
        self.profiler = profiler
        self.registry = registry
        self.max_bundles = max(1, int(max_bundles))
        self.ring_s = float(ring_s)
        self.device_trace = bool(device_trace)
        self.captures: List[str] = []
        self.errors = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._trace = None

    # -- the hook ---------------------------------------------------------

    def on_transitions(self, transitions: List[dict], **context) -> None:
        """One sample turn's alert transitions: close a trace window armed
        by the previous firing edge, then capture each new firing edge."""
        self.turn()
        for t in transitions or []:
            if t.get("state") == "firing":
                try:
                    self.capture(t, **context)
                except Exception as e:  # forensic, never load-bearing
                    self.errors += 1
                    print(f"anomaly capture failed for "
                          f"{t.get('rule')}: {type(e).__name__}: {e}",
                          file=sys.stderr, flush=True)

    def capture(self, transition: dict, **context) -> str:
        """Publish one bundle for a firing transition; returns its path."""
        from .flightrec import _backend_metadata

        rule = str(transition.get("rule", "anomaly")).replace("/", "_")
        with self._lock:
            seq = self._seq
            self._seq += 1
        root = os.path.join(self.run_dir, ANOMALY_DIR)
        os.makedirs(root, exist_ok=True)
        final = os.path.join(root, f"{rule}-{seq:04d}")
        while os.path.exists(final):  # a restarted attempt resumes seq
            with self._lock:
                seq = self._seq
                self._seq += 1
            final = os.path.join(root, f"{rule}-{seq:04d}")
        tmp = os.path.join(root, f".tmp-{rule}-{seq:04d}-{os.getpid()}")
        os.makedirs(tmp)

        doc: Dict[str, Any] = {
            "rule": rule,
            "seq": seq,
            "time": round(time.time(), 3),
            "transition": dict(transition),
            "context": {k: v for k, v in context.items() if v is not None},
            "ring_s": self.ring_s,
        }
        errors: Dict[str, str] = {}
        if self.profiler is not None:
            doc["profiler"] = self.profiler.stats()
            try:
                with open(os.path.join(tmp, "samples.jsonl"), "w") as f:
                    for row in self.profiler.ring_tail(self.ring_s):
                        f.write(json.dumps(row) + "\n")
            except OSError as e:
                errors["samples"] = str(e)
        try:
            with open(os.path.join(tmp, "threads.json"), "w") as f:
                json.dump(thread_dump(), f, indent=1)
        except Exception as e:
            errors["threads"] = f"{type(e).__name__}: {e}"
        if self.registry is not None:
            try:
                with open(os.path.join(tmp, "metrics.json"), "w") as f:
                    json.dump(self.registry.rows(), f, indent=1,
                              sort_keys=True)
            except Exception as e:
                errors["metrics"] = f"{type(e).__name__}: {e}"
        ex_src = os.path.join(self.run_dir, EXEMPLARS_NAME)
        if os.path.exists(ex_src):
            try:
                shutil.copy(ex_src, os.path.join(tmp, EXEMPLARS_NAME))
            except OSError as e:
                errors["exemplars"] = str(e)
        doc["backend"] = _backend_metadata()
        if errors:
            doc["errors"] = errors
        with open(os.path.join(tmp, "capture.json"), "w") as f:
            json.dump(doc, f, indent=1, default=str)
        os.rename(tmp, final)  # atomic publish

        self.captures.append(final)
        if self.registry is not None:
            self.registry.counter(
                "soup_anomaly_captures_total",
                help="anomaly bundles captured on alert firing "
                     "edges").inc(1, rule=rule)
        self._arm_trace(os.path.join(final, "trace"),
                        doc["backend"].get("backend"))
        self._retain(root)
        return final

    def _retain(self, root: str) -> None:
        """FIFO eviction past the bundle bound (oldest by mtime)."""
        try:
            dirs = [os.path.join(root, d) for d in os.listdir(root)
                    if not d.startswith(".")
                    and os.path.isdir(os.path.join(root, d))]
        except OSError:
            return
        if len(dirs) <= self.max_bundles:
            return
        dirs.sort(key=lambda p: os.path.getmtime(p))
        for victim in dirs[:len(dirs) - self.max_bundles]:
            try:
                shutil.rmtree(victim)
            except OSError:
                pass

    # -- the armed trace window -------------------------------------------

    def _arm_trace(self, path: str, backend: Optional[str]) -> None:
        """Arm a ``torch.profiler`` window into the bundle on a card (on
        the CPU the sampler has the host already); one window at a time,
        closed by :meth:`turn`."""
        if not self.device_trace or self._trace is not None:
            return
        if backend in (None, "cpu"):
            return
        try:
            import torch

            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            self._trace = (prof, path)
        except Exception:
            pass  # a broken profiler must never break the run

    def turn(self) -> None:
        """Close a trace window armed by the previous firing edge (the
        sample cadence bounds the window)."""
        self.stop_trace()

    def stop_trace(self) -> None:
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

    def close(self) -> None:
        """Teardown: close any armed trace window (idempotent)."""
        self.stop_trace()


def capture_index(run_dir: str) -> List[Dict[str, Any]]:
    """The run's published anomaly bundles, oldest first: name, rule /
    seq / time from capture.json, and which artifacts landed.  Dot-tmp
    assembly directories are invisible."""
    root = os.path.join(run_dir, ANOMALY_DIR)
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if name.startswith(".") or not os.path.isdir(path):
            continue
        entry: Dict[str, Any] = {"name": name, "path": os.path.abspath(path)}
        try:
            with open(os.path.join(path, "capture.json")) as f:
                doc = json.load(f)
            entry.update({k: doc.get(k) for k in
                          ("rule", "seq", "time", "context")})
            entry["profiler"] = doc.get("profiler")
        except (OSError, json.JSONDecodeError):
            entry["unreadable"] = True
        for artifact in ("samples.jsonl", "threads.json", "metrics.json",
                         "exemplars.jsonl"):
            entry[artifact.split(".")[0]] = os.path.exists(
                os.path.join(path, artifact))
        trace_dir = os.path.join(path, "trace")
        entry["trace"] = os.path.isdir(trace_dir) \
            and any(os.scandir(trace_dir))
        out.append(entry)
    return sorted(out, key=lambda e: (e.get("time") or 0, e["name"]))
