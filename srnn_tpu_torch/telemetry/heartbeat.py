"""Run heartbeats: periodic liveness rows, so that a killed or timed-out run
leaves an attributable trail; port of ``srnn_tpu/telemetry/heartbeat.py``.

A :class:`Heartbeat` row carries the stage, the generation (of the total),
generations/s, the host's resident set size and the card's memory, written
through ``Experiment.event`` with ``fsync`` so that the tail survives a
SIGKILL.  The rows keep the JAX package's keys (``device_memory`` holds
``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit``), so its
``report`` reads them.

The helpers are fail-soft: a platform without ``/proc`` or without a card
yields rows without those fields, never an exception in the run loop.
"""

import resource
import sys
import time
from typing import Dict, Optional


def rss_bytes() -> Optional[int]:
    """Current resident set size of this process, or ``None`` when the
    platform offers no way to read it."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * resource.getpagesize()
    except (OSError, IndexError, ValueError):
        pass
    try:
        # portable fallback: the PEAK rss (ru_maxrss is KiB on linux,
        # bytes on macOS)
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except (OSError, ValueError):
        return None


def device_memory_stats() -> Optional[Dict[str, int]]:
    """The caching allocator's use of the current card under the JAX
    package's key names: ``bytes_in_use`` (allocated), ``peak_bytes_in_use``
    (its peak) and ``bytes_limit`` (the card's total memory).  ``None``
    without an initialised card (the CPU, as the JAX package's CPU
    backend reports none).  Never raises.

    It reads ``torch.cuda.memory_stats`` (allocator bookkeeping on the host)
    and, for the limit, the device properties; it never asks the card, so a
    beat costs no synchronisation."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats()
        out = {}
        if "allocated_bytes.all.current" in stats:
            out["bytes_in_use"] = int(stats["allocated_bytes.all.current"])
        if "allocated_bytes.all.peak" in stats:
            out["peak_bytes_in_use"] = int(stats["allocated_bytes.all.peak"])
        dev = torch.cuda.current_device()
        out["bytes_limit"] = int(torch.cuda.get_device_properties(
            dev).total_memory)
    except Exception:
        return None
    return out or None


class Heartbeat:
    """Emitter of ``{"kind": "heartbeat", ...}`` rows for one run stage.

    >>> hb = Heartbeat(exp, stage="mega_soup", total_generations=1000)
    >>> hb.beat(generation=100, gens_per_sec=28.5)

    Rows are fsync'd (the point is surviving a kill); each also carries
    ``beat`` (a per-instance sequence number) and the seconds since the
    previous beat.  ``fsync_every=N`` syncs only every N-th row (every row
    is still flushed).  ``writer`` (a ``utils.pipeline.BackgroundWriter``)
    moves the sink write -- fsync and gauge updates, as one ordered job --
    off the producing thread; the row is composed (rss and card memory
    read) at beat time.
    """

    def __init__(self, exp, stage: str, total_generations: Optional[int] = None,
                 registry=None, fsync_every: int = 1, writer=None):
        self.exp = exp
        self.stage = stage
        self.total_generations = total_generations
        self.registry = registry
        self.fsync_every = max(1, int(fsync_every))
        self.writer = writer
        self.count = 0
        self._last_t: Optional[float] = None

    def beat(self, generation: Optional[int] = None,
             gens_per_sec: Optional[float] = None, **extra) -> dict:
        now = time.monotonic()
        row = {"stage": self.stage, "beat": self.count}
        if generation is not None:
            row["generation"] = int(generation)
        if self.total_generations is not None:
            row["total_generations"] = int(self.total_generations)
        if gens_per_sec is not None:
            row["gens_per_sec"] = round(float(gens_per_sec), 3)
        if self._last_t is not None:
            row["since_last_s"] = round(now - self._last_t, 3)
        rss = rss_bytes()
        if rss is not None:
            row["rss_mb"] = round(rss / 2 ** 20, 1)
        dev = device_memory_stats()
        if dev is not None:
            row["device_memory"] = dev
        row.update(extra)
        fsync = (self.count % self.fsync_every) == 0

        def sink():
            # one job: the row and the gauges, all values taken at beat
            # time, so registry mutations stay ordered with the queued
            # flush_events snapshots
            self.exp.event(_fsync=fsync, kind="heartbeat", **row)
            if self.registry is not None:
                g = self.registry.gauge
                if generation is not None:
                    g("heartbeat_generation",
                      help="last heartbeat's generation").set(
                          int(generation), stage=self.stage)
                if gens_per_sec is not None:
                    g("gens_per_sec", help="generations per second",
                      unit="1/s").set(round(float(gens_per_sec), 3),
                                      stage=self.stage)
                if rss is not None:
                    g("rss_bytes", help="host resident set size",
                      unit="bytes").set(rss, stage=self.stage)

        if self.writer is not None:
            self.writer.submit(sink)
        else:
            sink()
        self.count += 1
        self._last_t = now
        return row
