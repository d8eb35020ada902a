"""Span tracing: wall-clock phase timing and the structured span records of
a run; port of ``srnn_tpu/telemetry/tracing.py``.

  * :func:`annotate` (``torch.profiler.record_function``) -- a named range
    that shows in ``torch.profiler`` traces (the JAX package's
    ``jax.named_scope``).
  * :func:`span` -- host-side wall-clock timing of a code block, recorded
    into a registry histogram (``srnn_span_seconds{span=...}``) and
    optionally as an ``events.jsonl`` row.  :meth:`Span.sync` names a
    tensor (or a tree of them) whose computation the span waits for at its
    exit: a CUDA tensor's card is synchronised.
  * :class:`SpanStream` -- run-scoped structured span records
    (``trace_id`` / ``span_id`` / ``parent``, run-relative monotonic start
    and duration, the emitting process) appended as ``{"kind": "span"}``
    rows through the run's event channel, riding the ``BackgroundWriter``
    when one is attached.  The JAX package's ``telemetry.fleet`` merges
    them into the run's timeline (``perfetto_trace``).

The JAX package's ``trace`` (a full device trace into a directory) is
``utils.profiling.trace``, a ``torch.profiler`` window of the host and the
card written into a directory; the watchdog and the anomaly capture arm
``torch.profiler`` themselves.
"""

import contextlib
import itertools
import threading
import time
from typing import Any, Optional

import torch

from .metrics import RUNTIME, MetricsRegistry

#: a named range in ``torch.profiler`` traces (``jax.named_scope``'s role)
annotate = torch.profiler.record_function


def _leaves(value: Any):
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _leaves(v)
    else:
        yield value


def _readback(value: Any) -> None:
    """Wait until the computation of ``value`` (a tensor or a tree of
    tensors) has finished: a CUDA tensor's card is synchronised; a CPU
    tensor is complete already."""
    for leaf in _leaves(value):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


class Span:
    """The in-flight record :func:`span` yields; ``seconds`` is set on
    exit.  :meth:`sync` names a tensor whose computation the span must
    wait for at its exit."""

    __slots__ = ("name", "seconds", "_sync_value")

    def __init__(self, name: str):
        self.name = name
        self.seconds: Optional[float] = None
        self._sync_value: Any = None

    def sync(self, value):
        """Register ``value`` for completion at span exit; returns it
        unchanged."""
        self._sync_value = value
        return value


@contextlib.contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None,
         exp=None, **labels):
    """Time a block of host code (usually launches on the card).

    >>> with span("soup.chunk", registry=reg, exp=exp) as s:
    ...     state = s.sync(evolve(cfg, state, generations=100))

    Enters :func:`annotate` (``name``), measures wall seconds with the
    work waited for when :meth:`Span.sync` was called, then records the
    duration into ``registry``'s ``span_seconds`` histogram (label
    ``span=name`` and any extra labels; default registry: the process's
    ``RUNTIME``) and, given ``exp``, appends a ``{"kind": "span"}`` row to
    its ``events.jsonl``."""
    reg = RUNTIME if registry is None else registry
    s = Span(name)
    with annotate(name):
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            if s._sync_value is not None:
                _readback(s._sync_value)
            s.seconds = time.perf_counter() - t0
            reg.histogram(
                "span_seconds",
                help="wall-clock seconds of telemetry.span blocks",
                unit="seconds").observe(s.seconds, span=name, **labels)
            if exp is not None:
                exp.event(kind="span", span=name,
                          seconds=round(s.seconds, 6), **labels)


class SpanStream:
    """Run-scoped structured span emitter.

    Each row is a trace record: ``trace_id`` (stable for the run: the run
    directory's basename for the mega runs), ``span_id`` (monotone per
    stream; ``parent`` links a child such as a chunk's ``device_wait`` /
    ``host_io`` halves to its span), ``start_s`` / ``seconds`` (run-relative
    ``time.monotonic`` start and duration) and ``process``.

    Rows ride ``exp.event``, through a ``BackgroundWriter`` when one is
    given, so that the producing thread only enqueues; the ``span_seconds``
    histogram (label ``span=name``) is folded in the same job.  A stream
    never touches a tensor, so spans cannot perturb a run's results.
    """

    def __init__(self, exp, trace_id: str, process: int = 0,
                 writer=None, registry: Optional[MetricsRegistry] = None):
        self.exp = exp
        self.trace_id = str(trace_id)
        self.process = int(process)
        self.writer = writer
        self.registry = registry
        self._t0 = time.monotonic()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def now(self) -> float:
        """Run-relative monotonic seconds (the ``start_s`` clock)."""
        return time.monotonic() - self._t0

    def emit(self, name: str, start_s: float, dur_s: float,
             parent: Optional[int] = None, **labels) -> int:
        """Record one finished span; returns its ``span_id`` (for a later
        child's ``parent``).  All values are computed here; the sink job
        only appends."""
        with self._lock:
            sid = next(self._ids)
        row = dict(span=name, trace_id=self.trace_id, span_id=sid,
                   process=self.process, start_s=round(float(start_s), 6),
                   seconds=round(float(dur_s), 6), **labels)
        if parent is not None:
            row["parent"] = int(parent)

        def sink():
            self.exp.event(kind="span", **row)
            if self.registry is not None:
                self.registry.histogram(
                    "span_seconds",
                    help="wall-clock seconds of telemetry.span blocks",
                    unit="seconds").observe(row["seconds"], span=name)

        if self.writer is not None:
            self.writer.submit(sink)
        else:
            sink()
        return sid

    @contextlib.contextmanager
    def timed(self, name: str, parent: Optional[int] = None, **labels):
        """Context-manager spelling of :meth:`emit` for host code whose
        bounds are the block itself.  Yields a dict the block may add
        labels to."""
        start = self.now()
        extra: dict = {}
        try:
            yield extra
        finally:
            self.emit(name, start, self.now() - start, parent=parent,
                      **{**labels, **extra})
