"""Async host/device pipeline: dispatch-ahead chunks, non-blocking frame
capture, and background checkpoint/telemetry I/O; port of
``srnn_tpu/utils/pipeline.py``.

The device stays busy while a single background worker drains the host
work:

  * :func:`snapshot` -- a copy of a tree's tensors to the host, started at
    once on a side CUDA stream into page-locked buffers (a
    :class:`PinnedPool`), and :func:`resolve`, which waits for it before
    any host read.  The JAX package copies on the device before a donating
    dispatch; nothing here is donated, and no soup phase writes into a
    state's tensors in place, so the copy reads the producer's tensors
    themselves (``record_stream`` holds them until it lands).
  * :class:`BackgroundWriter` -- ONE worker thread draining a bounded FIFO
    queue of host jobs (``TrajStore`` appends, checkpoint saves).
    ``submit`` blocks when the queue is full (the backpressure contract:
    the producing loop runs at most ``maxsize`` host jobs ahead, which also
    bounds the page-locked memory held by queued snapshots).  Jobs run in
    submission order; the first job error latches, later jobs are skipped,
    and the error re-raises on the next ``submit`` / ``flush`` / ``close``.
    ``close()`` drains, joins, and runs the registered close hooks (e.g.
    ``TrajStore.join``), so shutdown -- clean or crashed -- leaves no
    orphan thread and no buffered frame.
  * :class:`ChunkDriver` -- the double-buffered dispatch-ahead scheduler:
    dispatch chunk *k+1*'s device work, *then* run chunk *k*'s host
    finisher (``depth=1``); ``depth=0`` is the blocking order.
  * :class:`OverlapMeter` -- host-side attribution of each chunk's wall
    time into device-wait and host-I/O seconds, exported as ``pipeline_*``
    gauges and counters of a ``telemetry.MetricsRegistry`` when given one.

Thread hygiene: :func:`spawn_thread` is the only way this package starts a
thread -- it registers the thread with the module's join-on-exit registry
(``live_threads`` audits it), and threads default to non-daemon so
interpreter exit cannot strand buffered I/O.
"""

from __future__ import annotations

import errno
import queue
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, List, Optional

import torch

# ---------------------------------------------------------------------------
# thread registry: every thread this package starts is accounted for
# ---------------------------------------------------------------------------

_THREADS: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
_THREADS_LOCK = threading.Lock()


def register_thread(thread: threading.Thread) -> threading.Thread:
    """Add ``thread`` to the join-on-exit registry.  Owners still join
    their own threads (``BackgroundWriter.close``); the registry exists so
    shutdown tests — and operators — can audit that nothing survived."""
    with _THREADS_LOCK:
        _THREADS.add(thread)
    return thread


def live_threads() -> List[threading.Thread]:
    """Registered threads that are still alive (empty after every pipeline
    owner has been ``close()``d — the no-orphan-threads invariant)."""
    with _THREADS_LOCK:
        return [t for t in _THREADS if t.is_alive()]


def spawn_thread(target: Callable, *, name: str, daemon: bool = False,
                 args: tuple = (), kwargs: Optional[dict] = None
                 ) -> threading.Thread:
    """The package's thread factory: explicit daemon-ness (non-daemon by
    default, so buffered I/O is never stranded by interpreter exit) and
    registration with the join-on-exit registry."""
    t = threading.Thread(target=target, name=name, args=args,
                         kwargs=kwargs or {}, daemon=daemon)
    register_thread(t)
    t.start()
    return t


# ---------------------------------------------------------------------------
# the bounded background writer
# ---------------------------------------------------------------------------


class WriterError(RuntimeError):
    """A background job failed; raised on the submitting thread at the
    next ``submit``/``flush``/``close`` after the failure.  The message
    names the failed job (its function name) so an operator — or the run
    supervisor's fault log — sees *which* write died, not just that one
    did."""


#: errnos retried in place by the worker before the permanent latch trips:
#: interrupted syscalls and would-block conditions are transient by
#: definition; ENOSPC gets its own *time*-bounded grace (logs rotate,
#: sibling runs finish) configured per writer.
_TRANSIENT_ERRNOS = frozenset({errno.EINTR, errno.EAGAIN})


class BackgroundWriter:
    """Single worker thread draining a bounded FIFO of host-I/O jobs.

    >>> w = BackgroundWriter(name="capture-io")
    >>> w.submit(store.append, gen, weights, ...)   # returns immediately
    >>> w.flush()                                   # barrier: queue drained
    >>> w.close()                                   # drain + join + hooks

    Contract:

    * **Order** — jobs run in submission order (one worker, FIFO queue),
      so "frames before the checkpoint that supersedes them" and every
      other cross-job invariant of the blocking loop is preserved.
    * **Backpressure** — ``submit`` blocks while ``maxsize`` jobs are
      pending; a producer can run at most one bounded window ahead.
    * **Errors** — *transient* I/O failures (``EINTR``/``EAGAIN``, and
      ``ENOSPC`` within a configurable grace window) are retried in
      place with exponential backoff; the first error that survives its
      retry budget latches: subsequent jobs are skipped (a checkpoint
      must never land after its chunk's frame appends failed) and the
      error re-raises, wrapped in :class:`WriterError` **naming the
      failed job**, on the next call into the writer.
    * **Shutdown** — ``close()`` drains the queue, joins the worker, runs
      close hooks (e.g. ``TrajStore.join``), and re-raises any latched
      error.  Idempotent; also the context-manager ``__exit__``.
    """

    def __init__(self, maxsize: int = 8, name: str = "srnn-io",
                 io_retries: int = 3, retry_backoff_s: float = 0.05,
                 enospc_grace_s: float = 5.0):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(maxsize)))
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._error_job: Optional[str] = None
        self._failed = False       # latched forever once any job raised
        self._closed = False
        self._busy_s = 0.0
        self.jobs_done = 0
        self.jobs_retried = 0
        self.io_retries = max(0, int(io_retries))
        self.retry_backoff_s = max(0.0, float(retry_backoff_s))
        self.enospc_grace_s = max(0.0, float(enospc_grace_s))
        self._close_hooks: List[Callable[[], None]] = []
        self._thread = spawn_thread(self._run, name=name)

    # -- worker ----------------------------------------------------------

    def _execute(self, fn, args, kwargs) -> Optional[BaseException]:
        """Run one job with the transient-I/O retry loop; return the
        error that should latch (None on success).  EINTR/EAGAIN retry up
        to ``io_retries`` times; ENOSPC retries while the grace window is
        open (disk pressure is a fleet condition that clears on its own
        schedule, not a count of attempts).

        Caveat for append-shaped jobs: a retry re-runs the WHOLE job, so
        a partial write followed by a successful retry can leave torn
        bytes mid-stream.  Both stream formats tolerate it — ``.traj``
        frames are CRC-checked (a torn frame drops on read) and every
        jsonl reader in the repo skips unparseable lines — so the cost
        is one lost row, against the satellite win of surviving the
        EINTR/ENOSPC blips that used to kill whole mega runs."""
        attempt = 0
        t0 = time.monotonic()
        while True:
            try:
                fn(*args, **kwargs)
                return None
            except OSError as e:
                transient = e.errno in _TRANSIENT_ERRNOS \
                    and attempt < self.io_retries
                enospc = e.errno == errno.ENOSPC \
                    and (time.monotonic() - t0) < self.enospc_grace_s
                if not (transient or enospc):
                    return e
                attempt += 1
                with self._lock:
                    self.jobs_retried += 1
                time.sleep(min(self.retry_backoff_s * (2.0 ** (attempt - 1)),
                               1.0))
            except BaseException as e:
                return e

    def _run(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                fn, args, kwargs = job
                with self._lock:
                    skip = self._failed
                if skip:
                    continue
                t0 = time.perf_counter()
                try:
                    err = self._execute(fn, args, kwargs)
                    if err is not None:  # latch; surface on the producer
                        with self._lock:
                            self._error = err
                            self._error_job = getattr(fn, "__name__",
                                                      repr(fn))
                            self._failed = True
                finally:
                    dt = time.perf_counter() - t0
                    with self._lock:
                        self._busy_s += dt
                        self.jobs_done += 1
            finally:
                self._q.task_done()

    # -- producer API ----------------------------------------------------

    @property
    def busy_s(self) -> float:
        """Cumulative seconds the worker spent executing jobs (the
        host-I/O side of :class:`OverlapMeter`'s attribution)."""
        with self._lock:
            return self._busy_s

    @property
    def failed(self) -> bool:
        with self._lock:
            return self._failed

    def _job_failure_message(self, err: BaseException) -> str:
        job = self._error_job or "<unknown>"
        return (f"background writer job '{job}' failed: "
                f"{type(err).__name__}: {err}")

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise WriterError(self._job_failure_message(err)) from err

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        """Enqueue ``fn(*args, **kwargs)``; blocks while the queue is full
        (the backpressure bound) and raises any latched job error.  A
        writer that has ever failed refuses all further jobs — they would
        be skipped anyway, and a silent no-op submit would let a producer
        loop run on believing its I/O is landing."""
        if self._closed:
            raise WriterError("submit() on a closed BackgroundWriter")
        self._raise_pending()
        if self.failed:
            raise WriterError(
                "background writer already failed; job refused")
        self._q.put((fn, args, kwargs))

    def flush(self) -> None:
        """Block until every submitted job has executed, then raise any
        latched job error."""
        self._q.join()
        self._raise_pending()

    def add_close_hook(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` during ``close()`` after the queue drains — the slot
        a ``TrajStore`` hands its flush/join hook to, so even an
        error-path shutdown leaves the frames that DID append durable."""
        self._close_hooks.append(fn)

    def close(self) -> None:
        """Drain, join the worker, run close hooks; idempotent.  Raises
        the latched job (or hook) error after the thread is down."""
        with self._lock:
            already = self._closed
            self._closed = True
        if already:
            self._raise_pending()
            return
        self._q.put(None)               # after all queued jobs (FIFO)
        self._thread.join()
        hook_err: Optional[BaseException] = None
        for hook in self._close_hooks:
            try:
                hook()
            except BaseException as e:
                hook_err = hook_err or e
        # surface BOTH failure kinds in one error: a latched job error
        # must not swallow a close-hook failure (the operator needs to
        # know the store flush ALSO failed, i.e. what is actually durable)
        with self._lock:
            job_err, self._error = self._error, None
        if job_err is not None or hook_err is not None:
            parts = [self._job_failure_message(job_err)
                     ] if job_err is not None else []
            if hook_err is not None:
                parts.append(f"close hook failed: "
                             f"{type(hook_err).__name__}: {hook_err}")
            raise WriterError("; ".join(parts)) from (job_err or hook_err)

    def __enter__(self) -> "BackgroundWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def submit_or_run(writer: Optional[BackgroundWriter], fn: Callable,
                  *args, **kwargs) -> None:
    """Route one host job through ``writer`` when pipelining, else run it
    inline — the single switch the mega loops use for A/B parity."""
    if writer is None:
        fn(*args, **kwargs)
    else:
        writer.submit(fn, *args, **kwargs)


# ---------------------------------------------------------------------------
# snapshots: a copy of a tree's tensors to the host, started now, read later
# ---------------------------------------------------------------------------


class PinnedPool:
    """Page-locked host buffers for :func:`snapshot`, reused by shape and
    dtype.  A copy from the card into pageable memory is synchronous, and
    allocating page-locked memory for every frame costs milliseconds at
    tens of MB, so the buffers of a snapshot go back to the pool once its
    consumer has read them (:meth:`Snapshot.release`).  The pool grows to
    the largest number of snapshots alive at once, which a
    :class:`BackgroundWriter`'s bound caps (``maxsize`` queued + one
    running + one being taken)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict = {}
        self.allocated = 0

    def take(self, shape, dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        with self._lock:
            free = self._free.get(key)
            if free:
                return free.pop()
            self.allocated += 1
        return torch.empty(key[0], dtype=dtype, pin_memory=True)

    def give(self, buf: torch.Tensor) -> None:
        with self._lock:
            self._free.setdefault((tuple(buf.shape), buf.dtype),
                                  []).append(buf)


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    """The copy stream of ``device`` (one per card, made at first use)."""
    stream = _SIDE_STREAMS.get(device.index)
    if stream is None:
        stream = _SIDE_STREAMS[device.index] = torch.cuda.Stream(device)
    return stream


class Snapshot:
    """A tree whose tensors are host copies, some still in flight: read it
    with :func:`resolve`, then :meth:`release` its buffers to their pool."""

    def __init__(self, tree, events, buffers, pool):
        self.tree = tree
        self._events = events
        self._buffers = buffers
        self._pool = pool

    def wait(self) -> None:
        """Block until every copy of the snapshot has landed."""
        for e in self._events:
            e.synchronize()

    def release(self) -> None:
        """Hand the page-locked buffers back to their pool (after the
        last read of the resolved arrays); idempotent."""
        if self._pool is not None:
            for buf in self._buffers:
                self._pool.give(buf)
        self._buffers = []


def _map(fn, tree):
    """``fn`` over the leaves of a tree of tuples and lists."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def snapshot(tree: Any, pool: Optional[PinnedPool] = None) -> Snapshot:
    """Copies of every tensor leaf of ``tree`` (tuples and lists of
    tensors) on the host, started now and read later
    (``pipeline.snapshot`` of the JAX package, for CUDA).

    A CUDA tensor is copied on its card's side stream, after an event
    recorded on the producing (current) stream, into a page-locked buffer
    from ``pool`` (``non_blocking``); ``record_stream`` keeps the caching
    allocator from reusing the source while the copy is in flight, so the
    producer may drop it at once.  The call costs a few launches, not a
    round trip.  A CPU tensor is cloned.  Nothing in the soups writes into
    a state's tensors in place (every phase makes new ones), so the copy
    needs no wait on the next generation.  :func:`resolve` waits for the
    copies before any host read."""
    events, buffers = [], []
    ready = {}

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.device.type != "cuda":
            return x.clone()
        dev = x.device
        stream = _side_stream(dev)
        if dev.index not in ready:
            ready[dev.index] = torch.cuda.current_stream(dev).record_event()
            stream.wait_event(ready[dev.index])
        buf = (pool.take(x.shape, x.dtype) if pool is not None else
               torch.empty(x.shape, dtype=x.dtype, pin_memory=True))
        with torch.cuda.stream(stream):
            buf.copy_(x, non_blocking=True)
        x.record_stream(stream)
        buffers.append(buf)
        return buf

    out = _map(copy, tree)
    for index in ready:
        events.append(_SIDE_STREAMS[index].record_event())
    return Snapshot(out, events, buffers, pool)


def resolve(tree: Any) -> Any:
    """Materialize a :class:`Snapshot` (after its copies land) or any tree
    of tensors as numpy arrays on the host."""
    if isinstance(tree, Snapshot):
        tree.wait()
        tree = tree.tree

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return _map(host, tree)


# ---------------------------------------------------------------------------
# dispatch-ahead chunk scheduling
# ---------------------------------------------------------------------------


class StallError(RuntimeError):
    """A chunk finisher exceeded the :class:`ChunkDriver` stall deadline:
    the dispatch-ahead loop is wedged (a hung device resolve, a dead
    tunnel).  Carries ``bundle`` — the triage-bundle path the stall
    handler wrote, if any — so the failure names an artifact instead of
    an opaque timeout."""

    def __init__(self, message: str, bundle: Optional[str] = None):
        super().__init__(message)
        self.bundle = bundle


class ChunkDriver:
    """Run chunk *k*'s host finisher after chunk *k+1*'s device dispatch.

    The mega loops call ``step(finish)`` once per chunk, right after
    dispatching that chunk's device work; the driver holds up to ``depth``
    finishers and runs the oldest one as the ``depth+1``-th arrives —
    i.e. with the next chunk already queued on the device.  ``depth=1``
    is the double-buffered production shape; ``depth=0`` runs finishers
    immediately (the blocking order, for parity/A-B runs).  ``drain()``
    runs whatever is still pending (call it after the loop).

    **Stall deadline** (the flight recorder's liveness half):
    ``stall_timeout_s > 0`` runs each finisher on a watched daemon thread
    and raises :class:`StallError` if it does not complete in time — a
    chunk whose device results never land (wedged backend, dead tunnel)
    becomes a NAMED failure on the producing thread instead of an
    indefinite hang.  ``on_stall(elapsed_s)`` (set by the mega loops)
    runs first and may write a host-only triage bundle; its return value
    rides the error as ``StallError.bundle``.  The watched thread is
    daemon by design — it is exactly the thread presumed wedged, and a
    non-daemon spelling would hang interpreter exit on the very wedge
    this deadline exists to escape.  With ``stall_timeout_s=0`` (the
    default) finishers run inline and the hot path is unchanged.
    """

    def __init__(self, depth: int = 1, stall_timeout_s: float = 0.0,
                 on_stall: Optional[Callable[[float], Optional[str]]] = None):
        self.depth = max(0, int(depth))
        self.stall_timeout_s = float(stall_timeout_s)
        self.on_stall = on_stall
        self._pending: "deque[Callable[[], None]]" = deque()

    def _run(self, finish: Callable[[], None]) -> None:
        if self.stall_timeout_s <= 0:
            finish()
            return
        done = threading.Event()
        err: List[BaseException] = []

        def watched():
            try:
                finish()
            except BaseException as e:
                err.append(e)
            finally:
                done.set()

        spawn_thread(watched, name="srnn-chunk-finisher", daemon=True)
        if not done.wait(self.stall_timeout_s):
            bundle = None
            if self.on_stall is not None:
                try:
                    bundle = self.on_stall(self.stall_timeout_s)
                except Exception:
                    pass  # the stall itself is the failure to surface
            raise StallError(
                f"chunk finisher exceeded the {self.stall_timeout_s:.0f}s "
                "stall deadline (device results never landed)"
                + (f"; triage bundle: {bundle}" if bundle else ""),
                bundle=bundle)
        if err:
            raise err[0]

    def step(self, finish: Callable[[], None]) -> None:
        self._pending.append(finish)
        while len(self._pending) > self.depth:
            self._run(self._pending.popleft())

    def drain(self) -> None:
        while self._pending:
            self._run(self._pending.popleft())


# ---------------------------------------------------------------------------
# overlap attribution: host stall vs device compute
# ---------------------------------------------------------------------------


class OverlapMeter:
    """Per-chunk wall-time attribution for the async pipeline.

    Two accumulators per chunk, both host-observable and honest about
    what the host can know without a device profiler:

    * ``device_wait_s`` — seconds the producing thread spent *blocked on
      device results* (inside :meth:`waiting`): a lower bound on device
      busy time.
    * ``host_io_s`` — seconds of host I/O: foreground :meth:`host_io`
      blocks plus the attached :class:`BackgroundWriter`'s busy-seconds
      delta.  In the pipelined loop this work runs concurrently with
      device compute; in the blocking loop it is dead device time.  The
      writer delta necessarily folds into the rows one chunk late (a
      chunk's queued jobs mostly execute after its :meth:`chunk_done`);
      :meth:`summary` adds the still-unfolded tail so run totals are
      complete once the writer has been flushed.

    ``chunk_done(wall_s)`` returns the chunk's row -- ``wall_s``,
    ``device_wait_s``, ``host_io_s``, ``device_idle_bound_s`` (``wall -
    device_wait``: an upper bound on device idleness; in the blocking loop
    it IS the host stall) and ``overlap_ratio`` (``device_wait / wall``:
    1.0 means host I/O fully hidden behind device compute) -- adds it to
    the run totals and, given a ``registry`` (a
    ``telemetry.MetricsRegistry``), sets the JAX package's gauges of the
    last chunk (labelled ``stage=``): ``pipeline_chunk_wall_s``,
    ``pipeline_chunk_device_wait_s``, ``pipeline_chunk_host_io_s``,
    ``pipeline_chunk_device_idle_bound_s`` and ``pipeline_overlap_ratio``,
    and advances the ``pipeline_*_seconds_total`` counters.
    ``summary()`` returns the run totals.
    """

    def __init__(self, registry=None, stage: str = "",
                 writer: Optional[BackgroundWriter] = None):
        self.registry = registry
        self.stage = stage
        self.writer = writer
        self._lock = threading.Lock()
        self._wait = 0.0
        self._io = 0.0
        self._writer_mark = writer.busy_s if writer is not None else 0.0
        self.totals = {"wall_s": 0.0, "device_wait_s": 0.0,
                       "host_io_s": 0.0, "chunks": 0}

    @contextmanager
    def waiting(self):
        """Wrap a blocking device resolve (``np.asarray``, scalar
        readback): the time accrues to ``device_wait_s``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._wait += dt

    @contextmanager
    def host_io(self):
        """Wrap foreground host I/O (the blocking loop's sink writes)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._io += dt

    def chunk_done(self, wall_s: float) -> dict:
        """Close one chunk window: compute the attribution row, add it to
        the run totals, reset the per-chunk accumulators."""
        with self._lock:
            wait, self._wait = self._wait, 0.0
            io, self._io = self._io, 0.0
        if self.writer is not None:
            busy = self.writer.busy_s
            io += busy - self._writer_mark
            self._writer_mark = busy
        wall = max(float(wall_s), 0.0)
        row = {
            "wall_s": wall,
            "device_wait_s": wait,
            "host_io_s": io,
            "device_idle_bound_s": max(0.0, wall - wait),
            "overlap_ratio": min(1.0, wait / wall) if wall > 0 else 0.0,
        }
        self.totals["wall_s"] += wall
        self.totals["device_wait_s"] += wait
        self.totals["host_io_s"] += io
        self.totals["chunks"] += 1
        if self.registry is not None:
            g = self.registry.gauge
            labels = {"stage": self.stage} if self.stage else {}
            g("pipeline_chunk_wall_s",
              help="last chunk wall seconds", unit="seconds").set(
                  round(wall, 4), **labels)
            g("pipeline_chunk_device_wait_s",
              help="last chunk seconds blocked on device results",
              unit="seconds").set(round(wait, 4), **labels)
            g("pipeline_chunk_host_io_s",
              help="last chunk host-I/O seconds (background + foreground)",
              unit="seconds").set(round(io, 4), **labels)
            g("pipeline_chunk_device_idle_bound_s",
              help="last chunk upper bound on device idle seconds "
                   "(wall - device wait)", unit="seconds").set(
                  round(row["device_idle_bound_s"], 4), **labels)
            g("pipeline_overlap_ratio",
              help="device-bound fraction of the last chunk "
                   "(1.0 = host I/O fully hidden)").set(
                  round(row["overlap_ratio"], 4), **labels)
            c = self.registry.counter
            c("pipeline_wall_seconds_total",
              help="chunk-loop wall seconds", unit="seconds").inc(
                  wall, **labels)
            c("pipeline_device_wait_seconds_total",
              help="seconds blocked on device results",
              unit="seconds").inc(wait, **labels)
            c("pipeline_host_io_seconds_total",
              help="host-I/O seconds", unit="seconds").inc(io, **labels)
        return row

    def summary(self) -> dict:
        """Run-total attribution (rounded, JSON-ready): wall/device-wait/
        host-I/O seconds, chunk count, overall overlap ratio and the
        device-idle upper bound.

        The writer's busy seconds fold into the per-chunk rows one
        window LATE (a chunk's queued jobs mostly execute after its
        ``chunk_done``), so the run total here also counts the
        still-unfolded busy delta — call after ``writer.flush()`` (as the
        mega loops do) and the tail chunk's I/O is included too."""
        t = self.totals
        wall = t["wall_s"]
        io = t["host_io_s"]
        if self.writer is not None:
            # pending delta read non-destructively: _writer_mark stays,
            # so a later chunk_done still folds the same seconds into its
            # row and summary() stays idempotent
            io += max(0.0, self.writer.busy_s - self._writer_mark)
        return {
            "chunks": t["chunks"],
            "wall_s": round(wall, 4),
            "device_wait_s": round(t["device_wait_s"], 4),
            "host_io_s": round(io, 4),
            "device_idle_bound_s": round(max(0.0, wall - t["device_wait_s"]),
                                         4),
            "overlap_ratio": round(min(1.0, t["device_wait_s"] / wall), 4)
            if wall > 0 else 0.0,
        }
