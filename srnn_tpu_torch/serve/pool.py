"""Multi-worker serve fleet: N dispatch processes behind one front socket;
port of ``srnn_tpu/serve/pool.py``.

``python -m srnn_tpu_torch.serve --workers N`` turns the single-process
experiment service into a fleet: the FRONT process (this module — pure
host logic that touches no device) binds the public socket, owns
admission, and forwards tickets to N WORKER processes, each a full
``python -m srnn_tpu_torch.serve`` service on its own sub-root with its
own journal, dispatch thread and adaptive window controller.  On one
card every worker is a process on it; the workers share the kernels'
build directory (``ops/_build.py`` builds under a lock and publishes each
library by an atomic rename, so two workers never load a half-written
one).

Recovery topology (the ticket journal as the shared-nothing substrate):

  * the front journals every admission (append+fsync BEFORE the ticket
    id is acknowledged — the same contract the solo service keeps), so
    an acknowledged ticket survives even a ``kill -9`` of the front; a
    restarted front replays its journal and re-forwards.
  * each forward carries ``idempotency_key="pool:<front-ticket>"``, so
    worker journals speak front ticket ids.  Any worker can therefore
    replay any admitted ticket: when a worker DIES mid-load (SIGKILL,
    OOM, chaos), the front reads the dead worker's journal suffix
    (``journal.read_journal`` on its sub-root — the dead process needs
    no cooperation), maps the unfinished entries back to front tickets,
    and resubmits them to the survivors.  Acknowledged work is never
    lost; the executors are deterministic functions of the journaled
    params, so replayed results are bitwise-equal.
  * ``/healthz`` tells the story live: ``ok`` is false while any
    admitted ticket is stranded on a dead worker and true again once the
    survivors have absorbed the replays (the loss, then the heal); the
    per-worker ``workers`` map keeps showing the corpse.

Fairness: tenants are assigned to workers STICKY round-robin by first
appearance (a tenant's tickets land on one worker while it lives, so
same-spelling tickets still stack; tenants spread across the fleet), and
each worker runs the service-level fair plan (``scheduler.plan_dispatches
(fair=True)``) within its own queue.

Process discipline is the JAX package's launcher's: workers spawn with
relayed ``[w<i>]`` output prefixes, reap with terminate-then-kill
(:func:`_reap`, a copy of its ``distributed.launch._reap``), and the
front's exit code never reports success over a worker it had to kill.
"""

import itertools
import json
import os
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..telemetry.exemplars import EXEMPLARS_NAME, ExemplarRing
from ..utils.pipeline import spawn_thread
from .client import ServiceClient
from .journal import TicketJournal, read_journal
from .server import _Handler

#: connection-class failures that mean "this worker is gone" when talking
#: to a worker socket — the trigger for the death/replay ladder.  Every
#: member is a connection-class exception: a value error must never be
#: read as a worker death, or the replay ladder would double-run real
#: work.
WORKER_DEATH_EXC = (ConnectionRefusedError, FileNotFoundError,
                    ConnectionResetError, BrokenPipeError, TimeoutError)

#: monitor cadence: how often worker processes are polled for death
POLL_S = 0.25
#: fleet gauge / history-sample refresh cadence (the live plane's turn)
SAMPLE_S = 5.0


def _reap(procs, killed: set) -> None:
    """Terminate every process still running (its index into ``killed``),
    then kill whatever has not exited 10 s later (a copy of the JAX
    package's ``distributed/launch.py:127-139``)."""
    for i, p in enumerate(procs):
        if p.poll() is None:
            killed.add(i)
            p.terminate()
    deadline = time.monotonic() + 10
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


class WorkerHandle:
    """One spawned worker process + its client-side state."""

    def __init__(self, index: int, root: str, socket_path: str,
                 proc: subprocess.Popen):
        self.index = index
        self.root = root
        self.socket_path = socket_path
        self.proc = proc
        self.alive = True
        self.client = ServiceClient(socket_path)


def spawn_worker(index: int, root: str, worker_args: List[str],
                 module: str = "srnn_tpu_torch.serve") -> WorkerHandle:
    """Spawn worker ``index`` on ``<root>/workers/w<i>`` with a relayed
    ``[w<i>]`` output prefix (the launcher's ``[p<i>]`` idiom)."""
    wroot = os.path.join(root, "workers", f"w{index}")
    wsock = os.path.join(root, "workers", f"w{index}.sock")
    os.makedirs(os.path.dirname(wroot), exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", module, "--root", wroot,
         "--socket", wsock, *worker_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def relay():
        for line in proc.stdout:
            print(f"[w{index}] {line.rstrip()}", flush=True)

    spawn_thread(relay, name=f"pool-relay-w{index}")
    return WorkerHandle(index, wroot, wsock, proc)


class ServicePool:
    """The front: admission + forwarding + death/replay over N workers."""

    def __init__(self, root: str, workers: List[WorkerHandle],
                 registry=None, max_queue: int = 0, history=None,
                 engine=None, capture=None, profiler=None):
        from ..telemetry.metrics import MetricsRegistry

        os.makedirs(root, exist_ok=True)
        self.root = root
        self.workers = list(workers)
        self.max_queue = max(0, int(max_queue))
        self.registry = registry or MetricsRegistry()
        self.journal = TicketJournal(root)
        self._history = history
        self._engine = engine
        # continuous profiling plane, the front's half: the sampler
        # watches the monitor/relay threads, anomaly bundles land in the
        # FRONT root on pool-rule firing edges (worker bundles land in
        # their own sub-roots)
        self._capture = capture
        self._profiler = profiler
        self._lock = threading.Lock()
        self._done_cv = threading.Condition(self._lock)
        #: front ticket -> {"kind","params","tenant","worker","key",
        #: "deadline_s","replays"} for every admitted-not-yet-collected
        self._tickets: Dict[str, dict] = {}
        self._idem: Dict[str, str] = {}
        self._tenant_worker: Dict[str, int] = {}
        self._rr = 0
        self._counter = itertools.count(1)
        #: front-side span ids (front.admit/assign/relay/replay) — only
        #: unique per process, which is why cross-hop links travel as
        #: ``remote_parent``/``parent_span``, never as ``parent``
        self._span_ids = itertools.count(1)
        #: tail-kept exemplar ring, the front's half: replayed / failed
        #: tickets keep their full front-span family, the rest keep only
        #: their admit root
        self._exemplars = ExemplarRing(os.path.join(root, EXEMPLARS_NAME))
        self._admitted = 0
        self._completed = 0
        self._replayed = 0
        self._deaths = 0
        self._draining = False
        self._stop = threading.Event()
        self._events = open(os.path.join(root, "events.jsonl"), "a")
        self._events_lock = threading.Lock()
        self._t0 = time.monotonic()
        # eager zeros, the serve counters' discipline: a clean fleet
        # scrapes 0 deaths/replays, not missing series
        self.registry.counter("serve_worker_deaths_total",
                              help="worker processes lost (crash/kill)")
        self.registry.counter(
            "serve_worker_replays_total",
            help="admitted tickets resubmitted to surviving workers "
                 "after a worker death")
        self._set_worker_gauge()
        self._monitor = spawn_thread(self._monitor_loop,
                                     name="pool-monitor")

    # -- admission / results ---------------------------------------------

    def submit(self, kind: str, params: dict,
               tenant: Optional[str] = None,
               deadline_s: Optional[float] = None,
               idempotency_key: Optional[str] = None,
               trace_id: Optional[str] = None,
               parent_span: Optional[int] = None) -> str:
        """Admit one ticket at the front (durable-before-acknowledged,
        the solo service's contract) and forward it to its tenant's
        worker.  The front is the fleet's admission authority: workers
        run unbounded queues; ``max_queue`` bounds the ADMITTED-not-
        collected set here.

        ``trace_id``/``parent_span`` are the client's trace context;
        the front journals them, adopts the id for its own
        ``front.*`` spans, and propagates it across the worker hop —
        one trace per ticket, fleet-wide."""
        from .service import OverloadedError

        with self._lock:
            if self._draining:
                raise RuntimeError("service shutting down")
            if idempotency_key:
                known = self._idem.get(idempotency_key)
                if known is not None:
                    return known
            depth = len(self._tickets)
            if self.max_queue and depth >= self.max_queue:
                self.registry.counter(
                    "serve_overload_rejections_total",
                    help="submits rejected at admission "
                         "(--max-queue)").inc(1, kind=kind)
                raise OverloadedError(
                    f"queue full ({depth} >= max_queue={self.max_queue}); "
                    "back off and resubmit")
            ticket = f"t{next(self._counter):06d}"
            tenant = tenant or ticket
            admit_start = time.monotonic() - self._t0
            self.journal.record_submit(
                ticket=ticket, kind=kind, params=dict(params),
                tenant=tenant, key=idempotency_key,
                deadline_wall=(time.time() + float(deadline_s)
                               if deadline_s is not None else None),
                wall=time.time(), trace_id=trace_id or None,
                parent_span=parent_span)
            admit_span = next(self._span_ids)
            self._tickets[ticket] = {
                "kind": kind, "params": dict(params), "tenant": tenant,
                "worker": None, "worker_ticket": None,
                "deadline_s": deadline_s, "replays": 0,
                "key": idempotency_key,
                "trace_id": trace_id or ticket,
                "admit_span": admit_span, "spans": []}
            if idempotency_key:
                self._idem[idempotency_key] = ticket
            self._admitted += 1
        # the pool hop's root marker: duration = the durable journal
        # append the ack waited on; remote_parent points back at the
        # CLIENT's span when it sent one
        self._span_row(ticket, "front.admit", admit_span,
                       start_s=admit_start,
                       seconds=time.monotonic() - self._t0 - admit_start,
                       remote_parent=parent_span)
        self.registry.counter("serve_requests_total",
                              help="experiment requests accepted").inc(
                                  1, kind=kind)
        self.registry.gauge(
            "serve_queue_depth",
            help="requests queued, not yet dispatched").set(
                self.queue_depth())
        self._forward(ticket)
        return ticket

    def _span_row(self, ticket: str, name: str, span_id: int, *,
                  start_s: float, seconds: float,
                  parent: Optional[int] = None, **labels) -> None:
        """One front-side span: appended to the front's events.jsonl
        (the merged fleet timeline's process-0 lane) AND retained on the
        ticket entry so resolution can capture the family into the
        exemplar ring."""
        with self._lock:
            ent = self._tickets.get(ticket)
            trace_id = ent["trace_id"] if ent else ticket
            tenant = ent["tenant"] if ent else None
            req_kind = ent["kind"] if ent else None
        row = dict(kind="span", span=name, span_id=span_id,
                   trace_id=trace_id, ticket=ticket, process=0,
                   tenant=tenant, request_kind=req_kind,
                   start_s=round(start_s, 6), seconds=round(seconds, 6),
                   **labels)
        if parent is not None:
            row["parent"] = parent
        row = {k: v for k, v in row.items() if v is not None}
        self._event_row(**row)
        with self._lock:
            ent = self._tickets.get(ticket)
            if ent is not None and len(ent.get("spans", ())) < 64:
                ent["spans"].append(row)

    def _pick_worker(self, tenant: str) -> Optional[WorkerHandle]:
        """Sticky per-tenant round-robin over the LIVE workers."""
        with self._lock:
            alive = [w for w in self.workers if w.alive]
            if not alive:
                return None
            idx = self._tenant_worker.get(tenant)
            w = next((x for x in alive if x.index == idx), None)
            if w is None:
                w = alive[self._rr % len(alive)]
                self._rr += 1
                self._tenant_worker[tenant] = w.index
            return w

    def _forward(self, ticket: str) -> None:
        """Send ``ticket`` to its tenant's worker; a worker dying under
        the forward routes through the death ladder and the next
        survivor takes the ticket (bounded by the fleet size)."""
        from .client import ServiceError

        for _ in range(len(self.workers) + 1):
            with self._lock:
                ent = self._tickets.get(ticket)
            if ent is None:
                return   # collected (a racing wait) — nothing to do
            assign_start = time.monotonic() - self._t0
            w = self._pick_worker(ent["tenant"])
            if w is None:
                self._resolve_failed(ticket, "no live workers")
                return
            self._span_row(ticket, "front.assign", next(self._span_ids),
                           start_s=assign_start,
                           seconds=(time.monotonic() - self._t0
                                    - assign_start),
                           parent=ent.get("admit_span"), worker=w.index)
            # relay span id minted BEFORE the worker submit: it crosses
            # the hop as the worker ticket's parent_span, so the far
            # side links back without a second round trip.  A replay
            # (post-worker-death re-forward) gets its own span name —
            # the kill -9 story stays legible in the merged timeline.
            relay_span = next(self._span_ids)
            relay_name = ("front.replay" if ent.get("replays")
                          else "front.relay")
            relay_start = time.monotonic() - self._t0
            try:
                wt = w.client.submit(ent["kind"], ent["params"],
                                     tenant=ent["tenant"],
                                     deadline_s=ent["deadline_s"],
                                     idempotency_key=f"pool:{ticket}",
                                     trace_id=ent["trace_id"],
                                     parent_span=relay_span)
                with self._done_cv:
                    if ticket in self._tickets:
                        self._tickets[ticket]["worker"] = w.index
                        self._tickets[ticket]["worker_ticket"] = wt
                    self._done_cv.notify_all()
                self._span_row(ticket, relay_name, relay_span,
                               start_s=relay_start,
                               seconds=(time.monotonic() - self._t0
                                        - relay_start),
                               parent=ent.get("admit_span"),
                               worker=w.index, worker_ticket=wt,
                               replays=ent.get("replays") or None)
                return
            except WORKER_DEATH_EXC as e:
                self._span_row(ticket, relay_name, relay_span,
                               start_s=relay_start,
                               seconds=(time.monotonic() - self._t0
                                        - relay_start),
                               parent=ent.get("admit_span"),
                               worker=w.index, error=type(e).__name__)
                self._note_death(w.index)
            except ServiceError as e:
                self._resolve_failed(ticket, str(e))
                return
        self._resolve_failed(ticket, "no live workers")

    def _resolve_failed(self, ticket: str, error: str) -> None:
        with self._lock:
            ent = self._tickets.get(ticket)
            if ent is None:
                return
            ent["worker"] = None
            ent["failed"] = {"status": "failed", "error": error,
                             "mode": "none"}
            self._done_cv.notify_all()

    def wait(self, ticket: str, timeout_s: float = 600.0) -> dict:
        """Block until ``ticket`` completes; CONSUMES the entry (the solo
        service's contract).  Rides out worker deaths: a connection that
        dies mid-wait triggers the replay ladder and the wait re-targets
        wherever the ticket landed."""
        deadline = time.monotonic() + timeout_s
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"request {ticket} still pending "
                                   f"after {timeout_s}s")
            with self._lock:
                ent = self._tickets.get(ticket)
                if ent is None:
                    raise KeyError(f"unknown ticket {ticket!r}")
                if "failed" in ent:
                    entry = dict(ent["failed"])
                    self._finish_locked(ticket, "failed")
                    return entry
                widx, wticket = ent["worker"], ent["worker_ticket"]
            if widx is None or wticket is None:
                # forward still in flight (or mid-replay): wait for it
                with self._done_cv:
                    self._done_cv.wait(timeout=min(0.2, left))
                continue
            w = self.workers[widx]
            try:
                resp = _raw_op(w.socket_path,
                               {"op": "wait", "ticket": wticket,
                                "timeout_s": min(left, 60.0)},
                               timeout_s=min(left, 60.0) + 10.0)
            except WORKER_DEATH_EXC:
                self._note_death(widx)
                continue
            if resp.get("status") in ("done", "failed"):
                with self._lock:
                    self._finish_locked(ticket, resp["status"])
                entry = {k: v for k, v in resp.items()
                         if k not in ("ok", "ticket")}
                return entry
            # service-side timeout (clean ok:false, still pending) or a
            # transient error string: loop and re-check the deadline

    def _finish_locked(self, ticket: str, status: str) -> None:
        ent = self._tickets.pop(ticket, None)
        if ent is None:
            return
        self._completed += 1
        self.journal.record_done([ticket], status)
        if ent.get("key"):
            self._idem.pop(ent["key"], None)
        # tail-based retention, the front's half: a ticket that was
        # REPLAYED across a worker death (or failed) keeps its whole
        # front-span family — admit, assigns, the dead relay and the
        # replay — everything else keeps only its admit root
        reasons = [r for r, on in (("replayed", bool(ent.get("replays"))),
                                   ("failed", status != "done")) if on]
        spans = ent.get("spans") or []
        self._exemplars.add(
            {"ticket": ticket, "trace_id": ent.get("trace_id", ticket),
             "reason": ",".join(reasons) or "root",
             "kind": ent.get("kind"), "tenant": ent.get("tenant"),
             "replays": ent.get("replays", 0),
             "spans": spans if reasons else spans[:1]})
        self.registry.gauge(
            "serve_queue_depth",
            help="requests queued, not yet dispatched").set(
                len(self._tickets))

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._tickets)

    def recover(self) -> int:
        """Replay the FRONT journal after a front restart: unfinished
        admissions re-enter the tickets table under their original ids
        and re-forward.  (Workers recover their own journals themselves
        at startup — this is the front's half of the topology.)"""
        entries, torn, next_ticket = self.journal.recover()
        replayed = []
        with self._lock:
            self._counter = itertools.count(next_ticket)
            now_s = time.monotonic() - self._t0
            for e in entries:
                deadline_s = None
                if e.deadline_wall is not None:
                    deadline_s = float(e.deadline_wall) - time.time()
                self._tickets[e.ticket] = {
                    "kind": e.kind, "params": dict(e.params),
                    "tenant": e.tenant, "worker": None,
                    "worker_ticket": None, "deadline_s": deadline_s,
                    "replays": 0, "key": e.key,
                    "trace_id": e.trace_id or e.ticket,
                    "admit_span": next(self._span_ids), "spans": []}
                if e.key:
                    self._idem[e.key] = e.ticket
                replayed.append(e.ticket)
            self._admitted += len(replayed)
        for t in replayed:
            # a re-admission marker under the ORIGINAL trace id: the
            # restarted front's lane joins the trace the dead front left
            with self._lock:
                ent = self._tickets.get(t)
            if ent is not None:
                self._span_row(t, "front.admit", ent["admit_span"],
                               start_s=now_s, seconds=0.0, replayed=True)
        for t in replayed:
            self._forward(t)
        if replayed:
            self._event_row(kind="pool_replay", source="front_journal",
                            tickets=replayed, torn_tail=torn or None)
        return len(replayed)

    # -- death / replay ladder -------------------------------------------

    def _note_death(self, index: int) -> None:
        """The fleet's heal: mark worker ``index`` dead (idempotent),
        reap its process, read its journal's unfinished suffix, and
        resubmit every stranded admitted ticket to the survivors."""
        with self._lock:
            w = self.workers[index]
            if not w.alive:
                return
            w.alive = False
            self._deaths += 1
            stranded = [t for t, ent in self._tickets.items()
                        if ent["worker"] == index]
            for t in stranded:
                self._tickets[t]["worker"] = None
                self._tickets[t]["worker_ticket"] = None
                self._tickets[t]["replays"] += 1
        self.registry.counter(
            "serve_worker_deaths_total",
            help="worker processes lost (crash/kill)").inc(1)
        self._set_worker_gauge()
        _reap([w.proc], set())
        # the shared-nothing story: the DEAD worker's journal names every
        # ticket it had admitted but not finished — read it without any
        # cooperation from the corpse, map keys back to front tickets
        from_journal: List[str] = []
        try:
            unfinished, _torn, _next = read_journal(
                os.path.join(w.root, "journal.jsonl"))
            from_journal = [e.key[len("pool:"):] for e in unfinished
                            if e.key and e.key.startswith("pool:")]
        except OSError:
            pass
        replay = sorted(set(stranded) | set(from_journal))
        replay = [t for t in replay if t in self._tickets]
        self._event_row(kind="pool_worker_death", worker=index,
                        pid=w.proc.pid,
                        journal_unfinished=len(from_journal),
                        replaying=len(replay))
        print(f"serve pool: worker w{index} died; replaying "
              f"{len(replay)} ticket(s) onto the survivors", flush=True)
        if replay:
            with self._lock:
                self._replayed += len(replay)
            self.registry.counter(
                "serve_worker_replays_total",
                help="admitted tickets resubmitted to surviving workers "
                     "after a worker death").inc(len(replay))
        for t in replay:
            self._forward(t)
        with self._done_cv:
            self._done_cv.notify_all()

    def _set_worker_gauge(self) -> None:
        with self._lock:
            alive = sum(1 for w in self.workers if w.alive)
        self.registry.gauge("serve_workers",
                            help="live worker processes").set(alive)

    def _monitor_loop(self) -> None:
        """Poll worker liveness (the death ladder's detector for workers
        nobody is talking to) and refresh the fleet gauges + the live
        telemetry plane on the sample cadence."""
        last_sample = float("-inf")
        while not self._stop.is_set():
            for w in list(self.workers):
                if w.alive and w.proc.poll() is not None:
                    self._note_death(w.index)
            now = time.monotonic()
            if now - last_sample >= SAMPLE_S:
                last_sample = now
                self._refresh_fleet_gauges()
                if self._history is not None:
                    try:
                        self._history.sample()
                        transitions = []
                        if self._engine is not None:
                            for tr in self._engine.evaluate():
                                self._event_row(kind="alert", **tr)
                                transitions.append(tr)
                        if self._capture is not None:
                            self._capture.on_transitions(transitions)
                        if self._profiler is not None:
                            # monitor cadence doubles as the profile
                            # flush cadence (inline — the front has no
                            # background writer, and this IS its own
                            # housekeeping thread)
                            self._profiler.update_gauges(self.registry)
                            self._profiler.write_files(self.root)
                    except Exception as e:  # pragma: no cover - defensive
                        print(f"serve pool: live telemetry sample failed:"
                              f" {type(e).__name__}: {e}",
                              file=sys.stderr, flush=True)
            self._stop.wait(POLL_S)

    def _refresh_fleet_gauges(self) -> None:
        g = self.registry.gauge(
            "serve_worker_queue_depth",
            help="per-worker dispatch queue depth")
        for w in list(self.workers):
            if not w.alive:
                continue
            try:
                st = w.client.stats()
            except Exception:
                continue
            g.set(st.get("queue_depth", 0), worker=f"w{w.index}")

    # -- views -----------------------------------------------------------

    def stats(self) -> dict:
        """Fleet snapshot: front admission state + one row per worker
        (queue depth, in-flight slots, adaptive window, replay counts) —
        the shape ``watch --service`` renders."""
        with self._lock:
            depth = len(self._tickets)
            front = {"admitted": self._admitted,
                     "completed": self._completed,
                     "pending": depth, "replayed": self._replayed,
                     "deaths": self._deaths,
                     "workers": sum(1 for w in self.workers if w.alive),
                     "max_queue": self.max_queue or None}
        fleet = {}
        slowest: List[dict] = []
        for w in list(self.workers):
            row = {"alive": w.alive, "pid": w.proc.pid}
            if w.alive:
                try:
                    st = w.client.stats()
                    row.update(
                        queue_depth=st.get("queue_depth"),
                        completed=st.get("completed"),
                        inflight=_metric_sum(st, "serve_inflight_requests"),
                        window_s=(st.get("dispatch") or {}).get(
                            "window_min_s"),
                        adaptive=(st.get("dispatch") or {}).get(
                            "adaptive"),
                        replayed=(st.get("self_healing") or {}).get(
                            "replayed"))
                    slowest.extend(dict(e, worker=f"w{w.index}")
                                   for e in st.get("slowest") or ())
                except Exception as e:
                    row["error"] = f"{type(e).__name__}: {e}"
            fleet[f"w{w.index}"] = row
        # fleet-wide slowest-traces panel: the workers' per-service
        # top-K lists merged and re-capped (same depth as the solo
        # service's SLOWEST_KEPT)
        slowest.sort(key=lambda e: -e.get("seconds", 0.0))
        del slowest[8:]
        alerts = None
        if self._engine is not None:
            alerts = {"active": self._engine.active()}
        return {"completed": front["completed"], "queue_depth": depth,
                "uptime_s": round(time.monotonic() - self._t0, 2),
                "front": front, "fleet": fleet, "slowest": slowest,
                "alerts": alerts,
                "metrics": self.registry.rows()}

    def healthz(self) -> dict:
        """The loss-then-heal contract: ``ok`` is false while any
        admitted ticket is stranded on a dead worker (between the death
        and the survivors absorbing its replays) and true again after
        the heal; dead workers stay visible in ``workers``."""
        with self._lock:
            stranded = sum(
                1 for ent in self._tickets.values()
                if ent["worker"] is not None
                and not self.workers[ent["worker"]].alive)
            unassigned = sum(1 for ent in self._tickets.values()
                             if ent["worker"] is None
                             and "failed" not in ent)
            workers = {}
            for w in self.workers:
                # event-lane heartbeat age, the worker_liveness
                # idiom: seconds since the worker's events.jsonl moved
                # (pure mtime read — callable under the lock)
                try:
                    age = round(time.time() - os.path.getmtime(
                        os.path.join(w.root, "events.jsonl")), 1)
                except OSError:
                    age = None
                workers[str(w.index)] = {"ok": w.alive,
                                         "pid": w.proc.pid,
                                         "age_s": age}
            any_alive = any(w.alive for w in self.workers)
        return {"ok": bool(any_alive and not stranded and not unassigned),
                "workers": workers, "stranded": stranded + unassigned,
                "deaths": self._deaths, "replayed": self._replayed,
                "queue_depth": self.queue_depth()}

    # -- lifecycle -------------------------------------------------------

    def _event_row(self, **fields) -> None:
        fields.setdefault("t", round(time.monotonic() - self._t0, 4))
        fields = {k: v for k, v in fields.items() if v is not None}
        with self._events_lock:
            self._events.write(json.dumps(fields) + "\n")
            self._events.flush()

    def close(self, drain: bool = False) -> None:
        """Stop the fleet: drain (or shut down) every live worker, reap
        stragglers with the launcher's terminate-then-kill, publish the
        front's metrics.prom."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
        self._stop.set()
        self._monitor.join(timeout=10)
        for w in self.workers:
            if not w.alive:
                continue
            try:
                if drain:
                    w.client.drain()
                else:
                    w.client.shutdown()
            except (OSError, RuntimeError):
                pass
        _reap([w.proc for w in self.workers], set())
        if self._profiler is not None:
            try:
                self._profiler.update_gauges(self.registry)
                self._profiler.write_files(self.root)
            except OSError:
                pass
        if self._capture is not None:
            self._capture.close()
        self.registry.write_textfile(os.path.join(self.root,
                                                  "metrics.prom"))
        self.journal.close()
        with self._events_lock:
            self._events.close()


def _metric_sum(stats: dict, name: str):
    """Sum a metric's label sets out of a stats() ``metrics`` rows dict
    (rows are keyed ``name{labels}`` flat strings)."""
    rows = stats.get("metrics") or {}
    vals = [v for k, v in rows.items()
            if k == name or k.startswith(name + "{")]
    return sum(vals) if vals else None


def _raw_op(socket_path: str, msg: dict, timeout_s: float = 60.0) -> dict:
    """One worker op returning the parsed response REGARDLESS of ``ok``
    (the front's proxied wait needs failed entries verbatim, where
    ``ServiceClient`` would raise them away)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout_s)
        s.connect(socket_path)
        s.sendall((json.dumps(msg) + "\n").encode())
        line = s.makefile("rb").readline()
    if not line:
        raise ConnectionResetError("worker closed the connection mid-op")
    return json.loads(line.decode("utf-8", "replace"))


class PoolServer(socketserver.ThreadingMixIn,
                 socketserver.UnixStreamServer):
    """The front transport: the SAME one-JSON-line-per-op protocol as
    ``ServiceServer`` (clients cannot tell a fleet from a solo service),
    delegating to a :class:`ServicePool`."""

    daemon_threads = False
    allow_reuse_address = True
    # the client opens one connection PER OP, so a burst of concurrent
    # clients is a burst of simultaneous connects; socketserver's default
    # backlog of 5 overflows whenever the accept loop stalls (e.g. a
    # worker-death replay) and Linux fails the connect with EAGAIN
    request_queue_size = 128

    def __init__(self, pool: ServicePool, socket_path: str):
        from .server import wait_for_socket

        if os.path.exists(socket_path):
            if wait_for_socket(socket_path, timeout_s=0.0):
                raise RuntimeError(
                    f"a live experiment service already answers on "
                    f"{socket_path}; refusing to steal its socket")
            os.unlink(socket_path)
        super().__init__(socket_path, _Handler)
        self.pool = pool
        self.socket_path = socket_path
        self._stop = threading.Event()
        self._drain = threading.Event()

    def handle_op(self, msg: dict) -> dict:
        from .service import DeadlineExpired, OverloadedError

        op = msg.get("op")
        if op == "ping":
            return {"ok": True}
        if op in ("submit", "request"):
            if self._stop.is_set():
                return {"ok": False, "error": "service shutting down"}
            try:
                ticket = self.pool.submit(
                    msg["kind"], msg.get("params", {}),
                    tenant=msg.get("tenant"),
                    deadline_s=msg.get("deadline_s"),
                    idempotency_key=msg.get("idempotency_key"),
                    trace_id=msg.get("trace_id"),
                    parent_span=msg.get("parent_span"))
            except OverloadedError as e:
                return {"ok": False, "error": str(e), "overloaded": True}
            except DeadlineExpired as e:
                return {"ok": False, "error": str(e),
                        "deadline_expired": True}
            if op == "submit":
                return {"ok": True, "ticket": ticket}
            msg = dict(msg, ticket=ticket)
        if op in ("wait", "request"):
            ticket = msg["ticket"]
            try:
                entry = self.pool.wait(
                    ticket, timeout_s=float(msg.get("timeout_s", 600.0)))
            except (KeyError, TimeoutError) as e:
                return {"ok": False, "ticket": ticket, "error": str(e)}
            out = {"ok": entry.get("status") == "done", "ticket": ticket}
            out.update(entry)
            return out
        if op == "stats":
            return {"ok": True, "stats": self.pool.stats()}
        if op == "drain":
            self.stop(drain=True)
            return {"ok": True, "bye": True, "draining": True}
        if op == "shutdown":
            self.stop()
            return {"ok": True, "bye": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def stop(self, drain: bool = False) -> None:
        if drain:
            self._drain.set()
        self._stop.set()
        spawn_thread(self.shutdown, name="pool-stop")

    def serve_until_shutdown(self) -> None:
        try:
            self.serve_forever(poll_interval=0.1)
        finally:
            self._stop.set()
            self.pool.close(drain=self._drain.is_set())
            self.server_close()
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass


def run_pool(args, worker_args: List[str]) -> int:
    """``python -m srnn_tpu_torch.serve --workers N`` server mode: spawn the
    fleet, bind the front socket, serve until shutdown/SIGTERM (SIGTERM
    drains: workers journal their queues and a restart resumes)."""
    os.makedirs(args.root, exist_ok=True)
    sock = args.socket or os.path.join(args.root, "serve.sock")
    workers = []
    for i in range(args.workers):
        wargs = list(worker_args)
        if args.metrics_port:
            # port layout mirrors the mega fleet's: the front (the
            # fleet's process 0) owns PORT below; worker i — process
            # i+1 of the merged timeline — exports on PORT+1+i
            wargs += ["--metrics-port", str(args.metrics_port + 1 + i)]
        workers.append(spawn_worker(i, args.root, wargs))
    try:
        for w in workers:
            w.client.wait_until_up(timeout_s=180.0)
    except TimeoutError as e:
        _reap([w.proc for w in workers], set())
        raise SystemExit(f"serve pool: {e}")
    from ..telemetry.alerts import (AlertEngine, default_pool_rules,
                                    default_serve_rules)
    from ..telemetry.metrics import MetricsRegistry
    from ..telemetry.timeseries import MetricHistory

    registry = MetricsRegistry()
    history = MetricHistory(
        registry, path=os.path.join(args.root, "metrics_history.jsonl"))
    engine = AlertEngine(
        default_serve_rules(max_queue=args.max_queue)
        + default_pool_rules(workers=args.workers),
        registry, history)
    prof = capture = None
    if not getattr(args, "no_profile", False):
        from ..telemetry.profiler import AnomalyCapture, SamplingProfiler

        prof = SamplingProfiler(
            hz=getattr(args, "profile_hz", 50.0),
            ring_s=getattr(args, "profile_ring_s", 30.0)).start()
        capture = AnomalyCapture(
            args.root, profiler=prof, registry=registry,
            max_bundles=getattr(args, "anomaly_captures", 4),
            ring_s=getattr(args, "profile_ring_s", 30.0))
    pool = ServicePool(args.root, workers, registry=registry,
                       max_queue=args.max_queue, history=history,
                       engine=engine, capture=capture, profiler=prof)
    exporter = None
    if args.metrics_port:
        from ..telemetry.exporter import MetricsExporter

        try:
            exporter = MetricsExporter(registry, port=args.metrics_port,
                                       healthz=pool.healthz)
            print(f"serve pool: /metrics + /healthz live on "
                  f"{exporter.url}", flush=True)
        except OSError as e:
            print(f"serve pool: metrics exporter bind failed on "
                  f":{args.metrics_port} ({e}); continuing without the "
                  "live endpoint", flush=True)
    replayed = pool.recover()
    if replayed:
        print(f"serve pool: replayed {replayed} journaled ticket(s) "
              "from a previous front", flush=True)
    server = PoolServer(pool, sock)
    prev = signal.signal(signal.SIGTERM,
                         lambda *_: server.stop(drain=True))
    print(f"serve pool: listening on {sock} (root={args.root}, "
          f"workers={args.workers}"
          + (f", max_queue={args.max_queue}" if args.max_queue else "")
          + ")", flush=True)
    try:
        server.serve_until_shutdown()
    finally:
        signal.signal(signal.SIGTERM, prev)
        if exporter is not None:
            exporter.close()
        if prof is not None:
            prof.stop()
        history.close()
    pending = pool.queue_depth()
    if pending:
        print(f"serve pool: exiting with {pending} ticket(s) journaled "
              "for replay on restart", flush=True)
    return 0
