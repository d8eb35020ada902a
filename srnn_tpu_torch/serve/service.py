"""The multi-tenant experiment service core; port of
``srnn_tpu/serve/service.py``.

A long-lived :class:`ExperimentService` owns the device the experiments
run on (the card; the CPU only when asked: ``device="cpu"`` or
``SRNN_SETUPS_PLATFORM=cpu``), a request queue, and the batching
scheduler: submitted experiment
requests are grouped by static spelling (``serve.scheduler``), compatible
groups dispatch STACKED on the tenant axis (``serve.tenant``), odd
configs fall back to solo dispatch — per-tenant results are bitwise-equal
either way, so batching is purely an amortization decision.

Telemetry: queue-depth / latency / throughput ride the registry as
``srnn_serve_*`` metrics, every dispatch and
every per-tenant completion appends a labeled row to the service's
``events.jsonl`` through the existing ``BackgroundWriter``, and soup
requests with ``lineage: true`` stream per-tenant replication-dynamics
window rows (tenant-labeled) into ``lineage.jsonl`` — one I/O thread, the
same submission-order guarantees as the mega loops.

Ticket tracing (the fleet observatory's request-level half): every
completed ticket emits a structured span family into ``events.jsonl`` —
a ``serve.ticket`` root whose duration IS the measured request latency,
with ``queue``/``window``/``dispatch``/``publish`` children that sum to
it exactly (queue = pre-window backlog wait, window = the share of the
batching window the ticket actually sat out, dispatch = its group's
execution wall with the per-tenant amortized cost and stack width K as
labels, publish = the result-delivery residual).  The breakdown also
feeds the ``serve_ticket_*_seconds`` histograms, and a request whose
latency exceeds the ``slo_p95_ms`` target counts into
``serve_slo_violations_total`` — the signal the adaptive batch window
(``serve.controller``) optimizes against.

Self-healing: every admitted submit is
journaled durably (``serve.journal``, append+fsync) BEFORE its ticket id
is acknowledged, so a ``kill -9`` loses no admitted work — a restarted
service calls :meth:`ExperimentService.recover` and replays every
unfinished ticket with results bitwise-equal to an uninterrupted run.
Dispatch is SUPERVISED: failures route through the resilience tier's
``classify_fault`` taxonomy — retryable kinds (:data:`DISPATCH_RETRYABLE`)
get bounded deterministic-backoff retries, and a persisting stacked-group
failure BISECTS the group to isolate the poisoned tenant(s), quarantining
them (failed, with the real error) while the innocent groupmates complete
solo.  Admission is bounded (``max_queue`` -> typed
:class:`OverloadedError` the client backs off on), per-ticket deadlines
are enforced at admission and at dispatch (expired tickets fail fast,
never occupying a stack slot), and completed-but-never-collected results
evict on a TTL so a long-lived service cannot leak its results table.

Transport lives elsewhere (``serve.server`` wraps this in a Unix-socket
JSON-lines server; in-process callers such as the tests drive it
directly).

Executors: a ``soup`` request seeds each tenant's soup from
``setups.common.generator(seed)`` and a ``fixpoint_density`` request draws
each batch from ``setups.common.population``, exactly as the setups'
process mode does, so a setup's ``--service`` artifacts equal its local
run's.  A stacked soup dispatch runs ``serve.tenant.evolve_stacked`` (one
launch of the variant's SGD kernel per phase for all K tenants), the
fixpoint-density one ``engine.fixpoint_density_stacked``.  Each tenant's
results are read back to the host once, after its dispatch
(``utils.pipeline.snapshot``), not field by field.

Not ported (their metrics are not registered; :data:`NOT_PORTED` names
them): the cost plane, which attributes each dispatched program's
compiler-reported flops to its tenants (``telemetry/costs.py``,
``utils/aot.py``), and the block autotuner that JAX's ``warm`` calls
before it compiles; both wait for ROADMAP.md A.7.
"""

import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..resilience.supervisor import (DEVICE_LOSS, IO, STALL, BackoffPolicy,
                                     classify_fault)
from ..telemetry.exemplars import EXEMPLARS_NAME, ExemplarRing
from ..telemetry.metrics import MetricsRegistry
from .journal import TicketJournal
from .scheduler import (DEFAULT_MAX_STACK, Dispatch, Request,
                        plan_dispatches)

#: metrics of the JAX package's service that wait for the tiers they
#: read, with the ROADMAP.md item that brings them (not registered, not
#: faked as zero)
NOT_PORTED = {
    "serve_tenant_flops_total":
        "A.7: the cost plane (telemetry/costs.py, utils/aot.py)",
}

#: request latency / dispatch wall buckets: 1ms .. 2 min
_LATENCY_BUCKETS = (1e-3, 5e-3, 2e-2, 0.1, 0.5, 2.0, 8.0, 30.0, 120.0)

#: dispatch-thread fault kinds the service retries in place (bounded,
#: deterministic backoff) instead of failing the group: transient by the
#: supervisor's taxonomy.  Everything else — including the deterministic
#: config errors a poisoned tenant raises — goes straight to bisection
#: (stacked) or a failed ticket (solo).
DISPATCH_RETRYABLE = (DEVICE_LOSS, IO, STALL)


class OverloadedError(RuntimeError):
    """Typed admission rejection: the queue is at ``max_queue``.  The
    transport maps it to an ``overloaded: true`` response the client
    backs off on — load past saturation degrades into explicit pushback,
    never an unbounded queue."""


class DeadlineExpired(RuntimeError):
    """The ticket's ``deadline_s`` was already spent at admission (the
    dispatch-time expiry path resolves the ticket as failed instead,
    since it was admitted and journaled)."""


def _soup_config_from_params(params: dict):
    """Build the STATIC ``SoupConfig`` a soup request selects (the group
    key: tenants stack iff this — plus the generation count and lineage
    flag — matches exactly).  Beside the JAX package's fields the port
    reads ``generation_impl`` when it is stated, so that a
    population-major ticket can ride the fused generation kernel."""
    from ..soup import SoupConfig
    from ..topology import Topology

    topo_kw = {"width": int(params.get("width", 2)),
               "depth": int(params.get("depth", 2))}
    if params.get("aggregates") is not None:
        # only when stated: Topology has its own default, and overriding
        # it with None would select a different static config (and jit
        # cache entry) than the solo process builds
        topo_kw["aggregates"] = int(params["aggregates"])
    topo = Topology(params.get("variant", "weightwise"), **topo_kw)
    base = SoupConfig(topo=topo, size=int(params["size"]))
    # unstated knobs take SoupConfig's OWN defaults (DEFAULT_LR etc.):
    # a drifted default here would silently run tenants with different
    # dynamics than the solo process they must stay bitwise-equal to
    return base._replace(
        attacking_rate=float(params.get("attacking_rate",
                                        base.attacking_rate)),
        learn_from_rate=float(params.get("learn_from_rate",
                                         base.learn_from_rate)),
        train=int(params.get("train", base.train)),
        learn_from_severity=int(params.get("learn_from_severity",
                                           base.learn_from_severity)),
        remove_divergent=bool(params.get("remove_divergent",
                                         base.remove_divergent)),
        remove_zero=bool(params.get("remove_zero", base.remove_zero)),
        epsilon=float(params.get("epsilon", base.epsilon)),
        lr=float(params.get("lr", base.lr)),
        train_mode=params.get("train_mode", base.train_mode),
        mode=params.get("mode", base.mode),
        layout=params.get("layout", base.layout),
        respawn_draws=params.get("respawn_draws", base.respawn_draws),
        generation_impl=params.get("generation_impl",
                                   base.generation_impl))


def _fixpoint_density_key(params: dict):
    """Tenants stack iff the dispatch SHAPES match; seed and epsilon are
    traced per tenant."""
    return (int(params["trials"]), int(params["batch"]))


def _soup_key(params: dict):
    """Full static spelling: config + generations (+ lineage, which picks
    a different program).  Non-stackable configs return None -> solo."""
    from ..soup import tenant_stackable

    cfg = _soup_config_from_params(params)
    if not tenant_stackable(cfg):
        return None
    return (cfg, int(params.get("generations", 10)),
            bool(params.get("lineage", False)))


GROUP_KEYS = {
    "fixpoint_density": _fixpoint_density_key,
    "soup": _soup_key,
}


#: completed results kept for ``poll`` readers; ``wait`` CONSUMES its
#: entry, so this bound only matters for fire-and-forget submitters —
#: past it the oldest un-waited results evict (a long-lived service must
#: not grow without bound; soup results can embed whole final states)
RESULT_RETENTION = 4096

#: slowest-traces panel depth (``stats()['slowest']``, rendered by
#: ``watch --service``): the in-memory top-K by latency, flag-labeled
SLOWEST_KEPT = 8


class ExperimentService:
    """Queue + scheduler + executors + telemetry; one instance per
    service process.  Thread-safe: any thread may ``submit``/``wait``;
    execution happens on whichever thread calls ``run_pending`` (the
    socket server runs one dispatch thread)."""

    def __init__(self, root: str, max_stack: int = DEFAULT_MAX_STACK,
                 registry: Optional[MetricsRegistry] = None,
                 writer=None, slo_p95_ms: float = 0.0,
                 max_queue: int = 0, results_ttl_s: float = 0.0,
                 dispatch_retries: int = 2, retry_backoff_s: float = 0.05,
                 chaos=None, fair_tenants: bool = False, device=None):
        from ..utils.pipeline import BackgroundWriter

        #: where the executors run: ``device``, else the setups' device
        #: (the card, or the CPU under SRNN_SETUPS_PLATFORM=cpu); raises
        #: without a card unless the CPU was asked for
        if device is None:
            from ..setups.common import device as setups_device

            self.device = setups_device()
        else:
            from ..init import resolve_device

            self.device = resolve_device(device)
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.max_stack = max_stack
        self.slo_p95_ms = float(slo_p95_ms)
        self.max_queue = max(0, int(max_queue))       # 0 = unbounded
        self.results_ttl_s = max(0.0, float(results_ttl_s))  # 0 = no TTL
        self.dispatch_retries = max(0, int(dispatch_retries))
        #: deterministic retry backoff (seeded like the supervisor's, so
        #: a chaos-harness run replays the same delay sequence); the base
        #: is service-scale — a dispatch retry must not stall the queue
        #: the way a mega-run restart may
        self._retry_policy = BackoffPolicy(
            max_restarts=self.dispatch_retries,
            base_s=max(0.0, float(retry_backoff_s)), max_s=2.0, seed=0)
        self.chaos = chaos
        self.registry = registry or MetricsRegistry()
        # registered eagerly so metrics.prom always exposes the SLO
        # counter (a clean service shows the 0, not a missing series)
        self.registry.counter(
            "serve_slo_violations_total",
            help="requests whose latency exceeded the --slo-p95-ms "
                 "target")
        # ... and the self-healing ladder counters, for the same reason:
        # the watch console / chaos smoke read zeros, not missing series
        self.registry.counter(
            "serve_journal_replays_total",
            help="journaled tickets replayed after a restart")
        self.registry.counter(
            "serve_quarantined_tenants_total",
            help="poisoned tenants isolated by group bisection")
        self.registry.counter(
            "serve_overload_rejections_total",
            help="submits rejected at admission (--max-queue)")
        self.registry.counter(
            "serve_deadline_expirations_total",
            help="tickets expired by their deadline_s (admission or "
                 "dispatch)")
        self.registry.counter(
            "serve_dispatch_retries_total",
            help="dispatch attempts retried on a transient classified "
                 "fault")
        self.registry.counter(
            "serve_results_evicted_total",
            help="uncollected results evicted (TTL or retention cap)")
        self._own_writer = writer is None
        self.writer = writer or BackgroundWriter(name="serve-io")
        self._events = open(os.path.join(root, "events.jsonl"), "a")
        self._lineage = None  # opened lazily on the first lineage row
        self.journal = TicketJournal(root)
        #: the continuous-batching tier's fairness flag (on whenever the
        #: adaptive controller is attached): tenant-interleave + cross-
        #: group round-robin chunk emission in every drain's plan
        self.fair_tenants = bool(fair_tenants)
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        #: signaled at admission (submit/recover) — the dispatcher blocks
        #: here instead of poll-sleeping, so an idle service burns no CPU
        #: and the first ticket after quiet starts its window immediately
        self._work = threading.Condition(self._lock)
        #: the adaptive window controller (attach_controller); None = the
        #: fixed-window dispatcher, its telemetry surface unchanged
        self._controller = None
        self._pending: List[Request] = []
        self._results: Dict[str, dict] = {}
        self._idem: Dict[str, str] = {}          # idempotency key -> ticket
        self._idem_by_ticket: Dict[str, str] = {}  # reverse (for cleanup)
        self._unfinished = set()  # admitted, not yet journaled done
        self._replayed = 0        # tickets re-admitted by recover()
        self._completed = 0   # monotone; _results is consume-on-wait
        self._draining = False   # set by fail_pending: no more submits
        self._warming = False    # warm() dispatches skip telemetry rows
        self._tickets = itertools.count(1)
        self._span_ids = itertools.count(1)   # ticket-span ids
        #: tail-kept exemplar traces (full family for SLO-violating /
        #: failed / quarantined tickets, root-only otherwise) + the
        #: in-memory slowest-traces panel the stats op exposes
        self._exemplars = ExemplarRing(os.path.join(root, EXEMPLARS_NAME))
        self._slowest: List[dict] = []
        self._programs = set()   # distinct (kind, key, shape) signatures
        self._closed = False
        # live telemetry plane (attach_live): the history ring sampled at
        # the top of every drain + the declarative alert engine
        self._live_history = None
        self._live_engine = None
        self._live_capture = None
        self._live_profiler = None
        self._live_last_profile_flush = float("-inf")
        self._t0 = time.monotonic()

    # -- submission / results -------------------------------------------

    def submit(self, kind: str, params: dict,
               tenant: Optional[str] = None,
               deadline_s: Optional[float] = None,
               idempotency_key: Optional[str] = None,
               trace_id: Optional[str] = None,
               parent_span: Optional[int] = None) -> str:
        """Admit one request; returns its ticket id.

        The returned id is DURABLE: the journal append (with fsync)
        happens under the admission lock, before the id escapes — an
        acknowledged ticket survives ``kill -9`` and replays on restart.
        ``idempotency_key`` dedupes: a resubmit with a known key (live
        table or journal-recovered) returns the existing ticket instead
        of double-running.  Raises :class:`OverloadedError` past
        ``max_queue`` and :class:`DeadlineExpired` for a ``deadline_s``
        that is already spent.

        ``trace_id``/``parent_span`` are the propagated trace context
        (fleet tracing): journaled with the submit and adopted by the
        ticket's span family, so a pool-forwarded ticket keeps ONE trace
        across the hop.  Telemetry-only — dispatch never reads them.
        """
        if kind not in GROUP_KEYS:
            raise ValueError(f"unknown request kind {kind!r}; "
                             f"expected one of {sorted(GROUP_KEYS)}")
        if deadline_s is not None and float(deadline_s) <= 0:
            self.registry.counter(
                "serve_deadline_expirations_total",
                help="tickets expired by their deadline_s (admission or "
                     "dispatch)").inc(1, kind=kind)
            raise DeadlineExpired(
                f"deadline_s={deadline_s} is already spent at admission")
        with self._lock:
            if self._draining:
                # closes the shutdown race for good: fail_pending flips
                # this under the SAME lock, so a submit that slipped past
                # the transport's stop check cannot strand its waiter
                raise RuntimeError("service shutting down")
            if idempotency_key:
                known = self._idem.get(idempotency_key)
                if known is not None:
                    return known   # admitted once per key; no re-run
            if self.max_queue and len(self._pending) >= self.max_queue:
                depth = len(self._pending)
                self.registry.counter(
                    "serve_overload_rejections_total",
                    help="submits rejected at admission "
                         "(--max-queue)").inc(1, kind=kind)
                self.registry.gauge(
                    "serve_queue_rejected_depth",
                    help="queue depth observed at the last overload "
                         "rejection").set(depth)
                raise OverloadedError(
                    f"queue full ({depth} >= max_queue={self.max_queue}); "
                    "back off and resubmit")
            now = time.monotonic()
            ticket = f"t{next(self._tickets):06d}"
            req = Request(ticket=ticket, kind=kind, params=dict(params),
                          tenant=tenant or ticket, submitted_s=now,
                          deadline_mono=(now + float(deadline_s)
                                         if deadline_s is not None
                                         else None),
                          idem_key=idempotency_key or None,
                          trace_id=trace_id or None,
                          parent_span=parent_span)
            # durable BEFORE acknowledged: fsync under the admission lock,
            # so the ticket id never outruns its journal record
            self.journal.record_submit(
                ticket=ticket, kind=kind, params=req.params,
                tenant=req.tenant, key=idempotency_key,
                deadline_wall=(time.time() + float(deadline_s)
                               if deadline_s is not None else None),
                wall=time.time(), trace_id=req.trace_id,
                parent_span=req.parent_span)
            admit_done = time.monotonic()
            admit_span = next(self._span_ids)
            self._pending.append(req)
            self._unfinished.add(ticket)
            if idempotency_key:
                self._idem[idempotency_key] = ticket
                self._idem_by_ticket[ticket] = idempotency_key
            depth = len(self._pending)
            self._work.notify_all()   # wake the blocked dispatcher
        # admission span: emitted NOW, not at completion like the ticket
        # family — it is the corpse's only lane marker for a ticket whose
        # worker dies mid-flight, which is exactly the trace the fleet
        # merge must still render end to end.  Duration = the durable
        # journal append the ack waited on.
        self._event_row(kind="span", span="serve.admit",
                        span_id=admit_span,
                        trace_id=req.trace_id or ticket,
                        remote_parent=req.parent_span, ticket=ticket,
                        process=0, tenant=req.tenant, request_kind=kind,
                        start_s=round(now - self._t0, 6),
                        seconds=round(admit_done - now, 6))
        if self.chaos is not None:
            self.chaos.note_submit(ticket)
        self.registry.counter("serve_requests_total",
                              help="experiment requests accepted").inc(
                                  1, kind=kind)
        self.registry.gauge("serve_queue_depth",
                            help="requests queued, not yet dispatched").set(
                                depth)
        return ticket

    def recover(self) -> int:
        """Replay the journal's unfinished tickets after a restart: each
        is re-admitted under its ORIGINAL ticket id (clients reconnect
        and ``wait`` the ids they already hold; idempotent resubmits
        dedupe onto them), the ticket counter resumes past every id the
        journal ever issued, and the journal itself is compacted to the
        unfinished suffix.  Returns the number of replayed tickets."""
        entries, torn, next_ticket = self.journal.recover()
        bad = []
        now = time.monotonic()
        wall_now = time.time()
        with self._lock:
            self._tickets = itertools.count(next_ticket)
            for e in entries:
                if e.kind not in GROUP_KEYS:
                    bad.append(e)     # foreign/forward-version record
                    continue
                deadline_mono = None
                if e.deadline_wall is not None:
                    # wall-clock deadline re-derived: downtime counts
                    # against the budget, like any other queueing delay
                    deadline_mono = now + (float(e.deadline_wall)
                                           - wall_now)
                req = Request(ticket=e.ticket, kind=e.kind,
                              params=dict(e.params), tenant=e.tenant,
                              submitted_s=now, deadline_mono=deadline_mono,
                              idem_key=e.key, trace_id=e.trace_id,
                              parent_span=e.parent_span)
                self._pending.append(req)
                self._unfinished.add(e.ticket)
                if e.key:
                    self._idem[e.key] = e.ticket
                    self._idem_by_ticket[e.ticket] = e.key
            replayed = [e for e in entries if e.kind in GROUP_KEYS]
            self._replayed += len(replayed)
            replay_spans = [next(self._span_ids) for _ in replayed]
            depth = len(self._pending)
            if depth:
                self._work.notify_all()
        for e, span_id in zip(replayed, replay_spans):
            # the survivor's re-admission marker, under the ORIGINAL
            # trace id: the merged fleet timeline shows the corpse's
            # serve.admit and this replay admit in one trace
            self._event_row(kind="span", span="serve.admit",
                            span_id=span_id,
                            trace_id=e.trace_id or e.ticket,
                            remote_parent=e.parent_span, ticket=e.ticket,
                            process=0, tenant=e.tenant,
                            request_kind=e.kind, replayed=True,
                            start_s=round(now - self._t0, 6),
                            seconds=0.0)
        for e in replayed:
            if self.chaos is not None:
                self.chaos.note_submit(e.ticket)
        for e in bad:
            req = Request(ticket=e.ticket, kind=e.kind, params=e.params,
                          tenant=e.tenant, submitted_s=now)
            self._resolve_failed(
                [req], f"unknown request kind {e.kind!r} in journal")
        if replayed:
            self.registry.counter(
                "serve_journal_replays_total",
                help="journaled tickets replayed after a restart").inc(
                    len(replayed))
            self.registry.gauge(
                "serve_queue_depth",
                help="requests queued, not yet dispatched").set(depth)
            self._event_row(kind="serve_replay",
                            tickets=[e.ticket for e in replayed],
                            torn_tail=torn or None)
        return len(replayed)

    def poll(self, ticket: str) -> Optional[dict]:
        """Completed entry for ``ticket`` ({'status', 'result'|'error'}),
        or None while pending."""
        with self._lock:
            return self._results.get(ticket)

    def wait(self, ticket: str, timeout_s: float = 600.0) -> dict:
        """Block until ``ticket`` completes (or fail after ``timeout_s``).
        CONSUMES the entry — each result is delivered to exactly one
        waiter, and the results table stays bounded under load."""
        deadline = time.monotonic() + timeout_s
        with self._done:
            while ticket not in self._results:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"request {ticket} still pending "
                                       f"after {timeout_s}s")
                self._done.wait(timeout=left)
            self._drop_idem_locked(ticket)
            return self._results.pop(ticket)

    def _drop_idem_locked(self, ticket: str) -> None:
        """A consumed (or evicted) result ends its idempotency window: a
        later resubmit with the same key is a fresh run, not a dangling
        pointer at a ticket whose result is gone."""
        key = self._idem_by_ticket.pop(ticket, None)
        if key is not None:
            self._idem.pop(key, None)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def wait_for_work(self, timeout_s: float = 1.0) -> bool:
        """Block until at least one request is pending (or ``timeout_s``
        elapses); returns whether work is pending.  The dispatcher's
        idle wait: admission (``submit``/``recover``) signals it, so an
        idle service burns no CPU and first-ticket latency is bounded by
        the adaptive window, not a poll interval.  Spurious returns are
        fine — the caller loops."""
        with self._work:
            if self._pending:
                return True
            self._work.wait(timeout=timeout_s)
            return bool(self._pending)

    def wake(self) -> None:
        """Wake a dispatcher blocked in :meth:`wait_for_work` (the
        transport's stop/drain path — the dispatcher re-checks its stop
        flag on every wake)."""
        with self._work:
            self._work.notify_all()

    def pending_groups(self) -> List:
        """Ordered-unique scheduler group ids ``(kind, key)`` of the
        pending queue — the adaptive controller's lookup domain for the
        next wait window.  A request whose key function raises (or
        returns None) reports ``(kind, None)``: the solo pool, which the
        controller treats as one group per kind."""
        with self._lock:
            snapshot = list(self._pending)
        out, seen = [], set()
        for req in snapshot:
            keyfn = GROUP_KEYS.get(req.kind)
            try:
                key = keyfn(req.params) if keyfn is not None else None
            except Exception:
                key = None
            gid = (req.kind, key)
            if gid not in seen:
                seen.add(gid)
                out.append(gid)
        return out

    # -- execution -------------------------------------------------------

    def attach_controller(self, controller, fair: bool = True) -> None:
        """Arm the continuous-batching tier: ``controller`` (an
        ``serve.controller.AdaptiveWindowController``) observes every
        retired dispatch and owns the per-group wait windows; ``fair``
        turns on the tenant-fairness plan (the two ship together — the
        ``--no-adaptive`` oracle disables both so the fixed-window path
        keeps the fixed-window surface, metrics.prom included)."""
        self._controller = controller
        self.fair_tenants = bool(fair)

    def attach_live(self, history, engine=None, capture=None,
                    profiler=None) -> None:
        """Arm the live telemetry plane: ``history`` (a
        ``telemetry.timeseries.MetricHistory`` over this service's
        registry, its jsonl stream in the service root) is sampled at
        the TOP of every drain — before the queue pops, so the
        queue-depth gauge still holds its pre-drain peak and a
        queue-at-the-bound condition is observable — and ``engine`` (a
        ``telemetry.alerts.AlertEngine``) evaluates on the same cadence,
        each transition riding events.jsonl as a ``{"kind": "alert"}``
        row.  ``capture`` (a ``telemetry.profiler.AnomalyCapture``)
        publishes its black-box bundle on each firing edge, inline after
        the alert rows that cite it; ``profiler`` (the owning process's
        ``SamplingProfiler``) folds its gauges on the same cadence and
        rides a throttled ``profile.folded``/``profile.jsonl`` rewrite
        on the service writer.  All close with the service (the caller
        keeps ownership of the profiler's ``stop()``)."""
        self._live_history = history
        self._live_engine = engine
        self._live_capture = capture
        self._live_profiler = profiler
        self._live_last_sample = float("-inf")
        self._live_last_profile_flush = float("-inf")

    def _sample_live(self) -> None:
        """One live-plane turn, inline on the dispatch thread (the
        sample is a registry snapshot + a jsonl append — microseconds
        against a dispatch).  Fail-soft: a telemetry error must never
        take down the dispatch loop."""
        if self._live_history is None:
            return
        try:
            self._live_last_sample = time.monotonic()
            self._live_history.sample()
            transitions = []
            if self._live_engine is not None:
                for transition in self._live_engine.evaluate():
                    self._event_row(kind="alert", **transition)
                    transitions.append(transition)
            if self._live_capture is not None:
                self._live_capture.on_transitions(transitions)
            if self._live_profiler is not None:
                self._live_profiler.update_gauges(self.registry)
                now = time.monotonic()
                if now - self._live_last_profile_flush >= 10.0:
                    # throttled cumulative rewrite: profile files need
                    # not track every dispatch, just stay fresh
                    self._live_last_profile_flush = now
                    self.writer.submit(self._live_profiler.write_files,
                                       self.root)
        except Exception as e:  # pragma: no cover - defensive
            import sys

            print(f"serve: live telemetry sample failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)

    def idle_sample_live(self, min_interval_s: float = 5.0) -> None:
        """Throttled live-plane turn for the dispatcher's IDLE ticks.
        Rate windows must keep sliding while no traffic arrives — a
        fired SLO-burn alert clears only once a quiet window passes,
        and with sampling confined to ``run_pending`` an idle service
        would report it firing until the next request.  Throttled so a
        50ms idle poll doesn't grow metrics_history.jsonl one row per
        tick."""
        if self._live_history is None:
            return
        if time.monotonic() - self._live_last_sample < min_interval_s:
            return
        self._sample_live()

    def run_pending(self, window_s: float = 0.0) -> int:
        """Drain the queue through the scheduler: plan stacked/solo
        dispatches, execute them, publish results.  Returns the number of
        requests completed.  ``window_s`` is the batching-window sleep
        the transport just performed before this drain (the stacking
        knob) — it attributes each ticket's pre-dispatch wait between
        queue backlog and window in the ticket-span breakdown."""
        # live plane first: the queue-depth gauge still holds the
        # pre-drain peak, so a saturated queue fires its alert even
        # though this very drain is about to empty it
        self._sample_live()
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return 0
        self.registry.gauge("serve_queue_depth",
                            help="requests queued, not yet dispatched").set(
                                self.queue_depth())
        batch = self._expire_overdue(batch)
        plan = plan_dispatches(batch, GROUP_KEYS, self.max_stack,
                               fair=self.fair_tenants)
        inflight = sum(len(d.requests) for d in plan)
        if self._controller is not None:
            # fleet-view gauges, adaptive tier only: the fixed-window
            # oracle's metrics.prom keeps its fixed-window surface
            g = self.registry.gauge(
                "serve_inflight_requests",
                help="tenant slots in the dispatch round in flight")
            g.set(inflight)
            self.registry.gauge(
                "serve_window_seconds",
                help="the adaptive batching window just applied "
                     "(min over pending groups)").set(
                    max(0.0, float(window_s)))
        for dispatch in plan:
            self._run_dispatch(dispatch, window_s=window_s)
            if self._controller is not None:
                inflight -= len(dispatch.requests)
                g.set(inflight)
        self.write_metrics()
        # post-drain turn: conditions this drain resolved (the queue is
        # empty again) emit their "cleared" edge now rather than at the
        # next burst
        self._sample_live()
        return len(batch)

    def _expire_overdue(self, reqs: Sequence[Request]) -> List[Request]:
        """Fail every request whose deadline has passed (they never
        occupy a stack slot) and return the live remainder."""
        now = time.monotonic()
        overdue = [r for r in reqs
                   if r.deadline_mono is not None and now > r.deadline_mono]
        if overdue:
            for r in overdue:
                self.registry.counter(
                    "serve_deadline_expirations_total",
                    help="tickets expired by their deadline_s (admission "
                         "or dispatch)").inc(1, kind=r.kind)
            self._resolve_failed(overdue,
                                 "deadline_s expired before dispatch")
        return [r for r in reqs
                if r.deadline_mono is None or now <= r.deadline_mono]

    def _execute(self, dispatch: Dispatch) -> List[dict]:
        """One dispatch execution attempt through the production path
        (the chaos injector's serve hooks fire here, so every recovery
        ladder drills the code real traffic runs)."""
        if self.chaos is not None:
            self.chaos.serve_dispatch(dispatch.requests)
        if dispatch.kind == "fixpoint_density":
            return self._exec_fixpoint_density(dispatch)
        if dispatch.kind == "soup":
            return self._exec_soup(dispatch)
        # pragma: no cover - submit() already validates
        raise ValueError(f"unknown kind {dispatch.kind!r}")

    def _run_dispatch(self, dispatch: Dispatch,
                      window_s: float = 0.0, _depth: int = 0) -> None:
        """Supervised dispatch: execute with bounded deterministic-backoff
        retries for transient classified faults; on a persisting STACKED
        failure, bisect the group to isolate the poisoned tenant(s) — the
        innocents complete solo, the poisoned quarantine (failed with the
        real error).  ``_depth`` marks bisection recursion: a solo failure
        under bisection is a quarantine, a top-level solo failure is an
        ordinary failed request."""
        # a ticket whose deadline burned away in the queue/backoff must
        # not occupy a stack slot — re-check at every (sub)dispatch
        live = self._expire_overdue(dispatch.requests)
        if not live:
            return
        if len(live) != len(dispatch.requests):
            dispatch = Dispatch(kind=dispatch.kind, key=dispatch.key,
                                requests=live)
        mode = "stacked" if dispatch.stacked else "solo"
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                results = self._execute(dispatch)
                error = fault = None
                break
            except Exception as e:  # a bad request must not kill the service
                fault = classify_fault(e)
                if fault in DISPATCH_RETRYABLE \
                        and attempt < self.dispatch_retries:
                    delay = self._retry_policy.delay(attempt)
                    attempt += 1
                    self.registry.counter(
                        "serve_dispatch_retries_total",
                        help="dispatch attempts retried on a transient "
                             "classified fault").inc(
                            1, kind=dispatch.kind, fault=fault)
                    self._event_row(kind="serve_retry",
                                    request_kind=dispatch.kind, fault=fault,
                                    attempt=attempt,
                                    backoff_s=round(delay, 4),
                                    error=f"{type(e).__name__}: {e}")
                    if delay > 0:
                        time.sleep(delay)
                    continue
                if dispatch.stacked:
                    # persisting group failure: bisect — one poisoned
                    # tenant must not take its stacked groupmates down
                    self._event_row(
                        kind="serve_bisect", request_kind=dispatch.kind,
                        tenants=[r.tenant for r in dispatch.requests],
                        fault=fault, error=f"{type(e).__name__}: {e}")
                    mid = len(dispatch.requests) // 2
                    for half in (dispatch.requests[:mid],
                                 dispatch.requests[mid:]):
                        self._run_dispatch(
                            Dispatch(kind=dispatch.kind, key=dispatch.key,
                                     requests=list(half)),
                            window_s=window_s, _depth=_depth + 1)
                    return
                results, error = None, f"{type(e).__name__}: {e}"
                break
        wall = time.monotonic() - t0
        quarantined = error is not None and _depth > 0
        if quarantined:
            self.registry.counter(
                "serve_quarantined_tenants_total",
                help="poisoned tenants isolated by group bisection").inc(
                    len(dispatch.requests), kind=dispatch.kind)
        self.registry.counter(
            "serve_dispatches_total",
            help="scheduler dispatch groups executed").inc(
                1, kind=dispatch.kind, mode=mode)
        self.registry.counter(
            "serve_dispatch_tenants_total",
            help="tenant slots executed across all dispatches").inc(
                len(dispatch.requests), mode=mode)
        self.registry.histogram(
            "serve_dispatch_seconds", help="dispatch group wall seconds",
            unit="seconds", buckets=_LATENCY_BUCKETS).observe(
                wall, kind=dispatch.kind, mode=mode)
        self._event_row(kind="serve_dispatch", request_kind=dispatch.kind,
                        mode=mode, tenants=[r.tenant for r in
                                            dispatch.requests],
                        wall_s=round(wall, 4),
                        error=error)
        now = time.monotonic()
        # journal the completions BEFORE any waiter can observe them: a
        # kill between delivery and the done-record would otherwise
        # replay tickets whose results were already collected
        self._mark_done(dispatch.requests,
                        "done" if error is None else "failed")
        violations = 0
        with self._done:
            for i, req in enumerate(dispatch.requests):
                if error is None:
                    entry = {"status": "done", "result": results[i],
                             "mode": mode}
                else:
                    entry = {"status": "failed", "error": error,
                             "mode": mode}
                if quarantined:
                    entry["quarantined"] = True
                entry["done_s"] = round(now, 4)   # TTL-eviction stamp
                self._results[req.ticket] = entry
                self._completed += 1
                self.registry.histogram(
                    "serve_request_seconds",
                    help="submit-to-completion latency", unit="seconds",
                    buckets=_LATENCY_BUCKETS).observe(
                        now - req.submitted_s, kind=req.kind)
                if error is not None:
                    self.registry.counter(
                        "serve_requests_failed_total",
                        help="requests whose dispatch raised").inc(
                            1, kind=req.kind)
                if self._ticket_spans(req, mode=mode,
                                      stack_k=len(dispatch.requests),
                                      dispatch_start=t0, wall=wall,
                                      now=now, window_s=window_s,
                                      error=error,
                                      quarantined=quarantined):
                    violations += 1
                self._event_row(kind="serve_tenant", ticket=req.ticket,
                                tenant=req.tenant, request_kind=req.kind,
                                mode=mode, quarantined=quarantined or None,
                                latency_s=round(now - req.submitted_s, 4),
                                error=error)
            self._evict_results_locked(now)
            self._done.notify_all()
        if self._controller is not None:
            # the controller's error signal: this dispatch's share of
            # the SLO counter (the serve_slo_burn rule's numerator) folds
            # into its group's window — shrink on burn, grow on clean
            self._controller.observe_dispatch(
                (dispatch.kind, dispatch.key), violations,
                len(dispatch.requests))

    def _mark_done(self, reqs: Sequence[Request], status: str) -> None:
        """Journal the completions (one fsync for the group) so a restart
        never re-runs a resolved ticket."""
        tickets = [r.ticket for r in reqs]
        self.journal.record_done(tickets, status)
        with self._lock:
            self._unfinished.difference_update(tickets)

    def _evict_results_locked(self, now: float) -> None:
        """Collected-or-TTL retention (caller holds ``self._done``):
        ``wait`` consumes its own entry; what nobody collects leaves by
        TTL (``results_ttl_s``) or, as the backstop, by the retention
        cap — counted, and with the idempotency window closed, so a
        long-lived service cannot leak its results table."""
        evicted = 0
        if self.results_ttl_s > 0:
            expired = [t for t, e in self._results.items()
                       if now - e.get("done_s", now) > self.results_ttl_s]
            for t in expired:
                self._results.pop(t)
                self._drop_idem_locked(t)
                evicted += 1
        # bound the table for fire-and-forget submitters (waiters
        # consume their own entries): evict oldest-first
        while len(self._results) > RESULT_RETENTION:
            t = next(iter(self._results))
            self._results.pop(t)
            self._drop_idem_locked(t)
            evicted += 1
        if evicted:
            self.registry.counter(
                "serve_results_evicted_total",
                help="uncollected results evicted (TTL or retention "
                     "cap)").inc(evicted)

    def _resolve_failed(self, reqs: Sequence[Request], error: str,
                        journal_done: bool = True,
                        resumable: bool = False) -> None:
        """Resolve ``reqs`` as failed WITHOUT executing (deadline expiry,
        drain, shutdown races).  ``journal_done=False`` leaves the
        tickets unfinished in the journal — the drain path's contract:
        the waiter gets a typed resumable failure now, and a restarted
        service replays the ticket."""
        now = time.monotonic()
        if journal_done:
            # journaled before any waiter observes it, like _run_dispatch
            self._mark_done(reqs, "failed")
        with self._done:
            for req in reqs:
                entry = {"status": "failed", "error": error, "mode": "none",
                         "done_s": round(now, 4)}
                if resumable:
                    entry["resumable"] = True
                self._results[req.ticket] = entry
                self._completed += 1
                self.registry.counter(
                    "serve_requests_failed_total",
                    help="requests whose dispatch raised").inc(
                        1, kind=req.kind)
                self._event_row(kind="serve_tenant", ticket=req.ticket,
                                tenant=req.tenant, request_kind=req.kind,
                                mode="none", error=error,
                                resumable=resumable or None)
            self._evict_results_locked(now)
            self._done.notify_all()

    def _ticket_spans(self, req: Request, *, mode: str, stack_k: int,
                      dispatch_start: float, wall: float, now: float,
                      window_s: float, error,
                      quarantined: bool = False) -> bool:
        """One completed ticket's structured span family + the
        ``serve_ticket_*`` histograms + the SLO counter; returns whether
        the ticket violated the SLO (the adaptive controller's per-
        dispatch error signal).

        Breakdown contract (asserted in ``tests/test_fleet.py``): the
        root ``serve.ticket`` span's duration is EXACTLY the latency the
        ``serve_request_seconds`` histogram observed, and the four child
        durations sum to it — queue (backlog wait before the batching
        window's share), window (``min(pre-dispatch wait, window_s)`` —
        a ticket that arrived mid-window only sat out the remainder),
        dispatch (its group's execution wall), publish (result-delivery
        residual).

        Trace adoption (fleet tracing): the family's ``trace_id`` is the
        PROPAGATED id when the submit carried one (a pool-forwarded
        ticket), the ticket id otherwise — and the root records the far
        side of the hop as ``remote_parent`` (the front's relay span id;
        a remote link, not ``parent``, because span ids are only unique
        per process).  The resolved family also feeds tail-based
        exemplar retention and the slowest-traces panel."""
        latency = now - req.submitted_s
        pre_dispatch = max(0.0, dispatch_start - req.submitted_s)
        window_wait = min(max(0.0, float(window_s)), pre_dispatch)
        queue_wait = pre_dispatch - window_wait
        publish = max(0.0, latency - pre_dispatch - wall)
        start = req.submitted_s - self._t0
        root = next(self._span_ids)
        common = dict(trace_id=req.trace_id or req.ticket, process=0,
                      tenant=req.tenant, request_kind=req.kind)
        rows = [dict(kind="span", span="serve.ticket", span_id=root,
                     start_s=round(start, 6),
                     seconds=round(latency, 6), mode=mode,
                     stack_k=stack_k, error=error, ticket=req.ticket,
                     remote_parent=req.parent_span, **common)]
        for name, child_start, dur, extra in (
                ("serve.ticket.queue", start, queue_wait, {}),
                ("serve.ticket.window", start + queue_wait, window_wait,
                 {}),
                ("serve.ticket.dispatch", dispatch_start - self._t0, wall,
                 {"stack_k": stack_k,
                  "per_tenant_s": round(wall / max(1, stack_k), 6)}),
                ("serve.ticket.publish", now - self._t0 - publish, publish,
                 {})):
            rows.append(dict(kind="span", span=name,
                             span_id=next(self._span_ids), parent=root,
                             start_s=round(child_start, 6),
                             seconds=round(dur, 6), **common, **extra))
        for row in rows:
            self._event_row(**row)
        h = self.registry.histogram
        h("serve_ticket_queue_seconds",
          help="per-ticket backlog wait before the batching window",
          unit="seconds", buckets=_LATENCY_BUCKETS).observe(
            queue_wait, kind=req.kind)
        h("serve_ticket_window_seconds",
          help="per-ticket share of the batching window sat out",
          unit="seconds", buckets=_LATENCY_BUCKETS).observe(
            window_wait, kind=req.kind)
        h("serve_ticket_dispatch_seconds",
          help="per-ticket dispatch-group execution wall",
          unit="seconds", buckets=_LATENCY_BUCKETS).observe(
            wall, kind=req.kind)
        violated = (self.slo_p95_ms > 0
                    and latency * 1000.0 > self.slo_p95_ms)
        if violated:
            self.registry.counter(
                "serve_slo_violations_total",
                help="requests whose latency exceeded the --slo-p95-ms "
                     "target").inc(1, kind=req.kind)
        self._retain_exemplar(req, rows, latency=latency, mode=mode,
                              violated=violated, quarantined=quarantined,
                              error=error)
        return violated   # a violating ticket burns: controller signal

    def _retain_exemplar(self, req: Request, rows: List[dict], *,
                         latency: float, mode: str, violated: bool,
                         quarantined: bool, error) -> None:
        """Tail-based retention: a ticket that violated the SLO, failed,
        or was quarantined keeps its FULL span family in the bounded
        exemplars ring; every other ticket keeps only its root span.
        Also maintains the slowest-traces panel (stats ``slowest``) —
        caller holds the service lock, so the list update is safe."""
        reasons = [r for r, on in (("slo", violated),
                                   ("quarantined", quarantined),
                                   ("failed", error is not None)) if on]
        spans = rows if reasons else rows[:1]
        record = {"ticket": req.ticket,
                  "trace_id": req.trace_id or req.ticket,
                  "reason": ",".join(reasons) or "root",
                  "seconds": round(latency, 6), "kind": req.kind,
                  "tenant": req.tenant,
                  "spans": [{k: v for k, v in row.items()
                             if v is not None} for row in spans]}
        # rides the writer like the span rows themselves: retention is
        # one appended line off the dispatch thread, never an fsync
        self.writer.submit(self._exemplars.add, record)
        self._slowest.append(
            {"ticket": req.ticket, "trace_id": req.trace_id or req.ticket,
             "seconds": round(latency, 6), "kind": req.kind,
             "tenant": req.tenant, "mode": mode,
             "slo_violation": violated, "failed": error is not None,
             "quarantined": quarantined})
        self._slowest.sort(key=lambda e: -e["seconds"])
        del self._slowest[SLOWEST_KEPT:]

    # -- executors -------------------------------------------------------

    def _note_program(self, kind: str, signature) -> None:
        self._programs.add((kind,) + tuple(signature))

    def _exec_fixpoint_density(self, dispatch: Dispatch) -> List[dict]:
        """The fixpoint-density sweep (``setups/fixpoint_density.py``'s
        compute) for 1..K tenants: the setups' per-batch draws
        (``setups.common.generator(seed, variant, offset)``), stacked
        across tenants on the leading axis."""
        from ..engine import fixpoint_density, fixpoint_density_stacked
        from ..setups.common import STANDARD_VARIANTS, generator, population
        from ..utils.pipeline import resolve, snapshot
        from .tenant import init_population_stacked

        reqs = dispatch.requests
        k = len(reqs)
        dev = self.device
        trials = int(reqs[0].params["trials"])
        batch = int(reqs[0].params["batch"])
        seeds = [int(r.params.get("seed", 0)) for r in reqs]
        eps = [float(r.params.get("epsilon", 1e-4)) for r in reqs]
        variants = STANDARD_VARIANTS[:2]  # WW + Agg, like the reference
        per_variant = []
        for i, (_name, topo) in enumerate(variants):
            totals = torch.zeros((k, 5), dtype=torch.int32, device=dev)
            done = 0
            while done < trials:
                n = min(batch, trials - done)
                if k > 1:
                    pops = init_population_stacked(
                        topo, [generator(sd, i, done) for sd in seeds], n,
                        dev)
                    totals = totals + fixpoint_density_stacked(topo, pops,
                                                               eps)
                else:
                    # the solo spelling is the setups' own call
                    pop = population(topo, n, dev, seeds[0], i, done)
                    totals = totals + fixpoint_density(topo, pop,
                                                       eps[0])[None]
                self._note_program(dispatch.kind, (str(topo), k, n))
                done += n
            per_variant.append(totals)
        host = resolve(snapshot(per_variant))
        names = [name for name, _ in variants]
        return [{"variant_names": names,
                 "counters": [v[t].tolist() for v in host]}
                for t in range(k)]

    def _exec_soup(self, dispatch: Dispatch) -> List[dict]:
        """A homogeneous soup run (seed -> evolve -> count) for 1..K
        tenants, each seeded from ``setups.common.generator(seed)`` as
        the soup setups seed theirs; the stacked spelling runs
        ``serve.tenant.evolve_stacked`` and streams per-tenant lineage
        rows."""
        from ..setups.common import generator
        from ..soup import count, evolve, seed
        from ..telemetry.dynamics import DEFAULT_EDGE_CAPACITY, seed_lineage
        from ..utils.pipeline import resolve, snapshot
        from .tenant import evolve_stacked, stack_tenants, unstack_tenants

        reqs = dispatch.requests
        k = len(reqs)
        dev = self.device
        params0 = reqs[0].params
        cfg = _soup_config_from_params(params0)
        gens = int(params0.get("generations", 10))
        lineage = bool(params0.get("lineage", False))
        states = [seed(cfg, generator(int(r.params.get("seed", 0))), dev)
                  for r in reqs]
        kw = {"generations": gens, "metrics": True}
        if lineage:
            kw["lineage"] = True
            kw["lineage_capacity"] = DEFAULT_EDGE_CAPACITY
        if k > 1:
            if lineage:
                kw["lineage_state"] = stack_tenants(
                    [seed_lineage(cfg.size, device=dev) for _ in range(k)])
            out = evolve_stacked(cfg, stack_tenants(states), **kw)
            tenants = unstack_tenants(out, k)
        else:
            if lineage:
                kw["lineage_state"] = seed_lineage(cfg.size, device=dev)
            tenants = [evolve(cfg, states[0], **kw)]
        self._note_program(dispatch.kind,
                           (repr(cfg), gens, lineage, k))
        keep_state = cfg.size * cfg.topo.num_weights <= 262144
        # everything the results hold, read back in one go per dispatch
        wanted = []
        for t, (final, m, *rest) in enumerate(tenants):
            row = [count(cfg, final), final.time, final.next_uid,
                   m.generations, m.actions, m.loss_sum]
            if keep_state and bool(reqs[t].params.get("return_state",
                                                      True)):
                w = final.weights   # numpy has no bfloat16: widen it
                row += [w.float() if w.dtype == torch.bfloat16 else w,
                        final.uids]
            wanted.append(row)
        host = resolve(snapshot(wanted))
        results = []
        for t, req in enumerate(reqs):
            counts, time_, next_uid, g, actions, loss_sum, *state = host[t]
            row = {"counters": counts.tolist(),
                   "final_time": int(time_),
                   "next_uid": int(next_uid),
                   "metrics": {
                       "generations": int(g),
                       "actions": actions.tolist(),
                       "loss_sum": float(loss_sum)}}
            if state:
                row["weights"] = state[0].tolist()
                row["uids"] = state[1].tolist()
            if lineage:
                self._lineage_row(req, cfg, gens, tenants[t][2])
            results.append(row)
        return results

    def _lineage_row(self, req: Request, cfg, gens: int, ltriple) -> None:
        """Per-tenant replication-dynamics window row, tenant-labeled,
        appended to the service's lineage.jsonl through the writer."""
        if self._warming:
            return   # throwaway warm tenants must not pollute the stream
        from ..telemetry.dynamics import DEFAULT_EDGE_CAPACITY, window_record
        from ..utils.pipeline import resolve, snapshot

        lin, win, stats = ltriple
        win, stats, next_pid = resolve(snapshot(
            [list(win), list(stats), lin.next_pid]))
        row = window_record(0, gens, type(ltriple[1])(*win),
                            type(ltriple[2])(*stats), DEFAULT_EDGE_CAPACITY,
                            next_pid=int(next_pid))
        row["tenant"] = req.tenant
        row["ticket"] = req.ticket

        def append():
            if self._lineage is None:
                self._lineage = open(os.path.join(self.root,
                                                  "lineage.jsonl"), "a")
            self._lineage.write(json.dumps(row) + "\n")
            self._lineage.flush()

        self.writer.submit(append)

    def warm(self, kind: str, params: dict,
             widths: Optional[Sequence[int]] = None) -> None:
        """Pre-dispatch the executor for ``(kind, params)`` at each stack
        width in ``widths`` (default: the service's ``max_stack`` and solo)
        with throwaway seeds, so that the spelling's kernels are built
        (nvcc at a kernel's first launch) and its first real tenants only
        execute.  Warm dispatches do not touch the serve metrics; they DO
        count into ``distinct_programs``."""
        widths = sorted(set(widths or (self.max_stack, 1)))
        self._warming = True   # no lineage/event rows for warm tenants
        try:
            # the JAX package tunes the spelling's lane blocks here
            # (autotune.autotune_for_run, fail-soft); the port's block
            # autotuner waits for ROADMAP.md A.7 (autotune.py)
            for k in widths:
                reqs = [Request(ticket=f"warm{i:03d}", kind=kind,
                                params=dict(params), tenant=f"warm{i:03d}",
                                submitted_s=time.monotonic())
                        for i in range(k)]
                d = Dispatch(kind=kind, key=("warm",), requests=reqs)
                if kind == "fixpoint_density":
                    self._exec_fixpoint_density(d)
                elif kind == "soup":
                    self._exec_soup(d)
                else:
                    raise ValueError(f"unknown request kind {kind!r}")
        finally:
            self._warming = False

    # -- telemetry sinks -------------------------------------------------

    def _event_row(self, **fields) -> None:
        fields.setdefault("t", round(time.monotonic() - self._t0, 4))
        fields = {k: v for k, v in fields.items() if v is not None}

        def append():
            self._events.write(json.dumps(fields) + "\n")
            self._events.flush()

        self.writer.submit(append)

    def write_metrics(self) -> str:
        """Atomically publish metrics.prom in the service root (riding the
        writer so it lands after the rows it summarizes)."""
        path = os.path.join(self.root, "metrics.prom")
        self.writer.submit(self.registry.write_textfile, path)
        return path

    def stats(self) -> dict:
        """Host-side snapshot for the ``stats`` op / load bench / watch
        console; ``slo`` carries the target, the violation count, and a
        conservative measured p95 (histogram-bucket upper bound)."""
        with self._lock:
            done = self._completed
            depth = len(self._pending)
            programs = len(self._programs)
            slowest = [dict(e) for e in self._slowest]
        violations = sum(
            v for _suffix, v in self.registry.counter(
                "serve_slo_violations_total").samples())
        p95 = self.registry.histogram(
            "serve_request_seconds",
            help="submit-to-completion latency", unit="seconds",
            buckets=_LATENCY_BUCKETS).quantile(0.95)
        alerts = None
        if self._live_engine is not None:
            alerts = {"active": self._live_engine.active(),
                      "fired": self._counter_total("soup_alerts_total")}
        if self._controller is not None:
            dispatch = self._controller.snapshot()
            dispatch["fair_tenants"] = self.fair_tenants
        else:
            dispatch = {"adaptive": False}
        return {"completed": done, "queue_depth": depth,
                "dispatch": dispatch,
                "distinct_programs": programs,
                "uptime_s": round(time.monotonic() - self._t0, 2),
                "slo": {
                    "target_p95_ms": self.slo_p95_ms or None,
                    "violations": int(violations),
                    "p95_ms": round(p95 * 1000.0, 3)
                    if p95 is not None else None,
                },
                "self_healing": self._self_healing_stats(),
                "slowest": slowest,
                "alerts": alerts,
                "metrics": self.registry.rows()}

    def _counter_total(self, name: str) -> int:
        return int(sum(v for _suffix, v in
                       self.registry.counter(name).samples()))

    def _self_healing_stats(self) -> dict:
        """The recovery-ladder snapshot the watch console's ``--service``
        view renders: journal depth, replay/quarantine/admission
        counters."""
        with self._lock:
            unfinished = len(self._unfinished)
            replayed = self._replayed
        return {"journal_unfinished": unfinished,
                "replayed": replayed,
                "quarantined": self._counter_total(
                    "serve_quarantined_tenants_total"),
                "dispatch_retries": self._counter_total(
                    "serve_dispatch_retries_total"),
                "overload_rejections": self._counter_total(
                    "serve_overload_rejections_total"),
                "deadline_expirations": self._counter_total(
                    "serve_deadline_expirations_total"),
                "results_evicted": self._counter_total(
                    "serve_results_evicted_total"),
                "max_queue": self.max_queue or None}

    def fail_pending(self, reason: str, resumable: bool = False) -> int:
        """Resolve every still-queued request as failed (shutdown/drain
        path: a submit that raced the dispatcher's final drain must not
        leave its waiter blocked until timeout).  The tickets stay
        UNFINISHED in the journal either way — a restarted service
        replays them; ``resumable=True`` (the SIGTERM drain) says so in
        the typed response, so the client resubmits-or-waits after the
        restart instead of treating the failure as final.  Returns how
        many."""
        with self._done:
            self._draining = True   # submit() refuses from here on
            stranded, self._pending = self._pending, []
            self._work.notify_all()   # unblock an idle dispatcher
        if stranded:
            self._resolve_failed(stranded, reason, journal_done=False,
                                 resumable=resumable)
        return len(stranded)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._live_profiler is not None:
            # final cumulative profile rewrite from the (frozen) tables
            try:
                self._live_profiler.update_gauges(self.registry)
                self._live_profiler.write_files(self.root)
            except OSError:
                pass
        self.registry.write_textfile(os.path.join(self.root,
                                                  "metrics.prom"))
        if self._own_writer:
            self.writer.close()
        else:
            # a SHARED writer stays open for its other producers, but any
            # queued row jobs reference the files closed below — drain
            # them first or they would latch a WriterError on everyone
            self.writer.flush()
        self._events.close()
        self.journal.close()
        if self._lineage is not None:
            self._lineage.close()
        if self._live_history is not None:
            self._live_history.close()
        if self._live_capture is not None:
            self._live_capture.close()

    def __enter__(self) -> "ExperimentService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

