"""Batching scheduler: group compatible requests into stacked dispatches;
a copy of ``srnn_tpu/serve/scheduler.py``.

The grouping key is the request's STATIC spelling — everything that
selects a compiled program (experiment kind, topology, the full
``SoupConfig`` statics, generation count, dispatch shapes).  Requests
whose keys match are interchangeable up to traced values (seeds,
epsilons), so K of them stack into one ``(K, ...)`` tenant-axis dispatch
(``serve.tenant``); an odd-one-out key falls back to SOLO dispatch — the
exact per-tenant program, so fallback never changes results, only
amortization.

Fairness (the continuous-batching tier's policy, ``fair=True``): a hog
tenant flooding one spelling must not starve other tenants' tickets for
whole drain cycles.  Two stable transforms, both deterministic given the
same queue snapshot: :func:`interleave_tenants` reorders the batch
round-robin by tenant (round r takes each tenant's r-th request, tenants
in first-appearance order) BEFORE grouping, and the planner then emits
chunks round-robin ACROSS groups (chunk 0 of every group, then chunk 1,
...) so one group's long chunk train cannot push another group's first
chunk to the end of the drain.

Pure host logic, no torch: the service owns execution; this module only
decides who rides together.
"""

from typing import Dict, Hashable, List, NamedTuple, Optional, Sequence

#: default cap on tenants per stacked dispatch (K): past this the stacked
#: program's own compile becomes a new spelling per K — the service warms
#: a fixed K and chunks bigger groups into full stacks + a remainder
DEFAULT_MAX_STACK = 8


class Request(NamedTuple):
    """One queued experiment request."""
    ticket: str           # unique id, assigned by the service
    kind: str             # executor name ('fixpoint_density', 'soup', ...)
    params: dict          # kind-specific payload (seeds, shapes, knobs)
    tenant: str           # tenant label for telemetry/lineage rows
    submitted_s: float    # monotonic submit stamp (latency accounting)
    #: absolute MONOTONIC deadline stamped at admission (None = no
    #: deadline); expired tickets fail fast and never occupy a stack slot
    deadline_mono: Optional[float] = None
    #: client idempotency key — a resubmit with the same key dedupes
    #: against the live table / the durable journal instead of re-running
    idem_key: Optional[str] = None
    #: propagated trace context (fleet tracing).  ``trace_id`` is the
    #: distributed trace this ticket belongs to (the service falls back
    #: to the ticket id when absent); ``parent_span`` is the span id of
    #: the far side of the hop (e.g. the pool front's relay span), kept
    #: as a REMOTE link because span ids are only unique per process.
    #: Telemetry labels only — scheduling/grouping never reads them.
    trace_id: Optional[str] = None
    parent_span: Optional[int] = None


class Dispatch(NamedTuple):
    """One planned dispatch: ``requests`` ride together iff ``stacked``."""
    kind: str
    key: Hashable
    requests: List[Request]

    @property
    def stacked(self) -> bool:
        return len(self.requests) > 1


def interleave_tenants(requests: Sequence[Request]) -> List[Request]:
    """Stable per-tenant round-robin: round r takes the r-th request of
    each tenant, tenants ordered by first appearance.  Within a tenant,
    submission order is preserved; across tenants, a hog submitting 50
    tickets ahead of a second tenant's one no longer owns the first 50
    stack slots of the drain."""
    by_tenant: Dict[str, List[Request]] = {}
    tenant_order: List[str] = []
    for req in requests:
        if req.tenant not in by_tenant:
            by_tenant[req.tenant] = []
            tenant_order.append(req.tenant)
        by_tenant[req.tenant].append(req)
    out: List[Request] = []
    r = 0
    while len(out) < len(requests):
        for tenant in tenant_order:
            queue = by_tenant[tenant]
            if r < len(queue):
                out.append(queue[r])
        r += 1
    return out


def plan_dispatches(requests: Sequence[Request], group_keys: Dict[str, "callable"],
                    max_stack: int = DEFAULT_MAX_STACK,
                    fair: bool = False) -> List[Dispatch]:
    """Group ``requests`` into stacked/solo dispatches.

    ``group_keys`` maps kind -> key function over params; a kind without
    one (or a key function returning ``None``) never stacks.  Groups keep
    submission order, chunk at ``max_stack``, and a chunk of one is a
    solo dispatch by construction.  The returned plan preserves
    first-submission order across groups (fairness: an early solo request
    is not starved behind later stackable traffic).

    ``fair=True`` (the adaptive tier) layers the tenant policy on top:
    requests are tenant-interleaved before grouping, and chunks are
    emitted round-robin across groups rather than group-by-group — see
    the module docstring.  Stacking itself is unchanged (same spellings
    ride together either way), so fairness reorders WHO dispatches when,
    never WHAT a dispatch computes.
    """
    if fair:
        requests = interleave_tenants(requests)
    groups: Dict = {}
    order: List = []
    for i, req in enumerate(requests):
        keyfn = group_keys.get(req.kind)
        try:
            key = keyfn(req.params) if keyfn is not None else None
        except Exception:
            # malformed params must not take down the scheduling round:
            # route the request solo so its executor raises inside the
            # per-dispatch error wall and fails ONLY this request
            key = None
        if key is None:
            gid = ("solo", i)      # unstackable: its own group
            full_key = None
        else:
            gid = (req.kind, key)
            full_key = key
        if gid not in groups:
            groups[gid] = (full_key, [])
            order.append(gid)
        groups[gid][1].append(req)
    chunked: Dict = {}
    for gid in order:
        key, members = groups[gid]
        chunked[gid] = [
            Dispatch(kind=members[0].kind, key=key,
                     requests=members[lo:lo + max_stack])
            for lo in range(0, len(members), max(1, max_stack))]
    plan: List[Dispatch] = []
    if fair:
        # round-robin across groups: chunk 0 of every group in order,
        # then chunk 1 of every group, ... — no group's chunk train
        # monopolizes the head of the drain
        r = 0
        while len(plan) < sum(len(c) for c in chunked.values()):
            for gid in order:
                if r < len(chunked[gid]):
                    plan.append(chunked[gid][r])
            r += 1
    else:
        for gid in order:
            plan.extend(chunked[gid])
    return plan
