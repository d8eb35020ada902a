"""Multi-tenant batched experiment service ("soup of soups"); port of
``srnn_tpu/serve``, exporting its ``__all__``.

  * ``serve.tenant`` — the tenant axis: K experiment configs (same
    statics, different seeds) stacked into one (K, N, ...) row-major soup,
    one launch per phase for all of them, every tenant bitwise equal to
    its solo run.
  * ``serve.scheduler`` — group requests by static spelling; stacked
    dispatch for matching groups, solo for odd configs.
  * ``serve.service`` — the long-lived core on the card: queue, executors,
    ``srnn_serve_*`` metrics, tenant-labelled telemetry and lineage rows.
  * ``serve.server`` / ``serve.client`` — the Unix-socket JSON-lines
    transport (the JAX package's protocol); ``python -m
    srnn_tpu_torch.serve`` runs the server, the setups' ``--service``
    flag makes them clients.
  * ``serve.journal`` — the durable ticket journal (the JAX package's
    file format): admits fsynced before acknowledgment, completions
    journaled, a restarted service replays the rest bitwise.
  * ``serve.controller`` — the adaptive batching window.
  * ``serve.pool`` — ``--workers N``: N dispatch processes behind one
    front socket, sticky per-tenant round-robin, the journal as the
    shared-nothing replay substrate.
"""

from .client import ServiceClient, ServiceError, ServiceOverloaded
from .controller import AdaptiveWindowController, make_controller
from .journal import TicketJournal, read_journal
from .pool import ServicePool, WorkerHandle
from .scheduler import (DEFAULT_MAX_STACK, Request, interleave_tenants,
                        plan_dispatches)
from .service import (DeadlineExpired, ExperimentService, OverloadedError)
from .tenant import (evolve_multi_stacked, evolve_multi_stacked_donated,
                     evolve_stacked, evolve_stacked_captured,
                     evolve_stacked_donated, evolve_stacked_step,
                     evolve_stacked_step_donated, init_population_stacked,
                     seed_stacked, stack_tenants, unstack_tenants)

__all__ = [
    "AdaptiveWindowController",
    "DEFAULT_MAX_STACK",
    "DeadlineExpired",
    "ExperimentService",
    "OverloadedError",
    "Request",
    "ServiceClient",
    "ServiceError",
    "ServiceOverloaded",
    "ServicePool",
    "TicketJournal",
    "WorkerHandle",
    "read_journal",
    "evolve_multi_stacked",
    "evolve_multi_stacked_donated",
    "evolve_stacked",
    "evolve_stacked_captured",
    "evolve_stacked_donated",
    "evolve_stacked_step",
    "evolve_stacked_step_donated",
    "init_population_stacked",
    "interleave_tenants",
    "make_controller",
    "plan_dispatches",
    "seed_stacked",
    "stack_tenants",
    "unstack_tenants",
]
