"""The distributed runtime tier: multi-process mega runs on
``torch.distributed``; port of ``srnn_tpu/distributed``.

Three layers:

  * ``bootstrap`` -- per-process bring-up of the process group from the
    launcher's variables or explicit flags (NCCL on the card, gloo on the
    CPU or when asked for), idempotent, a no-op for single-process runs.
  * ``hostio`` -- the process-0 I/O contract: the collective host gather
    of the sharded state (``fetch_tree``), the run-directory broadcast,
    and the ``WorkerLog`` sink non-primary processes log through.
  * ``launch`` -- the process-restart tier: ``python -m
    srnn_tpu_torch.distributed.launch --processes N -- mega_soup ...``
    spawns the workers, relays their output, re-ramps on a lost host
    (fewer processes, resumed from the last durable checkpoint) and
    propagates exit codes.
"""

from .bootstrap import (CoordinatorTimeout, DistContext, HostLost,
                        add_distributed_args, context, ensure_initialized)

__all__ = [
    "CoordinatorTimeout",
    "DistContext",
    "HostLost",
    "add_distributed_args",
    "context",
    "ensure_initialized",
]
