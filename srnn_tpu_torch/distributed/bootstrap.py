"""Process bring-up for the multi-process runs; port of
``srnn_tpu/distributed/bootstrap.py`` on ``torch.distributed``.

One mega run spanning several processes (one per card, or several ranks
on the CPU) needs three facts before it touches a device: where the
coordinator (the rendezvous store) lives, how many processes take part,
and which one this is.  The launcher (``distributed.launch``) exports them
as ``SRNN_DIST_*`` variables; explicit CLI flags (``--dist-coordinator``
etc.) win over them.  :func:`ensure_initialized` is the one entry every
mega loop calls first: idempotent, and a no-op for a single-process run.

The backend follows the device: NCCL for CUDA tensors, gloo for the CPU
(``SRNN_SETUPS_PLATFORM=cpu``).  Gloo on CUDA tensors -- several ranks on
one card, each staging its collectives through host memory -- runs only
when asked for, with ``--dist-backend gloo``.
Each rank takes card ``process_id % device_count``.  NCCL refuses two
ranks on one card; its error is raised as NCCL raises it.

Failure vocabulary (classified by ``resilience.classify_fault``):

  * :class:`CoordinatorTimeout` -- the rendezvous store did not form (a
    peer or the coordinator never answered) within ``SRNN_DIST_TIMEOUT_S``.
    A dead coordinator is a lost host as far as recovery goes: both
    classify ``host_loss``.
  * :class:`HostLost` -- a peer process is gone mid-run: raised by the
    chaos injector's ``host_loss@G`` and by the soup mesh's collectives
    when gloo reports a closed or reset connection
    (``parallel.mesh``).  In a multi-process run the supervisor turns it
    into ``resilience.EXIT_HOST_LOST`` (71) and the launcher re-ramps on
    fewer processes from the last durable checkpoint: a process group's
    membership is fixed for its lifetime.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Optional

import torch

COORD_ENV = "SRNN_DIST_COORD"
PROCS_ENV = "SRNN_DIST_PROCS"
PID_ENV = "SRNN_DIST_PID"
TIMEOUT_ENV = "SRNN_DIST_TIMEOUT_S"

#: default bring-up deadline: long enough for a slow peer's imports,
#: short enough that a dead coordinator shows inside one test timeout
DEFAULT_TIMEOUT_S = 120.0

BACKENDS = ("nccl", "gloo")


class CoordinatorTimeout(Exception):
    """Distributed bring-up failed: the rendezvous store did not form
    within the deadline.  Classified ``host_loss``."""


class HostLost(Exception):
    """A peer process is gone mid-run.  Classified ``host_loss``: a
    multi-process run exits ``EXIT_HOST_LOST`` for the launcher tier to
    re-ramp on fewer processes."""


class DistContext:
    """What one process knows about the distributed run it belongs to,
    and the device its rank runs on."""

    def __init__(self, active: bool, process_id: int = 0,
                 num_processes: int = 1,
                 coordinator: Optional[str] = None,
                 backend: Optional[str] = None, device=None):
        self.active = active
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.coordinator = coordinator
        self.backend = backend
        self.device = torch.device(device) if device is not None \
            else _platform_device(0)

    @property
    def primary(self) -> bool:
        """Process 0 owns all host I/O but per-process heartbeats (the
        process-0 I/O contract, ``distributed.hostio``)."""
        return self.process_id == 0

    def __repr__(self):
        return (f"DistContext(active={self.active}, "
                f"process={self.process_id}/{self.num_processes}, "
                f"{self.backend}, {self.device})")


#: the process-wide bring-up result (a process joins one group for life)
_CONTEXT: Optional[DistContext] = None


def _platform_device(process_id: int) -> torch.device:
    """The rank's device without touching it: the CPU under
    ``SRNN_SETUPS_PLATFORM=cpu`` or without a card, else card
    ``process_id % device_count``."""
    if os.environ.get("SRNN_SETUPS_PLATFORM") == "cpu" \
            or not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def _resolve(args) -> "tuple[Optional[str], Optional[int], Optional[int]]":
    """(coordinator, num_processes, process_id) from CLI flags first
    (explicit wins), then the launcher's variables; all ``None`` means
    single-process."""
    coord = getattr(args, "dist_coordinator", None) if args is not None \
        else None
    nproc = getattr(args, "dist_processes", None) if args is not None \
        else None
    pid = getattr(args, "dist_process_id", None) if args is not None \
        else None
    if coord is None and nproc is None and pid is None:
        coord = os.environ.get(COORD_ENV) or None
        if coord:
            nproc = int(os.environ.get(PROCS_ENV, "0") or 0) or None
            pid = int(os.environ.get(PID_ENV, "-1"))
            pid = pid if pid >= 0 else None
    return coord, nproc, pid


def resolve_backend(args, device: torch.device) -> str:
    """The process group's backend: ``--dist-backend``, else the
    device's (NCCL for a card, gloo for the CPU).  NCCL cannot move CPU
    tensors, so it is refused there."""
    asked = getattr(args, "dist_backend", None) if args is not None \
        else None
    if asked is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if asked not in BACKENDS:
        raise SystemExit(f"distributed backend {asked!r} is not one of "
                         f"{', '.join(BACKENDS)}")
    if asked == "nccl" and device.type != "cuda":
        raise SystemExit("the nccl backend moves CUDA tensors; a CPU run "
                         "needs gloo")
    return asked


def ensure_initialized(args=None) -> DistContext:
    """Idempotent multi-process bring-up; returns the process's
    :class:`DistContext` (``active=False`` for plain single-process
    runs).  Runs before anything else touches a device."""
    global _CONTEXT
    if _CONTEXT is not None:
        return _CONTEXT
    coord, nproc, pid = _resolve(args)
    if coord is None and nproc is None and pid is None:
        _CONTEXT = DistContext(active=False)
        return _CONTEXT
    if coord is None or nproc is None or pid is None:
        # a partial spec must fail loudly: running solo would leave the
        # correctly configured peers blocked on a group that never forms
        raise SystemExit(
            "distributed bring-up needs all three of coordinator address, "
            "process count and process id (SRNN_DIST_COORD/_PROCS/_PID or "
            "--dist-coordinator/--dist-processes/--dist-process-id); got "
            f"coordinator={coord!r}, processes={nproc!r}, id={pid!r}")
    if int(nproc) <= 1:
        # a 1-process "distributed" job (the launcher's re-ramp floor) is
        # a solo run: no coordinator needed
        _CONTEXT = DistContext(active=False)
        return _CONTEXT
    import torch.distributed as dist

    dev = _platform_device(int(pid))
    backend = resolve_backend(args, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = float(os.environ.get(TIMEOUT_ENV, "") or DEFAULT_TIMEOUT_S)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}", world_size=int(nproc),
            rank=int(pid), timeout=datetime.timedelta(seconds=timeout))
    except Exception as e:
        raise CoordinatorTimeout(
            f"distributed bring-up failed for process {pid}/{nproc} "
            f"(coordinator {coord}, timeout {timeout:g}s): "
            f"{type(e).__name__}: {e}") from e
    _CONTEXT = DistContext(active=True, process_id=int(pid),
                           num_processes=int(nproc), coordinator=coord,
                           backend=backend, device=dev)
    print(f"distributed: process {pid}/{nproc} up (coordinator {coord}, "
          f"{backend} on {dev})", file=sys.stderr, flush=True)
    return _CONTEXT


def context() -> DistContext:
    """The bring-up result so far (inactive when nothing initialized)."""
    return _CONTEXT if _CONTEXT is not None else DistContext(active=False)


def shutdown() -> None:
    """Leave the process group at the end of a run that every rank
    finished (a no-op where none was formed)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def add_distributed_args(p):
    """The explicit-flag spelling of the launcher's variables, for driving
    a worker by hand, and the backend choice."""
    p.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address of the process group (usually "
                        "set through SRNN_DIST_COORD by distributed.launch)")
    p.add_argument("--dist-processes", type=int, default=None, metavar="N",
                   help="total process count of the distributed run")
    p.add_argument("--dist-process-id", type=int, default=None, metavar="I",
                   help="this process's id (0 = primary, owns host I/O)")
    p.add_argument("--dist-backend", default=None, choices=BACKENDS,
                   help="the process group's backend (default: nccl on "
                        "the card, gloo on the CPU; 'gloo' on the card "
                        "stages collectives through host memory and lets "
                        "several ranks share one card)")
    return p
