"""``python -m srnn_tpu_torch.setups <name> [flags]``.

Runs on the card; ``SRNN_SETUPS_PLATFORM=cpu`` runs on the CPU instead, and
without either it exits 1 with a message (no fallback).  Where
``SRNN_LAUNCH_COUNTS`` names a file, the run's kernel launch counts are
written there as one JSON object ({kernel name: launches}), also when the
run exits with a code; a process of a distributed run writes its own,
the name with ``.p<process id>`` appended.  The supervised mega runs
speak the supervisor's exit codes (``resilience.supervisor``): 0 clean, 3
recovered; 75 preempted-clean and 69 retries-exhausted leave through
``SystemExit``, and 71 (a worker of a multi-process run after a lost
host, for the launcher to re-ramp) through ``os._exit``.
"""

import json
import os
import sys

from ..distributed.bootstrap import context, shutdown
from ..ops.cuda_sgd_common import KERNELS
from ..resilience import supervisor
from . import REGISTRY
from .common import NoDeviceError, device


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in REGISTRY:
        names = "\n  ".join(sorted(REGISTRY))
        print("usage: python -m srnn_tpu_torch.setups <name> [flags]\n\n"
              f"names:\n  {names}")
        return 2 if argv and argv[0] not in ("-h", "--help") else 0
    try:
        device()
    except NoDeviceError as e:
        print(f"srnn_tpu_torch.setups {argv[0]}: {e}", file=sys.stderr)
        return 1
    try:
        out = REGISTRY[argv[0]](argv[1:])
    except SystemExit as e:
        if e.code == supervisor.EXIT_HOST_LOST and context().active:
            # a worker of a multi-process run leaves without tearing its
            # process group down: a peer may sit in a collective whose
            # participant is gone, and the teardown would wait on it
            _write_counts()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(supervisor.EXIT_HOST_LOST)
        raise
    finally:
        _write_counts()
    if isinstance(out, str):
        print(out)  # the run directory, scriptable like the run() API
    shutdown()  # every rank finished: leave the process group
    return supervisor.exit_code_for_report(getattr(out, "report", None))


def _write_counts() -> None:
    path = os.environ.get("SRNN_LAUNCH_COUNTS")
    if path:
        ctx = context()
        if ctx.active:
            path = f"{path}.p{ctx.process_id}"  # one file a process
        with open(path, "w") as f:
            json.dump({k.name: k.launches for k in KERNELS}, f)


if __name__ == "__main__":
    sys.exit(main())
