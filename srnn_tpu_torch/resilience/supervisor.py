"""The run supervisor: preemption-tolerant mega runs; port of
``srnn_tpu/resilience/supervisor.py``.

The supervisor wraps one attempt of a mega loop (``mega_soup`` /
``mega_multisoup``) and turns a classified fault into a restart from the
run's newest intact checkpoint, with bounded retries, exponential backoff
and deterministic jitter.

Fault taxonomy (:func:`classify_fault`), remapped from XLA to CUDA:

  * ``device_loss`` -- torch's CUDA runtime errors and the port's kernel
    launch errors, by type and message: a ``torch.AcceleratorError``, or a
    ``RuntimeError`` whose text matches :data:`DEVICE_LOSS_PATTERNS`
    ("CUDA error: ...", the kernels' "<entry> failed: CUDA error <rc>
    (...)", an illegal address, a launch failure, an ECC error, a lost
    or halted device).  Deterministic failures are fatal even in that
    form (:data:`DETERMINISTIC_PATTERNS`: out of memory, an invalid
    argument or configuration, no kernel image): a retry repeats them.
    A CUDA error of this kind is sticky -- the context is unusable after
    an illegal address or a launch failure -- so before an in-process
    restart the supervisor probes the card (a small allocation and a
    synchronise); where the probe fails it prints the traceback and exits
    :data:`EXIT_RETRIES_EXHAUSTED`, so that a fresh process can
    ``--resume`` (the JAX package's rule that a backend cannot be
    re-initialised in-process).
  * ``host_loss`` -- ``distributed.HostLost`` (a peer process is gone:
    the chaos drill, or a gloo collective whose connection a peer
    closed or reset, ``parallel.mesh``) and ``distributed.
    CoordinatorTimeout`` (the rendezvous never formed), and the
    ``torch.distributed`` errors that say a peer failed
    (:data:`PEER_LOSS_PATTERNS`: gloo's closed or reset connections,
    NCCL's aborted communicator, a collective's timeout, a lost store).
    NCCL's own usage errors (two ranks on one card) stay fatal.
  * ``stall`` -- ``utils.pipeline.StallError`` from the ``ChunkDriver``
    finisher deadline.
  * ``io`` -- ``utils.pipeline.WriterError`` (as retryable as what it
    wraps) or an ``OSError`` with a transient errno.  ``FileNotFoundError``
    and permission errors are fatal: a retry can only repeat them.
  * ``preempt`` -- :class:`Preempted`, raised by the mega loops at the next
    chunk boundary after SIGTERM, once the pipeline drained (the last
    checkpoint is durable).  Never retried: the process exits
    :data:`EXIT_PREEMPTED_CLEAN`.
  * ``fatal`` -- everything else, ``SystemExit`` from CLI validation
    included: re-raised unchanged.

Recovery is resume: the next attempt is pointed at the faulted run
directory whenever it holds a finalized checkpoint, so the restore path is
the one ``--resume`` tests bitwise, and a recovered run ends bitwise equal
to an uninterrupted one.  In a multi-process run no retryable fault
restarts in-process: a one-sided restart would replay collectives from
the checkpoint while the peers wait mid-schedule, so the process exits
:data:`EXIT_HOST_LOST` and the launcher (``distributed.launch``) relaunches
the survivors from the last durable checkpoint.  The in-process topology
re-ramp onto surviving cards waits for ROADMAP.md A.6.

Exit codes (``setups/__main__``): 0 clean; :data:`EXIT_RECOVERED` (3)
success after at least one restart; :data:`EXIT_RETRIES_EXHAUSTED` (69)
the budget is spent or the card is unusable; :data:`EXIT_HOST_LOST` (71)
a retryable fault in a multi-process run, for the launcher to re-ramp;
:data:`EXIT_PREEMPTED_CLEAN` (75) SIGTERM honoured, resumable.
"""

from __future__ import annotations

import random
import re
import signal
import sys
import threading
import time
import traceback
from typing import Any, Callable, List, Optional

# -- fault taxonomy ---------------------------------------------------------

DEVICE_LOSS = "device_loss"
HOST_LOSS = "host_loss"
STALL = "stall"
IO = "io"
PREEMPT = "preempt"
FATAL = "fatal"

#: retryable faults (in a multi-process run each exits EXIT_HOST_LOST)
RETRYABLE = (DEVICE_LOSS, HOST_LOSS, STALL, IO)

# CLI exit codes (sysexits.h where one fits)
EXIT_RECOVERED = 3
EXIT_RETRIES_EXHAUSTED = 69   # EX_UNAVAILABLE
EXIT_HOST_LOST = 71           # EX_OSERR: a peer process is gone
EXIT_PREEMPTED_CLEAN = 75     # EX_TEMPFAIL

EXIT_CODE_NAMES = {
    EXIT_RECOVERED: "recovered",
    EXIT_RETRIES_EXHAUSTED: "retries-exhausted",
    EXIT_HOST_LOST: "host-lost",
    EXIT_PREEMPTED_CLEAN: "preempted-clean",
}

#: the text of a ``torch.distributed`` failure caused by a peer: gloo's
#: closed or reset connections, NCCL's aborted communicator or remote
#: error, a collective's watchdog timeout, a lost rendezvous store
PEER_LOSS_PATTERNS = (
    r"gloo.*(connection (closed|reset)|connect failure|timed out)",
    r"connection (closed|reset) by peer",
    r"communicator (was )?abort|ncclRemoteError|remote process exited",
    r"watchdog caught collective operation timeout",
    r"(store|socket).*(timed out|timeout|connection refused|closed)",
)
_PEER_LOSS_RE = re.compile("|".join(PEER_LOSS_PATTERNS), re.IGNORECASE)

class Preempted(Exception):
    """SIGTERM was honoured: the mega loop stopped at a chunk boundary,
    drained its pipeline (the last checkpoint durable) and unwound.
    Carries the generation of that checkpoint."""

    def __init__(self, generation: int):
        super().__init__(f"preempted at generation {generation} "
                         "(final checkpoint durable)")
        self.generation = generation


#: the text of a CUDA runtime or kernel-launch error that reads as a lost
#: or broken card: torch's "CUDA error: ..." messages, the port's kernel
#: wrappers' "<entry> failed: CUDA error <rc> (...)", the sticky errors by
#: name, and the JAX package's lost/halted-device spellings
DEVICE_LOSS_PATTERNS = (
    r"CUDA error",
    r"cuda(Error)?.*(illegal (memory )?(access|address|instruction)"
    r"|launch failure|launch timed out|device-side assert|ECC"
    r"|uncorrectable|hardware stack error|not permitted)",
    r"illegal memory access|unspecified launch failure",
    r"device.*(lost|loss|halt|fail|unavailable|fallen off the bus)",
    r"goaway|preempt|data_loss",
)
_DEVICE_LOSS_RE = re.compile("|".join(DEVICE_LOSS_PATTERNS), re.IGNORECASE)

#: CUDA failures a retry repeats (an OOM, a bad argument or launch
#: configuration, a binary built for another card): fatal even when they
#: arrive in a device-loss form
DETERMINISTIC_PATTERNS = (
    r"out of memory",
    r"invalid (argument|value|configuration|device function"
    r"|resource handle)",
    r"no kernel image",
    r"too many resources requested",
    r"not supported",
)
_DETERMINISTIC_RE = re.compile("|".join(DETERMINISTIC_PATTERNS),
                               re.IGNORECASE)

# OSError errnos worth retrying (transient by nature); every other errno
# (ENOENT, EACCES, EISDIR...) is a user or programming error
_RETRYABLE_ERRNOS = frozenset({
    4,    # EINTR
    5,    # EIO (flaky storage, NFS blips)
    11,   # EAGAIN
    28,   # ENOSPC (logs may rotate; the writer already spent its grace)
    110,  # ETIMEDOUT
    116,  # ESTALE
})


def _cuda_error_types() -> tuple:
    """The types torch raises for CUDA runtime failures (where this build
    of torch has them)."""
    import torch

    return tuple(t for t in (getattr(torch, "AcceleratorError", None),)
                 if isinstance(t, type))


def classify_fault(exc: BaseException) -> str:
    """Map an exception to the fault taxonomy (module docstring)."""
    import torch

    from ..distributed import CoordinatorTimeout, HostLost
    from ..utils.pipeline import StallError, WriterError

    if isinstance(exc, Preempted):
        return PREEMPT
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return FATAL
    if isinstance(exc, (HostLost, CoordinatorTimeout)):
        return HOST_LOSS
    if isinstance(exc, RuntimeError) and _PEER_LOSS_RE.search(str(exc)):
        # checked before the CUDA patterns: a lost peer is not a lost card
        return HOST_LOSS
    if isinstance(exc, StallError):
        return STALL
    if isinstance(exc, WriterError):
        # as retryable as what it wraps: a job that died on ENOENT or on a
        # logic error dies again on every retry, while a device loss that
        # surfaced on the writer thread keeps its kind
        cause = exc.__cause__
        if cause is None:
            return IO  # the writer's own refusal (closed / latched)
        inner = classify_fault(cause)
        return inner if inner in (IO, DEVICE_LOSS) else FATAL
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return FATAL
    if isinstance(exc, OSError):
        return IO if exc.errno in _RETRYABLE_ERRNOS else FATAL
    cuda_types = _cuda_error_types()
    if (cuda_types and isinstance(exc, cuda_types)) or (
            isinstance(exc, RuntimeError) and _DEVICE_LOSS_RE.search(str(exc))):
        return FATAL if _DETERMINISTIC_RE.search(str(exc)) else DEVICE_LOSS
    return FATAL


def probe_card() -> Optional[BaseException]:
    """Can the card still run work?  A small allocation, a launch and a
    synchronise on the current CUDA device; returns the error, or None
    when the card answers (or this process never used one)."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        t = torch.ones(16, device="cuda")
        t.add_(1)
        torch.cuda.synchronize()
        if float(t.sum()) != 32.0:
            return RuntimeError("card probe: wrong result")
    except BaseException as e:  # the probe reports, never raises
        return e
    return None


def _in_multiprocess_run() -> bool:
    """Is this process one of several of a distributed run?  Reads the
    bring-up context (never the card: the caller may be handling the very
    fault that makes the card hang)."""
    from ..distributed import context

    return context().active


# -- SIGTERM / preemption ---------------------------------------------------

_PREEMPT = threading.Event()


def preempt_requested() -> bool:
    """True once SIGTERM arrived: the mega loops poll this at every chunk
    boundary and stop gracefully (drain, last checkpoint, unwind)."""
    return _PREEMPT.is_set()


def _on_sigterm(signum, frame):  # pragma: no cover - trivial
    _PREEMPT.set()


class _SigtermGuard:
    """Install the SIGTERM handler (which only sets a flag) for the span
    of a supervised run; restore the previous disposition and clear the
    flag on the way out.  Off the main thread (no signal access) it is a
    no-op."""

    _NOT_INSTALLED = object()

    def __enter__(self):
        _PREEMPT.clear()
        self._prev = self._NOT_INSTALLED
        try:
            self._prev = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass
        return self

    def __exit__(self, *exc):
        if self._prev is not self._NOT_INSTALLED:
            try:
                signal.signal(signal.SIGTERM, self._prev)
            except (ValueError, TypeError):
                pass
        _PREEMPT.clear()
        return False


# -- retry policy -----------------------------------------------------------


class BackoffPolicy:
    """Bounded exponential backoff with deterministic jitter:
    ``delay(k)`` for restart ``k`` is ``base * 2**k`` capped at ``max_s``,
    scaled by ``1 +- jitter`` from a ``random.Random(seed)`` stream, so a
    seed gives one delay sequence (the JAX package's, for the same seed)."""

    def __init__(self, max_restarts: int = 3, base_s: float = 2.0,
                 max_s: float = 60.0, jitter: float = 0.1, seed: int = 0):
        self.max_restarts = max(0, int(max_restarts))
        self.base_s = max(0.0, float(base_s))
        self.max_s = max(0.0, float(max_s))
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self._rng = random.Random(int(seed) ^ 0x5E51)

    def delay(self, restart: int) -> float:
        d = min(self.base_s * (2.0 ** max(0, int(restart))), self.max_s)
        if self.jitter:
            d *= 1.0 + self.jitter * self._rng.uniform(-1.0, 1.0)
        return d


# -- the supervisor ---------------------------------------------------------


class AttemptContext:
    """What one attempt of a mega loop shares with its supervisor: the
    loop publishes ``run_dir`` (as soon as its Experiment exists) and reads
    ``chaos`` (the fault injector, if armed) and ``restarts`` /
    ``recoveries`` (for the restart log line and the telemetry fold)."""

    def __init__(self, chaos=None):
        self.chaos = chaos
        self.attempt = 0
        self.restarts = 0
        self.run_dir: Optional[str] = None
        self.recoveries: List[dict] = []


class Supervisor:
    """Run ``run_once(args, ctx)`` until it finishes, turning retryable
    faults into checkpoint-resume attempts (module docstring).
    ``last_report`` holds the report of the last :meth:`run`, also when it
    left through ``SystemExit``."""

    def __init__(self, policy: BackoffPolicy, chaos=None,
                 sleep: Callable[[float], None] = time.sleep,
                 log: Callable[[str], None] = None,
                 probe: Callable[[], Optional[BaseException]] = probe_card):
        self.policy = policy
        self.chaos = chaos
        self.ctx = AttemptContext(chaos=chaos)
        self._sleep = sleep
        self._probe = probe
        self.last_report: Optional[dict] = None
        self._log = log or (lambda msg: print(f"supervisor: {msg}",
                                              file=sys.stderr, flush=True))

    def _recover(self, kind: str, exc: BaseException, args) -> None:
        ctx = self.ctx
        t0 = time.monotonic()
        self._log(f"attempt {ctx.attempt + 1} failed with {kind} fault: "
                  f"{type(exc).__name__}: {exc}")
        if self.chaos is not None:
            # release condemned finisher threads, so that no chaos thread
            # outlives its attempt
            self.chaos.abort_pending()
        delay = self.policy.delay(ctx.restarts)
        if delay > 0:
            self._log(f"backing off {delay:.2f}s before restart "
                      f"{ctx.restarts + 1}/{self.policy.max_restarts}")
            self._sleep(delay)
        # recovery is resume whenever a finalized checkpoint exists
        if ctx.run_dir and not getattr(args, "resume", None):
            from ..setups.common import latest_checkpoint

            try:
                latest_checkpoint(ctx.run_dir)
                args.resume = ctx.run_dir
                self._log(f"resuming {ctx.run_dir} from its latest "
                          "finalized checkpoint")
            except FileNotFoundError:
                self._log("no finalized checkpoint yet; retrying from "
                          "scratch (same seed, fresh run dir)")
        ctx.restarts += 1
        ctx.attempt += 1
        ctx.recoveries.append({
            "kind": kind,
            "error": f"{type(exc).__name__}: {exc}",
            "backoff_s": round(delay, 3),
            "seconds": round(time.monotonic() - t0, 3),
        })

    def report(self, outcome: str) -> dict:
        ctx = self.ctx
        return {
            "outcome": outcome,
            "attempts": ctx.attempt + 1,
            "restarts": ctx.restarts,
            "run_dir": ctx.run_dir,
            "recoveries": list(ctx.recoveries),
        }

    def run(self, run_once: Callable[[Any, AttemptContext], Any],
            args) -> Any:
        self.last_report = None
        ctx = self.ctx
        with _SigtermGuard():
            while True:
                try:
                    out = run_once(args, ctx)
                except BaseException as e:
                    kind = classify_fault(e)
                    if kind == PREEMPT:
                        self.last_report = self.report("preempted")
                        self._log(f"{e} — exiting "
                                  f"{EXIT_PREEMPTED_CLEAN} (preempted-clean)")
                        raise SystemExit(EXIT_PREEMPTED_CLEAN) from e
                    if kind in RETRYABLE and _in_multiprocess_run():
                        # no in-process restart in a multi-process run: a
                        # one-sided restart replays collectives while the
                        # peers wait mid-schedule.  The process leaves the
                        # group (its peers' collectives then fail over to
                        # host_loss) and the launcher relaunches the
                        # survivors from the last durable checkpoint.
                        self.last_report = self.report("host-lost")
                        self._log(
                            f"{kind} fault in a multi-process run "
                            f"({type(e).__name__}: {e}) — in-process "
                            "restart would desync the mesh; exiting "
                            f"{EXIT_HOST_LOST} (host-lost) for the "
                            "launcher tier to relaunch")
                        raise SystemExit(EXIT_HOST_LOST) from e
                    if kind == FATAL or self.policy.max_restarts <= 0:
                        # unsupervised or unclassifiable failures keep their
                        # type
                        raise
                    if ctx.restarts >= self.policy.max_restarts:
                        traceback.print_exc()
                        self.last_report = self.report("exhausted")
                        self._log(
                            f"{kind} fault after {ctx.restarts} restart(s); "
                            f"retry budget spent — exiting "
                            f"{EXIT_RETRIES_EXHAUSTED} (retries-exhausted)")
                        raise SystemExit(EXIT_RETRIES_EXHAUSTED) from e
                    if kind == DEVICE_LOSS:
                        broken = self._probe()
                        if broken is not None:
                            # a sticky CUDA error: an in-process restart
                            # would only fail again
                            traceback.print_exc()
                            self.last_report = self.report("card-unusable")
                            self._log(
                                f"device_loss fault and the card does not "
                                f"answer ({type(broken).__name__}: "
                                f"{broken}); exiting "
                                f"{EXIT_RETRIES_EXHAUSTED} for a fresh "
                                "process to --resume")
                            raise SystemExit(EXIT_RETRIES_EXHAUSTED) from e
                    self._recover(kind, e, args)
                    continue
                self.last_report = self.report(
                    "recovered" if ctx.restarts else "clean")
                if ctx.restarts:
                    self._log(f"run completed after {ctx.restarts} "
                              f"restart(s)")
                return out


class RunDir(str):
    """A supervised run's directory, with its supervisor's ``report``."""

    def __new__(cls, run_dir: str, report: Optional[dict]):
        out = super().__new__(cls, run_dir)
        out.report = report
        return out


def exit_code_for_report(report: Optional[dict]) -> int:
    """CLI exit code of a supervised run that returned: 0 for a clean
    pass, :data:`EXIT_RECOVERED` when restarts were needed."""
    if report is not None and report.get("outcome") == "recovered":
        return EXIT_RECOVERED
    return 0


def supervised_run(args, run_once: Callable[[Any, AttemptContext], Any]):
    """The mega loops' entry: the chaos injector and the policy from the
    CLI namespace (``setups.common.add_resilience_args``), then
    ``run_once`` under a :class:`Supervisor`.  Returns the run dir as a
    :class:`RunDir` (its ``report`` gives the CLI exit code)."""
    from .chaos import ChaosMonkey

    chaos = ChaosMonkey.from_args(args)
    policy = BackoffPolicy(
        max_restarts=getattr(args, "max_restarts", 0),
        base_s=getattr(args, "backoff_base_s", 2.0),
        max_s=getattr(args, "backoff_max_s", 60.0),
        jitter=getattr(args, "backoff_jitter", 0.1),
        seed=getattr(args, "seed", 0))
    sup = Supervisor(policy, chaos=chaos)
    out = sup.run(run_once, args)
    return RunDir(out, sup.last_report)
