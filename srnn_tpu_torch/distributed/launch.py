"""Multi-process launcher: the process-restart tier of the recovery
ladder; port of ``srnn_tpu/distributed/launch.py``.

    python -m srnn_tpu_torch.distributed.launch --processes 2 -- \\
        mega_soup --smoke --sharded --seed 3 --root experiments

Spawns N worker processes running ``python -m srnn_tpu_torch.setups
<cmd...>``, wires them into one ``torch.distributed`` process group (a
free rendezvous port on localhost, ``SRNN_DIST_*`` variables read by
``distributed.bootstrap``), prefixes each worker's output with ``[p<i>]``,
and propagates exit codes:

  * all workers 0 → 0 (or 3/``recovered`` when a re-ramp round was
    needed — the supervisor vocabulary, launcher tier);
  * any worker exits ``EXIT_HOST_LOST`` (71) → the **re-ramp**: remaining
    workers are reaped, the job relaunches on the largest world of at
    most one process fewer whose size divides the population the run
    published (``parallel.multihost.reramp_process_count``, the rule of
    the JAX package's ``reramp_soup_mesh``), resuming the run dir from
    its last durable
    checkpoint (``--resume`` injected; any ``--chaos`` schedule is
    stripped — resumes are chaos-free, matching the in-process
    supervisor's contract).  Bounded by ``--max-reramps``.
  * a worker killed by signal S → 128+S (e.g. a SIGKILLed worker → 137);
  * otherwise the first failing worker's code (75 preempted-clean and
    69 retries-exhausted pass through for the watch tier).

The launcher itself never touches a device (no CUDA context, no process
group membership): a wedged card cannot hang the tier whose job is
reaping wedged workers.  Each worker takes card ``i % device_count``
(``distributed.bootstrap``); ``--dist-backend gloo`` in the worker command
lets several workers share one card.  On the CPU (``SRNN_SETUPS_PLATFORM=cpu``) the workers form
a gloo group, which is how the whole tier runs on one machine.
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import time

from ..parallel.multihost import reramp_process_count

#: mirrors ``resilience.supervisor``, spelled here as literals so that the
#: parent tier depends on none of the worker-side machinery; the tests
#: hold the two together
EXIT_HOST_LOST = 71
EXIT_RECOVERED = 3

#: how long peers may keep running after a CLEAN worker exit before
#: being reaped (generous: a slow peer may still be flushing its final
#: checkpoint; a worker wedged after its peers finished must still be
#: bounded).  Failures use the much shorter --grace-s.
CLEAN_EXIT_GRACE_S = float(os.environ.get("SRNN_LAUNCH_EXIT_GRACE_S",
                                          "300"))

_CREATED_RE = re.compile(r"\*\* created (.+?) \*\*")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="spawn a multi-process srnn_tpu_torch run "
                    "(see srnn_tpu_torch/distributed/launch.py)")
    p.add_argument("--processes", type=int, required=True, metavar="N",
                   help="worker process count (each becomes one rank "
                        "of the process group, one card, one 'slice')")
    p.add_argument("--module", default="srnn_tpu_torch.setups",
                   help="worker module run as python -m MODULE CMD…")
    p.add_argument("--max-reramps", type=int, default=2, metavar="K",
                   help="host-loss re-launch budget: each round drops one "
                        "process and resumes from the last durable "
                        "checkpoint (0 = propagate 71 to the watch tier)")
    p.add_argument("--grace-s", type=float, default=30.0, metavar="S",
                   help="after the first worker failure, how long peers "
                        "may keep running (they are usually wedged in a "
                        "collective whose participant died) before being "
                        "reaped")
    p.add_argument("--coordinator-port", type=int, default=0, metavar="P",
                   help="rendezvous port of the process group (0 = pick "
                        "a free one)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="worker command: setup name + flags (a leading "
                        "'--' separator is accepted and dropped)")
    return p


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _strip_flag(argv, flag: str, has_value: bool = True):
    """Remove ``flag [VALUE]`` / ``flag=VALUE`` occurrences."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = has_value
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def _log(msg: str) -> None:
    print(f"launch: {msg}", file=sys.stderr, flush=True)


def _stream(proc, idx: int, run_dir_box: dict) -> None:
    """Relay one worker's combined output with a [p<i>] prefix; the
    primary's Experiment-creation line additionally yields the run dir
    the re-ramp rounds resume."""
    for line in proc.stdout:
        line = line.rstrip("\n")
        m = _CREATED_RE.search(line)
        if m and idx == 0:
            run_dir_box["dir"] = m.group(1)
        print(f"[p{idx}] {line}", flush=True)


def _reap(procs, killed: set) -> None:
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


def launch_once(module: str, cmd, processes: int, grace_s: float,
                port: int = 0):
    """One launch round.  Returns ``(codes, launcher_killed, run_dir)``:
    per-worker exit codes, the set of workers this launcher reaped itself
    (their codes are consequences, not causes), and the primary's run
    dir if one was created."""
    port = port or _free_port()
    procs, threads = [], []
    run_dir_box: dict = {}
    for i in range(processes):
        env = dict(os.environ)
        env["SRNN_DIST_COORD"] = f"127.0.0.1:{port}"
        env["SRNN_DIST_PROCS"] = str(processes)
        env["SRNN_DIST_PID"] = str(i)
        p = subprocess.Popen(
            [sys.executable, "-u", "-m", module, *cmd],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        procs.append(p)
        # the package thread factory (join-on-exit registry): each relay
        # exits at its worker's pipe EOF, which the reap path guarantees
        from ..utils.pipeline import spawn_thread

        threads.append(spawn_thread(_stream, name=f"launch-relay-p{i}",
                                    args=(p, i, run_dir_box)))
    killed: set = set()
    first_exit_t = None
    any_failed = False
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        exited = [c for c in codes if c is not None]
        if exited and first_exit_t is None:
            first_exit_t = time.monotonic()
            failed = [c for c in exited if c != 0]
            if failed:
                _log(f"worker failure (rc={failed[0]}); giving peers "
                     f"{grace_s:g}s to unwind")
        any_failed = any_failed or any(c != 0 for c in exited)
        # the reap deadline: short after a FAILURE (peers are usually
        # wedged in a collective whose participant died), generous after
        # a clean exit (a slow peer may legitimately still be writing its
        # final checkpoint) — but never unbounded: a worker that wedges
        # after its peers finished must not hang the launcher forever
        if first_exit_t is not None:
            deadline = grace_s if any_failed else max(grace_s,
                                                      CLEAN_EXIT_GRACE_S)
            if time.monotonic() - first_exit_t > deadline:
                _log("grace elapsed; reaping remaining workers")
                _reap(procs, killed)
        time.sleep(0.2)
    for t in threads:
        t.join(timeout=5)
    return [p.returncode for p in procs], killed, run_dir_box.get("dir")


def _propagate(codes, killed) -> int:
    """Map one round's worker exit codes to the launcher's (host-loss
    handled by the caller's re-ramp loop before this runs)."""
    meaningful = [(i, c) for i, c in enumerate(codes) if i not in killed]
    if any(c == EXIT_HOST_LOST for _, c in meaningful):
        return EXIT_HOST_LOST
    for _, c in meaningful:
        if c is not None and c < 0:
            return 128 - c  # killed by signal S -> 128+S
    for _, c in meaningful:
        if c:
            return c
    # only launcher-reaped workers failed (their deaths are consequences
    # of a failure whose owner exited 0?) — that cannot normally happen,
    # but never report success over a reaped worker
    return 0 if not killed else 1


def _published_sizes(run_dir: str):
    """The population sizes a run published in its ``config.json`` (the
    ``size`` of a mega run), which the re-ramped world must divide."""
    import json

    try:
        with open(os.path.join(run_dir, "config.json")) as f:
            size = json.load(f).get("size")
    except (OSError, ValueError):
        return ()
    return (int(size),) if size else ()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("launch: missing worker command (setup name + flags)",
              file=sys.stderr)
        return 2
    if args.processes < 1:
        print("launch: --processes must be >= 1", file=sys.stderr)
        return 2
    processes = args.processes
    reramps = 0
    # a launch that already resumes a run dir can re-ramp from round one
    # — the primary prints no '** created **' line on attach, so the
    # resume target is the only place the dir is spelled
    run_dir = None
    for i, a in enumerate(cmd):
        if a == "--resume" and i + 1 < len(cmd):
            run_dir = cmd[i + 1]
        elif a.startswith("--resume="):
            run_dir = a.split("=", 1)[1]
    while True:
        codes, killed, created = launch_once(
            args.module, cmd, processes, args.grace_s,
            port=args.coordinator_port if reramps == 0 else 0)
        run_dir = created or run_dir
        host_lost = any(c == EXIT_HOST_LOST for i, c in enumerate(codes)
                        if i not in killed)
        if host_lost and reramps < args.max_reramps and processes > 1 \
                and run_dir:
            # the re-ramp: one slice is gone; relaunch the survivors as a
            # fresh (smaller) process group resuming the run dir.
            # Chaos schedules are stripped — resumes are chaos-free, the
            # same contract the in-process supervisor keeps.
            reramps += 1
            processes = reramp_process_count(processes - 1,
                                             _published_sizes(run_dir))
            cmd = _strip_flag(cmd, "--chaos")
            cmd = _strip_flag(cmd, "--resume")
            cmd = cmd + ["--resume", run_dir]
            _log(f"host loss: re-ramp {reramps}/{args.max_reramps} — "
                 f"relaunching {processes} process(es), resuming {run_dir}")
            continue
        rc = _propagate(codes, killed)
        if rc == 0 and reramps:
            _log(f"run completed after {reramps} re-ramp round(s) — "
                 f"exiting {EXIT_RECOVERED} (recovered)")
            return EXIT_RECOVERED
        if rc:
            _log(f"worker exit codes {codes} -> exiting {rc}")
        return rc


if __name__ == "__main__":
    sys.exit(main())
