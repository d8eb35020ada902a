"""The port's distributed tier (``srnn_tpu_torch.distributed``, the mesh
builders of ``parallel.multihost``, the supervisor's and chaos's
multi-process paths) on the CPU, against the JAX package's where both
have the piece, and the launcher end to end on gloo.

* Bring-up: the env and flag priority of ``_resolve``, the partial-spec
  refusal, the no-op for plain runs and the 1-process spec, against the
  JAX package's wording and behaviour; the backend choice;
  ``parallel.initialize_distributed`` as their explicit spelling.
* ``slice_groups`` / ``reramp_soup_mesh``'s layout against the JAX
  package's on the same device records; the launcher's re-ramp world.
* The fault taxonomy's ``host_loss``, the chaos events ``host_loss@G`` /
  ``coordinator_timeout@G`` and the supervisor's exit 71 in a
  multi-process run; the launcher's flag stripping and exit codes against
  the JAX package's.
* End to end (``python -m srnn_tpu_torch.distributed.launch``, its
  workers ``python -m srnn_tpu_torch.setups`` processes on gloo, N = 64, 6
  generations; the four launches run side by side): ``--processes 2 --
  mega_soup --smoke --sharded --lineage`` against the solo run, bitwise
  (weights, uids, next_uid, time, the generator), with the process-0
  artifacts and the worker's heartbeats; the ``host_loss@4`` drill
  (every worker exits 71, the launcher relaunches one process resuming
  the run, exit 3) ending bitwise on the uninterrupted run; killed
  workers (exit 137); ``mega_soup --sharded`` alone (a world of one) and
  ``mega_multisoup --sharded`` on two processes against their solo runs.

The JAX package's own launcher tests fail at the seed
(``tests/test_distributed.py``); they are not the oracle here.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from srnn_tpu.distributed import bootstrap as jboot
from srnn_tpu.distributed import launch as jlaunch
from srnn_tpu_torch.distributed import (CoordinatorTimeout, HostLost,
                                        bootstrap, launch)
from srnn_tpu_torch.distributed.hostio import WorkerLog
from srnn_tpu_torch.experiment import (restore_checkpoint,
                                       restore_multi_checkpoint)
from srnn_tpu_torch.parallel import multihost
from srnn_tpu_torch.resilience import (EXIT_HOST_LOST, EXIT_RECOVERED,
                                       HOST_LOSS, BackoffPolicy, ChaosMonkey,
                                       Supervisor, classify_fault,
                                       parse_schedule, supervisor)
from srnn_tpu_torch.setups import REGISTRY, common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAST = "ckpt-gen00000006"
FAST = ["--backoff-base-s", "0.01", "--backoff-max-s", "0.05"]


@pytest.fixture(autouse=True)
def fresh_context(monkeypatch):
    """Every test starts and ends without a bring-up result."""
    monkeypatch.setattr(bootstrap, "_CONTEXT", None)
    monkeypatch.setattr(jboot, "_CONTEXT", None)
    for var in (bootstrap.COORD_ENV, bootstrap.PROCS_ENV, bootstrap.PID_ENV):
        monkeypatch.delenv(var, raising=False)


def _active(monkeypatch, pid=0, n=2):
    monkeypatch.setattr(bootstrap, "_CONTEXT", bootstrap.DistContext(
        active=True, process_id=pid, num_processes=n, backend="gloo",
        device="cpu"))


# ---------------------------------------------------------------- bring-up


class _Args:
    def __init__(self, coord=None, nproc=None, pid=None):
        self.dist_coordinator = coord
        self.dist_processes = nproc
        self.dist_process_id = pid


@pytest.mark.parametrize("env, args", [
    ({}, _Args()),
    ({"SRNN_DIST_COORD": "127.0.0.1:9999", "SRNN_DIST_PROCS": "2",
      "SRNN_DIST_PID": "1"}, _Args()),
    ({"SRNN_DIST_COORD": "127.0.0.1:9999", "SRNN_DIST_PROCS": "2",
      "SRNN_DIST_PID": "1"}, _Args("10.0.0.1:1234", 4, 3)),
    ({"SRNN_DIST_COORD": "127.0.0.1:9999"}, _Args()),
    ({"SRNN_DIST_PROCS": "2", "SRNN_DIST_PID": "0"}, _Args()),
    ({}, _Args(nproc=2)),
    ({}, None),
])
def test_resolve_env_and_flag_priority_matches_jax(monkeypatch, env, args):
    """Flags win over the launcher's variables; the variables count only
    with a coordinator; the same triple as the JAX package's."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert bootstrap._resolve(args) == jboot._resolve(args)


def test_partial_spec_refused_with_jax_wording():
    """A partial --dist-* spec fails loudly, in the JAX package's words;
    a 1-process spec is a solo run."""
    args = _Args("10.0.0.1:1234", None, 1)
    with pytest.raises(SystemExit) as want:
        jboot.ensure_initialized(args)
    with pytest.raises(SystemExit) as got:
        bootstrap.ensure_initialized(args)
    assert str(got.value) == str(want.value)
    assert "all three" in str(got.value)
    solo = bootstrap.ensure_initialized(_Args("127.0.0.1:1", 1, 0))
    assert not solo.active and solo.primary


def test_plain_run_is_a_no_op_and_idempotent():
    ctx = bootstrap.ensure_initialized(None)
    assert not ctx.active and ctx.primary
    assert bootstrap.ensure_initialized(None) is ctx
    assert not torch.distributed.is_initialized()
    assert bootstrap.context() is ctx


def test_backend_follows_the_device():
    """NCCL for a card, gloo for the CPU; gloo on a card only when asked
    for (``--dist-backend``); NCCL is refused on the CPU."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert bootstrap.resolve_backend(None, cuda) == "nccl"
    assert bootstrap.resolve_backend(None, cpu) == "gloo"

    class A:
        dist_backend = "gloo"

    assert bootstrap.resolve_backend(A(), cuda) == "gloo"
    A.dist_backend = "nccl"
    with pytest.raises(SystemExit, match="nccl backend moves CUDA"):
        bootstrap.resolve_backend(A(), cpu)


def test_coordinator_timeout_when_the_store_never_forms(monkeypatch):
    """A rendezvous nobody answers raises CoordinatorTimeout within the
    deadline (classified host_loss)."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    monkeypatch.setenv(bootstrap.TIMEOUT_ENV, "0.3")
    monkeypatch.setenv("SRNN_SETUPS_PLATFORM", "cpu")
    with pytest.raises(CoordinatorTimeout, match="process 1/2") as e:
        bootstrap.ensure_initialized(_Args(f"127.0.0.1:{port}", 2, 1))
    assert classify_fault(e.value) == HOST_LOSS
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_spells_ensure_initialized(monkeypatch):
    """``parallel.initialize_distributed`` is ``ensure_initialized`` by
    explicit arguments: a no-op without them, a solo run for one
    process, the partial-spec refusal in the same words, and the
    bring-up's deadline (``CoordinatorTimeout``) on a store nobody
    answers."""
    import socket

    from srnn_tpu_torch.parallel import initialize_distributed

    assert initialize_distributed() is False
    assert not bootstrap.context().active
    monkeypatch.setattr(bootstrap, "_CONTEXT", None)
    assert initialize_distributed("127.0.0.1:1", 1, 0) is False
    monkeypatch.setattr(bootstrap, "_CONTEXT", None)
    with pytest.raises(SystemExit) as got:
        initialize_distributed("10.0.0.1:1234", None, 1)
    with pytest.raises(SystemExit) as want:
        bootstrap.ensure_initialized(_Args("10.0.0.1:1234", None, 1))
    assert str(got.value) == str(want.value)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    monkeypatch.setenv(bootstrap.TIMEOUT_ENV, "0.3")
    monkeypatch.setenv("SRNN_SETUPS_PLATFORM", "cpu")
    with pytest.raises(CoordinatorTimeout, match="process 1/2"):
        initialize_distributed(f"127.0.0.1:{port}", 2, 1)
    assert not torch.distributed.is_initialized()


def test_worker_log_matches_jax(tmp_path, capsys):
    """The non-primary sink: heartbeats in events-p<i>.jsonl, narration on
    stderr, no primary artifacts; the rows the JAX package's WorkerLog
    writes."""
    from srnn_tpu.distributed.hostio import WorkerLog as JWorkerLog

    rows = {}
    for name, cls in (("port", WorkerLog), ("jax", JWorkerLog)):
        d = tmp_path / name
        d.mkdir()
        with cls(str(d), 1) as wl:
            wl.log("hello", generation=4)
            wl.event(_fsync=True, kind="heartbeat", stage="mega_soup@p1/2")
            assert wl.save(foo=1) == {}
        rows[name] = [json.loads(line)
                      for line in open(d / "events-p1.jsonl")]
        assert not (d / "events.jsonl").exists()
        assert not (d / "log.txt").exists()
    strip = [[{k: v for k, v in r.items() if k != "t"} for r in rows[n]]
             for n in ("port", "jax")]
    assert strip[0] == strip[1]
    assert capsys.readouterr().err.count("[p1] hello") == 2


# ------------------------------------------------------------ mesh layout


class _Dev:
    def __init__(self, i, s=None, p=0):
        self.id = i
        if s is not None:
            self.slice_index = s
        self.process_index = p


DEVICE_SETS = {
    "flat8": [_Dev(i) for i in range(8)],
    "real2x4": [_Dev(i, s=i // 4) for i in range(8)],
    "three4": [_Dev(i, s=i // 4) for i in range(12)],
    "ragged": [_Dev(i, s=0) for i in range(4)]
    + [_Dev(10 + i, s=1) for i in range(3)]
    + [_Dev(20 + i, s=2) for i in range(2)],
    "modal-tie": [_Dev(i, s=i // 2) for i in range(4)]
    + [_Dev(10 + i, s=10 + i // 4) for i in range(8)],
    "procs3": [_Dev(i, p=i) for i in range(3)],
    "one3": [_Dev(i, s=0) for i in range(3)],
    "one6": [_Dev(i, s=0) for i in range(6)],
}


@pytest.mark.parametrize("force", [None, "2", "4", "3"])
@pytest.mark.parametrize("name", list(DEVICE_SETS))
def test_slice_groups_match_jax(monkeypatch, name, force):
    from srnn_tpu.parallel import slice_groups as jslice_groups

    if force:
        monkeypatch.setenv(multihost.FORCE_SLICES_ENV, force)
    else:
        monkeypatch.delenv(multihost.FORCE_SLICES_ENV, raising=False)
    devs = DEVICE_SETS[name]
    got = [[d.id for d in g] for g in multihost.slice_groups(devs)]
    want = [[d.id for d in g] for g in jslice_groups(devs)]
    assert got == want


@pytest.mark.parametrize("sizes", [(), (1_000_000,), (1_000_000, 300_000),
                                   (64,)])
@pytest.mark.parametrize("name", list(DEVICE_SETS))
def test_reramp_layout_matches_jax(monkeypatch, name, sizes):
    """The re-ramped mesh's axes and device grid equal the JAX package's
    ``reramp_soup_mesh`` on the same devices and published sizes."""
    from srnn_tpu.parallel import reramp_soup_mesh as jreramp

    monkeypatch.delenv(multihost.FORCE_SLICES_ENV, raising=False)
    devs = DEVICE_SETS[name]
    want = jreramp(devs, shard_sizes=sizes)
    names, grid = multihost.reramp_layout(devs, sizes)
    ids = [[d.id for d in g] for g in grid] if len(names) == 2 \
        else [d.id for d in grid]
    assert names == tuple(want.axis_names)
    assert ids == np.vectorize(lambda d: d.id)(want.devices).tolist()


@pytest.mark.parametrize("processes, sizes, want", [
    (1, (64,), 1), (2, (64,), 2), (3, (64,), 2), (3, (1_000_000,), 2),
    (4, (1_000_000,), 4), (6, (1_000_000, 300_000), 5), (3, (), 3)])
def test_reramp_process_count(processes, sizes, want):
    """The launcher's re-ramp world: the largest process count up to the
    survivors' that divides every published size."""
    assert multihost.reramp_process_count(processes, sizes) == want


# ---------------------------------------------------- faults and the drills


def test_exit_codes_mirror_the_supervisor_and_jax():
    from srnn_tpu.resilience import supervisor as jsup

    assert launch.EXIT_HOST_LOST == supervisor.EXIT_HOST_LOST \
        == jsup.EXIT_HOST_LOST == 71
    assert launch.EXIT_RECOVERED == supervisor.EXIT_RECOVERED == 3
    assert supervisor.EXIT_CODE_NAMES[EXIT_HOST_LOST] == "host-lost"


@pytest.mark.parametrize("exc, kind", [
    (HostLost("slice 1 gone"), "host_loss"),
    (CoordinatorTimeout("no coordinator"), "host_loss"),
    (RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] "
                  "Connection closed by peer [127.0.0.1]:12345"),
     "host_loss"),
    (RuntimeError("Gloo connectFullMesh failed with ... connect failure"),
     "host_loss"),
    (RuntimeError("NCCL communicator was aborted on rank 1"), "host_loss"),
    (RuntimeError("[Rank 0] Watchdog caught collective operation timeout: "
                  "WorkNCCL(SeqNum=7, OpType=ALLGATHER)"), "host_loss"),
    (RuntimeError("NCCL error in: NCCLUtils.cpp:93, invalid usage, "
                  "ncclInvalidUsage: Duplicate GPU detected : rank 0 and "
                  "rank 1 both on CUDA device 9b000"), "fatal"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "device_loss"),
])
def test_classify_peer_faults(exc, kind):
    assert classify_fault(exc) == kind


def test_mesh_collective_turns_a_lost_peer_into_host_lost():
    from srnn_tpu_torch.parallel.mesh import _collective

    def closed():
        raise RuntimeError("Connection closed by peer [127.0.0.1]:5")

    with pytest.raises(HostLost, match="peer of the process group"):
        _collective("gather", closed)

    def other():
        raise RuntimeError("ncclInvalidUsage: Duplicate GPU detected")

    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        _collective("gather", other)


def test_chaos_host_loss_fires_by_the_live_run(monkeypatch):
    """host_loss needs a slice to survive it: one process refuses at fire
    time, an out-of-range group too; in a run of two the event raises
    HostLost (group 1 by default), coordinator_timeout raises
    CoordinatorTimeout; each fires once."""
    with pytest.raises(ValueError, match="no surviving slice"):
        ChaosMonkey(parse_schedule("host_loss@1")).chunk_start(1)
    _active(monkeypatch)
    with pytest.raises(ValueError, match="out of range"):
        ChaosMonkey(parse_schedule("host_loss@1:7")).chunk_start(1)
    monkey = ChaosMonkey(parse_schedule("host_loss@3,coordinator_timeout@5"))
    monkey.chunk_start(2)
    with pytest.raises(HostLost, match="slice group 1 lost"):
        monkey.chunk_start(3)
    monkey.chunk_start(4)
    with pytest.raises(CoordinatorTimeout):
        monkey.chunk_start(5)
    monkey.chunk_start(6)
    assert not monkey.pending


@pytest.mark.parametrize("fault", [HostLost("peer gone"),
                                   OSError(5, "flaky disk")])
def test_supervisor_multiprocess_fault_exits_71(monkeypatch, fault):
    """No in-process restart in a multi-process run: a host loss, and a
    one-sided retryable fault too, exit 71 for the launcher."""
    _active(monkeypatch, pid=1)
    sup = Supervisor(BackoffPolicy(max_restarts=3, base_s=0.0),
                     log=lambda m: None)

    def run_once(args, ctx):
        raise fault

    with pytest.raises(SystemExit) as e:
        sup.run(run_once, object())
    assert e.value.code == EXIT_HOST_LOST
    assert sup.last_report["outcome"] == "host-lost"
    assert sup.last_report["restarts"] == 0


def test_launcher_strip_and_propagate_match_jax():
    argv = ["mega_soup", "--chaos", "host_loss@4", "--smoke",
            "--chaos=stall@2", "--resume", "old", "--sharded"]
    for flag in ("--chaos", "--resume"):
        assert launch._strip_flag(argv, flag) == jlaunch._strip_flag(argv,
                                                                     flag)
    for codes, killed in (([0, 0], set()), ([0, 3], set()),
                          ([1, 71], set()), ([0, -9], set()),
                          ([75, -15], {1}), ([0, -15], {1}),
                          ([69, 0], set())):
        assert launch._propagate(codes, killed) \
            == jlaunch._propagate(codes, killed)
    assert launch._propagate([0, -9], set()) == 137


def test_published_sizes(tmp_path):
    assert launch._published_sizes(str(tmp_path)) == ()
    (tmp_path / "config.json").write_text(json.dumps({"size": 64}))
    assert launch._published_sizes(str(tmp_path)) == (64,)


# ------------------------------------------------------------ end to end


#: the launcher's end-to-end runs, started together by ``launches``:
#: name -> the launcher's arguments (the worker's ``--root`` is appended)
RUNS = {
    "two": ["--processes", "2", "--", "mega_soup", "--smoke", "--seed", "13",
            "--sharded", "--lineage"],
    "drill": ["--processes", "2", "--grace-s", "10", "--", "mega_soup",
              "--smoke", "--seed", "13", "--sharded", "--chaos",
              "host_loss@4", *FAST],
    "kill": ["--processes", "2", "--grace-s", "5", "--", "mega_soup",
             "--smoke", "--seed", "17", "--sharded", "--chaos", "sigkill@2"],
    "multi": ["--processes", "2", "--", "mega_multisoup", "--smoke", "--seed",
              "13", "--sharded"],
}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Every run of ``RUNS`` as ``python -m srnn_tpu_torch.distributed.
    launch``, its workers on the CPU, all started at the first read (so
    that they run side by side); ``launches(name)`` waits for one and
    returns (exit code, its output, the run root)."""
    root = tmp_path_factory.mktemp("launch")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SRNN_DIST_")}
    env.update({"PYTHONPATH": REPO, common.PLATFORM_ENV: "cpu",
                "OMP_NUM_THREADS": "1"})
    procs = {}
    for name, argv in RUNS.items():
        log = open(root / f"{name}.log", "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "srnn_tpu_torch.distributed.launch",
             *argv, "--root", str(root / name)], cwd=REPO, env=env,
            stdout=log, stderr=subprocess.STDOUT), log)

    def result(name):
        proc, log = procs[name]
        proc.wait(timeout=300)
        log.seek(0)
        return proc.returncode, log.read(), root / name

    yield result
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        log.close()


def _state(run_dir, multi=False):
    path = os.path.join(run_dir, LAST)
    s = (restore_multi_checkpoint if multi else restore_checkpoint)(path)
    ws = s.weights if multi else (s.weights,)
    uids = s.uids if multi else (s.uids,)
    return ([w.numpy() for w in ws] + [u.numpy() for u in uids]
            + [s.next_uid.numpy(), s.time.numpy(),
               s.key.get_state().numpy()])


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    """The solo smoke runs of seed 13 (mega_soup with lineage, and
    mega_multisoup), in this process."""
    root = tmp_path_factory.mktemp("solo")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(common.PLATFORM_ENV, "cpu")
        mp.setattr(bootstrap, "_CONTEXT", None)
        return {
            "soup": REGISTRY["mega_soup"](["--smoke", "--seed", "13",
                                           "--lineage", "--root",
                                           str(root / "soup")]),
            "multi": REGISTRY["mega_multisoup"](["--smoke", "--seed", "13",
                                                 "--root",
                                                 str(root / "multi")])}


def _run_dir(root):
    dirs = glob.glob(os.path.join(str(root), "exp-*"))
    assert len(dirs) == 1, dirs
    return dirs[0]


def _windows(run_dir):
    return [json.loads(line) for line in open(os.path.join(
        run_dir, "lineage.jsonl")) if '"window"' in line]


def test_launch_two_processes_bitwise_and_process0_io(launches, solo):
    """``launch --processes 2 -- mega_soup --smoke --sharded --lineage``:
    the final checkpoint equals the solo run's bitwise; the run's
    artifacts are written once, by process 0, the worker's heartbeats in
    events-p1.jsonl; the lineage windows carry the solo run's edges (per
    rank side by side) and census."""
    rc, out, root = launches("two")
    assert rc == 0, out[-3000:]
    d = _run_dir(root)
    _same(_state(d), _state(solo["soup"]))
    for name in ("metrics.prom", "lineage.jsonl", "log.txt", "events.jsonl",
                 "config.json", "meta.json"):
        assert os.path.exists(os.path.join(d, name)), name
    assert not glob.glob(os.path.join(d, "events-p0*"))
    beats = [json.loads(line) for line in open(os.path.join(
        d, "events-p1.jsonl"))]
    assert any(r.get("stage") == "mega_soup@p1/2" for r in beats)
    wa, wb = _windows(solo["soup"]), _windows(d)
    assert len(wa) == len(wb) == 3
    for ra, rb in zip(wa, wb):
        assert sorted(map(tuple, ra["edges"])) == sorted(map(tuple,
                                                             rb["edges"]))
        for k in ("fixpoints", "births_attack", "births_respawn",
                  "gen_start", "gen_end", "next_pid"):
            assert ra[k] == rb[k], k
    log = open(os.path.join(d, "log.txt")).read()
    assert "sharded over 2 devices across 2 processes" in log
    prom = open(os.path.join(d, "metrics.prom")).read()
    assert "srnn_soup_distributed_processes 2" in prom


def test_launch_host_loss_drill_recovers_bitwise(launches, solo):
    """``--chaos host_loss@4``: every worker exits 71 at generation 4; the
    launcher relaunches one process resuming the run (chaos stripped) and
    exits 3; the final checkpoint equals the uninterrupted run's."""
    rc, out, root = launches("drill")
    assert rc == EXIT_RECOVERED, out[-3000:]
    assert "re-ramp 1/2" in out and "exiting 71 (host-lost)" in out
    _same(_state(_run_dir(root)), _state(solo["soup"]))


def test_launch_killed_worker_exit_code(launches):
    """``--chaos sigkill@2`` kills every worker (the schedule is each
    process's): the launcher exits 128 + 9, as the JAX package's does,
    and does not re-ramp a run whose workers were killed."""
    rc, out, _ = launches("kill")
    assert rc == 137, out[-3000:]
    assert "worker exit codes [-9, -9] -> exiting 137" in out
    assert "re-ramp" not in out


def test_mega_runs_sharded_equal_their_solo_runs(tmp_path, launches, solo,
                                                 monkeypatch):
    """``mega_soup --sharded`` alone (a world of one, formed and ended by
    the run) and ``mega_multisoup --sharded`` on two processes (each
    type's size a multiple of 2 already) end bitwise on their solo
    runs."""
    monkeypatch.setenv(common.PLATFORM_ENV, "cpu")
    d = REGISTRY["mega_soup"](["--smoke", "--seed", "13", "--sharded",
                               "--lineage", "--root", str(tmp_path / "one")])
    assert not torch.distributed.is_initialized()
    _same(_state(d), _state(solo["soup"]))
    rc, out, root = launches("multi")
    assert rc == 0, out[-3000:]
    _same(_state(_run_dir(root), multi=True),
          _state(solo["multi"], multi=True))
