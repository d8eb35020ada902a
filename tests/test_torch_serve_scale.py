"""The continuous-batching serve tier (``srnn_tpu_torch/serve``): the
adaptive window controller, the tenant-fair plan, the dispatcher's
admission wait, the fixed-window oracle and the worker fleet, on the CPU;
twins of the JAX package's ``tests/test_serve_scale.py``.

* The controller's windows and the fair plans equal the JAX package's on
  the same traces, exactly.
* The fleet: real ``ServiceServer`` workers on threads behind a real
  ``ServicePool`` (only the worker process handle is faked), results
  bitwise equal to a solo service on the same trace; a worker killed
  mid-load replays onto the survivor; a restarted front replays its
  journal.  The subprocess drill (``--workers 2`` and a SIGKILL) is
  slow-marked as in the JAX package; chip_smoke.py's phase "experiment
  service" runs it on the card.
"""

import itertools
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from srnn_tpu.serve import controller as jcontroller
from srnn_tpu.serve import scheduler as jscheduler
from srnn_tpu_torch.serve import (AdaptiveWindowController, ExperimentService,
                                  Request, ServiceClient, ServicePool,
                                  WorkerHandle, interleave_tenants,
                                  make_controller, plan_dispatches,
                                  read_journal)
from srnn_tpu_torch.serve.controller import DEFAULT_FLOOR_S
from srnn_tpu_torch.serve.server import ServiceServer
from srnn_tpu_torch.utils.pipeline import spawn_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the one spelling every in-process test rides
PARAMS = {"trials": 16, "batch": 16}
GROUP = ("fixpoint_density", None)


def _req(ticket, tenant, seed=0, kind="fixpoint_density", cls=Request):
    return cls(ticket=ticket, kind=kind, params=dict(PARAMS, seed=seed),
               tenant=tenant, submitted_s=0.0)


def _service(path, **kw):
    return ExperimentService(str(path), device="cpu", **kw)


# ---------------------------------------------------------------------------
# controller law, against the JAX package's on the same traces
# ---------------------------------------------------------------------------


def test_controller_starts_at_floor_grows_clean_shrinks_burn():
    c = AdaptiveWindowController(ceiling_s=0.25, slo_p95_ms=100.0)
    j = jcontroller.AdaptiveWindowController(ceiling_s=0.25,
                                             slo_p95_ms=100.0)
    assert c.window_s([GROUP]) == DEFAULT_FLOOR_S == j.window_s([GROUP])
    last = DEFAULT_FLOOR_S
    for _ in range(40):
        cur = c.observe_dispatch(GROUP, violations=0, completed=4)
        assert cur == j.observe_dispatch(GROUP, violations=0, completed=4)
        assert cur >= last
        last = cur
    assert last == 0.25
    for _ in range(40):
        cur = c.observe_dispatch(GROUP, violations=2, completed=4)
        assert cur == j.observe_dispatch(GROUP, violations=2, completed=4)
        assert cur <= last
        last = cur
    assert last == DEFAULT_FLOOR_S
    assert c.observe_dispatch(GROUP, violations=0, completed=0) == last


def test_controller_windows_are_per_group_and_min_folds():
    c = AdaptiveWindowController(ceiling_s=0.25, slo_p95_ms=100.0)
    hot, cold = ("soup", "a"), ("soup", "b")
    for _ in range(10):
        c.observe_dispatch(cold, violations=0, completed=2)
    c.observe_dispatch(hot, violations=1, completed=2)
    assert c.window_s([cold]) > c.window_s([hot])
    assert c.window_s([cold, hot]) == c.window_s([hot])
    snap = c.snapshot()
    assert snap["adaptive"] is True and snap["groups"] == 2
    assert snap["window_min_s"] <= snap["window_max_s"]


def test_controller_is_deterministic_over_a_trace():
    trace = [(GROUP, 0, 4), (GROUP, 1, 4), (("soup", "x"), 0, 2),
             (GROUP, 0, 4), (("soup", "x"), 3, 2), (GROUP, 0, 4)]

    def run(make):
        c = make(0.25, 100.0)
        return [c.observe_dispatch(g, v, n) for g, v, n in trace] \
            + [c.snapshot()]

    assert run(make_controller) == run(make_controller) == \
        run(jcontroller.make_controller)


def test_make_controller_gates_on_adaptive():
    assert make_controller(0.25, 100.0, adaptive=False) is None
    assert make_controller(0.25, 0.0) is not None


# ---------------------------------------------------------------------------
# fairness, against the JAX package's plans
# ---------------------------------------------------------------------------


def _hog_trace(cls):
    return [_req(f"h{i}", "hog", seed=i, cls=cls) for i in range(6)] \
        + [_req("b0", "b", seed=10, cls=cls), _req("c0", "c", seed=11,
                                                   cls=cls)]


def test_interleave_tenants_breaks_the_hog():
    order = [r.ticket for r in interleave_tenants(_hog_trace(Request))]
    assert order == [r.ticket for r in jscheduler.interleave_tenants(
        _hog_trace(jscheduler.Request))]
    assert order[:3] == ["h0", "b0", "c0"]
    assert [t for t in order if t.startswith("h")] == \
        [f"h{i}" for i in range(6)]


def test_fair_plan_spreads_stack_slots_and_groups():
    keys = {"fixpoint_density": lambda p: (p["trials"], p["batch"])}

    def shape(plan):
        return [(d.key, [r.ticket for r in d.requests]) for d in plan]

    unfair = plan_dispatches(_hog_trace(Request), keys, max_stack=4)
    fair = plan_dispatches(_hog_trace(Request), keys, max_stack=4, fair=True)
    for got, jfair in ((unfair, False), (fair, True)):
        assert shape(got) == shape(jscheduler.plan_dispatches(
            _hog_trace(jscheduler.Request), keys, max_stack=4, fair=jfair))
    assert {r.tenant for r in unfair[0].requests} == {"hog"}
    assert {"b", "c"}.issubset({r.tenant for r in fair[0].requests})
    two_groups = [_req(f"a{i}", "t", seed=i) for i in range(8)] + \
        [Request(ticket=f"s{i}", kind="fixpoint_density",
                 params={"trials": 32, "batch": 8, "seed": i}, tenant="t",
                 submitted_s=0.0) for i in range(8)]
    plan = plan_dispatches(two_groups, keys, max_stack=4, fair=True)
    assert [d.key for d in plan] == [(16, 16), (32, 8), (16, 16), (32, 8)]


# ---------------------------------------------------------------------------
# condvar admission: an idle dispatcher blocks, the first ticket wakes it
# ---------------------------------------------------------------------------


def test_wait_for_work_blocks_idle_and_wakes_on_submit(tmp_path):
    svc = _service(tmp_path / "svc")
    with svc:
        t0 = time.monotonic()
        assert svc.wait_for_work(timeout_s=0.05) is False
        assert time.monotonic() - t0 >= 0.05

        def late_submit():
            time.sleep(0.1)
            svc.submit("fixpoint_density", dict(PARAMS, seed=0))

        th = spawn_thread(late_submit, name="late-submit")
        t0 = time.monotonic()
        assert svc.wait_for_work(timeout_s=30.0) is True
        assert time.monotonic() - t0 < 5.0
        th.join(timeout=30)
        assert not th.is_alive()
        assert svc.wait_for_work(timeout_s=0.0) is True
        svc.run_pending()
        th = spawn_thread(lambda: (time.sleep(0.1), svc.wake()),
                          name="late-wake")
        t0 = time.monotonic()
        assert svc.wait_for_work(timeout_s=30.0) is False
        assert time.monotonic() - t0 < 5.0
        th.join(timeout=30)
        assert not th.is_alive()


def test_pending_groups_orders_unique(tmp_path):
    svc = _service(tmp_path / "svc")
    with svc:
        svc.submit("fixpoint_density", dict(PARAMS, seed=0))
        svc.submit("fixpoint_density", dict(PARAMS, seed=1))
        svc.submit("fixpoint_density", {"trials": 32, "batch": 8, "seed": 2})
        groups = svc.pending_groups()
        assert len(groups) == 2 and groups[0][0] == "fixpoint_density"
        svc.run_pending()
        assert svc.pending_groups() == []


# ---------------------------------------------------------------------------
# the adaptive service; the fixed-window oracle
# ---------------------------------------------------------------------------


def test_adaptive_service_grows_when_clean_shrinks_under_burn(tmp_path):
    svc = _service(tmp_path / "svc", slo_p95_ms=60000.0)
    with svc:
        ctrl = make_controller(0.25, 60000.0)
        svc.attach_controller(ctrl)
        gid = None
        for i in range(3):
            svc.submit("fixpoint_density", dict(PARAMS, seed=i))
            gid = gid or svc.pending_groups()[0]
            svc.run_pending()
        assert ctrl.window_s([gid]) > DEFAULT_FLOOR_S
        st = svc.stats()
        assert st["dispatch"]["adaptive"] is True
        assert st["dispatch"]["fair_tenants"] is True
        assert st["dispatch"]["groups"] == 1
        assert "srnn_serve_inflight_requests" in st["metrics"]
        assert "srnn_serve_window_seconds" in st["metrics"]
    svc2 = _service(tmp_path / "svc2", slo_p95_ms=0.001)
    with svc2:
        ctrl2 = make_controller(0.25, 0.001)
        svc2.attach_controller(ctrl2)
        svc2.submit("fixpoint_density", dict(PARAMS, seed=0))
        gid = svc2.pending_groups()[0]
        for _ in range(6):
            ctrl2.observe_dispatch(gid, violations=0, completed=1)
        grown = ctrl2.window_s([gid])
        svc2.run_pending()
        assert ctrl2.window_s([gid]) < grown
        assert svc2.stats()["slo"]["violations"] >= 1


def test_no_adaptive_oracle_keeps_legacy_metrics_surface(tmp_path):
    svc = _service(tmp_path / "svc")
    with svc:
        svc.submit("fixpoint_density", dict(PARAMS, seed=0))
        svc.run_pending(window_s=0.25)
        rows = svc.stats()["metrics"]
        assert svc.stats()["dispatch"] == {"adaptive": False}
        assert not any(k.startswith("srnn_serve_window_seconds")
                       for k in rows)
        assert not any(k.startswith("srnn_serve_inflight_requests")
                       for k in rows)


# ---------------------------------------------------------------------------
# the in-process fleet: real workers on threads, fake process handles
# ---------------------------------------------------------------------------


class _FakeProc:
    _pids = itertools.count(90001)

    def __init__(self):
        self.pid = next(self._pids)
        self.returncode = None

    def poll(self):
        return self.returncode

    def terminate(self):
        if self.returncode is None:
            self.returncode = 0

    def kill(self):
        if self.returncode is None:
            self.returncode = -9

    def wait(self, timeout=None):
        return self.returncode


class _Fleet:
    """N real ServiceServers (threads) behind one real ServicePool."""

    def __init__(self, tmp_path, n, window_s=0.05, windows=None):
        self.root = str(tmp_path)
        self.services, self.servers, self.threads, handles = [], [], [], []
        for i in range(n):
            wroot = os.path.join(self.root, "workers", f"w{i}")
            wsock = os.path.join(self.root, "workers", f"w{i}.sock")
            os.makedirs(os.path.dirname(wroot), exist_ok=True)
            svc = _service(wroot)
            server = ServiceServer(svc, wsock, batch_window_s=(
                windows[i] if windows else window_s))
            thread = spawn_thread(server.serve_until_shutdown,
                                  name=f"fleet-w{i}")
            ServiceClient(wsock).wait_until_up(30)
            self.services.append(svc)
            self.servers.append(server)
            self.threads.append(thread)
            handles.append(WorkerHandle(i, wroot, wsock, _FakeProc()))
        self.pool = ServicePool(self.root, handles)

    def kill_worker(self, i):
        """The crash: drain stops the worker without dispatching its queue
        (its tickets stay journaled-unfinished, as SIGKILL leaves them)."""
        self.servers[i].stop(drain=True)
        self.threads[i].join(timeout=60)
        self.services[i].close()

    def close(self):
        self.pool.close()
        for th in self.threads:
            th.join(timeout=60)
            assert not th.is_alive()
        for svc in self.services:
            svc.close()


def test_two_worker_fleet_matches_solo_bitwise(tmp_path):
    trace = [("a", 0), ("b", 1), ("a", 2), ("c", 3), ("b", 4), ("c", 5)]
    fleet = _Fleet(tmp_path / "fleet", n=2)
    try:
        tickets = [fleet.pool.submit("fixpoint_density",
                                     dict(PARAMS, seed=s), tenant=t)
                   for t, s in trace]
        tickets.append(fleet.pool.submit(
            "soup", {"size": 8, "generations": 2, "train": 1, "seed": 6},
            tenant="a"))
        got = [fleet.pool.wait(t, timeout_s=240) for t in tickets]
        st = fleet.pool.stats()
        assert st["front"]["admitted"] == st["front"]["completed"] == 7
        assert st["front"]["workers"] == 2
        assert {fleet.pool._tenant_worker[t] for t, _ in trace} == {0, 1}
        assert fleet.pool.healthz()["ok"] is True
    finally:
        fleet.close()
    solo = _service(tmp_path / "solo")
    with solo:
        ref_t = [solo.submit("fixpoint_density", dict(PARAMS, seed=s),
                             tenant=t) for t, s in trace]
        ref_t.append(solo.submit(
            "soup", {"size": 8, "generations": 2, "train": 1, "seed": 6}))
        solo.run_pending()
        for entry, rt in zip(got, ref_t):
            assert entry["status"] == "done"
            assert entry["result"] == solo.poll(rt)["result"]


def test_kill_worker_mid_load_replays_onto_survivor(tmp_path):
    """Tickets queued on worker 0 (a 1 s window: they are still queued,
    journaled and undone, when it dies a few milliseconds later; the JAX
    package's twin waits out a 30 s one and is slow-marked): the front
    reads the corpse's journal and replays its suffix onto worker 1;
    healthz tells the loss and then the heal."""
    fleet = _Fleet(tmp_path, n=2, windows=[1.0, 0.05])
    try:
        tickets = [fleet.pool.submit("fixpoint_density",
                                     dict(PARAMS, seed=i), tenant="a")
                   for i in range(3)]
        assert fleet.pool._tenant_worker["a"] == 0
        unfinished, _, _ = read_journal(
            os.path.join(fleet.root, "workers", "w0", "journal.jsonl"))
        assert [e.key for e in unfinished] == \
            [f"pool:{t}" for t in tickets]
        fleet.kill_worker(0)
        with fleet.pool._lock:
            fleet.pool.workers[0].alive = False
        hz = fleet.pool.healthz()
        assert hz["ok"] is False and hz["stranded"] == 3
        with fleet.pool._lock:
            fleet.pool.workers[0].alive = True
        fleet.pool._note_death(0)
        hz = fleet.pool.healthz()
        assert hz["ok"] is True
        assert hz["deaths"] == 1 and hz["replayed"] == 3
        assert hz["workers"]["0"]["ok"] is False
        for t in tickets:
            assert fleet.pool.wait(t, timeout_s=240)["status"] == "done"
        reg = fleet.pool.registry
        assert reg.counter("serve_worker_replays_total").value() == 3
        assert reg.counter("serve_worker_deaths_total").value() == 1
        assert reg.gauge("serve_workers").value() == 1
        rows = [json.loads(line) for line in
                open(os.path.join(fleet.root, "events.jsonl"))]
        assert any(r.get("kind") == "pool_worker_death" for r in rows)
    finally:
        fleet.close()


def test_front_restart_recovers_its_journal(tmp_path):
    fleet = _Fleet(tmp_path, n=1, window_s=0.05)
    try:
        tickets = [fleet.pool.submit("fixpoint_density",
                                     dict(PARAMS, seed=i), tenant="a")
                   for i in range(2)]
        fleet.pool._stop.set()   # the front "crashes": only its monitor
        fleet.pool._monitor.join(timeout=10)
        pool2 = ServicePool(fleet.root, fleet.pool.workers)
        try:
            assert pool2.recover() == 2
            for t in tickets:
                assert pool2.wait(t, timeout_s=240)["status"] == "done"
            assert pool2.submit("fixpoint_density", dict(PARAMS, seed=9),
                                tenant="a") == "t000003"
            assert pool2.wait("t000003", timeout_s=240)["status"] == "done"
        finally:
            pool2.close()
            fleet.pool.journal.close()
            with fleet.pool._events_lock:
                fleet.pool._events.close()
    finally:
        for th in fleet.threads:
            th.join(timeout=60)
        for svc in fleet.services:
            svc.close()


def test_pool_rules_and_reap():
    """The fleet's alert rules are the JAX package's, and ``_reap``
    terminates what still runs."""
    from srnn_tpu.telemetry import alerts as jalerts
    from srnn_tpu_torch.serve.pool import _reap
    from srnn_tpu_torch.telemetry import alerts

    def table(rules):
        return [(r.name, r.metric, r.kind, r.op, r.value, r.window_s)
                for r in rules]

    assert table(alerts.default_pool_rules(workers=3)) == \
        table(jalerts.default_pool_rules(workers=3))
    for q in (0, 16):
        assert table(alerts.default_serve_rules(max_queue=q)) == \
            table(jalerts.default_serve_rules(max_queue=q))
    procs, killed = [_FakeProc(), _FakeProc()], set()
    procs[1].returncode = 0
    _reap(procs, killed)
    assert killed == {0} and procs[0].returncode == 0


# ---------------------------------------------------------------------------
# the subprocess drill (slow): --workers 2, SIGKILL one worker under load
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_fleet_e2e_sigkill_worker_under_load(tmp_path):
    root = str(tmp_path / "fleet")
    log = open(str(tmp_path / "fleet.log"), "w")
    env = dict(os.environ, SRNN_SETUPS_PLATFORM="cpu", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "srnn_tpu_torch.serve", "--root", root,
         "--workers", "2", "--batch-window-s", "0.25",
         "--slo-p95-ms", "2000"], cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    try:
        client = ServiceClient(os.path.join(root, "serve.sock"), retries=3,
                               backoff_base_s=0.1)
        client.wait_until_up(240)
        tickets = [client.submit("fixpoint_density", dict(PARAMS, seed=s),
                                 tenant=f"tn{s % 4}",
                                 idempotency_key=f"fe2e-{s}")
                   for s in range(8)]
        stats = client.stats()
        assert stats["front"]["workers"] == 2
        os.kill(stats["fleet"]["w0"]["pid"], signal.SIGKILL)
        for t in tickets:
            assert client.wait(t, timeout_s=300) is not None
        stats = client.stats()
        assert stats["front"]["deaths"] == 1
        assert stats["front"]["workers"] == 1
        assert stats["front"]["completed"] == 8
        client.shutdown()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    prom = open(os.path.join(root, "metrics.prom")).read()
    assert "srnn_serve_worker_deaths_total 1" in prom
