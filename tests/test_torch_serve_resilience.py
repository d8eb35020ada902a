"""The self-healing experiment service (``srnn_tpu_torch/serve``): the
durable journal, supervised dispatch, admission control, deadlines,
retention and the transport's drain, on the CPU; twins of the JAX
package's ``tests/test_serve_resilience.py``.

* The journal is the JAX package's file format: a journal written by
  either package is read by the other (tickets, torn tail, watermark).
* The client's backoff sequence and the serve chaos schedule's parse and
  validation messages equal the JAX package's.
* Chaos events fire through the service's own admission and dispatch
  paths (``resilience.chaos``'s serve hooks).

Every in-process test rides one small fixpoint-density spelling (trials
16, batch 16).  The two process drills (kill -9 then restart, SIGTERM
drain then restart) are slow-marked as in the JAX package; chip_smoke.py's
phase "experiment service" runs both kinds on the card.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from srnn_tpu.resilience import chaos as jchaos
from srnn_tpu.serve import client as jclient
from srnn_tpu.serve import journal as jjournal
from srnn_tpu_torch.resilience.chaos import (SERVE_FAULT_KINDS, ChaosMonkey,
                                             parse_schedule)
from srnn_tpu_torch.serve import (DeadlineExpired, ExperimentService,
                                  OverloadedError, ServiceClient,
                                  ServiceOverloaded, TicketJournal,
                                  read_journal)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the one spelling every in-process test rides
PARAMS = {"trials": 16, "batch": 16}


def _service(path, **kw):
    return ExperimentService(str(path), device="cpu", **kw)


def _submit(svc, seed, **kw):
    return svc.submit("fixpoint_density", dict(PARAMS, seed=seed), **kw)


# ---------------------------------------------------------------------------
# journal: round trip, torn tail, compaction, across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer, reader", [
    (TicketJournal, read_journal), (TicketJournal, jjournal.read_journal),
    (jjournal.TicketJournal, read_journal)])
def test_journal_round_trip_and_torn_tail(tmp_path, writer, reader):
    j = writer(str(tmp_path))
    j.record_submit(ticket="t000001", kind="soup", params={"size": 8},
                    tenant="a", key="k1", deadline_wall=None, wall=1.0)
    j.record_submit(ticket="t000002", kind="soup", params={"size": 8},
                    tenant="b", key=None, deadline_wall=123.5, wall=2.0,
                    trace_id="abc", parent_span=7)
    j.record_done(["t000001"], "done")
    with open(j.path, "a") as f:   # the partial line kill -9 can leave
        f.write('{"e": "submit", "ticket": "t0000')
    unfinished, torn, nxt = reader(j.path)
    assert [e.ticket for e in unfinished] == ["t000002"]
    assert torn == 1 and nxt == 3
    assert (unfinished[0].tenant, unfinished[0].deadline_wall,
            unfinished[0].trace_id, unfinished[0].parent_span) == \
        ("b", 123.5, "abc", 7)
    unfinished2, torn2, nxt2 = j.recover()
    assert [e.ticket for e in unfinished2] == ["t000002"]
    assert torn2 == 1 and nxt2 == 3
    rows = [json.loads(line) for line in open(j.path).read().splitlines()]
    assert [r["e"] for r in rows] == ["mark", "submit"]
    assert rows[0]["next_ticket"] == 3 and rows[1]["ticket"] == "t000002"
    j.record_done(["t000002"], "failed")
    j.close()
    assert reader(j.path)[0] == [] and reader(j.path)[2] == 3
    # the two packages write the same bytes for the same records
    files = []
    for cls in (TicketJournal, jjournal.TicketJournal):
        d = tmp_path / cls.__module__.split(".")[0]
        d.mkdir()
        jj = cls(str(d))
        jj.record_submit(ticket="t000003", kind="fixpoint_density",
                         params=dict(PARAMS, seed=1), tenant="c", key="k",
                         deadline_wall=9.5, wall=3.0)
        jj.record_done(["t000003"], "done")
        jj.recover()
        jj.close()
        files.append(open(jj.path, "rb").read())
    assert files[0] == files[1]


def test_journal_watermark_survives_idle_restarts(tmp_path):
    j = TicketJournal(str(tmp_path))
    j.record_submit(ticket="t000005", kind="soup", params={}, tenant="a",
                    wall=1.0)
    j.record_done(["t000005"], "done")
    assert j.recover() == ([], 0, 6)
    j.close()
    j2 = jjournal.TicketJournal(str(tmp_path))   # JAX's reads it on
    assert j2.recover() == ([], 0, 6)
    j2.close()
    j3 = TicketJournal(str(tmp_path))
    assert j3.recover() == ([], 0, 6)
    j3.close()


def test_service_journals_submits_and_dones(tmp_path):
    svc = _service(tmp_path / "svc")
    with svc:
        t1 = _submit(svc, 0)
        unfinished, _, _ = read_journal(svc.journal.path)
        assert [e.ticket for e in unfinished] == [t1]
        svc.run_pending()
        assert read_journal(svc.journal.path)[0] == []


def test_recover_replays_and_dedupes(tmp_path):
    root = tmp_path / "svc"
    svc = _service(root)
    tickets = [_submit(svc, i, idempotency_key=f"k{i}") for i in range(3)]
    svc.close()   # queued, never dispatched: the crash
    svc2 = _service(root)
    with svc2:
        assert svc2.recover() == 3
        assert _submit(svc2, 0, idempotency_key="k0") == tickets[0]
        svc2.run_pending()
        for t in tickets:
            assert svc2.wait(t, timeout_s=120)["status"] == "done"
        sh = svc2.stats()["self_healing"]
        assert sh["replayed"] == 3 and sh["journal_unfinished"] == 0
        assert _submit(svc2, 9) == "t000004"


# ---------------------------------------------------------------------------
# supervised dispatch: transient retries, poison-bisect quarantine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", SERVE_FAULT_KINDS)
def test_transient_dispatch_fault_is_retried(tmp_path, fault):
    chaos = ChaosMonkey(parse_schedule(f"serve_dispatch_fault@1:{fault}"))
    svc = _service(tmp_path / "svc", chaos=chaos, retry_backoff_s=0.01)
    with svc:
        t = _submit(svc, 0)
        svc.run_pending()
        assert svc.poll(t)["status"] == "done"
        sh = svc.stats()["self_healing"]
        assert sh["dispatch_retries"] == 1 and sh["quarantined"] == 0
        assert svc.registry.counter("serve_dispatch_retries_total").value(
            kind="fixpoint_density", fault=fault) == 1


def test_poison_bisect_quarantines_only_the_poisoned(tmp_path):
    chaos = ChaosMonkey(parse_schedule("serve_poison_tenant@2"))
    svc = _service(tmp_path / "svc", max_stack=8, chaos=chaos,
                   retry_backoff_s=0.01)
    with svc:
        tickets = [_submit(svc, i) for i in range(4)]
        svc.run_pending()
        entries = [svc.poll(t) for t in tickets]
        assert [e["status"] for e in entries] == \
            ["done", "failed", "done", "done"]
        assert entries[1]["quarantined"] is True
        assert "poisoned" in entries[1]["error"]
        assert svc.stats()["self_healing"]["quarantined"] == 1
        svc.writer.flush()
        rows = [json.loads(line) for line in
                open(os.path.join(svc.root, "events.jsonl"))]
        assert any(r.get("kind") == "serve_bisect" for r in rows)
    ref = _service(tmp_path / "ref")
    with ref:
        rt = [_submit(ref, i) for i in (0, 2, 3)]
        ref.run_pending()
        for i, t in zip((0, 2, 3), rt):
            assert entries[i]["result"] == ref.poll(t)["result"]


def test_deterministic_fatal_fault_is_not_retried(tmp_path):
    svc = _service(tmp_path / "svc", dispatch_retries=3)
    with svc:
        t = svc.submit("soup", {"size": 8, "generations": 2,
                                "train_mode": "bogus"})
        svc.run_pending()
        e = svc.poll(t)
        assert e["status"] == "failed" and "bogus" in e["error"]
        assert "quarantined" not in e
        assert svc.stats()["self_healing"]["dispatch_retries"] == 0


# ---------------------------------------------------------------------------
# admission control, deadlines, retention
# ---------------------------------------------------------------------------


def test_overload_rejection_in_process(tmp_path):
    svc = _service(tmp_path / "svc", max_queue=2)
    with svc:
        _submit(svc, 0), _submit(svc, 1)
        with pytest.raises(OverloadedError, match="max_queue"):
            _submit(svc, 2)
        assert svc.stats()["self_healing"]["overload_rejections"] == 1
        assert svc.registry.gauge("serve_queue_rejected_depth").value() == 2
        svc.run_pending()
        _submit(svc, 2)


def test_deadline_enforced_at_admission_and_dispatch(tmp_path):
    svc = _service(tmp_path / "svc")
    with svc:
        with pytest.raises(DeadlineExpired):
            _submit(svc, 0, deadline_s=0)
        t1 = _submit(svc, 1, deadline_s=0.01)
        t2 = _submit(svc, 2, deadline_s=600.0)
        time.sleep(0.05)
        svc.run_pending()
        e1, e2 = svc.poll(t1), svc.poll(t2)
        assert e1["status"] == "failed" and "deadline" in e1["error"]
        assert e2["status"] == "done"
        assert svc.stats()["self_healing"]["deadline_expirations"] == 2
        assert read_journal(svc.journal.path)[0] == []


def test_results_ttl_eviction(tmp_path):
    svc = _service(tmp_path / "svc", results_ttl_s=0.05)
    with svc:
        t1 = _submit(svc, 0)
        svc.run_pending()
        assert svc.poll(t1) is not None
        time.sleep(0.1)
        t2 = _submit(svc, 1)
        svc.run_pending()
        assert svc.poll(t1) is None and svc.poll(t2) is not None
        assert svc.stats()["self_healing"]["results_evicted"] == 1


def test_idempotency_window_closes_on_consume(tmp_path):
    svc = _service(tmp_path / "svc")
    with svc:
        t1 = _submit(svc, 0, idempotency_key="k")
        assert _submit(svc, 0, idempotency_key="k") == t1
        svc.run_pending()
        assert _submit(svc, 0, idempotency_key="k") == t1
        svc.wait(t1, timeout_s=60)
        assert _submit(svc, 0, idempotency_key="k") != t1


# ---------------------------------------------------------------------------
# socket transport: typed overload and client backoff, drain-resume
# ---------------------------------------------------------------------------


def _start_server(svc, sock, window_s):
    from srnn_tpu_torch.serve.server import ServiceServer
    from srnn_tpu_torch.utils.pipeline import spawn_thread

    server = ServiceServer(svc, sock, batch_window_s=window_s)
    thread = spawn_thread(server.serve_until_shutdown, name="test-serve")
    ServiceClient(sock).wait_until_up(30)
    return server, thread


def test_socket_overload_typed_and_client_backoff(tmp_path):
    svc = _service(tmp_path / "svc", max_queue=1)
    sock = str(tmp_path / "serve.sock")
    _server, thread = _start_server(svc, sock, window_s=0.05)
    try:
        plain = ServiceClient(sock)
        saw_overload = False
        for i in range(200):
            try:
                plain.submit("fixpoint_density", dict(PARAMS, seed=i))
            except ServiceOverloaded:
                saw_overload = True
                break
        assert saw_overload
        patient = ServiceClient(sock, retries=10, backoff_base_s=0.05,
                                seed=3)
        res = patient.request("fixpoint_density", dict(PARAMS, seed=99),
                              timeout_s=120)
        assert len(res["counters"]) == 2
        assert plain.stats()["self_healing"]["overload_rejections"] >= 1
    finally:
        ServiceClient(sock).shutdown()
        thread.join(timeout=60)
        svc.close()


def test_socket_drain_keeps_journal_and_resumes(tmp_path):
    root = tmp_path / "svc"
    svc = _service(root, max_stack=8)
    sock = str(tmp_path / "serve.sock")
    _server, thread = _start_server(svc, sock, window_s=1.0)
    client = ServiceClient(sock)
    try:
        tickets = [client.submit("fixpoint_density", dict(PARAMS, seed=i),
                                 idempotency_key=f"k{i}") for i in range(3)]
        client.drain()   # inside the 1 s window
    finally:
        thread.join(timeout=60)
        svc.close()
    unfinished, _, _ = read_journal(os.path.join(root, "journal.jsonl"))
    assert [e.ticket for e in unfinished] == tickets
    svc2 = _service(root)
    with svc2:
        assert svc2.recover() == 3
        svc2.run_pending()
        for t in tickets:
            assert svc2.wait(t, timeout_s=120)["status"] == "done"


def test_client_backoff_is_deterministic():
    """The same seed gives the JAX package's client's delay sequence."""
    for seed in (7, 8):
        a = ServiceClient("/nonexistent", seed=seed)
        b = jclient.ServiceClient("/nonexistent", seed=seed)
        assert [a._policy.delay(k) for k in range(6)] == \
            [b._policy.delay(k) for k in range(6)]
    a = ServiceClient("/nonexistent", seed=7)
    c = ServiceClient("/nonexistent", seed=8)
    assert [a._policy.delay(k) for k in range(4)] != \
        [c._policy.delay(k) for k in range(4)]


def test_client_never_retries_keyless_submit_after_delivery_risk(tmp_path):
    from srnn_tpu_torch.serve.client import _retry_is_safe

    for msg in ({"op": "submit", "kind": "soup"},
                {"op": "request", "kind": "soup"},
                {"op": "submit", "idempotency_key": "k"},
                {"op": "wait", "ticket": "t000001"}, {"op": "stats"}):
        assert _retry_is_safe(msg) == jclient._retry_is_safe(msg)
    calls = []

    class _Boom(ServiceClient):
        def _op_once(self, msg, timeout_s=None):
            calls.append(msg["op"])
            raise ConnectionResetError("mid-op")

    c = _Boom(str(tmp_path / "x.sock"), retries=3, backoff_base_s=0.001)
    with pytest.raises(ConnectionResetError):
        c._op({"op": "submit", "kind": "soup"})
    assert len(calls) == 1
    calls.clear()
    with pytest.raises(ConnectionResetError):
        c._op({"op": "submit", "kind": "soup", "idempotency_key": "k"})
    assert len(calls) == 4


def test_client_retries_connection_refused(tmp_path):
    client = ServiceClient(str(tmp_path / "nope.sock"), retries=2,
                           backoff_base_s=0.01)
    t0 = time.monotonic()
    with pytest.raises((OSError, ServiceOverloaded)):
        client.stats()
    assert time.monotonic() - t0 >= 0.02


# ---------------------------------------------------------------------------
# the serve chaos schedule: parse and validation, as the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "serve_kill@1,serve_dispatch_fault@2:stall,serve_poison_tenant@3",
    "serve_dispatch_fault@1", "serve_kill@0",
    "serve_dispatch_fault@1:bogus", "device_loss@3:io",
    "serve_poison_tenant@2:io", "serve_kill@x", "serve_dispatch_fault@-1"])
def test_serve_chaos_schedule_validation(spec):
    def parse(pkg):
        try:
            return [(e.kind, e.at, e.arg, repr(e))
                    for e in pkg.parse_schedule(spec)]
        except ValueError as e:
            return str(e)

    assert parse(sys.modules[parse_schedule.__module__]) == parse(jchaos)
    assert SERVE_FAULT_KINDS == jchaos.SERVE_FAULT_KINDS


# ---------------------------------------------------------------------------
# process drills (slow): kill -9 bitwise replay, SIGTERM drain-resume
# ---------------------------------------------------------------------------


def _spawn_service(root, log, *extra):
    env = dict(os.environ, SRNN_SETUPS_PLATFORM="cpu", PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "srnn_tpu_torch.serve", "--root", root,
         "--no-adaptive"] + list(extra), cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT)


def _wait_up(root, timeout_s=90):
    ServiceClient(os.path.join(root, "serve.sock")).wait_until_up(timeout_s)


@pytest.mark.slow
def test_kill9_restart_replays_bitwise(tmp_path):
    seeds = list(range(8))
    log = open(str(tmp_path / "serve.log"), "w")
    ref_root = str(tmp_path / "ref")
    proc = _spawn_service(ref_root, log, "--batch-window-s", "0.1")
    try:
        _wait_up(ref_root)
        client = ServiceClient(os.path.join(ref_root, "serve.sock"))
        tickets = [client.submit("fixpoint_density", dict(PARAMS, seed=s))
                   for s in seeds]
        reference = [client.wait(t, timeout_s=240) for t in tickets]
        client.shutdown()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    root = str(tmp_path / "svc")
    proc = _spawn_service(root, log, "--batch-window-s", "2",
                          "--chaos", "serve_kill@1")
    try:
        _wait_up(root)
        client = ServiceClient(os.path.join(root, "serve.sock"))
        tickets = [client.submit("fixpoint_density", dict(PARAMS, seed=s),
                                 idempotency_key=f"e2e-{s}")
                   for s in seeds]
        assert proc.wait(timeout=120) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
    unfinished, _, _ = read_journal(os.path.join(root, "journal.jsonl"))
    assert [e.ticket for e in unfinished] == tickets
    proc = _spawn_service(root, log, "--batch-window-s", "0.1")
    try:
        _wait_up(root)
        client = ServiceClient(os.path.join(root, "serve.sock"),
                               retries=3, backoff_base_s=0.1)
        assert client.submit("fixpoint_density", dict(PARAMS, seed=0),
                             idempotency_key="e2e-0") == tickets[0]
        replayed = [client.wait(t, timeout_s=240) for t in tickets]
        assert replayed == reference
        assert client.stats()["self_healing"]["replayed"] == 8
        client.shutdown()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    prom = open(os.path.join(root, "metrics.prom")).read()
    assert "srnn_serve_journal_replays_total 8" in prom


@pytest.mark.slow
def test_sigterm_drain_resume(tmp_path):
    root = str(tmp_path / "svc")
    log = open(str(tmp_path / "serve.log"), "w")
    proc = _spawn_service(root, log, "--batch-window-s", "5")
    try:
        _wait_up(root)
        client = ServiceClient(os.path.join(root, "serve.sock"))
        tickets = [client.submit("fixpoint_density", dict(PARAMS, seed=s),
                                 idempotency_key=f"d-{s}") for s in range(6)]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    unfinished, _, _ = read_journal(os.path.join(root, "journal.jsonl"))
    assert [e.ticket for e in unfinished] == tickets
    proc = _spawn_service(root, log, "--batch-window-s", "0.1")
    try:
        _wait_up(root)
        client = ServiceClient(os.path.join(root, "serve.sock"))
        for t in tickets:
            assert client.wait(t, timeout_s=240) is not None
        assert client.stats()["self_healing"]["replayed"] == 6
        client.shutdown()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
