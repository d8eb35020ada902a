"""The port's run supervisor, chaos drills and host telemetry modules
(``srnn_tpu_torch.resilience``, ``telemetry.heartbeat`` / ``timeseries`` /
``alerts`` / ``exporter`` / ``profiler`` / ``tracing``) at the unit level,
held against the JAX package's modules on the same inputs where both
define the behaviour: the fault taxonomy on the exception kinds both
packages share (the CUDA kinds are the port's own), the backoff delays,
the chaos grammar, the alert rows and the metric-history stream of the
same registry updates (byte-identical), the heartbeat row's keys.  The
mega runs end to end are ``tests/test_torch_mega.py``."""

import errno
import threading
import time

import pytest
import torch

import srnn_tpu.resilience as jres
from srnn_tpu.telemetry import alerts as jalerts
from srnn_tpu.telemetry import heartbeat as jheartbeat
from srnn_tpu.telemetry import metrics as jmetrics
from srnn_tpu.telemetry import timeseries as jtimeseries
from srnn_tpu.utils import pipeline as jpipeline
from srnn_tpu_torch import resilience as res
from srnn_tpu_torch.telemetry import alerts, heartbeat, metrics, timeseries
from srnn_tpu_torch.utils.pipeline import (BackgroundWriter, StallError,
                                           WriterError, live_threads)


# ---------------------------------------------------------------------------
# fault taxonomy
# ---------------------------------------------------------------------------


def _shared_faults(pkg, preempted, stall, writer_error):
    """The exception kinds both packages classify, built from ``pkg``'s own
    Preempted / StallError / WriterError types."""
    def wrapped(cause):
        e = writer_error("job 'x' failed")
        e.__cause__ = cause
        return e

    return [
        OSError(errno.EIO, "flaky disk"), OSError(errno.ENOSPC, "full"),
        OSError(errno.EINTR, "interrupted"), OSError(errno.ETIMEDOUT, "t"),
        OSError(errno.EACCES, "denied"),
        FileNotFoundError(2, "no config.json"),
        PermissionError(13, "denied"), IsADirectoryError(21, "dir"),
        SystemExit(2), KeyboardInterrupt(), ValueError("bad shape"),
        TypeError("bad arg"), preempted(42), stall("finisher wedged"),
        writer_error("job refused"),
        wrapped(OSError(errno.EIO, "flaky")),
        wrapped(FileNotFoundError(2, "store dir gone")),
        wrapped(TypeError("bad arg")),
        RuntimeError("tpu received a goaway from the system"),
        RuntimeError("device halted"),
        RuntimeError("plain logic error"),
    ]


def test_taxonomy_matches_jax_on_shared_kinds():
    ours = [res.classify_fault(e) for e in _shared_faults(
        res, res.Preempted, StallError, WriterError)]
    theirs = [jres.classify_fault(e) for e in _shared_faults(
        jres, jres.Preempted, jpipeline.StallError, jpipeline.WriterError)]
    assert ours == theirs
    assert ours[:5] == ["io", "io", "io", "io", "fatal"]
    assert ours[12:15] == ["preempt", "stall", "io"]


@pytest.mark.parametrize("exc, kind", [
    (torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
     "device_loss"),
    (RuntimeError("CUDA error: unspecified launch failure"), "device_loss"),
    (RuntimeError("srnn_generation failed: CUDA error 700 (an illegal "
                  "memory access was encountered)"), "device_loss"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     "device_loss"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "fatal"),
    (RuntimeError("CUDA error: out of memory"), "fatal"),
    (RuntimeError("srnn_ww_sgd failed: CUDA error 1 (invalid argument)"),
     "fatal"),
    (RuntimeError("CUDA error: no kernel image is available for execution "
                  "on the device"), "fatal"),
    (RuntimeError("index out of range"), "fatal"),
], ids=["accelerator", "launch-failure", "kernel-wrapper", "ecc", "oom",
        "oom-text", "invalid-argument", "no-kernel-image", "logic"])
def test_cuda_taxonomy(exc, kind):
    """The CUDA remap: runtime and kernel-launch errors read as a device
    loss, deterministic ones stay fatal, also through a WriterError."""
    assert res.classify_fault(exc) == kind
    wrapped = WriterError("job 'update_registry' failed")
    wrapped.__cause__ = exc
    assert res.classify_fault(wrapped) == kind


def test_backoff_delays_match_jax():
    for kw in (dict(base_s=1.0, max_s=8.0, jitter=0.25, seed=7),
               dict(base_s=2.0, max_s=60.0, jitter=0.1, seed=0),
               dict(base_s=0.5, max_s=1.0, jitter=0.0, seed=3)):
        a, b = res.BackoffPolicy(**kw), jres.BackoffPolicy(**kw)
        assert [a.delay(k) for k in range(8)] == \
            [b.delay(k) for k in range(8)], kw
    assert res.BackoffPolicy(base_s=1.0, jitter=0.0).delay(2) == 4.0


# ---------------------------------------------------------------------------
# the chaos grammar and events
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "stall@6:9.5,writer@3,sigterm@8", "device_loss@4", " sigkill@2 ,",
    "writer@1,stall@0", "meteor@4", "device_loss", "stall@-1", "writer@0",
    "stall@x"])
def test_parse_schedule_matches_jax(spec):
    def parse(pkg):
        try:
            return [(e.kind, e.at, e.arg) for e in pkg.parse_schedule(spec)]
        except ValueError as e:
            return type(e)

    assert parse(res) == parse(jres)


@pytest.mark.parametrize("spec, item", [
    ("device_loss@4:2", "A.6"), ("host_loss@3", "A.6"),
    ("coordinator_timeout@2", "A.6")])
def test_parse_schedule_refuses_what_waits(spec, item):
    jres.parse_schedule(spec)  # the JAX package takes it
    with pytest.raises(ValueError, match=item):
        res.parse_schedule(spec)

    class A:
        chaos = spec

    with pytest.raises(SystemExit, match=item):
        res.ChaosMonkey.from_args(A())


@pytest.mark.parametrize("spec", [
    "serve_kill@1", "serve_dispatch_fault@1:io",
    "serve_dispatch_fault@2:stall,serve_poison_tenant@3"])
def test_parse_schedule_takes_the_serve_events(spec):
    """The experiment service's events parse as the JAX package's do (they
    were refused, naming A.7, before the service was ported), and a mega
    run's chunk hook never fires them."""
    got = [(e.kind, e.at, e.arg) for e in res.parse_schedule(spec)]
    assert got == [(e.kind, e.at, e.arg) for e in jres.parse_schedule(spec)]

    class A:
        chaos = spec
        stall_timeout_s = 0.0

    monkey = res.ChaosMonkey.from_args(A())
    monkey.chunk_start(100)
    assert len(monkey.pending) == len(got)


def test_chaos_from_args_validates_stall_needs_timeout():
    class A:
        chaos = "stall@4"
        stall_timeout_s = 0.0

    with pytest.raises(SystemExit, match="stall-timeout"):
        res.ChaosMonkey.from_args(A())
    A.stall_timeout_s = 2.0
    assert res.ChaosMonkey.from_args(A()) is not None

    class B:
        chaos = None

    assert res.ChaosMonkey.from_args(B()) is None


def test_chaos_device_loss_fires_once_as_a_cuda_error():
    m = res.ChaosMonkey(res.parse_schedule("device_loss@4"))
    m.chunk_start(2)
    with pytest.raises(torch.AcceleratorError,
                       match="simulated device loss") as ei:
        m.chunk_start(4)
    assert res.classify_fault(ei.value) == "device_loss"
    m.chunk_start(6)  # a fired event never fires again
    assert not m.pending


def test_chaos_condemned_finisher_never_runs_and_aborts():
    m = res.ChaosMonkey(res.parse_schedule("stall@2,stall@6"))
    ran = []
    fin = m.wrap_finisher(lambda: ran.append(1), gen_end=2)
    t = threading.Thread(target=fin, daemon=True)
    t.start()
    time.sleep(0.05)
    assert t.is_alive()
    m.abort_pending()
    t.join(timeout=5)
    assert not t.is_alive() and ran == []
    # a second stall event after a recovery still holds
    second = m.wrap_finisher(lambda: ran.append(2), gen_end=6)
    t2 = threading.Thread(target=second, daemon=True)
    t2.start()
    time.sleep(0.05)
    assert t2.is_alive()
    m.abort_pending()
    t2.join(timeout=5)
    assert ran == []
    later = lambda: None  # noqa: E731
    assert m.wrap_finisher(later, gen_end=8) is later


def test_chaos_writer_poisons_nth_job_and_names_it():
    m = res.ChaosMonkey(res.parse_schedule("writer@2"))
    seen = []
    w = BackgroundWriter(name="t-chaos")
    m.attach_writer(w)

    def first():
        seen.append("first")

    def save_checkpoint():
        seen.append("second")

    w.submit(first)
    w.submit(save_checkpoint)
    with pytest.raises(WriterError, match="save_checkpoint") as ei:
        w.close()
    assert seen == ["first"] and res.classify_fault(ei.value) == "io"
    assert not live_threads()


# ---------------------------------------------------------------------------
# the supervisor's retry loop
# ---------------------------------------------------------------------------


def _fast(n):
    return res.BackoffPolicy(max_restarts=n, base_s=0.001, max_s=0.002,
                             jitter=0.0)


def _args():
    return type("A", (), {"resume": None})()


def test_supervisor_recovers_then_returns():
    calls = []

    def run_once(args, ctx):
        calls.append(ctx.restarts)
        if len(calls) < 3:
            raise OSError(errno.EIO, "flaky")
        return "run-dir"

    sup = res.Supervisor(_fast(5))
    assert sup.run(run_once, _args()) == "run-dir"
    assert calls == [0, 1, 2]
    assert sup.last_report["outcome"] == "recovered"
    assert sup.last_report["restarts"] == 2
    assert len(sup.last_report["recoveries"]) == 2
    assert res.exit_code_for_report(sup.last_report) == res.EXIT_RECOVERED


def test_supervisor_exhausts_with_exit_code():
    def run_once(args, ctx):
        raise OSError(errno.EIO, "always broken")

    sup = res.Supervisor(_fast(2))
    with pytest.raises(SystemExit) as ei:
        sup.run(run_once, _args())
    assert ei.value.code == res.EXIT_RETRIES_EXHAUSTED
    assert sup.last_report["outcome"] == "exhausted"


def test_supervisor_fatal_and_unsupervised_propagate_unchanged():
    def bad(args, ctx):
        raise ValueError("logic error")

    with pytest.raises(ValueError, match="logic error"):
        res.Supervisor(_fast(5)).run(bad, _args())

    def stall(args, ctx):
        raise StallError("wedged")

    with pytest.raises(StallError, match="wedged"):
        res.Supervisor(_fast(0)).run(stall, _args())


def test_device_loss_restarts_only_when_the_card_answers():
    """A device loss restarts in-process where the card probe passes; a
    card that does not answer (a sticky CUDA error) exits 69 for a fresh
    process to resume."""
    calls = []

    def run_once(args, ctx):
        calls.append(ctx.restarts)
        if len(calls) == 1:
            raise torch.AcceleratorError("CUDA error: launch failure")
        return "run-dir"

    probes = []
    sup = res.Supervisor(_fast(3), probe=lambda: probes.append(1))
    assert sup.run(run_once, _args()) == "run-dir" and probes == [1]
    assert res.probe_card() is None  # no card used here: nothing to probe

    def lost(args, ctx):
        raise torch.AcceleratorError("CUDA error: an illegal memory access")

    sticky = res.Supervisor(
        _fast(3), probe=lambda: RuntimeError("CUDA error: illegal address"))
    with pytest.raises(SystemExit) as ei:
        sticky.run(lost, _args())
    assert ei.value.code == res.EXIT_RETRIES_EXHAUSTED
    assert sticky.last_report["outcome"] == "card-unusable"


# ---------------------------------------------------------------------------
# the host telemetry modules against the JAX package's
# ---------------------------------------------------------------------------


def _update(reg, step):
    """One chunk's worth of registry updates (the same calls on either
    package's registry)."""
    reg.gauge("soup_health_nan_frac", help="h").set(
        [0.0, 0.05, 0.05, 0.0][step])
    reg.gauge("gens_per_sec", help="g", unit="1/s").set(
        10.0 + step, stage="mega_soup")
    reg.counter("soup_watchdog_trips_total", help="w").inc(
        [0, 1, 0, 0][step])
    reg.counter("soup_generations_total", help="n").inc(2)


def test_history_and_alerts_match_jax(tmp_path, monkeypatch):
    """The same registry updates give byte-identical
    ``metrics_history.jsonl`` streams and the same alert transitions and
    registry rows in both packages."""
    for mod in (timeseries, jtimeseries):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
    out = {}
    for tag, m, ts, al in (("port", metrics, timeseries, alerts),
                           ("jax", jmetrics, jtimeseries, jalerts)):
        reg = m.MetricsRegistry()
        path = tmp_path / f"{tag}.jsonl"
        hist = ts.MetricHistory(reg, capacity=3, path=str(path))
        engine = al.AlertEngine(al.default_run_rules(), reg, hist)
        trans = []
        for step in range(4):
            _update(reg, step)
            hist.sample(t=10.0 * step, generation=2 * step)
            trans.append(engine.evaluate(now=10.0 * step))
        hist.close()
        out[tag] = (path.read_bytes(), trans, reg.rows(),
                    hist.series("gens_per_sec"), hist.dropped_points,
                    engine.active())
    assert out["port"] == out["jax"]
    data, trans = out["port"][:2]
    assert [t["rule"] + ":" + t["state"] for ts_ in trans for t in ts_] == [
        "soup_nan_frac:firing", "soup_watchdog_burn:firing",
        "soup_nan_frac:cleared", "soup_watchdog_burn:cleared"]
    assert timeseries.summarize_history(str(tmp_path / "port.jsonl")) == \
        jtimeseries.summarize_history(str(tmp_path / "jax.jsonl"))


class _Exp:
    def __init__(self):
        self.rows = []

    def event(self, _fsync=False, **row):
        self.rows.append((_fsync, row))


def test_heartbeat_rows_match_jax_keys():
    rows = {}
    for tag, mod, m in (("port", heartbeat, metrics),
                        ("jax", jheartbeat, jmetrics)):
        exp, reg = _Exp(), m.MetricsRegistry()
        hb = mod.Heartbeat(exp, stage="mega_soup", total_generations=6,
                           registry=reg, fsync_every=2)
        hb.beat(generation=0)
        hb.beat(generation=2, gens_per_sec=3.5, chunk_seconds=0.5)
        rows[tag] = ([(f, sorted(r)) for f, r in exp.rows],
                     sorted(k.split("{")[0] for k in reg.rows()))
    assert rows["port"] == rows["jax"]
    assert rows["port"][0][0][0] is True and rows["port"][0][1][0] is False
    assert heartbeat.device_memory_stats() is None  # no card here
