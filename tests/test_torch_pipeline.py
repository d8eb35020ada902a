"""The port's async pipeline (``srnn_tpu_torch/utils/pipeline.py``): the
unit cases of tests/test_pipeline.py that need no JAX -- the background
writer's ordering, backpressure, error latch and close hooks, no orphan
threads, ``ChunkDriver``'s deferral depth and ``OverlapMeter``'s
attribution -- and ``snapshot`` / ``resolve`` on CPU tensors.  On the card
``chip_smoke.py`` drives the side-stream copies inside ``evolve_captured``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from srnn_tpu_torch.utils.pipeline import (BackgroundWriter, ChunkDriver,
                                           OverlapMeter, PinnedPool,
                                           Snapshot, WriterError,
                                           live_threads, resolve, snapshot,
                                           submit_or_run)


def test_writer_runs_jobs_in_submission_order():
    seen = []
    with BackgroundWriter(name="t-order") as w:
        for i in range(20):
            w.submit(seen.append, i)
        w.flush()
        assert seen == list(range(20))
    assert w.jobs_done == 20


def test_writer_backpressure_bounds_the_producer():
    """submit() blocks while ``maxsize`` jobs are pending."""
    gate = threading.Event()
    w = BackgroundWriter(maxsize=1, name="t-bp")
    t = None
    try:
        w.submit(gate.wait)     # occupies the worker
        w.submit(lambda: None)  # fills the 1-slot queue
        blocked = threading.Event()

        def producer():
            w.submit(lambda: None)  # must block until the gate opens
            blocked.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        assert not blocked.wait(0.2), "submit() returned past a full queue"
        gate.set()
        assert blocked.wait(5.0), "submit() never unblocked after drain"
    finally:
        gate.set()
        if t is not None:
            t.join(5.0)
        w.close()


def test_writer_error_latches_skips_later_jobs_and_reraises():
    seen = []

    def boom():
        raise RuntimeError("disk gone")

    w = BackgroundWriter(name="t-err")
    try:
        w.submit(seen.append, "before")
        w.submit(boom)
        w.submit(seen.append, "after")  # skipped: the failure latched
        with pytest.raises(WriterError, match="disk gone"):
            w.flush()
        assert seen == ["before"]
        assert w.failed
        with pytest.raises(WriterError, match="refused"):
            w.submit(seen.append, "rejected")
    finally:
        w.close()  # the error already surfaced: close is clean
    w.close()      # and idempotent


def test_writer_retries_transient_errors():
    import errno

    tries = []

    def flaky():
        tries.append(1)
        if len(tries) < 3:
            raise OSError(errno.EINTR, "interrupted")

    with BackgroundWriter(name="t-retry", retry_backoff_s=0.0) as w:
        w.submit(flaky)
        w.flush()
    assert len(tries) == 3 and w.jobs_retried == 2


def test_writer_close_hooks_run_even_after_job_failure():
    hooks = []
    w = BackgroundWriter(name="t-hook")
    w.add_close_hook(lambda: hooks.append("joined"))
    w.submit(lambda: (_ for _ in ()).throw(OSError("enospc")))
    with pytest.raises(WriterError, match="enospc"):
        w.close()
    assert hooks == ["joined"]


def test_writer_close_leaves_no_orphan_threads():
    writers = [BackgroundWriter(name=f"t-orphan{i}") for i in range(3)]
    try:
        assert len(live_threads()) >= 3
    finally:
        for w in writers:
            w.close()
    assert live_threads() == []


def test_submit_or_run_inline_when_no_writer():
    seen = []
    submit_or_run(None, seen.append, 1)
    assert seen == [1]
    with BackgroundWriter(name="t-sor") as w:
        submit_or_run(w, seen.append, 2)
        w.flush()
    assert seen == [1, 2]


def test_chunk_driver_depth_one_defers_exactly_one_finisher():
    ran = []
    d = ChunkDriver(depth=1)
    d.step(lambda: ran.append(1))
    assert ran == []
    d.step(lambda: ran.append(2))
    assert ran == [1]
    d.drain()
    assert ran == [1, 2]


def test_chunk_driver_depth_zero_is_the_blocking_order():
    ran = []
    d = ChunkDriver(depth=0)
    d.step(lambda: ran.append(1))
    assert ran == [1]
    d.drain()
    assert ran == [1]


def test_overlap_meter_attribution():
    m = OverlapMeter(stage="unit")
    with m.waiting():
        time.sleep(0.02)
    with m.host_io():
        time.sleep(0.01)
    row = m.chunk_done(0.05)
    assert row["device_wait_s"] >= 0.02
    assert row["host_io_s"] >= 0.01
    assert row["device_idle_bound_s"] == pytest.approx(
        0.05 - row["device_wait_s"])
    assert 0.0 < row["overlap_ratio"] <= 1.0
    s = m.summary()
    assert s["chunks"] == 1 and s["wall_s"] == pytest.approx(0.05)


def test_overlap_meter_folds_writer_busy_seconds_into_host_io():
    with BackgroundWriter(name="t-meter") as w:
        m = OverlapMeter(writer=w)
        w.submit(time.sleep, 0.03)
        w.flush()
        row = m.chunk_done(0.1)
    assert row["host_io_s"] >= 0.03


def test_overlap_meter_registry_waits_for_telemetry():
    """With a registry the meter exports the JAX package's pipeline gauges
    of the last chunk and the running seconds counters, labelled by
    stage."""
    from srnn_tpu_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    m = OverlapMeter(registry=reg, stage="capture")
    with m.waiting():
        time.sleep(0.01)
    m.chunk_done(0.05)
    row = m.chunk_done(0.1)
    g = reg.gauge("pipeline_chunk_wall_s")
    assert g.value(stage="capture") == 0.1 == round(row["wall_s"], 4)
    assert reg.gauge("pipeline_overlap_ratio").value(stage="capture") == 0.0
    assert reg.counter("pipeline_wall_seconds_total").value(
        stage="capture") == pytest.approx(0.15)
    assert reg.counter("pipeline_device_wait_seconds_total").value(
        stage="capture") >= 0.01
    assert "srnn_pipeline_chunk_device_idle_bound_s{stage=\"capture\"} 0.1" \
        in reg.to_prometheus()


def test_snapshot_is_a_copy_and_resolves_to_numpy():
    """A CPU snapshot copies: later writes to the source do not show, and
    ``resolve`` gives numpy arrays in the tree's shape; a non-tensor leaf
    passes through."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    t = torch.tensor(4, dtype=torch.int32)
    snap = snapshot((t, (w, w[0]), "tag"), PinnedPool())
    assert isinstance(snap, Snapshot)
    w.add_(100.0)
    t.fill_(0)
    time_, (full, row), tag = resolve(snap)
    snap.release()
    assert int(time_) == 4 and tag == "tag"
    np.testing.assert_array_equal(full, np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(row, np.arange(3.0))
    assert full.dtype == np.float32
    # resolve also takes a plain tree of tensors
    (out,) = resolve((torch.ones(2),))
    np.testing.assert_array_equal(out, np.ones(2))


def test_pinned_pool_reuses_by_shape_and_dtype():
    """A buffer handed back is taken again for the same shape and dtype
    (no new page-locked allocation); release is idempotent."""
    pool = PinnedPool()
    buf = torch.empty((3, 2), dtype=torch.float32)
    pool.give(buf)
    assert pool.take((3, 2), torch.float32) is buf
    assert pool.allocated == 0
    snap = Snapshot((buf,), [], [buf], pool)
    snap.release()
    snap.release()
    assert pool.take((3, 2), torch.float32) is buf
    assert pool._free[((3, 2), torch.float32)] == []
