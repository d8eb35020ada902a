"""The port's flight recorder (``srnn_tpu_torch/telemetry/flightrec.py``)
and the ``health=`` carry, against tests/test_flightrec.py's cases and the
JAX package's functions.

* The health carry of ``evolve`` / ``evolve_multi`` against a NumPy
  recount of the recorded per-generation stored views (float32, bfloat16
  and the dequantized int8 view; both layouts), and of each type's final
  weights in the mixed soup.
* ``health_summary``, ``combined_health_summary`` and
  ``update_health_gauges`` against the JAX package's on the same carry
  (a mixed soup's, and crafted ones: healthy, a NaN storm, a collapse,
  an empty sketch).
* The ring's bounds and order, the watchdog's rules, the triage bundle's
  layout (its checkpoint restores the state; the trace window writes a
  ``torch.profiler`` trace) against a JAX bundle of the same inputs, the
  host-only bundle, and the stall sentinel.

Bounds: the health counts and sketch exact; ``norm_min`` / ``norm_max``
exact (a min and max of the same floats); the summaries equal.
"""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from srnn_tpu.telemetry import device as jdev
from srnn_tpu.telemetry import flightrec as jfr
from srnn_tpu.telemetry.metrics import MetricsRegistry as JRegistry
import srnn_tpu_torch as st
from srnn_tpu_torch import multisoup as ms
from srnn_tpu_torch.experiment import restore_checkpoint, save_checkpoint
from srnn_tpu_torch.telemetry import device as dev
from srnn_tpu_torch.telemetry.flightrec import (FlightRecorder,
                                                StallSentinel, Watchdog,
                                                combined_health_summary,
                                                health_summary,
                                                update_health_gauges,
                                                write_triage_bundle)
from srnn_tpu_torch.telemetry.metrics import MetricsRegistry
from srnn_tpu_torch.utils.pipeline import live_threads

DYNAMICS = dict(attacking_rate=0.3, learn_from_rate=0.2,
                learn_from_severity=1, train=1, remove_divergent=True,
                remove_zero=True)


def _np_health(w, epsilon):
    """NumPy recount of one generation's sentinels from a (N, P) matrix
    (tests/test_flightrec.py), epsilon compared in the view's dtype."""
    eps = float(np.asarray(epsilon, dtype=w.dtype))
    norm = np.abs(w).max(axis=-1)
    finite = np.isfinite(norm.astype(np.float32))
    zero_at = norm <= eps
    norm = norm.astype(np.float32)
    nonfinite = int((~finite).sum())
    zero = int((finite & zero_at).sum())
    safe = np.where(finite & (norm > 0), norm,
                    np.float32(2.0) ** dev.HEALTH_BUCKET_LO)
    b = np.clip((np.floor(np.log2(safe)).astype(np.int64)
                 - dev.HEALTH_BUCKET_LO) // dev.HEALTH_BUCKET_STEP, 0,
                dev.N_HEALTH_BUCKETS - 1)
    hist = np.bincount(b[finite], minlength=dev.N_HEALTH_BUCKETS)
    return nonfinite, zero, hist, norm[finite]


def _view_np(w):
    if w.dtype == torch.bfloat16:
        import ml_dtypes

        return w.float().numpy().astype(ml_dtypes.bfloat16)
    return w.numpy()


@pytest.mark.parametrize("layout,dtype", [
    ("rowmajor", "f32"), ("popmajor", "f32"), ("popmajor", "bf16"),
    ("rowmajor", "int8")])
def test_health_carry_recount(layout, dtype):
    """``health=True`` against a recount of every generation's recorded
    stored view; ``record=`` and ``metrics=`` compose."""
    cfg = st.SoupConfig(topo=st.Topology("weightwise"), size=40,
                        layout=layout, population_dtype=dtype, **DYNAMICS)
    s0 = st.seed(cfg, 3, device="cpu")
    # plant a zero and a diverged particle: both sentinels fire
    w0 = s0.weights.clone()
    w0[0] = 0
    if dtype == "int8":
        w0[1] = 127
        s0 = s0._replace(weights=w0, scales=s0.scales.clone().index_fill_(
            0, torch.tensor([1]), float("inf")))
    else:
        w0[1, 2] = float("inf")
        s0 = s0._replace(weights=w0)
    _, (_, stream, _), m, h = st.evolve(cfg, s0, 4, record=True,
                                        metrics=True, health=True)
    per_gen = [_np_health(_view_np(w), cfg.epsilon) for w in stream]
    assert int(h.checks) == 4 == int(m.generations)
    assert int(h.nonfinite) == per_gen[-1][0]
    assert int(h.zero) == per_gen[-1][1]
    assert int(h.nonfinite_peak) == max(g[0] for g in per_gen)
    assert int(h.zero_peak) == max(g[1] for g in per_gen)
    np.testing.assert_array_equal(h.norm_hist.numpy(),
                                  sum(g[2] for g in per_gen))
    fins = np.concatenate([g[3] for g in per_gen])
    assert float(h.norm_min) == fins.min()
    assert float(h.norm_max) == fins.max()


def test_multi_health_and_summaries_match_jax():
    """Each type's end-of-window counts against its final weights; the
    summaries and gauges of the port's carries against the JAX package's
    functions on the same numbers."""
    cfg = ms.MultiSoupConfig(
        topos=(st.Topology("weightwise"),
               st.Topology("aggregating", aggregates=4)),
        sizes=(6, 6), attacking_rate=0.4, learn_from_rate=0.3,
        learn_from_severity=1, train=1, remove_divergent=True,
        remove_zero=True)
    s0 = ms.seed_multi(cfg, 0, device="cpu")
    final, hs = ms.evolve_multi(cfg, s0, 3, health=True)
    ours, theirs = MetricsRegistry(), JRegistry()
    parts, jparts = [], []
    for t, (h, w) in enumerate(zip(hs, final.weights)):
        nonf, zero, _, _ = _np_health(w.numpy(), cfg.epsilon)
        assert (int(h.nonfinite), int(h.zero), int(h.checks)) == \
            (nonf, zero, 3)
        jh = jdev.HealthStats(*(x.numpy() for x in h))
        parts.append(health_summary(h, cfg.sizes[t]))
        jparts.append(jfr.health_summary(jh, cfg.sizes[t]))
        update_health_gauges(ours, parts[-1], type_name=f"t{t}")
        jfr.update_health_gauges(theirs, jparts[-1], type_name=f"t{t}")
    assert parts == jparts
    assert combined_health_summary(parts) == \
        jfr.combined_health_summary(jparts)
    assert ours.to_prometheus() == theirs.to_prometheus()
    # an empty sketch: the median is NaN in both
    empty = dev.probe_health(torch.full((3, 4), float("nan")))
    a = health_summary(empty, 3)
    b = jfr.health_summary(jdev.HealthStats(*(x.numpy() for x in empty)), 3)
    assert math.isnan(a.pop("norm_p50")) and math.isnan(b.pop("norm_p50"))
    assert a == b and a["nan_frac"] == 1.0


def test_ring_bounds_orders_and_dumps(tmp_path):
    ring = FlightRecorder(capacity=4)
    for i in range(7):
        ring.record({"gen": i})
    rows = ring.rows()
    assert len(rows) == len(ring) == 4
    assert [r["gen"] for r in rows] == [3, 4, 5, 6]
    assert [r["seq"] for r in rows] == [3, 4, 5, 6]
    assert ring.tail(2) == rows[-2:]
    path = ring.write(str(tmp_path / "ring.jsonl"))
    assert [json.loads(line)["gen"] for line in open(path)] == [3, 4, 5, 6]


def test_watchdog_rules():
    """tests/test_flightrec.py's rule cases, the port's watchdog and the
    JAX package's alike."""
    for wd_cls, ring_cls in ((Watchdog, FlightRecorder),
                             (jfr.Watchdog, jfr.FlightRecorder)):
        ring = ring_cls()
        wd = wd_cls(ring, nan_frac=0.02, zero_frac=0.9, respawn_frac=0.25,
                    gens_regress=0.5, min_history=3, profile_trips=False)
        assert wd.check({"health": {"nan_frac": 0.01,
                                    "zero_frac": 0.1}}) == []
        assert wd.check({"health": {"nan_frac": 0.5}}) == ["nan_frac"]
        assert wd.check({"health": {"zero_frac": 0.95}}) == ["zero_frac"]
        assert wd.check({"respawns": 60, "particle_gens": 100}) == \
            ["respawn_frac"]
        assert wd.check({"health": {"nan_frac": 0.5, "zero_frac": 0.95}}) \
            == ["nan_frac", "zero_frac"]
        slow = {"gens_per_sec": 40.0}
        assert wd.check(slow) == []
        for _ in range(3):
            ring.record({"gens_per_sec": 100.0})
        assert wd.check(slow) == ["gens_regress"]
        assert wd.check({"gens_per_sec": 60.0}) == []
        off = wd_cls(ring, nan_frac=None, zero_frac=0.0, respawn_frac=-1,
                     gens_regress=0.0, profile_trips=False)
        assert off.check({"health": {"nan_frac": 1.0, "zero_frac": 1.0},
                          "respawns": 100, "particle_gens": 100,
                          "gens_per_sec": 1.0}) == []
        assert wd.thresholds() == {"nan_frac": 0.02, "zero_frac": 0.9,
                                   "respawn_frac": 0.25,
                                   "gens_regress": 0.5}


def test_triage_bundle_layout_and_trace(tmp_path):
    """A bundle with a population snapshot: the JAX bundle's files and
    trip.json keys, a checkpoint that restores the state, a
    ``torch.profiler`` trace of the armed window, and the bundle quota."""
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump({"size": 12}, f)
    cfg = st.SoupConfig(topo=st.Topology("weightwise"), size=12, **DYNAMICS)
    state = st.evolve(cfg, st.seed(cfg, 0, device="cpu"), 2)
    row = {"gen": 2, "gens_per_sec": 50.0,
           "health": {"nan_frac": 0.5, "zero_frac": 0.0}}
    reg = MetricsRegistry()
    reg.counter("soup_attacks_total").inc(3)
    ring = FlightRecorder()
    ring.record(row)
    wd = Watchdog(ring, max_bundles=1)
    reasons = wd.check(row)
    assert reasons == ["nan_frac"]
    bundle = wd.trip(reasons, row, run_dir=run_dir, snapshot_state=state,
                     save_fn=save_checkpoint, registry=reg, generation=2)
    st.evolve(cfg, state, 1)  # the armed window
    wd.chunk_boundary()
    assert os.path.dirname(bundle) == run_dir
    assert os.path.basename(bundle) == "triage-gen00000002-nan_frac"
    trip = json.load(open(os.path.join(bundle, "trip.json")))
    assert trip["reasons"] == ["nan_frac"] and trip["generation"] == 2
    assert trip["thresholds"]["nan_frac"] == 0.02
    assert trip["snapshot"] == "ckpt-gen00000002"
    assert trip["backend"]["torch_version"] == torch.__version__
    assert json.load(open(os.path.join(bundle, "metrics.json"))) == \
        {"srnn_soup_attacks_total": 3}
    restored = restore_checkpoint(os.path.join(bundle, "ckpt-gen00000002"))
    assert torch.equal(restored.weights, state.weights)
    assert os.path.getsize(os.path.join(bundle, "trace", "trace.json")) > 0
    # the JAX package's bundle of the same inputs: the same files and keys
    jring = jfr.FlightRecorder()
    jring.record(row)
    jbundle = jfr.write_triage_bundle(
        str(tmp_path / "run"), ["nan_frac"], row, recorder=jring,
        registry=JRegistry(), thresholds=wd.thresholds(), generation=2)
    ours = set(os.listdir(bundle)) - {"ckpt-gen00000002", "trace"}
    assert ours == set(os.listdir(jbundle))
    jtrip = json.load(open(os.path.join(jbundle, "trip.json")))
    assert set(trip) - {"snapshot"} == set(jtrip)
    assert wd.trip(["nan_frac"], row, run_dir=run_dir) is None
    assert wd.trips == 2 and len(wd.bundles) == 1
    # a host-only bundle (a stall): no snapshot, trip.json all the same
    host = write_triage_bundle(run_dir, ["stall"], {"gen": 10},
                               recorder=FlightRecorder(),
                               thresholds={"stall_timeout_s": 5.0})
    trip = json.load(open(os.path.join(host, "trip.json")))
    assert trip["reasons"] == ["stall"] and "snapshot" not in trip
    assert os.path.exists(os.path.join(host, "ring.jsonl"))


def test_stall_sentinel_fires_once_and_stops():
    fired = []
    s = StallSentinel(0.15, lambda mark, waited: fired.append((mark, waited)))
    quiet = StallSentinel(0.1, lambda *_: fired.append("quiet"))
    quiet.stop()
    try:
        s.mark("step-1")
        time.sleep(0.05)
        assert not s.fired
        time.sleep(0.35)
        assert s.fired and len(fired) == 1
        assert fired[0][0] == "step-1" and fired[0][1] >= 0.15
        assert not quiet.fired
    finally:
        s.stop()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            t.name == "srnn-stall-sentinel" for t in live_threads()):
        time.sleep(0.02)
    assert not [t for t in live_threads() if t.name == "srnn-stall-sentinel"]


@pytest.mark.parametrize("case", ["healthy", "nan-storm", "collapsed",
                                  "empty-sketch"])
def test_health_summary_matches_jax(case):
    """``health_summary`` and ``update_health_gauges`` of a carry equal
    the JAX package's on the same numbers (its fractions, peaks and the
    sketch's median)."""
    rng = np.random.default_rng(len(case))
    w = rng.standard_normal((50, 14)).astype(np.float32)
    if case == "nan-storm":
        w[::2] = np.nan
    elif case == "collapsed":
        w[:45] *= 1e-9
    elif case == "empty-sketch":
        w[:] = np.inf
    h = dev.accumulate_health(dev.probe_health(torch.from_numpy(w)),
                              torch.from_numpy(w * 3), -1, 1e-4)
    ours = health_summary(h, 50)
    theirs = jfr.health_summary(jdev.HealthStats(*(x.numpy() for x in h)),
                                50)
    p50 = ours.pop("norm_p50"), theirs.pop("norm_p50")
    assert ours == theirs
    assert p50[0] == p50[1] or (math.isnan(p50[0]) and math.isnan(p50[1]))
    if case != "empty-sketch":
        reg, jreg = MetricsRegistry(), JRegistry()
        update_health_gauges(reg, {**ours, "norm_p50": p50[0]})
        jfr.update_health_gauges(jreg, {**theirs, "norm_p50": p50[1]})
        assert reg.to_prometheus() == jreg.to_prometheus()
