"""The port's metrics carry and registry (``srnn_tpu_torch/telemetry/``
``metrics.py``, ``device.py``, ``soup_metrics.py``) against the JAX
package's, and the metered soups against the unmetered ones.

* The registry: the same updates (counters, gauges and histograms with
  labels, label values that need escaping) give byte-identical
  Prometheus text, textfile and ``events.jsonl`` rows in both packages.
* ``soup_metrics``: ``update_registry``, ``update_class_gauges``,
  ``update_multi_registry``, ``set_precision_gauges`` and
  ``update_fused_counters`` fed the same carries write the same
  exposition (the port's carries as tensors, the JAX package's as its
  arrays); ``EVENT_COUNTERS`` and ``type_names`` alike.
* ``device``: ``count_events``, ``accumulate_health`` / ``probe_health``
  and the merges against the JAX package's on the same arrays, (N, P)
  and (P, N), float32 and bfloat16 (its weakly typed epsilon), with NaN,
  Inf, zero and sub-epsilon rows.
* Flags on against flags off, bitwise: weights, uids, next_uid and the
  recorded events and views, for the row-major soup, the
  population-major phase chain and fused route, float32, bfloat16 and
  int8, the sequential soup, and the mixed soup in both layouts.
* The metrics carry against a NumPy recount of the port's own recorded
  events (tests/test_telemetry.py:37).
* ``evolve_multi_captured(registry=)`` meters every generation per type,
  pipelined and blocking (the homogeneous capture's case is in
  tests/test_torch_capture.py).

Bounds: integers exact; the loss sum rtol 1e-5 (against the recount of
the same losses, and against the JAX package's sum of the same array);
``norm_min`` / ``norm_max`` exact on the same array (a max of the same
floats).  Against the JAX package's ``evolve`` the carries are held in
tests/test_torch_dynamics.py.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import multisoup as jms
from srnn_tpu import soup as jsoup
from srnn_tpu.telemetry import device as jdev
from srnn_tpu.telemetry import metrics as jmetrics
from srnn_tpu.telemetry import soup_metrics as jsm
import srnn_tpu_torch as st
from srnn_tpu_torch import multisoup as ms
from srnn_tpu_torch.telemetry import device as dev
from srnn_tpu_torch.telemetry import dynamics as dyn
from srnn_tpu_torch.telemetry import metrics
from srnn_tpu_torch.telemetry import soup_metrics as sm

DYNAMICS = dict(attacking_rate=0.3, learn_from_rate=0.2,
                learn_from_severity=1, train=1, remove_divergent=True,
                remove_zero=True)


def _registries():
    return metrics.MetricsRegistry(), jmetrics.MetricsRegistry()


class _Exp:
    def __init__(self):
        self.rows = []

    def event(self, **row):
        self.rows.append(json.dumps(row, sort_keys=True))


def test_registry_sinks_byte_equal_to_jax(tmp_path):
    ours, theirs = _registries()
    for reg in (ours, theirs):
        c = reg.counter("soup_attacks_total", help="attacks")
        c.inc(3)
        c.inc(2.5, type="weightwise")
        c.inc(1, type='quo"te\\back\nline')
        reg.gauge("soup_class_particles", help="per class").set(
            7, cls="fix_zero")
        reg.gauge("soup_health_nan_frac").set(0.125)
        reg.gauge("soup_dynamics_next_pid").set(2 ** 40)
        h = reg.histogram("span_seconds", help="spans", unit="seconds")
        for v in (5e-5, 0.003, 0.3, 2.0, 500.0):
            h.observe(v, span="evolve")
        h.observe(0.01)
    assert ours.to_prometheus() == theirs.to_prometheus()
    assert ours.dumps() == theirs.dumps()
    assert ours.histogram("span_seconds").quantile(0.5) == \
        theirs.histogram("span_seconds").quantile(0.5)
    a, b = tmp_path / "a.prom", tmp_path / "b.prom"
    ours.write_textfile(str(a))
    theirs.write_textfile(str(b))
    assert a.read_bytes() == b.read_bytes()
    ea, eb = _Exp(), _Exp()
    ours.flush_events(ea, gen=4)
    theirs.flush_events(eb, gen=4)
    assert ea.rows == eb.rows
    for q in (0.0, 0.5, 0.95, 1.0):
        assert metrics.quantile_from_times([3.0, 1.0, 2.0, 9.0], q) == \
            jmetrics.quantile_from_times([3.0, 1.0, 2.0, 9.0], q)
    with pytest.raises(TypeError):
        ours.gauge("soup_attacks_total")
    with pytest.raises(ValueError, match="negative"):
        ours.counter("soup_attacks_total").inc(-1)


def _carry_pair(rng, n, loss_scale=1.0):
    action = rng.integers(0, dev.N_ACTIONS, n).astype(np.int32)
    loss = (rng.random(n) * loss_scale).astype(np.float32)
    ours = dev.count_events(torch.from_numpy(action), torch.from_numpy(loss))
    theirs = jdev.count_events(jnp.asarray(action), jnp.asarray(loss))
    return ours, theirs, action, loss


def test_soup_metrics_registry_matches_jax():
    assert len(st.soup.ACTION_NAMES) == dev.N_ACTIONS == jdev.N_ACTIONS
    assert st.soup.ACTION_NAMES == jsoup.ACTION_NAMES
    assert sm.EVENT_COUNTERS == jsm.EVENT_COUNTERS
    for name in ("N_HEALTH_BUCKETS", "HEALTH_BUCKET_LO",
                 "HEALTH_BUCKET_STEP"):
        assert getattr(dev, name) == getattr(jdev, name)
    rng = np.random.default_rng(0)
    ours, theirs = _registries()
    m, jm, action, loss = _carry_pair(rng, 300)
    np.testing.assert_array_equal(m.actions.numpy(), np.asarray(jm.actions))
    np.testing.assert_array_equal(m.actions.numpy(), np.bincount(
        action, minlength=dev.N_ACTIONS))
    np.testing.assert_allclose(float(m.loss_sum), float(jm.loss_sum),
                               rtol=1e-5)
    # the same carry (the port's loss sum) into both registries
    shared = jdev.SoupMetrics(jm.generations, jm.actions,
                              jnp.float32(float(m.loss_sum)))
    sm.update_registry(ours, m, n_particles=300)
    jsm.update_registry(theirs, shared, n_particles=300)
    bad = dev.SoupMetrics(m.generations, m.actions,
                          torch.tensor(float("nan")))
    sm.update_registry(ours, bad, type_name="weightwise")
    jsm.update_registry(theirs, jdev.SoupMetrics(
        jm.generations, jm.actions, jnp.float32(jnp.nan)),
        type_name="weightwise")
    counts = np.array([3, 1, 4, 1, 5])
    sm.update_class_gauges(ours, torch.from_numpy(counts),
                           prev=torch.from_numpy(counts[::-1].copy()))
    jsm.update_class_gauges(theirs, jnp.asarray(counts),
                            prev=jnp.asarray(counts[::-1].copy()))
    topos = (st.Topology("weightwise"), st.Topology("weightwise", width=3),
             st.Topology("recurrent"))
    jtopos = (JTopology("weightwise"), JTopology("weightwise", width=3),
              JTopology("recurrent"))
    mcfg = ms.MultiSoupConfig(topos=topos, sizes=(4, 5, 6),
                              population_dtype="bf16")
    jmcfg = jms.MultiSoupConfig(topos=jtopos, sizes=(4, 5, 6),
                                population_dtype="bf16")
    assert sm.type_names(mcfg) == jsm.type_names(jmcfg)
    carries = [_carry_pair(rng, n) for n in mcfg.sizes]
    sm.update_multi_registry(ours, [c[0] for c in carries], mcfg)
    jsm.update_multi_registry(theirs, [jdev.SoupMetrics(
        c[1].generations, c[1].actions, jnp.float32(float(c[0].loss_sum)))
        for c in carries], jmcfg)
    sm.set_precision_gauges(ours, mcfg)
    jsm.set_precision_gauges(theirs, jmcfg)
    cfg = st.SoupConfig(topo=topos[0], size=10, population_dtype="int8")
    sm.set_precision_gauges(ours, cfg)
    jsm.set_precision_gauges(theirs, jsoup.SoupConfig(
        topo=jtopos[0], size=10, population_dtype="int8"))
    for kernel in (True, False):
        sm.update_fused_counters(ours, 7, kernel, type_name="recurrent")
        jsm.update_fused_counters(theirs, 7, kernel, type_name="recurrent")
    assert ours.to_prometheus() == theirs.to_prometheus()


def _health_cases():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((40, 14)).astype(np.float32)
    w[0] = np.nan
    w[1, 3] = np.inf
    w[2] = 0.0
    w[3] = 5e-5
    w[4] = 1e-4           # at epsilon: zero-collapsed
    w[5] = 1.00009e-4     # above epsilon in float32, at it in bfloat16
    w[6] *= 1e-12
    w[7] *= 1e9
    w[8] = 2.0 ** -3      # a power of two: a bucket edge
    return w


@pytest.mark.parametrize("dtype,axis", [("f32", -1), ("bf16", 0)])
def test_health_functions_match_jax(dtype, axis):
    w = _health_cases()
    if axis == 0:
        w = np.ascontiguousarray(w.T)
    jw = jnp.asarray(w)
    tw = torch.from_numpy(w)
    if dtype == "bf16":
        jw = jw.astype(jnp.bfloat16)
        tw = tw.to(torch.bfloat16)
        w = w.astype(ml_dtypes.bfloat16)
    h = dev.probe_health(tw, axis, 1e-4)
    jh = jdev.probe_health(jw, axis, 1e-4)
    for f, a, b in zip(dev.HealthStats._fields, h, jh):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    # a second generation folds in; the merge of two windows alike
    h2 = dev.accumulate_health(h, tw * 2, axis, 1e-4)
    jh2 = jdev.accumulate_health(jh, jw * 2, axis, 1e-4)
    merged = dev.merge_health(h, h2)
    jmerged = jdev.merge_health(jh, jh2)
    for a, b in zip(merged, jmerged):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(h.nonfinite) == 2 and int(h2.checks) == 2
    m, jm, _, _ = _carry_pair(np.random.default_rng(2), 50)
    mm = dev.merge_soup_metrics(m, m)
    jmm = jdev.merge_soup_metrics(jm, jm)
    np.testing.assert_array_equal(mm.actions.numpy(), np.asarray(jmm.actions))
    assert int(mm.generations) == 2


def _route_configs():
    ww = st.Topology("weightwise")
    rnn = st.Topology("recurrent")
    base = dict(topo=ww, size=48, **DYNAMICS)
    return {
        "rowmajor": st.SoupConfig(**base),
        "rowmajor-int8": st.SoupConfig(**base, population_dtype="int8"),
        "phases": st.SoupConfig(**base, layout="popmajor"),
        "phases-recurrent": st.SoupConfig(**{**base, "topo": rnn},
                                          layout="popmajor"),
        "fused": st.SoupConfig(**base, layout="popmajor",
                               generation_impl="fused"),
        "fused-bf16": st.SoupConfig(**base, layout="popmajor",
                                    generation_impl="fused",
                                    population_dtype="bf16"),
        "sequential": st.SoupConfig(**{**base, "size": 16},
                                    mode="sequential"),
    }


ROUTES = _route_configs()


def _bits(t):
    return t.float().view(torch.int32) if t.dtype.is_floating_point else t


def _same(a, b, what):
    assert torch.equal(_bits(a), _bits(b)), what


@pytest.mark.parametrize("route", list(ROUTES))
def test_flags_leave_the_soup_bitwise(route):
    """All three flags on (lineage where the mode takes it) against none:
    the final state and the recorded events, views and uids bit for bit;
    the metrics carry against a NumPy recount of the recorded events."""
    cfg = ROUTES[route]
    s0 = st.seed(cfg, 4, device="cpu")
    plain, (ev, w, uids) = st.evolve(cfg, s0, 4, record=True)
    kw = dict(metrics=True, health=True)
    if cfg.mode == "parallel":
        kw.update(lineage=True, lineage_state=dyn.seed_lineage(
            cfg.size, device="cpu"), lineage_capacity=64)
    out = st.evolve(cfg, s0, 4, record=True, **kw)
    final, (ev2, w2, uids2), m, h = out[:4]
    for f in ("weights", "uids", "next_uid", "time"):
        _same(getattr(plain, f), getattr(final, f), f)
    if cfg.population_dtype == "int8":
        _same(plain.scales, final.scales, "scales")
    for a, b, f in zip(ev + (w, uids), ev2 + (w2, uids2),
                       ev._fields + ("weights", "uids")):
        _same(a, b, f)
    np.testing.assert_array_equal(
        m.actions.numpy(), np.bincount(ev.action.numpy().reshape(-1),
                                       minlength=dev.N_ACTIONS))
    assert int(m.generations) == int(h.checks) == 4
    np.testing.assert_allclose(float(m.loss_sum),
                               float(ev.loss.double().sum()), rtol=1e-5)
    assert len(out) == 4 + (cfg.mode == "parallel")


@pytest.mark.parametrize("layout,impl", [("rowmajor", "phases"),
                                         ("popmajor", "phases"),
                                         ("popmajor", "fused")])
def test_mixed_flags_leave_the_soup_bitwise(layout, impl):
    cfg = ms.MultiSoupConfig(
        topos=(st.Topology("weightwise"),
               st.Topology("aggregating", aggregates=4),
               st.Topology("recurrent")),
        sizes=(12, 10, 9), layout=layout, generation_impl=impl, **DYNAMICS)
    s0 = ms.seed_multi(cfg, 6, device="cpu")
    plain = ms.evolve_multi(cfg, s0, 2)
    final, mm, hh, (lins, win, stats) = ms.evolve_multi(
        cfg, s0, 2, metrics=True, health=True, lineage=True,
        lineage_state=dyn.seed_lineage_blocks(cfg.sizes, device="cpu"),
        lineage_capacity=64)
    for t in range(len(cfg.topos)):
        _same(plain.weights[t], final.weights[t], f"weights[{t}]")
        _same(plain.uids[t], final.uids[t], f"uids[{t}]")
        assert int(stats[t].census.sum()) == cfg.sizes[t]
        assert int(mm[t].actions.sum()) == 2 * cfg.sizes[t]
        assert int(hh[t].checks) == 2
    _same(plain.next_uid, final.next_uid, "next_uid")
    assert int(win.births[0, 1]) == int(final.next_uid) - cfg.total
    assert len({int(lin.next_pid) for lin in lins}) == 1
    # the per-type action histograms against the generations one by one
    s, rec = s0, [np.zeros(dev.N_ACTIONS, np.int64) for _ in cfg.topos]
    for _ in range(2):
        s, ev = ms.evolve_multi_step(cfg, s)
        for t, a in enumerate(ev.action):
            rec[t] += np.bincount(a.numpy(), minlength=dev.N_ACTIONS)
    for t in range(len(cfg.topos)):
        np.testing.assert_array_equal(mm[t].actions.numpy(), rec[t])


@pytest.mark.parametrize("pipelined", [True, False])
def test_mixed_capture_meters_every_generation(tmp_path, pipelined):
    """``evolve_multi_captured(registry=)``: per-type counters (labelled
    by ``type_names``) equal the per-type metrics carries of the
    uncaptured run of the same generations, pipelined and blocking."""
    from srnn_tpu_torch.utils import TrajStore, evolve_multi_captured

    cfg = ms.MultiSoupConfig(
        topos=(st.Topology("weightwise"), st.Topology("recurrent")),
        sizes=(10, 8), **DYNAMICS)
    s0 = ms.seed_multi(cfg, 2, device="cpu")
    _, mm = ms.evolve_multi(cfg, s0, 4, metrics=True)
    reg = metrics.MetricsRegistry()
    stores = [TrajStore(str(tmp_path / f"t{t}.traj"), n, topo.num_weights)
              for t, (n, topo) in enumerate(zip(cfg.sizes, cfg.topos))]
    try:
        evolve_multi_captured(cfg, s0, 4, stores, every=2, registry=reg,
                              pipelined=pipelined)
    finally:
        for store in stores:
            store.close()
    for name, m, n in zip(sm.type_names(cfg), mm, cfg.sizes):
        assert reg.counter("soup_generations_total").value(type=name) == 4
        assert reg.counter("soup_particle_generations_total").value(
            type=name) == 4 * n
        for code, action in enumerate(st.soup.ACTION_NAMES):
            if action in sm.EVENT_COUNTERS:
                assert reg.counter(sm.EVENT_COUNTERS[action][0]).value(
                    type=name) == int(m.actions[code]), (name, action)
