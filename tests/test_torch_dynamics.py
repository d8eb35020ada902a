"""The port's device telemetry carries against the JAX package's, and the
lineage layer (``srnn_tpu_torch/telemetry/dynamics.py``, ``genealogy.py``)
on its own.

* ``soup.evolve`` / ``multisoup.evolve_multi`` with ``metrics=``,
  ``health=`` and ``lineage=`` against the JAX package's ``evolve`` /
  ``evolve_multi`` with the same flags, fed the JAX package's draws (the
  port's ``draw`` replaced, as in tests/test_torch_soup_rowmajor.py) and
  seeded through ``convert.lineage_state_from_arrays``: the weightwise
  soup population-major (the port's phase chain and fused route against
  JAX's phases), the recurrent soup row-major (its window closing on the
  row-major transform) and the mixed weightwise + aggregating +
  recurrent soup population-major (both routes; the recurrent type's
  window closing on ``apply_popmajor``).  The recurrent particle runs
  sigmoid (tests/test_torch_soup.py: other activations amplify the two
  packages' rounding past any float bound); the row-major soup neither
  learns nor trains (``learn_from_severity=0``, ``train=0``: its learn
  gates are still recorded), which halves its JAX compile.  One JAX
  compile per soup, in a module-scoped fixture.
* ``record_step`` against the JAX package's on random masks, with and
  without overflow and with phases removed; the crafted census of
  tests/test_dynamics.py:386 through both packages' ``probe_dynamics``.
* NumPy recounts of the port's own runs (tests/test_dynamics.py:111): every
  pid mint and edge row from the port's own draws and uid trail; the census
  from the final weights and the layout's own self-application (the
  recurrent particle's two layouts close on different transforms, as in
  the JAX package); the capacity overflow (tests/test_dynamics.py:364).
* The host half across packages: the ``lineage_state.npz`` sidecar read by
  the other package both ways; the port's ``lineage.jsonl`` summarised by
  both packages' ``genealogy.summarize_dynamics`` alike, and byte for
  byte the JAX package's writer's file (fresh, resumed, continued, after
  a torn line); ``window_record`` and the ``soup_dynamics_*`` registry
  rows equal; ``edge_capacity``, the soup's edge widths and
  ``seed_lineage_blocks`` equal.
* The refusals, with the JAX package's wording.

Bounds: every integer exact (actions, generations, health counts and
sketch, pid / parent / birth / basin / next_pid, edge rows, n_edges,
dropped, births, census, transitions, the L2 and L-inf sketches); the
loss sum rtol 1e-5; ``norm_min`` / ``norm_max`` / ``l2_max`` /
``linf_max`` rtol 2e-5, atol 1e-6 (the port's weights and self-application
agree with JAX's to that bound, tests/test_torch_soup.py, and the sums
reduce in another order).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import multisoup as jms
from srnn_tpu import soup as jsoup
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
from srnn_tpu.telemetry import dynamics as jdyn
from srnn_tpu.telemetry import genealogy as jgen
from srnn_tpu.telemetry.metrics import MetricsRegistry as JRegistry
import srnn_tpu_torch as st
from srnn_tpu_torch import convert
from srnn_tpu_torch import multisoup as ms
from srnn_tpu_torch import soup as psoup
from srnn_tpu_torch.nets.dispatch import apply_to_weights
from srnn_tpu_torch.ops.popmajor import apply_popmajor
from srnn_tpu_torch.telemetry import dynamics as dyn
from srnn_tpu_torch.telemetry import genealogy
from srnn_tpu_torch.telemetry.metrics import MetricsRegistry
from torch_lazy import Lazy

G = 5
CAP = 512
F_TOL = dict(rtol=2e-5, atol=1e-6)
WW = JTopology("weightwise", width=2, depth=2)
AGG = JTopology("aggregating", width=2, depth=2, aggregates=4)
RNN = JTopology("recurrent", width=2, depth=2, activation="sigmoid")
DYNAMICS = dict(attacking_rate=0.3, learn_from_rate=0.2,
                learn_from_severity=1, train=1, remove_divergent=True,
                remove_zero=True)
SOUP = jsoup.SoupConfig(topo=WW, size=64, layout="popmajor",
                        respawn_draws="fused", **DYNAMICS)
ROWMAJOR = jsoup.SoupConfig(topo=RNN, size=64, layout="rowmajor",
                            respawn_draws="fused",
                            **{**DYNAMICS, "learn_from_severity": 0,
                               "train": 0})
MIXED = jms.MultiSoupConfig(topos=(WW, AGG, RNN), sizes=(24, 16, 16),
                            layout="popmajor", respawn_draws="fused",
                            **DYNAMICS)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_draws(cfg, key):
    n = cfg.size
    _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
    return (jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate,
            jax.random.randint(k_at, (n,), 0, n),
            jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate,
            jax.random.randint(k_lt, (n,), 0, n),
            j_fresh_lanes(cfg.topo, k_re, n, cfg.respawn_draws),
            jax.random.split(key, 6)[0])


def _jax_multi_draws(cfg, key):
    n = cfg.total
    _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
    re_keys = jax.random.split(k_re, len(cfg.topos))
    return (jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate,
            jax.random.randint(k_at, (n,), 0, n),
            jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate,
            tuple(jax.random.randint(jax.random.fold_in(k_lt, t), (n_t,), 0,
                                     n_t) for t, n_t in enumerate(cfg.sizes)),
            tuple(j_fresh_lanes(topo, re_keys[t], n_t, cfg.respawn_draws)
                  for t, (topo, n_t) in enumerate(zip(cfg.topos,
                                                      cfg.sizes))),
            jax.random.split(key, 6)[0])


def _draw_list(fn, cfg, key):
    step = jax.jit(lambda k: fn(cfg, k))
    out = []
    for _ in range(G):
        *d, key = step(key)
        out.append(jax.tree.map(np.asarray, tuple(d)))
    return out


def _lin_arrays(lin):
    return [np.asarray(x) for x in lin]


def _host(res):
    """A JAX ``evolve`` result on the host, the state's key dropped."""
    final, *carries = res
    final = final._replace(key=None)
    return jax.tree.map(np.asarray, (final, *carries))


def _jax_state(jcfg, seed: int):
    """A JAX state holding the port's seeded population (a JAX ``seed``
    compiles its initializers; the weights' law does not matter here)."""
    if hasattr(jcfg, "topos"):
        ps = ms.seed_multi(_port_multi_config(jcfg), seed, device="cpu")
        return jms.MultiSoupState(
            tuple(jax.numpy.asarray(w.numpy()) for w in ps.weights),
            tuple(jax.numpy.asarray(u.numpy()) for u in ps.uids),
            jax.numpy.int32(int(ps.next_uid)), jax.numpy.int32(0),
            jax.random.key(seed))
    ps = st.seed(_port_config(jcfg), seed, device="cpu")
    return jsoup.SoupState(jax.numpy.asarray(ps.weights.numpy()),
                           jax.numpy.asarray(ps.uids.numpy()),
                           jax.numpy.int32(int(ps.next_uid)),
                           jax.numpy.int32(0), jax.random.key(seed))


#: the JAX runs: name -> (config, seed)
RUNS = {"soup": (SOUP, 3), "rowmajor": (ROWMAJOR, 4), "mixed": (MIXED, 5)}


@pytest.fixture(scope="module")
def jax_runs():
    """Per soup: (config, initial state, its draws, the JAX package's
    ``evolve`` with all three flags), made at the first read."""
    def run(name):
        cfg, seed = RUNS[name]
        s0 = _jax_state(cfg, seed)
        if name == "mixed":
            lins0 = jdyn.seed_lineage_blocks(MIXED.sizes)
            res = jms.evolve_multi(MIXED, s0, generations=G, metrics=True,
                                   health=True, lineage=True,
                                   lineage_state=lins0,
                                   lineage_capacity=CAP)
            return (MIXED, s0, lins0,
                    _draw_list(_jax_multi_draws, MIXED, s0.key), _host(res))
        lin0 = jdyn.seed_lineage(cfg.size)
        res = jsoup.evolve(cfg, s0, generations=G, metrics=True,
                           health=True, lineage=True, lineage_state=lin0,
                           lineage_capacity=CAP)
        return (cfg, s0, lin0, _draw_list(_jax_draws, cfg, s0.key),
                _host(res))

    return Lazy(run)


def _tensors(x):
    """Numpy draws as the tensors ``draw`` makes (bool, int64, float32)."""
    if isinstance(x, tuple):
        return tuple(_tensors(t) for t in x)
    dtype = {"b": torch.bool, "i": torch.int64}.get(x.dtype.kind,
                                                      torch.float32)
    return torch.from_numpy(np.array(x)).to(dtype)


def _feed(monkeypatch, module, name, draws, cls):
    feed = iter(draws)

    def jax_draw(config, gen, device):
        return cls(*_tensors(next(feed)))

    monkeypatch.setattr(module, name, jax_draw)


def _port_config(jcfg, **kw):
    fields = jcfg._asdict()
    fields["topo"] = dataclasses.asdict(jcfg.topo)
    return convert.soup_config_from_fields(fields)._replace(**kw)


def _port_multi_config(jcfg):
    fields = jcfg._asdict()
    fields["topos"] = [dataclasses.asdict(t) for t in jcfg.topos]
    return convert.multisoup_config_from_fields(fields)


def _check_metrics(got, ref):
    assert int(got.generations) == int(ref.generations) == G
    np.testing.assert_array_equal(_np(got.actions), ref.actions)
    np.testing.assert_allclose(float(got.loss_sum), float(ref.loss_sum),
                               rtol=1e-5)


def _check_health(got, ref):
    for f in ("checks", "nonfinite", "nonfinite_peak", "zero", "zero_peak",
              "norm_hist"):
        np.testing.assert_array_equal(_np(getattr(got, f)), getattr(ref, f),
                                      err_msg=f)
    for f in ("norm_min", "norm_max"):
        np.testing.assert_allclose(_np(getattr(got, f)), getattr(ref, f),
                                   **F_TOL, err_msg=f)


def _check_lineage(got, ref):
    for f, a, b in zip(dyn.LineageState._fields, got, ref):
        np.testing.assert_array_equal(_np(a), b, err_msg=f)


def _check_window(got, ref):
    for f, a, b in zip(dyn.LineageWindow._fields, got, ref):
        np.testing.assert_array_equal(_np(a), b, err_msg=f)


def _check_stats(got, ref):
    for f in ("census", "transitions", "l2_hist", "linf_hist"):
        np.testing.assert_array_equal(_np(getattr(got, f)), getattr(ref, f),
                                      err_msg=f)
    for f in ("l2_max", "linf_max"):
        np.testing.assert_allclose(_np(getattr(got, f)), getattr(ref, f),
                                   **F_TOL, err_msg=f)


def _soup_carries_match_jax(jax_runs, monkeypatch, run, **kw):
    jcfg, s0, lin0, draws, (jfinal, jm, jh, (jlin, jwin, jstats)) = \
        jax_runs[run]
    cfg = _port_config(jcfg, **kw)
    _feed(monkeypatch, psoup, "draw", draws, st.SoupDraws)
    start = convert.soup_state_from_arrays(
        np.asarray(s0.weights), np.asarray(s0.uids), int(s0.next_uid),
        int(s0.time), device="cpu")
    lin = convert.lineage_state_from_arrays(*_lin_arrays(lin0),
                                            device="cpu")
    final, m, h, (lin, win, stats) = st.evolve(
        cfg, start, G, metrics=True, health=True, lineage=True,
        lineage_state=lin, lineage_capacity=CAP)
    np.testing.assert_array_equal(final.uids.numpy(), jfinal.uids)
    assert int(final.next_uid) == int(jfinal.next_uid)
    np.testing.assert_allclose(final.weights.numpy(), jfinal.weights,
                               **F_TOL)
    _check_metrics(m, jm)
    _check_health(h, jh)
    _check_lineage(lin, jlin)
    _check_window(win, jwin)
    _check_stats(stats, jstats)
    assert int(win.dropped) == 0 and int(win.n_edges) > 0


@pytest.mark.parametrize("impl", ["phases", "fused"])
def test_soup_carries_match_jax(jax_runs, monkeypatch, impl):
    """The population-major soup on both routes against JAX's phases."""
    _soup_carries_match_jax(jax_runs, monkeypatch, "soup",
                            generation_impl=impl)


def test_rowmajor_carries_match_jax(jax_runs, monkeypatch):
    """The row-major recurrent soup against JAX's: lineage from the
    row-major generation, the window closed on the row-major transform
    (not on ``apply_popmajor``, which differs for this particle in the
    last bits)."""
    _soup_carries_match_jax(jax_runs, monkeypatch, "rowmajor")


@pytest.mark.parametrize("impl", ["phases", "fused"])
def test_mixed_carries_match_jax(jax_runs, monkeypatch, impl):
    """Per-type metrics, health and census, and the one shared pid space
    and window, of the mixed soup against ``evolve_multi``."""
    jcfg, s0, lins0, draws, (jfinal, jms_, jhs, (jlins, jwin, jstats)) = \
        jax_runs["mixed"]
    cfg = _port_multi_config(jcfg)._replace(generation_impl=impl)
    _feed(monkeypatch, ms, "draw_multi", draws, ms.MultiSoupDraws)
    start = convert.multisoup_state_from_arrays(
        [np.asarray(w) for w in s0.weights], [np.asarray(u) for u in s0.uids],
        int(s0.next_uid), int(s0.time), device="cpu")
    lins = convert.lineage_states_from_arrays(
        [lin._asdict() for lin in lins0], device="cpu")
    final, mm, hh, (lins, win, stats) = ms.evolve_multi(
        cfg, start, G, metrics=True, health=True, lineage=True,
        lineage_state=lins, lineage_capacity=CAP)
    assert int(final.next_uid) == int(jfinal.next_uid)
    for t in range(len(cfg.topos)):
        np.testing.assert_array_equal(final.uids[t].numpy(), jfinal.uids[t])
        _check_metrics(mm[t], jms_[t])
        _check_health(hh[t], jhs[t])
        _check_lineage(lins[t], jlins[t])
        _check_stats(stats[t], jstats[t])
    _check_window(win, jwin)
    assert len({int(lin.next_pid) for lin in lins}) == 1


def _random_gates(rng, n):
    return dict(attacked=rng.random(n) < 0.3,
                attacker_pid=rng.integers(0, 500, n).astype(np.int32),
                learn_gate=rng.random(n) < 0.2,
                learn_tgt=rng.integers(0, n, n),
                dead=rng.random(n) < 0.1)


@pytest.mark.parametrize("caps,capacity", [
    ((64, 64, 128), 512), ((64, 64, 128), 100), ((8, 8, 8), 16),
    ((0, 64, 128), 512), ((64, 0, 0), 30), ((0, 0, 0), 10)],
    ids=["roomy", "overflow", "tight", "no-attack", "attack-only", "none"])
def test_record_step_matches_jax(caps, capacity):
    """Three generations of ``record_step`` on the same random gates: the
    carry and the window exactly JAX's, the overflow dropped and counted
    alike, a removed phase absent alike."""
    rng = np.random.default_rng(sum(caps) + capacity)
    n = 200
    jl, jw = jdyn.seed_lineage(n), jdyn.zero_window(capacity)
    tl, tw = dyn.seed_lineage(n, device="cpu"), dyn.zero_window(capacity,
                                                                "cpu")
    for g in range(3):
        gates = _random_gates(rng, n)
        jl, jw = jdyn.record_step(
            jl, jw, gen=jax.numpy.int32(g), caps=caps, capacity=capacity,
            **{k: jax.numpy.asarray(v) for k, v in gates.items()})
        tl, tw = dyn.record_step(
            tl, tw, gen=torch.tensor(g, dtype=torch.int32), caps=caps,
            capacity=capacity,
            **{k: torch.as_tensor(v) for k, v in gates.items()})
    _check_lineage(tl, _lin_arrays(jl))
    _check_window(tw, [np.asarray(x) for x in jw])
    if caps == (64, 64, 128) and capacity == 100:
        assert int(tw.dropped) > 0 and int(tw.n_edges) == capacity
    # the single-device mint alike
    gates = _random_gates(rng, n)
    got = dyn.mint(tl, torch.as_tensor(gates["dead"]),
                   torch.as_tensor(gates["attacker_pid"]),
                   torch.tensor(7, dtype=torch.int32))
    ref = jdyn.mint(jl, jax.numpy.asarray(gates["dead"]),
                    jax.numpy.asarray(gates["attacker_pid"]),
                    jax.numpy.int32(7))
    _check_lineage(got, _lin_arrays(ref))


def test_crafted_census_and_transitions():
    """tests/test_dynamics.py:386 through both packages' probe and
    close."""
    n, p = 6, WW.num_weights
    w = np.zeros((n, p), np.float32)
    w[1] = np.nan
    w[2] = 3.0
    w[3] = 1e9
    w[4] = 5e-5
    w[5] = 2.0
    topo = st.Topology("weightwise")
    got = psoup.probe_dynamics(topo, torch.from_numpy(w), 1e-4)
    ref = jsoup.probe_dynamics(WW, jax.numpy.asarray(w), 1e-4)
    _check_stats(got, jax.tree.map(np.asarray, ref))
    assert dyn.probe_record(3, 7, got) == jdyn.probe_record(3, 7, ref)
    assert dyn.probe_record(3, 7, [got], ["weightwise"]) == \
        jdyn.probe_record(3, 7, [ref], ["weightwise"])
    census = got.census.numpy()
    assert census[dyn.BASIN_ZERO] == 2 and census.sum() == n
    trans = got.transitions.numpy()
    assert trans[0].sum() == n and trans[1:].sum() == 0
    # the close folds the carried labels; f(w) == w fixes every finite one
    lin = dyn.seed_lineage(n, device="cpu")._replace(
        basin=torch.full((n,), dyn.BASIN_DRIFT, dtype=torch.int32))
    lin2, s2 = dyn.close_window(lin, torch.from_numpy(w),
                                torch.from_numpy(w), -1, 1e-4)
    jlin2, js2 = jdyn.close_window(
        jdyn.seed_lineage(n)._replace(basin=jax.numpy.full(
            n, jdyn.BASIN_DRIFT, jax.numpy.int32)),
        jax.numpy.asarray(w), jax.numpy.asarray(w), -1, 1e-4)
    _check_stats(s2, jax.tree.map(np.asarray, js2))
    np.testing.assert_array_equal(lin2.basin.numpy(), np.asarray(jlin2.basin))
    t2 = s2.transitions.numpy()
    assert t2[1 + dyn.BASIN_DRIFT].sum() == n and t2[0].sum() == 0
    assert s2.census.numpy()[dyn.BASIN_ZERO] == 2


def _port_cfg(layout, topo=None, **kw):
    return st.SoupConfig(topo=topo or st.Topology("weightwise"), size=64,
                         layout=layout, respawn_draws="fused"
                         if layout == "popmajor" else "perparticle",
                         **{**DYNAMICS, "train": 0, **kw})


@pytest.mark.parametrize("layout", ["rowmajor", "popmajor"])
def test_lineage_numpy_recount(layout):
    """tests/test_dynamics.py:111 on the port's own run: the phase gates
    replayed from the port's own draws (its generator, forked as
    ``evolve`` forks it), deaths from the uid trail."""
    cfg = _port_cfg(layout)
    n = cfg.size
    s0 = st.seed(cfg, 3, device="cpu")
    states = [s0]
    for _ in range(G):
        states.append(st.evolve(cfg, states[-1], 1))
    gen = psoup._fork(s0.key)
    pid = np.arange(n)
    parent = np.full(n, -1)
    birth = np.zeros(n, np.int64)
    next_pid, edges = n, []
    for t in range(G):
        d = psoup.draw(cfg, gen, "cpu")
        gate, tgt = d.attack_gate.numpy(), d.attack_tgt.numpy()
        att_idx = np.full(n, -1)
        for lane in np.nonzero(gate)[0]:
            att_idx[tgt[lane]] = max(att_idx[tgt[lane]], lane)
        dead = states[t].uids.numpy() != states[t + 1].uids.numpy()
        old = pid.copy()
        for lane in np.nonzero(att_idx >= 0)[0]:
            pid[lane], parent[lane], birth[lane] = next_pid, old[att_idx[lane]], t
            next_pid += 1
            edges.append([dyn.EDGE_ATTACK, t, old[att_idx[lane]], pid[lane],
                          old[lane]])
        mid = pid.copy()
        for lane in np.nonzero(d.learn_gate.numpy())[0]:
            edges.append([dyn.EDGE_LEARN, t, mid[d.learn_tgt[lane]], mid[lane],
                          -1])
        for lane in np.nonzero(dead)[0]:
            pid[lane], parent[lane], birth[lane] = next_pid, -1, t
            next_pid += 1
            edges.append([dyn.EDGE_RESPAWN, t, -1, pid[lane], mid[lane]])
    final, (lin, win, _) = st.evolve(
        cfg, s0, G, lineage=True,
        lineage_state=dyn.seed_lineage(n, device="cpu"),
        lineage_capacity=2048)
    assert torch.equal(final.weights, states[-1].weights)
    np.testing.assert_array_equal(lin.pid.numpy(), pid)
    np.testing.assert_array_equal(lin.parent.numpy(), parent)
    np.testing.assert_array_equal(lin.birth.numpy(), birth)
    assert int(lin.next_pid) == next_pid
    assert dyn.window_edge_rows(win, 2048) == edges
    assert int(win.dropped) == 0
    assert win.births.numpy().tolist() == [[
        sum(e[0] == dyn.EDGE_ATTACK for e in edges),
        sum(e[0] == dyn.EDGE_RESPAWN for e in edges)]]


@pytest.mark.parametrize("variant,layout", [
    ("weightwise", "popmajor"), ("recurrent", "popmajor"),
    ("recurrent", "rowmajor")])
def test_census_matches_numpy_recount(variant, layout):
    """The census and labels of the port's run against a NumPy recount of
    its final weights and the layout's own self-application: the
    population-major close applies ``apply_popmajor`` (K6's plain version
    for the recurrent particle), the row-major close the row-major
    transform, as the JAX package's closes do."""
    cfg = _port_cfg(layout, st.Topology(variant), train=1)
    s0 = st.seed(cfg, 2, device="cpu")
    final, (lin, _, stats) = st.evolve(
        cfg, s0, 4, lineage=True,
        lineage_state=dyn.seed_lineage(cfg.size, device="cpu"))
    w = final.weights
    fw = (apply_popmajor(cfg.topo, w.t().contiguous(),
                         w.t().contiguous()).t()
          if layout == "popmajor" else apply_to_weights(cfg.topo, w, w))
    w, fw = w.numpy(), fw.numpy()
    linf = np.max(np.abs(fw - w), axis=-1)
    with np.errstate(over="ignore", invalid="ignore"):
        l2 = np.sqrt(((fw - w) ** 2).sum(axis=-1, dtype=np.float32))
    div = ~np.isfinite(w).all(axis=-1) | ~np.isfinite(linf)
    zero = (np.abs(w) <= np.float32(cfg.epsilon)).all(axis=-1) & ~div
    fix = ~div & ~zero & (linf < np.float32(cfg.epsilon))
    expect = [fix.sum(), (~(div | zero | fix)).sum(), div.sum(), zero.sum()]
    np.testing.assert_array_equal(stats.census.numpy(), expect)
    np.testing.assert_array_equal(
        lin.basin.numpy(), np.select([div, zero, fix], [
            dyn.BASIN_DIV, dyn.BASIN_ZERO, dyn.BASIN_FIX], dyn.BASIN_DRIFT))
    finite = np.isfinite(l2) & np.isfinite(linf)
    assert float(stats.linf_max) == linf[finite].max()
    np.testing.assert_allclose(float(stats.l2_max), l2[finite].max(),
                               rtol=1e-6)


def test_edge_capacity_overflow_drops_and_counts():
    cfg = _port_cfg("popmajor")
    s0 = st.seed(cfg, 0, device="cpu")

    def run(cap):
        return st.evolve(cfg, s0, G, lineage=True, lineage_capacity=cap,
                         lineage_state=dyn.seed_lineage(64, device="cpu"))[1]

    lin_big, win_big, _ = run(2048)
    lin_small, win_small, _ = run(8)
    total, kept = int(win_big.n_edges), int(win_small.n_edges)
    assert kept == 8 and int(win_small.dropped) == total - kept > 0
    assert dyn.window_edge_rows(win_small, 8) == \
        dyn.window_edge_rows(win_big, 2048)[:8]
    assert torch.equal(win_small.births, win_big.births)
    assert torch.equal(lin_small.pid, lin_big.pid)


def test_sidecar_and_genealogy_across_packages(tmp_path):
    """The port's ``lineage_state.npz`` loads in the JAX package and JAX's
    in the port (one carry and a per-type tuple); the port's
    ``lineage.jsonl`` summarises alike in both packages' genealogy; the
    ``soup_dynamics_*`` registry rows are byte-equal."""
    cfg = _port_cfg("popmajor")
    st_ = st.seed(cfg, 0, device="cpu")
    run_dir = str(tmp_path)
    writer = dyn.LineageWriter(run_dir, n=cfg.size, capacity=CAP,
                               epsilon=cfg.epsilon)
    lin = dyn.seed_lineage(cfg.size, device="cpu")
    reg, jreg = MetricsRegistry(), JRegistry()
    for k in range(3):
        st_, (lin, win, stats) = st.evolve(
            cfg, st_, 3, lineage=True, lineage_state=lin,
            lineage_capacity=CAP)
        row = dyn.window_record(3 * k, 3 * k + 3, win, stats, CAP,
                                int(lin.next_pid))
        writer.append(row)
        dyn.update_dynamics_registry(reg, row)
        jdyn.update_dynamics_registry(jreg, row)
    writer.close()
    assert reg.to_prometheus() == jreg.to_prometheus()
    ours = genealogy.summarize_dynamics(run_dir)
    assert ours == jgen.summarize_dynamics(run_dir)
    assert ours["windows"] == 3

    dyn.save_lineage_state(run_dir, lin, 9)
    back = jdyn.load_lineage_state(run_dir, 9)
    _check_lineage(lin, _lin_arrays(back))
    assert jdyn.load_lineage_state(run_dir, 8) is None
    jlins = jdyn.seed_lineage_blocks((5, 7))
    jdyn.save_lineage_state(run_dir, jlins, 4)
    got = dyn.load_lineage_state(run_dir, 4, device="cpu")
    assert len(got) == 2
    for a, b in zip(got, jlins):
        _check_lineage(a, _lin_arrays(b))
        assert a.pid.dtype == torch.int32 and a.next_pid.shape == ()


def test_refusals_with_jax_wording():
    """Lineage in the sequential mode, and lineage without a carry, raise
    the JAX package's errors (both raise before anything compiles)."""
    # a config the sequential mode takes: the port checks it before the
    # flags
    jcfg = SOUP._replace(layout="rowmajor", respawn_draws="perparticle")
    js0 = _jax_state(SOUP, 3)
    cfg = _port_config(jcfg)
    s0 = st.seed(cfg, 0, device="cpu")
    for mode, lin, jlin in (
            ("sequential", dyn.seed_lineage(64, device="cpu"),
             jdyn.seed_lineage(64)),
            ("parallel", None, None)):
        with pytest.raises(ValueError) as ours:
            st.evolve(cfg._replace(mode=mode), s0, 1, lineage=True,
                      lineage_state=lin)
        with pytest.raises(ValueError) as theirs:
            jsoup.evolve(jcfg._replace(mode=mode), js0, generations=1,
                         lineage=True, lineage_state=jlin)
        assert str(ours.value) == str(theirs.value)
    jmcfg, jm0 = MIXED, _jax_state(MIXED, 5)
    mcfg = _port_multi_config(jmcfg)
    with pytest.raises(ValueError) as ours:
        ms.evolve_multi(mcfg, ms.seed_multi(mcfg, 0, device="cpu"), 1,
                        lineage=True)
    with pytest.raises(ValueError) as theirs:
        jms.evolve_multi(jmcfg, jm0, generations=1, lineage=True)
    assert str(ours.value) == str(theirs.value)
    # a lineage carry of another population's size (the sequential mode's
    # metrics and health: tests/test_torch_telemetry.py)
    with pytest.raises(ValueError, match="lineage_state"):
        st.evolve(cfg, s0, 1, lineage=True,
                  lineage_state=dyn.seed_lineage(8, device="cpu"))
    assert os.path.basename(dyn.STATE_NAME) == jdyn.STATE_NAME


@pytest.mark.parametrize("n,rate", [
    (64, 0.3), (64, 0.0), (640, 0.1), (1_000_000, 0.1), (1_000_000, 0.2),
    (50, 1.0), (7, -1.0), (100_000, 0.01)])
def test_edge_capacity_and_caps_match_jax(n, rate):
    """``edge_capacity`` and the soup's per-phase widths
    (``_lineage_caps``) equal the JAX package's, each phase on or off."""
    assert dyn.edge_capacity(n, rate) == jdyn.edge_capacity(n, rate)
    for removals in (True, False):
        for capacity in (8, 4096):
            kw = dict(attacking_rate=rate, learn_from_rate=rate / 2,
                      remove_divergent=removals, remove_zero=False)
            cfg = st.SoupConfig(topo=st.Topology("weightwise"), size=n, **kw)
            jcfg = jsoup.SoupConfig(topo=WW, size=n, **kw)
            assert psoup._lineage_caps(n, cfg, capacity) == \
                jsoup._lineage_caps(n, jcfg, capacity)


@pytest.mark.parametrize("sizes", [(5,), (24, 16), (3, 1, 7)])
def test_seed_lineage_blocks_match_jax(sizes):
    ours = dyn.seed_lineage_blocks(sizes, time=4, device="cpu")
    theirs = jdyn.seed_lineage_blocks(sizes, time=4)
    assert len(ours) == len(theirs) == len(sizes)
    for a, b in zip(ours, theirs):
        _check_lineage(a, _lin_arrays(b))
    _check_window(dyn.zero_window(16, "cpu"),
                  [np.asarray(x) for x in jdyn.zero_window(16)])


def _window_and_stats(rng, n, types):
    """A random window and per-type stats, as the port's tensors and the
    JAX package's arrays."""
    cap = 32
    edges = rng.integers(-1, 500, (cap, dyn.EDGE_WIDTH)).astype(np.int32)
    win = [edges, np.array([21], np.int32), np.array([9], np.int32),
           np.array([[13, 4]], np.int32)]
    stats = []
    for _ in range(types):
        s = [rng.integers(0, n, dyn.N_BASINS).astype(np.int32),
             rng.integers(0, n, (dyn.N_BASINS + 1, dyn.N_BASINS)).astype(
                 np.int32),
             rng.integers(0, n, 24).astype(np.int32),
             rng.integers(0, n, 24).astype(np.int32),
             np.float32(rng.random() * 10), np.float32(-np.inf)]
        stats.append(s)
    return cap, win, stats


@pytest.mark.parametrize("types", [None, 2])
def test_window_record_and_registry_match_jax(types):
    """``window_record`` (a soup's, and a mixed soup's per-type census)
    and the registry rows it folds into are the JAX package's for the
    same window and census."""
    rng = np.random.default_rng(7)
    cap, win, stats = _window_and_stats(rng, 64, types or 1)
    names = None if types is None else ["weightwise", "aggregating"]
    ours_stats = [dyn.FixpointStats(*(torch.as_tensor(x) for x in s))
                  for s in stats]
    theirs_stats = [jdyn.FixpointStats(*(jax.numpy.asarray(x) for x in s))
                    for s in stats]
    ours = dyn.window_record(
        2, 6, dyn.LineageWindow(*(torch.as_tensor(x) for x in win)),
        ours_stats if types else ours_stats[0], cap, 99, names)
    theirs = jdyn.window_record(
        2, 6, jdyn.LineageWindow(*(jax.numpy.asarray(x) for x in win)),
        theirs_stats if types else theirs_stats[0], cap, 99, names)
    assert ours == theirs and len(ours["edges"]) == 21
    reg, jreg = MetricsRegistry(), JRegistry()
    dyn.update_dynamics_registry(reg, ours)
    jdyn.update_dynamics_registry(jreg, theirs)
    assert reg.to_prometheus() == jreg.to_prometheus()


@pytest.mark.parametrize("scenario", ["fresh", "resume", "continue",
                                      "torn"])
def test_lineage_writer_files_equal_jax(tmp_path, scenario):
    """The port's ``lineage.jsonl`` is byte for byte the JAX package's for
    the same rows: a fresh run, a resume (a new epoch), a resume that
    continues the epoch, and a resume after a torn last line."""
    rows = [{"kind": "window", "gen_start": 0, "gen_end": 4, "edges": [],
             "next_pid": 64}]
    for cls, sub in ((dyn.LineageWriter, "ours"),
                     (jdyn.LineageWriter, "theirs")):
        d = tmp_path / sub
        d.mkdir()
        if scenario != "fresh":
            first = cls(str(d), n=64, capacity=512, epsilon=1e-4,
                        meta={"seed": 3})
            first.append(rows[0])
            first.close()
        if scenario == "torn":
            with open(d / cls.NAME, "a") as f:
                f.write('{"kind": "win')
        w = cls(str(d), n=64, capacity=512, epsilon=1e-4,
                resume=scenario != "fresh",
                continue_epoch=scenario == "continue")
        w.append(rows[0])
        w.close()
    assert (tmp_path / "ours" / dyn.LineageWriter.NAME).read_bytes() == \
        (tmp_path / "theirs" / jdyn.LineageWriter.NAME).read_bytes()
    epochs = genealogy.load_lineage(str(tmp_path / "ours"))
    assert epochs == jgen.load_lineage(str(tmp_path / "theirs"))
