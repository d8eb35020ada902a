"""The port's row-major soup (``layout='rowmajor'``, the default of both
packages) against the JAX package's ``_evolve_parallel``, fed the JAX
package's own draws.

Each JAX run is one ``evolve(..., record=True)`` of three generations,
built once per module: its stacked events, weights and uids are the
reference for the port's ``evolve_step`` chain (the draws handed over as
numpy, replayed from the keys the JAX scan splits) and for the port's own
``evolve(..., record=True)`` (its ``draw`` replaced by the same draws).
Particles: weightwise (both train modes), aggregating, and recurrent with
sigmoid, whose slope of at most 1/4 damps rounding noise along the 17-step
chain (ROADMAP.md §C, known gaps); weightwise bf16 and int8 populations.

Bounds: integer state exact; float32 weights rtol 2e-5 / atol 1e-6 and
losses rtol 1e-4 / atol 1e-6 (tests/test_torch_soup.py); bfloat16 weights
within one bfloat16 ulp (rtol 2^-7, atol 1e-6), int8 codes within one step
and scales within rtol 2e-5 (tests/test_torch_precision.py).  Inside the
port the row-major soup equals the population-major phase chain bit for
bit for the weightwise and aggregating particles, and not for the
recurrent one.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import soup as jsoup
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
import srnn_tpu_torch as st
from srnn_tpu_torch import convert
from srnn_tpu_torch import soup as psoup
from torch_lazy import Lazy

GENERATIONS = 3
N = 16
JCFG = jsoup.SoupConfig(
    topo=JTopology("weightwise", width=2, depth=2), size=N,
    attacking_rate=0.3, learn_from_rate=0.3, learn_from_severity=1, train=2,
    remove_divergent=True, remove_zero=True)
#: the JAX runs: name -> (config, seed)
RUNS = {
    "weightwise": (JCFG, 3),
    "weightwise-full_batch": (JCFG._replace(train_mode="full_batch"), 3),
    "weightwise-train0": (JCFG._replace(train=0, learn_from_severity=2), 5),
    "aggregating": (JCFG._replace(topo=JTopology(
        "aggregating", width=2, depth=2, aggregates=4)), 4),
    "recurrent": (JCFG._replace(topo=JTopology(
        "recurrent", width=2, depth=2, activation="sigmoid")), 4),
    "bf16": (JCFG._replace(population_dtype="bf16"), 3),
    "int8": (JCFG._replace(population_dtype="int8"), 3),
    "popmajor": (JCFG._replace(layout="popmajor"), 3),
}
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


def _jax_draws(cfg, key) -> st.SoupDraws:
    """The draws of one JAX generation (``soup.py:341-386``; the popmajor
    path draws the same, ``:553-614``)."""
    n = cfg.size
    _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
    return st.SoupDraws(
        np.asarray(jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate),
        np.asarray(jax.random.randint(k_at, (n,), 0, n)),
        np.asarray(jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate),
        np.asarray(jax.random.randint(k_lt, (n,), 0, n)),
        np.asarray(j_fresh_lanes(cfg.topo, k_re, n, cfg.respawn_draws)))


def _port_config(jcfg, **kw):
    fields = jcfg._asdict()
    fields["topo"] = dataclasses.asdict(jcfg.topo)
    return convert.soup_config_from_fields(fields)._replace(**kw)


def _port_state(js):
    return convert.soup_state_from_arrays(
        np.asarray(js.weights), np.asarray(js.uids), int(js.next_uid),
        int(js.time), device="cpu",
        scales=None if js.scales is None else np.asarray(js.scales))


def _planted(s0):
    """``s0`` with particle 0 all zero and particle 1 diverged, so that
    both respawn kinds (and an attack by a diverged particle) happen."""
    w = np.array(s0.weights)
    w[0] = 0
    if s0.scales is None:
        w[1, 3] = np.inf
        return s0._replace(weights=jax.numpy.asarray(w))
    w[1] = 127  # int8: a diverged particle's codes and scale
    scales = np.array(s0.scales)
    scales[1] = np.inf
    return s0._replace(weights=jax.numpy.asarray(w),
                       scales=jax.numpy.asarray(scales))


@pytest.fixture(scope="module")
def jax_runs():
    """Per run: (config, initial state, the draws of each generation,
    final state, (events, weights, uids) stacked over the generations),
    made at the first read."""
    def run(name):
        cfg, seed = RUNS[name]
        s0 = _planted(jsoup.seed(cfg, jax.random.key(seed)))
        final, recs = jsoup.evolve(cfg, s0, generations=GENERATIONS,
                                   record=True)
        draws, key = [], s0.key
        for _ in range(GENERATIONS):
            draws.append(_jax_draws(cfg, key))
            key = jax.random.split(key, 6)[0]
        return cfg, s0, draws, final, recs

    return Lazy(run)


def _check_weights(cfg, got, ref, msg):
    """The stored population (or its stored view) against JAX's."""
    ref = np.asarray(ref)
    if cfg.population_dtype == "bf16":
        assert got.dtype == torch.bfloat16, msg
        np.testing.assert_allclose(got.float().numpy(),
                                   ref.astype(np.float32), **BF16_TOL,
                                   err_msg=msg)
    elif cfg.population_dtype == "int8" and got.dtype == torch.int8:
        off = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
        assert off.max() <= 1, msg
    elif cfg.population_dtype == "int8":
        # the dequantized view: one code step of a particle's scale
        step = np.abs(ref).max(axis=-1, keepdims=True) / 127.0
        assert (np.abs(got.numpy() - ref) <= step * (1 + 2e-5)
                + 1e-6).all(), msg
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=1e-6,
                                   err_msg=msg)


def _check_events(ev, action, counterpart, loss, msg):
    np.testing.assert_array_equal(ev.action.numpy(), np.asarray(action),
                                  msg)
    np.testing.assert_array_equal(ev.counterpart.numpy(),
                                  np.asarray(counterpart), msg)
    np.testing.assert_allclose(ev.loss.numpy(), np.asarray(loss), rtol=1e-4,
                               atol=1e-6, err_msg=msg)


@pytest.mark.parametrize("name", [n for n in RUNS if n != "popmajor"])
def test_rowmajor_soup_matches_jax(jax_runs, name):
    """(a), (b): the port's ``evolve_step`` chain on JAX's draws against
    JAX's row-major generations, generation by generation."""
    jcfg, s0, draws, final, (jev, jw, juids) = jax_runs[name]
    cfg = _port_config(jcfg)
    assert cfg.layout == "rowmajor"
    state = _port_state(s0)
    for g in range(GENERATIONS):
        state, ev = st.evolve_step(cfg, state, draws[g])
        msg = f"{name} generation {g}"
        np.testing.assert_array_equal(state.uids.numpy(),
                                      np.asarray(juids[g]), msg)
        assert int(state.time) == g + 1
        _check_events(ev, jev.action[g], jev.counterpart[g], jev.loss[g],
                      msg)
        if g == GENERATIONS - 1:
            _check_weights(cfg, state.weights, final.weights, msg)
            if state.scales is not None:
                np.testing.assert_allclose(state.scales.numpy(),
                                           np.asarray(final.scales),
                                           rtol=2e-5, err_msg=msg)
        else:
            _check_weights(cfg, psoup._rows_view(cfg, state), jw[g], msg)
    assert int(state.next_uid) == int(final.next_uid)
    np.testing.assert_array_equal(
        st.count(cfg, _port_state(final)).numpy(),
        np.asarray(jsoup.count(jcfg, final)))


@pytest.mark.parametrize("name", ["weightwise", "popmajor", "int8"])
def test_evolve_record_matches_jax(jax_runs, name, monkeypatch):
    """(c): ``evolve(record=True)`` against JAX's stacked record, in both
    layouts, the port's draws replaced by JAX's."""
    jcfg, s0, draws, final, (jev, jw, juids) = jax_runs[name]
    cfg = _port_config(jcfg)
    feed = iter(draws)

    def jax_draw(config, gen, device):
        return st.SoupDraws(*(psoup._on(x, device, t) for x, t in zip(
            next(feed), (torch.bool, torch.int64, torch.bool, torch.int64,
                         torch.float32))))

    monkeypatch.setattr(psoup, "draw", jax_draw)
    start = _port_state(s0)
    got, (ev, w, uids) = st.evolve(cfg, start, GENERATIONS, record=True)
    assert int(start.time) == 0  # the caller's state is left as it was
    n, p = N, cfg.topo.num_weights
    assert ev.action.shape == ev.counterpart.shape == (GENERATIONS, n)
    assert ev.loss.dtype == torch.float32 and ev.loss.shape == (GENERATIONS, n)
    assert w.shape == (GENERATIONS, n, p) and w.dtype == torch.float32
    assert uids.shape == (GENERATIONS, n) and uids.dtype == torch.int32
    _check_events(ev, jev.action, jev.counterpart, jev.loss, name)
    np.testing.assert_array_equal(uids.numpy(), np.asarray(juids))
    for g in range(GENERATIONS):
        _check_weights(cfg, w[g], jw[g], f"{name} generation {g}")
    assert torch.equal(w[-1], psoup._rows_view(cfg, got))
    assert torch.equal(uids[-1], got.uids)


def _planted_port(s0):
    """``s0`` with particle 0 all zero and particle 1 diverged."""
    w = s0.weights.clone()
    w[0] = 0
    w[1, 3] = float("inf")
    return s0._replace(weights=w)


@pytest.mark.parametrize("variant", ["weightwise", "aggregating", "fft",
                                     "recurrent"])
def test_rowmajor_against_popmajor_phases(variant):
    """(d): from one state and one seed (so one stream of draws), the
    row-major soup equals the population-major phase chain bitwise for the
    weightwise, aggregating and fft particles; the recurrent one differs
    (its population-major attack, K6's plain chain, sums otherwise)."""
    topo = st.Topology(variant, width=2, depth=2, aggregates=4)
    cfg = st.SoupConfig(topo=topo, size=N, attacking_rate=0.3,
                        learn_from_rate=0.3, learn_from_severity=1, train=2,
                        remove_divergent=True, remove_zero=True)
    s0 = _planted_port(st.seed(cfg, 7, device="cpu"))
    row = st.evolve(cfg, s0, GENERATIONS)
    pop = st.evolve(cfg._replace(layout="popmajor"), s0, GENERATIONS)
    assert torch.equal(row.uids, pop.uids)
    assert torch.equal(row.next_uid, pop.next_uid)
    if variant == "recurrent":
        assert not torch.equal(row.weights, pop.weights)
    else:
        assert torch.equal(row.weights, pop.weights)


def test_rowmajor_refusals_and_default():
    """(h): the JAX package's refusals of the row-major layout and of the
    sequential mode (float32 only), and the default layout and mode; the
    sequential mode runs (tests/test_torch_soup_sequential.py)."""
    topo = st.Topology("weightwise", width=2, depth=2)
    cfg = st.SoupConfig(topo=topo, size=N)
    assert (cfg.layout, cfg.mode) == ("rowmajor", "parallel")
    s0 = st.seed(cfg, 0, device="cpu")
    for bad, match in ((dict(generation_impl="fused"), "megakernel"),
                       (dict(attack_impl="compact"), "compact"),
                       (dict(learn_from_impl="compact"), "compact"),
                       (dict(mode="sequential", population_dtype="bf16"),
                        "sequential"),
                       (dict(layout="columnar"), "layout")):
        with pytest.raises(ValueError, match=match):
            st.evolve_step(cfg._replace(**bad), s0)
        with pytest.raises(ValueError, match=match):
            st.evolve(cfg._replace(**bad), s0, 1)
    assert int(st.evolve(cfg._replace(mode="sequential"), s0, 1).time) == 1
    # the telemetry carries (tests/test_torch_telemetry.py) of a stacked
    # state come one per trial on a leading trial axis, each the lone
    # soup's; a lone one evolves as unmetered
    stacked = psoup.stack([s0, s0])
    _, ms = st.evolve(cfg, stacked, 1, metrics=True)
    metered, m = st.evolve(cfg, s0, 1, metrics=True)
    assert torch.equal(metered.weights, st.evolve(cfg, s0, 1).weights)
    assert int(m.generations) == 1 and int(m.actions.sum()) == N
    assert tuple(ms.actions.shape) == (2, 7)
    for t in range(2):
        assert torch.equal(ms.actions[t], m.actions)
        assert torch.equal(ms.loss_sum[t], m.loss_sum)
    # the popmajor layout takes no trial axis
    with pytest.raises(ValueError, match="rowmajor"):
        st.evolve(cfg._replace(layout="popmajor"), stacked, 1)
    # train_impl / apply_impl 'plain' select nothing; their 'kernel'
    # spellings are the popmajor lane kernels, refused here as the JAX
    # package refuses 'pallas'
    a = st.evolve(cfg, s0, 2)
    b = st.evolve(cfg._replace(train_impl="plain", apply_impl="plain"), s0,
                  2)
    assert torch.equal(a.weights, b.weights) and torch.equal(a.uids, b.uids)
    for field in ("train_impl", "apply_impl"):
        with pytest.raises(ValueError, match=f"{field}='kernel' is the "
                                             "popmajor lane kernel"):
            st.evolve(cfg._replace(**{field: "kernel"}), s0, 1)
