"""The slice as a whole: the port's soup against the JAX package's
popmajor soup, fed the JAX package's own draws.

The JAX ``evolve_step`` runs with ``layout='popmajor'`` in both
``generation_impl`` spellings (on the CPU its fused spelling is the phase
chain) for the weightwise particle, and in the phase spelling for the
aggregating, fft and recurrent particles (the same program as its fused one
on the CPU).  The recurrent reference runs ``train_impl='pallas'`` (its
Pallas SGD kernel in interpret mode): the hand BPTT in the operation order
the port's kernels follow.  The draws are replayed from the JAX state's
key exactly as ``soup._evolve_parallel_popmajor`` makes them and handed to
the port as numpy.  Integer state must be equal; weights and loss match within the
generation tolerance of tests/test_fused_generation.py (weights rtol 2e-5 /
atol 1e-6, losses rtol 1e-4 / atol 1e-6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import engine as jengine
from srnn_tpu import soup as jsoup
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
import srnn_tpu_torch as st
from srnn_tpu_torch import convert

GENERATIONS = 3
JCFG = jsoup.SoupConfig(
    topo=JTopology("weightwise", width=2, depth=2), size=64,
    attacking_rate=0.3, learn_from_rate=0.3, learn_from_severity=1, train=2,
    remove_divergent=True, remove_zero=True, layout="popmajor")


def _jax_draws(cfg, key) -> st.SoupDraws:
    """The draws of one JAX popmajor generation (soup.py:553-614)."""
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
        int(js.time), device="cpu")


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX generations per spelling: [(state_before, state_after,
    events)] per generation."""
    runs = {}
    for impl in ("phases", "fused"):
        cfg = JCFG._replace(generation_impl=impl)
        s = jsoup.seed(cfg, jax.random.key(3))
        steps = []
        for _ in range(GENERATIONS):
            s2, ev = jsoup.evolve_step(cfg, s)
            steps.append((s, s2, ev))
            s = s2
        runs[impl] = (cfg, steps)
    return runs


#: the other variants' soups, each with JCFG's dynamics.  The recurrent
#: particle runs sigmoid, whose slope of at most 1/4 damps rounding noise
#: along the 17-step chain.  With the other activations no float bound
#: separates a fault from noise over three generations: linear sequences
#: grow to ~1e36 within two epochs at the init law; tanh amplifies the
#: 1-ulp differences of XLA's and torch's tanh to 6.5e-5 relative in one
#: weight even against the Pallas BPTT; a relu pre-activation within
#: rounding of 0 flips its gradient.  test_torch_rnn.py holds those chains.
VARIANT_TOPOS = {
    "aggregating": JTopology("aggregating", width=2, depth=2, aggregates=4),
    "fft": JTopology("fft", width=2, depth=2, aggregates=4),
    "recurrent": JTopology("recurrent", width=2, depth=2, activation="sigmoid"),
}


@pytest.fixture(scope="module")
def jax_variant_runs():
    """Three JAX phase-chain generations per variant; the recurrent one
    through its Pallas SGD kernel."""
    runs = {}
    for name, topo in VARIANT_TOPOS.items():
        cfg = JCFG._replace(topo=topo)
        if name == "recurrent":
            cfg = cfg._replace(train_impl="pallas")
        s = jsoup.seed(cfg, jax.random.key(4))
        steps = []
        for _ in range(GENERATIONS):
            s2, ev = jsoup.evolve_step(cfg, s)
            steps.append((s, s2, ev))
            s = s2
        runs[name] = (cfg, steps)
    return runs


def _replay(jcfg, steps, cfg):
    """The port's soup over the JAX run's generations, on its draws."""
    state = _port_state(steps[0][0])
    for g, (before, after, jev) in enumerate(steps):
        state, ev = st.evolve_step(cfg, state, _jax_draws(jcfg, before.key))
        for field in ("uids", "next_uid", "time"):
            np.testing.assert_array_equal(
                getattr(state, field).numpy(), np.asarray(getattr(after, field)),
                err_msg=f"generation {g}: {field}")
        np.testing.assert_array_equal(ev.action.numpy(), np.asarray(jev.action))
        np.testing.assert_array_equal(ev.counterpart.numpy(),
                                      np.asarray(jev.counterpart))
        np.testing.assert_allclose(state.weights.numpy(),
                                   np.asarray(after.weights), rtol=2e-5,
                                   atol=1e-6, err_msg=f"generation {g}")
        np.testing.assert_allclose(ev.loss.numpy(), np.asarray(jev.loss),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("port_impl", [
    dict(generation_impl="phases", train_impl="plain"),
    dict(generation_impl="phases", train_impl="kernel"),
    dict(generation_impl="fused")], ids=["phases", "phases-kernel", "fused"])
@pytest.mark.parametrize("jax_impl", ["phases", "fused"])
def test_soup_matches_jax(jax_run, jax_impl, port_impl):
    jcfg, steps = jax_run[jax_impl]
    _replay(jcfg, steps, _port_config(jcfg, **port_impl))


@pytest.mark.parametrize("port_impl", [
    dict(generation_impl="phases"),
    dict(generation_impl="phases", apply_impl="kernel",
         train_mode="full_batch"),
    dict(generation_impl="fused")], ids=["phases", "phases-spelled", "fused"])
@pytest.mark.parametrize("variant", list(VARIANT_TOPOS))
def test_variant_soup_matches_jax(jax_variant_runs, variant, port_impl):
    """The aggregating, fft and recurrent soups; 'phases-spelled' converts
    the JAX spellings apply_impl='pallas' (the recurrent attack's kernel,
    which the other variants refuse, as the JAX package does) and
    train_mode='full_batch', which select nothing new here (one sample per
    epoch).  The fused generation runs beside train_impl='plain': it
    already fuses the SGD kernel that the recurrent reference's
    train_impl='pallas' converts to, and refuses that spelling, as the JAX
    package does."""
    jcfg, steps = jax_variant_runs[variant]
    if variant != "recurrent":
        port_impl = {k: v for k, v in port_impl.items() if k != "apply_impl"}
    if port_impl["generation_impl"] == "fused":
        port_impl = {**port_impl, "train_impl": "plain"}
    _replay(jcfg, steps, _port_config(jcfg, **port_impl))


def test_counts_and_fixpoint_engine_match_jax(jax_run):
    jcfg, steps = jax_run["phases"]
    js = steps[-1][1]
    cfg = _port_config(jcfg)
    state = _port_state(js)
    np.testing.assert_array_equal(st.count(cfg, state).numpy(),
                                  np.asarray(jsoup.count(jcfg, js)))
    rng = np.random.default_rng(12)
    lim = st.init.glorot_limit_rows(cfg.topo)
    pop = (rng.uniform(-1, 1, (200, 14)) * lim).astype(np.float32)
    ref = jengine.run_fixpoint(jcfg.topo, jax.numpy.asarray(pop),
                               step_limit=40)
    got = st.run_fixpoint(cfg.topo, torch.from_numpy(pop), step_limit=40)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(ref.steps))


def test_port_soup_own_draws_and_fences():
    cfg = _port_config(JCFG, respawn_draws="fused")
    s0 = st.seed(cfg, 5, device="cpu")
    a = st.evolve(cfg, s0, 2)
    b = st.evolve(cfg._replace(generation_impl="fused"), s0, 2)
    # same seed, same draws: the two spellings agree, and s0 is untouched
    assert torch.equal(a.uids, b.uids)
    torch.testing.assert_close(a.weights, b.weights, rtol=2e-5, atol=1e-6)
    assert int(a.time) == 2 and int(s0.time) == 0
    assert int(torch.unique(a.uids).numel()) == cfg.size
    for bad in (dict(layout="columnar"), dict(population_dtype="f16"),
                dict(mode="sequential"), dict(attack_impl="compact"),
                dict(apply_impl="pallas"),
                dict(train_mode="full_batch", generation_impl="fused"),
                dict(train_impl="pallas"),
                dict(train_impl="kernel",
                     topo=st.Topology("weightwise", activation="elu")),
                dict(topo=st.Topology("aggregating", shuffler="random"))):
        with pytest.raises(ValueError):
            st.evolve_step(cfg._replace(**bad), s0)
    # the particles outside the kernels run on their routes (the autograd
    # chains; an associative recurrent one on K5's serial scan here)
    for topo in (st.Topology("weightwise", activation="elu"),
                 st.Topology("recurrent", rnn_scan="associative")):
        c = cfg._replace(topo=topo)
        assert int(st.evolve(c, st.seed(c, 5, device="cpu"), 1).time) == 1
    # the weightwise full batch runs on the phase chain (its plain step)
    assert int(st.evolve(cfg._replace(train_mode="full_batch"), s0,
                         1).time) == 1
    # apply_impl='kernel' is K6's, the recurrent attack's: refused for the
    # weightwise particle, and beside the fused generation, as the JAX
    # package refuses 'pallas'
    with pytest.raises(ValueError, match="RECURRENT"):
        st.evolve(cfg._replace(apply_impl="kernel"), s0, 2)
    for field in ("train_impl", "apply_impl"):
        with pytest.raises(ValueError, match="already fuses"):
            st.evolve(cfg._replace(generation_impl="fused", **{field:
                                                               "kernel"}),
                      s0, 1)
    n = cfg.size
    out_of_range = st.SoupDraws(np.ones(n, bool), np.full(n, n),
                                np.zeros(n, bool), np.zeros(n, int),
                                np.zeros((14, n), np.float32))
    with pytest.raises(ValueError, match="outside"):
        st.evolve_step(cfg, s0, out_of_range)
    with pytest.raises(ValueError, match="state.weights"):
        st.evolve_step(cfg._replace(size=n // 2), s0)
