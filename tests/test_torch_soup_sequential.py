"""The port's sequential soup (``mode='sequential'``, the reference's
strict particle-by-particle order) against the JAX package's
``_evolve_sequential`` (``srnn_tpu/soup.py:880-943``), fed the JAX
package's own per-particle draws.

Three JAX configurations, one compile each in a module-scoped fixture:
weightwise, aggregating, and recurrent with sigmoid (whose slope of at
most 1/4 damps rounding noise along the 17-step chain,
tests/test_torch_soup_rowmajor.py); 10 particles, 3 generations of attack
0.3, learn_from 0.3, train 2, both removals.  Both packages start from the
port's seed with particle 0 all zero and particle 1 diverged, so that both
respawns happen.  The weightwise full batch in this mode is
tests/test_torch_full_batch.py's.  The draws are replayed from the JAX
state's key as the JAX scan makes them: particle i's five keys split from
the i-th of ``split(k_gen, N)``.

Bounds (tests/test_torch_soup.py): integer state (uids, next_uid, time,
actions, counterparts) exact; float32 weights rtol 2e-5 / atol 1e-6 every
generation with the non-finite pattern exact, losses rtol 1e-4 / atol
1e-6.  The JAX oracles mirrored: tests/test_soup.py:150, :161, :172.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import soup as jsoup
from srnn_tpu.init import init_population as j_init_population
import srnn_tpu_torch as st
from srnn_tpu_torch import convert
from srnn_tpu_torch import soup as psoup
from srnn_tpu_torch.nets.dispatch import apply_to_weights

GENERATIONS = 3
N = 10
JCFG = jsoup.SoupConfig(
    topo=JTopology("weightwise", width=2, depth=2), size=N,
    attacking_rate=0.3, learn_from_rate=0.3, learn_from_severity=1, train=2,
    remove_divergent=True, remove_zero=True, mode="sequential")
CONFIGS = {
    "weightwise": JCFG,
    "aggregating": JCFG._replace(topo=JTopology(
        "aggregating", width=2, depth=2, aggregates=4)),
    "recurrent": JCFG._replace(topo=JTopology(
        "recurrent", width=2, depth=2, activation="sigmoid")),
}


def jax_sequential_draws(cfg):
    """A function of the state's key giving one JAX sequential generation's
    per-particle draws as ``SoupDraws`` (``soup.py:886-921``), jitted."""
    n = cfg.size

    def draws(key):
        _, k_gen = jax.random.split(key)
        ks = jax.vmap(lambda k: jax.random.split(k, 5))(
            jax.random.split(k_gen, n))
        return (
            jax.vmap(jax.random.uniform)(ks[:, 0]) < cfg.attacking_rate,
            jax.vmap(lambda k: jax.random.randint(k, (), 0, n))(ks[:, 1]),
            jax.vmap(jax.random.uniform)(ks[:, 2]) < cfg.learn_from_rate,
            jax.vmap(lambda k: jax.random.randint(k, (), 0, n))(ks[:, 3]),
            jax.vmap(lambda k: j_init_population(cfg.topo, k, 1)[0])(
                ks[:, 4]).T)

    jitted = jax.jit(draws)
    return lambda key: st.SoupDraws(*(np.asarray(x) for x in jitted(key)))


def port_config(jcfg, **kw):
    fields = jcfg._asdict()
    fields["topo"] = dataclasses.asdict(jcfg.topo)
    return convert.soup_config_from_fields(fields)._replace(**kw)


def start(jcfg, seed=1):
    """The port's seed with particle 0 all zero and particle 1 diverged,
    and the same state as the JAX package's."""
    ps = st.seed(port_config(jcfg), seed, device="cpu")
    w = ps.weights.clone()
    w[0] = 0
    w[1, 3] = float("inf")
    ps = ps._replace(weights=w)
    js = jsoup.SoupState(jnp.asarray(w.numpy()), jnp.asarray(ps.uids.numpy()),
                         jnp.int32(jcfg.size), jnp.int32(0),
                         jax.random.key(seed))
    return ps, js


def jax_generations(jcfg, draws_of, js):
    """[(the generation's draws, state after, events)] of JAX's
    ``evolve_step``, generation by generation."""
    steps = []
    for _ in range(GENERATIONS):
        js2, ev = jsoup.evolve_step(jcfg, js)
        steps.append((draws_of(js.key), js2, ev))
        js = js2
    return steps


def check_generation(state, ev, after, jev, msg):
    """One port generation against JAX's: integers exact, the non-finite
    pattern exact, finite weights and losses within the bounds."""
    assert int(state.next_uid) == int(after.next_uid), msg
    assert int(state.time) == int(after.time), msg
    np.testing.assert_array_equal(state.uids.numpy(), np.asarray(after.uids),
                                  msg)
    np.testing.assert_array_equal(ev.action.numpy(), np.asarray(jev.action),
                                  msg)
    np.testing.assert_array_equal(ev.counterpart.numpy(),
                                  np.asarray(jev.counterpart), msg)
    np.testing.assert_allclose(state.weights.numpy(),
                               np.asarray(after.weights), rtol=2e-5,
                               atol=1e-6, err_msg=msg)
    np.testing.assert_allclose(ev.loss.numpy(), np.asarray(jev.loss),
                               rtol=1e-4, atol=1e-6, err_msg=msg)


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request):
    """(name, JAX config, the port's start, JAX's generations)."""
    jcfg = CONFIGS[request.param]
    ps, js = start(jcfg)
    return (request.param, jcfg, ps,
            jax_generations(jcfg, jax_sequential_draws(jcfg), js))


def test_sequential_soup_matches_jax(jax_run):
    """The port's sequential ``evolve_step`` chain on JAX's per-particle
    draws against JAX's ``_evolve_sequential``, generation by
    generation."""
    name, jcfg, state, steps = jax_run
    cfg = port_config(jcfg)
    assert (cfg.mode, cfg.layout) == ("sequential", "rowmajor")
    for g, (draws, after, jev) in enumerate(steps):
        state, ev = st.evolve_step(cfg, state, draws)
        check_generation(state, ev, after, jev, f"{name} gen {g}")
    assert int(state.next_uid) > N  # the planted particles respawned


def test_sequential_evolve_record(jax_run, monkeypatch):
    """``evolve(record=True)`` in the sequential mode, its draws replaced
    by JAX's: its record equals the step chain's bitwise and JAX's
    generations within the bounds; the caller's state is left as it
    was."""
    name, jcfg, start_state, steps = jax_run
    cfg = port_config(jcfg)
    feed = iter([dr for dr, _, _ in steps])
    monkeypatch.setattr(psoup, "draw", lambda config, gen, device:
                        psoup._resolve_draws(config, gen, device, next(feed)))
    final, (ev, w, uids) = st.evolve(cfg, start_state, GENERATIONS,
                                     record=True)
    assert int(start_state.time) == 0
    assert w.shape == (GENERATIONS, N, cfg.topo.num_weights)
    for g, (_, after, jev) in enumerate(steps):
        state = final._replace(weights=w[g], uids=uids[g],
                               next_uid=after.next_uid, time=after.time)
        check_generation(state, psoup.SoupEvents(*(e[g] for e in ev)), after,
                         jev, f"{name} record gen {g}")
    assert torch.equal(w[-1], final.weights) and torch.equal(uids[-1],
                                                             final.uids)


def _draws(n, p, attack=(), learn=()):
    """Hand-made draws: ``attack`` / ``learn`` are (particle, target)
    pairs; fresh replacements all 0.5."""
    d = [np.zeros(n, bool), np.zeros(n, int), np.zeros(n, bool),
         np.zeros(n, int)]
    for i, t in attack:
        d[0][i], d[1][i] = True, t
    for i, t in learn:
        d[2][i], d[3][i] = True, t
    return st.SoupDraws(*d, np.full((p, n), 0.5, np.float32))


def test_in_generation_chain_and_uid_quirk():
    """An earlier particle's attack this generation is what a later one
    reads (tests/test_soup.py:161), and the event record reads a
    counterpart's uid after the acting particle's own respawn, as the JAX
    scan does: particle 0 dies (all zero) and takes uid 3 before particle
    1, which attacks it, records its counterpart."""
    topo = st.Topology("weightwise", width=2, depth=2)
    cfg = st.SoupConfig(topo=topo, size=3, attacking_rate=1.0,
                        learn_from_rate=0.0, train=0, remove_zero=True,
                        mode="sequential")
    s0 = st.seed(cfg, 4, device="cpu")
    w = s0.weights.clone()
    w[0] = 0
    s0 = s0._replace(weights=w)
    s1, ev = st.evolve_step(cfg, s0, _draws(3, 14, attack=[(1, 0), (2, 1)]))
    assert ev.action.tolist() == [psoup.ACT_ZERO_DEAD, psoup.ACT_ATTACK,
                                  psoup.ACT_ATTACK]
    assert ev.counterpart.tolist() == [3, 3, 1]
    assert s1.uids.tolist() == [3, 1, 2] and int(s1.next_uid) == 4
    # particle 0 respawned (0.5 everywhere), then particle 1 rewrote it;
    # particle 2 rewrote particle 1, which particle 1's attack left alone
    fresh = torch.full((14,), 0.5)
    assert torch.equal(s1.weights[0], apply_to_weights(topo, w[1], fresh))
    assert torch.equal(s1.weights[1], apply_to_weights(topo, w[2], w[1]))
    assert torch.equal(s1.weights[2], w[2])
    # with rate 1 everyone attacks (the JAX oracle's own check)
    cfg = cfg._replace(size=12, remove_zero=False)
    _, ev = st.evolve_step(cfg, st.seed(cfg, 11, device="cpu"))
    assert ev.action.tolist() == [psoup.ACT_ATTACK] * 12


def test_attack_only_soup_leaves_other():
    """Without respawn, repeated attack drives the soup to zero or
    divergence in the sequential mode too (tests/test_soup.py:172)."""
    topo = st.Topology("weightwise", width=2, depth=2)
    cfg = st.SoupConfig(topo=topo, size=16, attacking_rate=0.5,
                        learn_from_rate=0.0, train=0, mode="sequential")
    final = st.evolve(cfg, st.seed(cfg, 12, device="cpu"), 60)
    assert int(st.count(cfg, final)[4]) < 8  # class 'other'


def test_sequential_refusals_are_jaxs():
    """The JAX package's refusals of the sequential mode, each raised by
    both packages: fused respawn draws, bfloat16 and int8 populations, the
    population-major layout; and the port's: no trial axis."""
    ps, js = start(JCFG)
    cfg = port_config(JCFG)
    for bad, match in ((dict(respawn_draws="fused"), "respawn_draws"),
                       (dict(population_dtype="bf16"), "population_dtype"),
                       (dict(population_dtype="int8"), "population_dtype"),
                       (dict(layout="popmajor"), "mode='parallel'")):
        with pytest.raises(ValueError, match=match):
            jsoup.evolve_step(JCFG._replace(**bad), js)
        with pytest.raises(ValueError, match=match):
            st.evolve_step(cfg._replace(**bad), ps)
        with pytest.raises(ValueError, match=match):
            st.evolve(cfg._replace(**bad), ps, 1)
    with pytest.raises(ValueError, match="stacked"):
        st.evolve(cfg, psoup.stack([ps, ps]), 1)
    with pytest.raises(ValueError, match="state.weights"):
        st.evolve_step(cfg._replace(size=N // 2), ps)
