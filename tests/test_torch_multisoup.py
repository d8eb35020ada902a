"""The mixed-type soup: the port's ``evolve_multi_step`` against the JAX
package's population-major one, fed the JAX package's own draws.

Two configurations: the four width-2 variants at sizes (6, 5, 4, 5), as in
tests/test_cross.py, and the weightwise / aggregating / recurrent thirds of
setups/mega_multisoup.py at small sizes.  The recurrent type runs sigmoid
(tests/test_torch_soup.py: with tanh the 17-step chain amplifies the two
packages' 1-ulp activation differences past any float bound).  The JAX
reference runs its XLA chains (``train_impl='xla'``, autodiff gradients):
with its Pallas kernels in interpret mode the two configurations take
about 210 s to compile on a cold cache against about 36 s, and the port
agrees with the XLA chains to 3.1e-6 relative in the weights at most, well
inside the tolerance below.  On the CPU the JAX package's fused spelling is
this phase chain; the port runs both of its spellings against it.  The draws are
replayed from the JAX state's key as ``multisoup._evolve_multi_popmajor``
makes them and handed to the port as numpy.  Integer state (uids,
next_uid, time, actions, counterparts) and ``count_multi`` must be equal;
weights within rtol 2e-5 / atol 1e-6, losses within rtol 1e-4 / atol 1e-6
(tests/test_fused_generation.py's generation tolerance).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import multisoup as jms
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
import srnn_tpu_torch as st
from srnn_tpu_torch import convert
from srnn_tpu_torch import multisoup as ms

GENERATIONS = 3
SIG_RNN = JTopology("recurrent", width=2, depth=2, activation="sigmoid")
CONFIGS = {
    "four": jms.MultiSoupConfig(
        topos=(JTopology("weightwise", width=2, depth=2),
               JTopology("aggregating", width=2, depth=2, aggregates=4),
               JTopology("fft", width=2, depth=2, aggregates=4), SIG_RNN),
        sizes=(6, 5, 4, 5), attacking_rate=0.5, learn_from_rate=0.3,
        learn_from_severity=2, train=2, remove_divergent=True,
        remove_zero=True, layout="popmajor"),
    "mega": jms.MultiSoupConfig(
        topos=(JTopology("weightwise", width=2, depth=2),
               JTopology("aggregating", width=2, depth=2, aggregates=4),
               SIG_RNN),
        sizes=(12, 11, 11), attacking_rate=0.3, learn_from_rate=0.3,
        learn_from_severity=1, train=2, remove_divergent=True,
        remove_zero=True, layout="popmajor"),
}


def jax_multi_draws(cfg, key) -> ms.MultiSoupDraws:
    """The draws of one JAX popmajor mixed generation
    (multisoup.py:306-407)."""
    n = cfg.total
    _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
    re_keys = jax.random.split(k_re, len(cfg.topos))
    return ms.MultiSoupDraws(
        np.asarray(jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate),
        np.asarray(jax.random.randint(k_at, (n,), 0, n)),
        np.asarray(jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate),
        tuple(np.asarray(jax.random.randint(jax.random.fold_in(k_lt, t),
                                            (n_t,), 0, n_t))
              for t, n_t in enumerate(cfg.sizes)),
        tuple(np.asarray(j_fresh_lanes(topo, re_keys[t], n_t,
                                       cfg.respawn_draws))
              for t, (topo, n_t) in enumerate(zip(cfg.topos, cfg.sizes))))


def port_multi_config(jcfg, **kw):
    fields = jcfg._asdict()
    fields["topos"] = [dataclasses.asdict(t) for t in jcfg.topos]
    return convert.multisoup_config_from_fields(fields)._replace(**kw)


def port_multi_state(js):
    return convert.multisoup_state_from_arrays(
        [np.asarray(w) for w in js.weights], [np.asarray(u) for u in js.uids],
        int(js.next_uid), int(js.time), device="cpu",
        scales=None if js.scales is None
        else [np.asarray(s) for s in js.scales])


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request):
    """Three JAX generations of one configuration: (config,
    [(state_before, state_after, events)]).  One configuration per
    fixture instance, so a test worker compiles only the one it runs."""
    cfg = CONFIGS[request.param]
    s = jms.seed_multi(cfg, jax.random.key(3))
    steps = []
    for _ in range(GENERATIONS):
        s2, ev = jms.evolve_multi_step(cfg, s)
        steps.append((s, s2, ev))
        s = s2
    return cfg, steps


@pytest.mark.parametrize("impl", ["phases", "fused"])
def test_multisoup_matches_jax(jax_run, impl):
    jcfg, steps = jax_run
    cfg = port_multi_config(jcfg, generation_impl=impl)
    assert ms.resolved_generation_impl(cfg, cfg.topos[0]) == impl
    state = port_multi_state(steps[0][0])
    for g, (before, after, jev) in enumerate(steps):
        state, ev = ms.evolve_multi_step(cfg, state,
                                         jax_multi_draws(jcfg, before.key))
        for field in ("next_uid", "time"):
            assert int(getattr(state, field)) == int(getattr(after, field))
        for t in range(len(cfg.topos)):
            msg = f"generation {g} type {t}"
            np.testing.assert_array_equal(state.uids[t].numpy(),
                                          np.asarray(after.uids[t]), msg)
            np.testing.assert_array_equal(ev.action[t].numpy(),
                                          np.asarray(jev.action[t]), msg)
            np.testing.assert_array_equal(ev.counterpart[t].numpy(),
                                          np.asarray(jev.counterpart[t]), msg)
            np.testing.assert_allclose(state.weights[t].numpy(),
                                       np.asarray(after.weights[t]),
                                       rtol=2e-5, atol=1e-6, err_msg=msg)
            np.testing.assert_allclose(ev.loss[t].numpy(),
                                       np.asarray(jev.loss[t]), rtol=1e-4,
                                       atol=1e-6, err_msg=msg)
    np.testing.assert_array_equal(
        ms.count_multi(cfg, state).numpy(),
        np.asarray(jms.count_multi(jcfg, steps[-1][1])))


def test_multisoup_own_draws_and_fences():
    """On its own generator: both routes agree (bitwise wherever the
    phase chain and K3's plain version compute alike), uids stay globally
    unique, the state passed in is left as it was; the fences raise."""
    cfg = port_multi_config(CONFIGS["mega"], respawn_draws="fused")
    s0 = ms.seed_multi(cfg, 5, device="cpu")
    a = ms.evolve_multi(cfg, s0, 3)
    b = ms.evolve_multi(cfg._replace(generation_impl="fused"), s0, 3)
    for t in range(3):
        assert torch.equal(a.uids[t], b.uids[t])
        torch.testing.assert_close(a.weights[t], b.weights[t], rtol=2e-5,
                                   atol=1e-6)
    uids = torch.cat(a.uids)
    assert int(torch.unique(uids).numel()) == cfg.total
    assert int(uids.max()) < int(a.next_uid)
    assert int(a.time) == 3 and int(s0.time) == 0
    counts = ms.count_multi(cfg, a)
    assert counts.shape == (3, 5)
    assert counts.sum(dim=1).tolist() == list(cfg.sizes)
    assert ms.fused_supported_multi(cfg)
    for bad in (dict(layout="rowmajor", generation_impl="fused"),
                dict(layout="columnar"), dict(population_dtype="f16"),
                dict(sizes=(12, 11)), dict(sizes=(12, 0, 11)),
                dict(topos=(st.Topology("weightwise"),
                            st.Topology("aggregating", shuffler="random"),
                            st.Topology("recurrent")))):
        with pytest.raises(ValueError):
            ms.evolve_multi_step(cfg._replace(**bad), s0)
    # the row-major layout runs (tests/test_torch_multisoup_rowmajor.py),
    # and refuses the fused spelling, as the JAX package's does
    row = cfg._replace(layout="rowmajor")
    assert int(ms.evolve_multi(row, ms.seed_multi(row, 0, device="cpu"),
                               1).time) == 1
    with pytest.raises(ValueError, match="megakernel"):
        ms.seed_multi(row._replace(generation_impl="fused"), 0, device="cpu")
    assert not ms.fused_supported_multi(row)
