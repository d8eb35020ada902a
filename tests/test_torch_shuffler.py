"""``shuffler='random'`` on the CPU against the JAX package.

The JAX package permutes a transform's output with
``jax.random.permutation(key, flat)``; the port takes the permutation
itself (``perm=``: ``out[..., i] = flat[..., perm[..., i]]``) or draws one
per particle from a ``torch.Generator`` (``generator=``).  Fed
``jax.random.permutation(key, P)``, the aggregating, fft and cross
transforms and the network verbs agree with the JAX package's within rtol
1e-5 / atol 1e-6 (tests/test_torch_variants.py's transform bound; the
permutation itself moves no bit).

The soups mirror the JAX package's refusals exactly: wherever it raises
(a population-major soup or mixed soup, whose per-lane permutation it
refuses; a row-major attack or classification, which passes no key; the
engines' transforms), the port raises ``ValueError``; wherever it runs (a
row-major soup that does not attack, a weightwise particle, which no
shuffler touches), the port runs and agrees with it, a generation at a
time from JAX's state: integers exact, weights rtol 2e-5 / atol 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import engine as jengine
from srnn_tpu import multisoup as jms
from srnn_tpu import netops as jnetops
from srnn_tpu import soup as jsoup
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
from srnn_tpu.nets import apply_to_weights as j_apply
from srnn_tpu.nets.cross import cross_apply as j_cross
import srnn_tpu_torch as st
from srnn_tpu_torch import convert, engine, netops
from srnn_tpu_torch import multisoup as ms
from srnn_tpu_torch.nets import apply_to_weights
from srnn_tpu_torch.nets.cross import cross_apply

TOL = dict(rtol=1e-5, atol=1e-6)
W_TOL = dict(rtol=2e-5, atol=1e-6)
B = 5


def _jt(topo) -> JTopology:
    return JTopology(**dataclasses.asdict(topo))


def _rows(n, p, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, p)) * scale).astype(np.float32)


def _perms(keys, p) -> np.ndarray:
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, p))(keys))


@pytest.mark.parametrize("attacker,victim", [
    (st.Topology("aggregating", shuffler="random"), None),
    (st.Topology("aggregating", shuffler="random", aggregator="max"), None),
    (st.Topology("fft", shuffler="random"), None),
    (st.Topology("fft", shuffler="random", fft_mode="rfft",
                 fft_use_target=True), None),
    (st.Topology("aggregating", shuffler="random"),
     st.Topology("weightwise")),
    (st.Topology("fft", shuffler="random"), st.Topology("recurrent"))],
    ids=["agg-average", "agg-max", "fft", "rfft-target", "cross-agg-ww",
         "cross-fft-rnn"])
def test_shuffled_transform_matches_jax(attacker, victim):
    """One key per particle; the port gets JAX's permutations."""
    vic = victim or attacker
    a = _rows(B, attacker.num_weights, 1)
    v = _rows(B, vic.num_weights, 2)
    keys = jax.random.split(jax.random.key(7), B)
    ja, jv = _jt(attacker), _jt(vic)
    if victim is None:
        fn = jax.jit(jax.vmap(lambda x, y, k: j_apply(ja, x, y, k)))
    else:
        fn = jax.jit(jax.vmap(lambda x, y, k: j_cross(ja, x, jv, y, k)))
    ref = np.asarray(fn(jnp.asarray(a), jnp.asarray(v), keys))
    perm = _perms(keys, vic.num_weights)
    if victim is None:
        got = apply_to_weights(attacker, torch.from_numpy(a),
                               torch.from_numpy(v), perm=perm)
    else:
        got = cross_apply(attacker, torch.from_numpy(a), vic,
                          torch.from_numpy(v), perm=perm)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the permutation acts, and only permutes
    plain = apply_to_weights(dataclasses.replace(attacker, shuffler="not"),
                             torch.from_numpy(a), torch.from_numpy(v)) \
        if victim is None else cross_apply(
            dataclasses.replace(attacker, shuffler="not"),
            torch.from_numpy(a), vic, torch.from_numpy(v))
    assert torch.equal(got.sort(dim=-1).values, plain.sort(dim=-1).values)
    with pytest.raises(ValueError, match="PRNG key"):
        apply_to_weights(attacker, torch.from_numpy(a), torch.from_numpy(v)) \
            if victim is None else cross_apply(
                attacker, torch.from_numpy(a), vic, torch.from_numpy(v))


def test_netops_and_generator_match_jax():
    """``self_attack`` splits its key per iteration; the verbs take one
    key; a generator draws one uniform permutation per particle."""
    topo = st.Topology("aggregating", shuffler="random")
    p = topo.num_weights
    w = _rows(1, p, 3)[0]
    key = jax.random.key(11)
    ref = np.asarray(jax.jit(lambda x, k: jnetops.self_attack(
        _jt(topo), x, 3, k))(jnp.asarray(w), key))
    perms = _perms(jax.random.split(key, 3), p)
    got = netops.self_attack(topo, torch.from_numpy(w), 3, perm=perms)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    o = _rows(1, p, 4)[0]
    ref = np.asarray(jax.jit(lambda x, y, k: jnetops.attack(
        _jt(topo), x, y, k))(jnp.asarray(w), jnp.asarray(o), key))
    perm = _perms(key[None], p)[0]
    for verb in (netops.attack, netops.fuck, netops.meet):
        got = verb(topo, torch.from_numpy(w), torch.from_numpy(o), perm=perm)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # a generator's draw is the permutation it stands for
    x = torch.from_numpy(_rows(B, p, 5))
    g1, g2 = (torch.Generator().manual_seed(6) for _ in range(2))
    drawn = apply_to_weights(topo, x, x, generator=g1)
    from srnn_tpu_torch.nets.aggregating import random_perm
    perm = random_perm(g2, (B,), p, "cpu")
    assert torch.equal(drawn, apply_to_weights(topo, x, x, perm=perm))
    assert torch.equal(perm.sort(dim=-1).values,
                       torch.arange(p).expand(B, p))


N = 8
AGG = st.Topology("aggregating", shuffler="random")
WW = st.Topology("weightwise", shuffler="random")


def _jax_soup_state(topo, seed):
    w = _rows(N, topo.num_weights, seed)
    return jsoup.SoupState(jnp.asarray(w), jnp.arange(N, dtype=jnp.int32),
                           jnp.int32(N), jnp.int32(0), jax.random.key(seed))


def _soup_cfgs(topo, **kw):
    base = dict(size=N, attacking_rate=0.3, learn_from_rate=0.3, train=1,
                remove_divergent=True, remove_zero=True)
    base.update(kw)
    return (jsoup.SoupConfig(topo=_jt(topo), **base),
            st.SoupConfig(topo=topo, **base))


def _multi_cfgs(**kw):
    topos = (st.Topology("weightwise"), AGG)
    base = dict(sizes=(4, 4), train=1, **kw)
    return (jms.MultiSoupConfig(topos=tuple(_jt(t) for t in topos), **base),
            ms.MultiSoupConfig(topos=topos, **base))


REFUSED = {
    "soup-popmajor": lambda: _soup_cfgs(AGG, layout="popmajor"),
    "soup-popmajor-weightwise": lambda: _soup_cfgs(WW, layout="popmajor"),
    "soup-rowmajor-attack": lambda: _soup_cfgs(AGG),
    "multi-popmajor": lambda: _multi_cfgs(layout="popmajor"),
    "multi-rowmajor-attack": lambda: _multi_cfgs(),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_soup_refusals_match_jax(name):
    jcfg, cfg = REFUSED[name]()
    if name.startswith("soup"):
        with pytest.raises(ValueError, match="shuffler="):
            jsoup.evolve_step(jcfg, _jax_soup_state(cfg.topo, 1))
        with pytest.raises(ValueError, match="shuffler="):
            st.evolve_step(cfg, st.seed(cfg._replace(layout="rowmajor",
                                                     attacking_rate=0.0),
                                        1, device="cpu"))
        return
    js = jms.MultiSoupState(
        tuple(jnp.asarray(_rows(n, t.num_weights, 2))
              for t, n in zip(jcfg.topos, jcfg.sizes)),
        (jnp.arange(4, dtype=jnp.int32), jnp.arange(4, 8, dtype=jnp.int32)),
        jnp.int32(8), jnp.int32(0), jax.random.key(2))
    with pytest.raises(ValueError, match="shuffler="):
        jms.evolve_multi_step(jcfg, js)
    s = ms.seed_multi(cfg._replace(layout="rowmajor", attacking_rate=0.0),
                      2, device="cpu")
    with pytest.raises(ValueError, match="shuffler="):
        ms.evolve_multi_step(cfg, s)


def test_engines_and_count_refuse_like_jax():
    pop = _rows(N, AGG.num_weights, 3)
    with pytest.raises(ValueError, match="shuffler="):
        jengine.run_fixpoint(_jt(AGG), jnp.asarray(pop), step_limit=2)
    for fn in (engine.run_fixpoint, engine.run_training,
               engine.run_known_fixpoint_variation,
               engine.fixpoint_density):
        with pytest.raises(ValueError, match="shuffler="):
            fn(AGG, torch.from_numpy(pop))
    jcfg, cfg = _soup_cfgs(AGG, attacking_rate=0.0)
    with pytest.raises(ValueError, match="shuffler="):
        jsoup.count(jcfg, _jax_soup_state(AGG, 4))
    with pytest.raises(ValueError, match="shuffler="):
        st.count(cfg, st.seed(cfg, 4, device="cpu"))


@functools.lru_cache(maxsize=None)
def _draws_fn(jcfg):
    """One JAX row-major generation's draws (``soup.py:341-386``),
    jitted once per config."""
    n = jcfg.size

    @jax.jit
    def draws(key):
        _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
        return (jax.random.uniform(k_ag, (n,)) < jcfg.attacking_rate,
                jax.random.randint(k_at, (n,), 0, n),
                jax.random.uniform(k_lg, (n,)) < jcfg.learn_from_rate,
                jax.random.randint(k_lt, (n,), 0, n),
                j_fresh_lanes(jcfg.topo, k_re, n, jcfg.respawn_draws))

    return lambda key: st.SoupDraws(*(np.asarray(a) for a in draws(key)))


@pytest.mark.parametrize("topo,rate", [(AGG, 0.0), (WW, 0.3)],
                         ids=["agg-no-attack", "weightwise-attack"])
def test_soups_that_jax_runs(topo, rate):
    """Where the JAX package's row-major soup runs with a random shuffler,
    the port's runs and agrees with it."""
    jcfg, _ = _soup_cfgs(topo, attacking_rate=rate)
    fields = jcfg._asdict()
    fields["topo"] = dataclasses.asdict(jcfg.topo)
    cfg = convert.soup_config_from_fields(fields)
    s = _jax_soup_state(topo, 5)
    for g in range(2):
        s2, jev = jsoup.evolve_step(jcfg, s)
        got, ev = st.evolve_step(cfg, convert.soup_state_from_arrays(
            np.asarray(s.weights), np.asarray(s.uids), int(s.next_uid),
            int(s.time), device="cpu"), _draws_fn(jcfg)(s.key))
        np.testing.assert_array_equal(got.uids.numpy(), np.asarray(s2.uids))
        np.testing.assert_array_equal(ev.action.numpy(),
                                      np.asarray(jev.action))
        np.testing.assert_allclose(got.weights.numpy(),
                                   np.asarray(s2.weights), **W_TOL)
        s = s2
