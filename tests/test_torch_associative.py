"""``rnn_scan='associative'`` on the CPU against the JAX package.

The port's associative scan (``nets/recurrent._forward_associative``)
follows ``jax.lax.associative_scan``'s recursion with explicit multiply-add
chains; the JAX package's combine runs XLA dots, which sum otherwise, so
the two agree within rtol 1e-5 / atol 1e-6 (the bound
tests/test_apply.py holds the JAX package's associative scan to against
its serial one), not bitwise.  Held: the transform at (width, depth) =
(2, 2), (3, 1) and (4, 3) as tests/test_apply.py does, for one net and a
batch; one train step, which differentiates through the associative
forward (the row-major autograd route); the row-major soup a generation
at a time from JAX's state (the linear recurrence amplifies last bits over
generations): integers exact, losses rtol 1e-4 / atol 1e-6, weights rtol
5e-5 / atol 1e-6 -- the generation bound of the other soups, 2e-5, is
exceeded by 2.1e-5 on a particle whose self-training drives its weights
to 3.3e4 in the second generation, where the two scans' reassociated
products and their gradients round apart; ``run_fixpoint``'s integer
results exactly.  The
population-major soup runs the serial scan, as the JAX package's does, so
it is the sequential-scan soup bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import engine as jengine
from srnn_tpu import soup as jsoup
from srnn_tpu import train as jtrain
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
from srnn_tpu.nets import apply_to_weights as j_apply
import srnn_tpu_torch as st
from srnn_tpu_torch import convert, engine, train
from srnn_tpu_torch.nets import apply_to_weights

APPLY_TOL = dict(rtol=1e-5, atol=1e-6)
W_TOL = dict(rtol=2e-5, atol=1e-6)
SOUP_TOL = dict(rtol=5e-5, atol=1e-6)
L_TOL = dict(rtol=1e-4, atol=1e-6)
N = 12


def _jt(topo) -> JTopology:
    return JTopology(**dataclasses.asdict(topo))


@pytest.mark.parametrize("width,depth", [(2, 2), (3, 1), (4, 3)])
def test_associative_transform_matches_jax(width, depth):
    topo = st.Topology("recurrent", width=width, depth=depth,
                       rnn_scan="associative")
    rng = np.random.default_rng(10)
    p = topo.num_weights
    w = (rng.normal(size=(4, p)) * 0.3).astype(np.float32)
    x = rng.normal(size=(4, p)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda a, b: j_apply(_jt(topo), a,
                                                           b)))(
        jnp.asarray(w), jnp.asarray(x)))
    got = apply_to_weights(topo, torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **APPLY_TOL)
    one = apply_to_weights(topo, torch.from_numpy(w[0]),
                           torch.from_numpy(x[0]))
    assert torch.equal(one, got[0])
    serial = apply_to_weights(dataclasses.replace(topo, rnn_scan="sequential"),
                              torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), serial.numpy(), **APPLY_TOL)


def test_associative_train_matches_jax():
    """One train step and one learn_from, autograd through the
    associative forward, against the JAX package's."""
    topo = st.Topology("recurrent", rnn_scan="associative")
    rng = np.random.default_rng(12)
    w = rng.uniform(-0.8, 0.8, (N, topo.num_weights)).astype(np.float32)
    o = rng.uniform(-0.8, 0.8, (N, topo.num_weights)).astype(np.float32)
    jt = _jt(topo)
    ref = jax.jit(jax.vmap(lambda a, b: (jtrain.train_step(jt, a),
                                         jtrain.learn_from(jt, a, b))))(
        jnp.asarray(w), jnp.asarray(o))
    got = (train.train_step(topo, torch.from_numpy(w)),
           train.learn_from(topo, torch.from_numpy(w), torch.from_numpy(o)))
    for (gw, gl), (rw, rl) in zip(got, ref):
        np.testing.assert_allclose(gw.numpy(), np.asarray(rw), **W_TOL)
        np.testing.assert_allclose(gl.numpy(), np.asarray(rl), **L_TOL)


JCFG = jsoup.SoupConfig(
    topo=JTopology("recurrent", rnn_scan="associative"), size=N,
    attacking_rate=0.3, learn_from_rate=0.3, learn_from_severity=1, train=2,
    remove_divergent=True, remove_zero=True)


@jax.jit
def _jax_draws(key):
    """One JAX generation's draws (``soup.py:341-386``)."""
    n = JCFG.size
    _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
    return (jax.random.uniform(k_ag, (n,)) < JCFG.attacking_rate,
            jax.random.randint(k_at, (n,), 0, n),
            jax.random.uniform(k_lg, (n,)) < JCFG.learn_from_rate,
            jax.random.randint(k_lt, (n,), 0, n),
            j_fresh_lanes(JCFG.topo, k_re, n, JCFG.respawn_draws))


def _port_state(js):
    return convert.soup_state_from_arrays(
        np.asarray(js.weights), np.asarray(js.uids), int(js.next_uid),
        int(js.time), device="cpu")


def test_rowmajor_associative_soup_matches_jax():
    fields = JCFG._asdict()
    fields["topo"] = dataclasses.asdict(JCFG.topo)
    cfg = convert.soup_config_from_fields(fields)
    rng = np.random.default_rng(13)
    w = rng.uniform(-0.6, 0.6, (N, JCFG.topo.num_weights)).astype(np.float32)
    w[0] = 0.0
    w[1, 4] = np.inf
    s = jsoup.SoupState(jnp.asarray(w), jnp.arange(N, dtype=jnp.int32),
                        jnp.int32(N), jnp.int32(0), jax.random.key(4))
    for g in range(2):
        s2, jev = jsoup.evolve_step(JCFG, s)
        draws = st.SoupDraws(*(np.asarray(a) for a in _jax_draws(s.key)))
        got, ev = st.evolve_step(cfg, _port_state(s), draws)
        msg = f"generation {g}"
        np.testing.assert_array_equal(got.uids.numpy(), np.asarray(s2.uids),
                                      msg)
        np.testing.assert_array_equal(ev.action.numpy(),
                                      np.asarray(jev.action), msg)
        np.testing.assert_allclose(got.weights.numpy(),
                                   np.asarray(s2.weights), **SOUP_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(ev.loss.numpy(), np.asarray(jev.loss),
                                   **L_TOL, err_msg=msg)
        s = s2
    np.testing.assert_array_equal(st.count(cfg, _port_state(s)).numpy(),
                                  np.asarray(jsoup.count(JCFG, s)))


def test_associative_fixpoint_engine_matches_jax():
    topo = st.Topology("recurrent", rnn_scan="associative")
    rng = np.random.default_rng(14)
    pop = rng.uniform(-0.5, 0.5, (16, topo.num_weights)).astype(np.float32)
    pop[0] = 0.0
    ref = jengine.run_fixpoint(_jt(topo), jnp.asarray(pop), step_limit=20)
    got = engine.run_fixpoint(topo, torch.from_numpy(pop), step_limit=20)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(ref.steps))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(ref.classes))


def test_popmajor_associative_soup_is_the_serial_one():
    """The population-major recurrence is the serial scan for either
    rnn_scan (K5's and K6's plain versions here), as in the JAX package."""
    base = st.SoupConfig(topo=st.Topology("recurrent"), size=N,
                         attacking_rate=0.3, learn_from_rate=0.3, train=2,
                         remove_divergent=True, remove_zero=True,
                         layout="popmajor")
    assoc = base._replace(topo=st.Topology("recurrent",
                                           rnn_scan="associative"))
    s0 = st.seed(base, 2, device="cpu")
    for impl in ("phases", "fused"):
        a = st.evolve(base._replace(generation_impl=impl), s0, 2)
        b = st.evolve(assoc._replace(generation_impl=impl), s0, 2)
        assert torch.equal(a.weights, b.weights)
        assert torch.equal(a.uids, b.uids)
