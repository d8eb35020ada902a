"""The route rule and the autograd route: every particle the JAX package
trains runs in the port, on the CPU against the JAX package.

* The route each particle's train phase takes (``ops/popmajor.train_route``
  / ``resolved_train_impl``) is the JAX package's resolution
  (``resolved_train_impl(topo, mode, 'pallas')``) read through the names:
  'pallas' is the port's 'kernel', 'xla' its 'plain' (the weightwise full
  batch's hand-derived step) or 'autograd'.  The port's kernels take the
  JAX package's Pallas envelope (any topology up to 64 weights), so a
  particle off the width-2 / depth-2 grid takes the kernel in both.
* ``train_impl='kernel'`` raises wherever the JAX package's 'pallas' soup
  raises.
* Soups of particles outside the kernels (elu weightwise of width 3 /
  depth 3; gelu weightwise in the full batch; softmax aggregating with 6
  aggregates; swish recurrent), converted from JAX configs with
  ``convert.py``, against the JAX
  package's ``evolve_step`` on its own draws, held a generation at a time
  from JAX's state (gelu and swish amplify the two packages' last-bit
  activation differences over generations): integers exact, weights rtol
  2e-5 / atol 1e-6, losses rtol 1e-4 / atol 1e-6.  softmax runs
  row-major: the JAX package's population-major layout normalizes each
  unit across the particles, the port across the layer's units, as keras
  and both packages' row-major transforms do; the port's two layouts are
  held to each other instead.
* The mixed soup of chip_smoke.py's main path at small sizes (an elu
  weightwise type beside a kernel aggregating type and an associative
  recurrent one), population-major, the same way.

The JAX programs are compiled once each, in module-scoped fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import multisoup as jms
from srnn_tpu import soup as jsoup
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
from srnn_tpu.ops.popmajor import resolved_train_impl as j_resolved
import srnn_tpu_torch as st
from srnn_tpu_torch import convert
from srnn_tpu_torch import multisoup as ms
from srnn_tpu_torch.ops.popmajor import resolved_train_impl, train_route

W_TOL = dict(rtol=2e-5, atol=1e-6)
L_TOL = dict(rtol=1e-4, atol=1e-6)
GENERATIONS = 2
N = 12
ACTIVATIONS = ("linear", "sigmoid", "tanh", "relu", "elu", "softmax",
               "swish", "gelu")
VARIANTS = ("weightwise", "aggregating", "fft", "recurrent")
MODES = ("sequential", "full_batch")
#: JAX 'pallas' / 'xla' -> the port's routes
PORT_NAMES = {"pallas": {"kernel"}, "xla": {"plain", "autograd"}}


def _jt(topo) -> JTopology:
    return JTopology(**dataclasses.asdict(topo))


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_route_is_jax_resolution(activation):
    """At width 2 / depth 2, the port's route is JAX's resolution, for
    every variant and train mode."""
    for variant in VARIANTS:
        for mode in MODES:
            topo = st.Topology(variant, activation=activation)
            got = resolved_train_impl(topo, mode, "plain")
            ref = j_resolved(_jt(topo), mode, "pallas")
            assert got in PORT_NAMES[ref], (variant, mode, got, ref)
            assert got == train_route(topo, mode)
            # the hand-derived full batch is 'plain'; autograd elsewhere
            if ref == "xla":
                full = variant == "weightwise" and mode == "full_batch" \
                    and activation in ("linear", "sigmoid", "tanh", "relu")
                assert got == ("plain" if full else "autograd")


@pytest.mark.parametrize("topo", [
    st.Topology("weightwise", width=3, depth=3),
    st.Topology("weightwise", width=5, depth=4),
    st.Topology("aggregating", aggregates=6),
    st.Topology("fft", width=3, depth=1),
    st.Topology("recurrent", width=3, depth=2)],
    ids=["ww-w3d3", "ww-w5d4", "agg-k6", "fft-w3d1", "rnn-w3d2"])
def test_route_off_grid(topo):
    """Off the width-2 / depth-2 grid the route is the JAX package's
    resolution: the kernel up to 64 weights, the autograd route past them
    (where the JAX package leaves Pallas); the row-major associative
    recurrent particle is autograd, its population-major twin the kernel
    (JAX's serial scan there)."""
    route = resolved_train_impl(topo, "sequential", "plain")
    ref = j_resolved(_jt(topo), "sequential", "pallas")
    assert route in PORT_NAMES[ref], (route, ref)
    assert route == ("autograd" if topo.num_weights > 64 else "kernel")
    assoc = st.Topology("recurrent", rnn_scan="associative")
    assert train_route(assoc, "sequential", "popmajor") == "kernel"
    assert train_route(assoc, "sequential", "rowmajor") == "autograd"


def _jax_state(topo, n):
    """A JAX SoupState of ``n`` zero particles (what a refusal sees)."""
    return jsoup.SoupState(
        weights=jnp.zeros((n, topo.num_weights), jnp.float32),
        uids=jnp.arange(n, dtype=jnp.int32), next_uid=jnp.int32(n),
        time=jnp.int32(0), key=jax.random.key(0))


@pytest.mark.parametrize("topo,layout,mode", [
    (st.Topology("weightwise", activation="elu"), "popmajor", "sequential"),
    (st.Topology("aggregating", activation="softmax"), "popmajor",
     "sequential"),
    (st.Topology("recurrent", activation="swish"), "popmajor", "full_batch"),
    (st.Topology("fft", activation="gelu"), "popmajor", "sequential"),
    (st.Topology("weightwise"), "popmajor", "full_batch"),
    (st.Topology("weightwise", width=5, depth=4), "popmajor", "sequential"),
    (st.Topology("weightwise"), "rowmajor", "sequential")],
    ids=["elu", "softmax", "swish-full_batch", "gelu", "ww-full_batch",
         "p-over-64", "rowmajor"])
def test_kernel_impl_raises_where_jax_pallas_raises(topo, layout, mode):
    """Where JAX's 'pallas' soup refuses a config upfront, the port's
    'kernel' soup refuses it too; 'plain' runs it."""
    jcfg = jsoup.SoupConfig(topo=_jt(topo), size=4, train=1,
                            layout=layout, train_mode=mode,
                            train_impl="pallas")
    with pytest.raises(ValueError, match="train_impl"):
        jsoup.evolve_step(jcfg, _jax_state(topo, 4))
    cfg = st.SoupConfig(topo=topo, size=4, train=1, layout=layout,
                        train_mode=mode, train_impl="kernel")
    state = st.seed(cfg._replace(train_impl="plain"), 0, device="cpu")
    with pytest.raises(ValueError, match="train_impl"):
        st.evolve_step(cfg, state)
    assert int(st.evolve(cfg._replace(train_impl="plain"), state,
                         1).time) == 1


def _port_config(jcfg, **kw):
    fields = jcfg._asdict()
    fields["topo"] = dataclasses.asdict(jcfg.topo)
    return convert.soup_config_from_fields(fields)._replace(**kw)


def _port_state(js):
    return convert.soup_state_from_arrays(
        np.asarray(js.weights), np.asarray(js.uids), int(js.next_uid),
        int(js.time), device="cpu")


def _draws_fn(cfg):
    """One JAX generation's draws from its key (``soup.py:341-386``; the
    population-major path draws the same), jitted."""
    n = cfg.size

    @jax.jit
    def draws(key):
        _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
        return (jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate,
                jax.random.randint(k_at, (n,), 0, n),
                jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate,
                jax.random.randint(k_lt, (n,), 0, n),
                j_fresh_lanes(cfg.topo, k_re, n, cfg.respawn_draws))

    return lambda key: st.SoupDraws(*(np.asarray(a) for a in draws(key)))


def _planted(cfg, seed):
    """A JAX state of glorot-scaled particles from numpy, particle 0 all
    zero and particle 1 diverged (both respawns happen)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1, 1, (cfg.size, cfg.topo.num_weights)).astype(
        np.float32) * 0.8
    w[0] = 0.0
    w[1, 2] = np.inf
    s = _jax_state(cfg.topo, cfg.size)
    return s._replace(weights=jnp.asarray(w),
                      key=jax.random.key(seed))


BASE = jsoup.SoupConfig(
    topo=JTopology("weightwise"), size=N, attacking_rate=0.3,
    learn_from_rate=0.3, learn_from_severity=1, train=2,
    remove_divergent=True, remove_zero=True)
SOUPS = {
    "ww-elu-w3d3-popmajor": BASE._replace(
        topo=JTopology("weightwise", width=3, depth=3, activation="elu"),
        layout="popmajor"),
    "ww-gelu-full_batch": BASE._replace(
        topo=JTopology("weightwise", activation="gelu"),
        train_mode="full_batch"),
    "agg-softmax-k6": BASE._replace(
        topo=JTopology("aggregating", activation="softmax", aggregates=6)),
    "rnn-swish-popmajor": BASE._replace(
        topo=JTopology("recurrent", activation="swish"), layout="popmajor"),
}


@pytest.fixture(scope="module", params=list(SOUPS))
def jax_soup(request):
    """GENERATIONS JAX generations of one soup: (config, [(before, after,
    events, draws)])."""
    cfg = SOUPS[request.param]
    draws = _draws_fn(cfg)
    s = _planted(cfg, 7)
    steps = []
    for _ in range(GENERATIONS):
        s2, ev = jsoup.evolve_step(cfg, s)
        steps.append((s, s2, ev, draws(s.key)))
        s = s2
    return request.param, cfg, steps


def test_autograd_soup_matches_jax(jax_soup):
    """Each generation from JAX's state on JAX's draws."""
    name, jcfg, steps = jax_soup
    cfg = _port_config(jcfg)
    assert train_route(cfg.topo, cfg.train_mode, cfg.layout) == "autograd"
    for g, (before, after, jev, draws) in enumerate(steps):
        state, ev = st.evolve_step(cfg, _port_state(before), draws)
        msg = f"{name} generation {g}"
        for field in ("uids", "next_uid", "time"):
            np.testing.assert_array_equal(
                getattr(state, field).numpy(),
                np.asarray(getattr(after, field)), msg)
        np.testing.assert_array_equal(ev.action.numpy(),
                                      np.asarray(jev.action), msg)
        np.testing.assert_array_equal(ev.counterpart.numpy(),
                                      np.asarray(jev.counterpart), msg)
        np.testing.assert_allclose(state.weights.numpy(),
                                   np.asarray(after.weights), **W_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(ev.loss.numpy(), np.asarray(jev.loss),
                                   **L_TOL, err_msg=msg)
    np.testing.assert_array_equal(
        st.count(cfg, _port_state(steps[-1][1])).numpy(),
        np.asarray(jsoup.count(jcfg, steps[-1][1])))


def test_softmax_layouts_agree():
    """softmax normalizes across a layer's units in both of the port's
    layouts: the population-major soup equals the row-major one, integers
    exact, weights within the generation bound (torch's softmax over a
    row's last axis and over a lane matrix's first may round apart)."""
    for topo in (st.Topology("weightwise", activation="softmax"),
                 st.Topology("aggregating", activation="softmax",
                             aggregates=6)):
        cfg = st.SoupConfig(topo=topo, size=N, attacking_rate=0.3,
                            learn_from_rate=0.3, train=2,
                            remove_divergent=True, remove_zero=True)
        s0 = st.seed(cfg, 3, device="cpu")
        row = st.evolve(cfg, s0, 2)
        pop = st.evolve(cfg._replace(layout="popmajor"), s0, 2)
        assert torch.equal(row.uids, pop.uids)
        torch.testing.assert_close(row.weights, pop.weights, **W_TOL)


MIXED = jms.MultiSoupConfig(
    topos=(JTopology("weightwise", activation="elu"),
           JTopology("aggregating"),
           JTopology("recurrent", rnn_scan="associative")),
    sizes=(8, 7, 7), attacking_rate=0.3, learn_from_rate=0.3,
    learn_from_severity=1, train=2, remove_divergent=True, remove_zero=True,
    layout="popmajor")


def _multi_draws_fn(cfg):
    """One JAX popmajor mixed generation's draws (multisoup.py:306-407),
    jitted."""
    n = cfg.total

    @jax.jit
    def draws(key):
        _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
        re_keys = jax.random.split(k_re, len(cfg.topos))
        return (jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate,
                jax.random.randint(k_at, (n,), 0, n),
                jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate,
                tuple(jax.random.randint(jax.random.fold_in(k_lt, t),
                                         (n_t,), 0, n_t)
                      for t, n_t in enumerate(cfg.sizes)),
                tuple(j_fresh_lanes(topo, re_keys[t], n_t,
                                    cfg.respawn_draws)
                      for t, (topo, n_t) in enumerate(zip(cfg.topos,
                                                          cfg.sizes))))

    def host(key):
        ag, at, lg, lt, fr = draws(key)
        return ms.MultiSoupDraws(
            np.asarray(ag), np.asarray(at), np.asarray(lg),
            tuple(np.asarray(t) for t in lt),
            tuple(np.asarray(f) for f in fr))

    return host


def test_mixed_soup_routes_match_jax():
    """The mixed soup of the main path: per-type routes (weightwise
    autograd, aggregating kernel, associative recurrent on K5's serial
    scan, as in JAX's popmajor layout), each generation from JAX's state
    on JAX's draws."""
    fields = MIXED._asdict()
    fields["topos"] = [dataclasses.asdict(t) for t in MIXED.topos]
    cfg = convert.multisoup_config_from_fields(fields)
    assert ms.resolved_train_impls(cfg) == \
        "weightwise=autograd,aggregating=kernel,recurrent=kernel"
    draws = _multi_draws_fn(MIXED)
    rng = np.random.default_rng(11)
    s = jms.MultiSoupState(
        weights=tuple(jnp.asarray(
            rng.uniform(-1, 1, (n_t, t.num_weights)).astype(np.float32)
            * 0.8) for t, n_t in zip(MIXED.topos, MIXED.sizes)),
        uids=tuple(jnp.arange(o, o + n_t, dtype=jnp.int32)
                   for o, n_t in zip(np.cumsum((0,) + MIXED.sizes),
                                     MIXED.sizes)),
        next_uid=jnp.int32(MIXED.total), time=jnp.int32(0),
        key=jax.random.key(5))
    for g in range(GENERATIONS):
        s2, jev = jms.evolve_multi_step(MIXED, s)
        port = convert.multisoup_state_from_arrays(
            [np.asarray(w) for w in s.weights],
            [np.asarray(u) for u in s.uids], int(s.next_uid), int(s.time),
            device="cpu")
        got, ev = ms.evolve_multi_step(cfg, port, draws(s.key))
        assert int(got.next_uid) == int(s2.next_uid)
        for t in range(len(cfg.topos)):
            msg = f"generation {g} type {t}"
            np.testing.assert_array_equal(got.uids[t].numpy(),
                                          np.asarray(s2.uids[t]), msg)
            np.testing.assert_array_equal(ev.action[t].numpy(),
                                          np.asarray(jev.action[t]), msg)
            np.testing.assert_allclose(got.weights[t].numpy(),
                                       np.asarray(s2.weights[t]), **W_TOL,
                                       err_msg=msg)
            np.testing.assert_allclose(ev.loss[t].numpy(),
                                       np.asarray(jev.loss[t]), **L_TOL,
                                       err_msg=msg)
        s = s2
