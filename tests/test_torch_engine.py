"""The port's row-major training (``train.py``), network verbs
(``netops.py``), known-fixpoint fixtures and five experiment engines
against the JAX package, on the CPU: the same numpy inputs, made from a
seed, through ``srnn_tpu.train`` / ``netops`` / ``fixtures`` / ``engine``
(XLA; no Pallas kernel on these paths) and their ports, whose SGD and
self-application routes run the kernels' plain chains on CPU tensors.

Tolerances: ``train.py`` weights rtol 1e-5 / atol 1e-6 and losses rtol
1e-4 / atol 1e-6 (the chains' bound in tests/test_torch_ww_train.py and
tests/test_torch_rnn.py); the engines' integer fields (steps, classes,
counts, time_to_vergence, time_as_fixpoint) exactly equal, their weights
and trajectories within rtol 2e-5 / atol 1e-6 where finite with the
non-finite positions exact (the linear chains overflow; whether an overflowed
entry reads Inf or NaN hangs on the summation order, so that is not held),
losses rtol 1e-4 / atol 1e-6; netops' text character-equal.  Bounds are taken
per particle, the relative part against the larger of an entry and its
particle's largest magnitude for the weightwise full-batch engines, whose
small weights are differences of large ones rounded in another order than
XLA's.  The JAX programs are compiled
once each, in module-scoped fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import engine as jengine
from srnn_tpu import fixtures as jfixtures
from srnn_tpu import netops as jnetops
from srnn_tpu import train as jtrain
from srnn_tpu.nets import compute_samples as j_samples
import srnn_tpu_torch as st
from srnn_tpu_torch import engine, fixtures, netops, train
from srnn_tpu_torch.ops.predicates import is_fixpoint
from srnn_tpu_torch.nets.dispatch import apply_to_weights

W_TOL = dict(rtol=1e-5, atol=1e-6)
L_TOL = dict(rtol=1e-4, atol=1e-6)
E_TOL = dict(rtol=2e-5, atol=1e-6)
VARIANTS = {
    "weightwise": st.Topology("weightwise"),
    "aggregating": st.Topology("aggregating"),
    "fft": st.Topology("fft"),
    "recurrent": st.Topology("recurrent"),
}
N = 16


def _jt(topo):
    return JTopology(**dataclasses.asdict(topo))


def _pop(topo, n, seed, scale=1.0):
    """(n, P) float32: each kernel U(-limit, limit), limit its glorot
    bound, times ``scale``."""
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(-1, 1, (n, a * b)) * np.sqrt(6.0 / (a + b))
             for a, b in topo.layer_shapes]
    return (np.concatenate(parts, axis=1) * scale).astype(np.float32)


def _engine_pop(topo):
    """Trials of every class: a zero net, a diverged net, for the
    weightwise variant the identity fixpoint, damped and fresh nets."""
    pop = np.concatenate([_pop(topo, N // 2, 3, 0.3), _pop(topo, N // 2, 4)])
    pop[0] = 0.0
    pop[1, 2] = np.inf
    if topo.variant == "weightwise":
        pop[2] = np.asarray(jfixtures.identity_fixpoint_flat(_jt(topo)))
    return pop


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, per_particle=False):
    """Shapes and dtypes equal, the non-finite entries the same, the finite
    ones within ``tol``.  ``per_particle``: the relative bound taken against
    the larger of an entry and its particle's largest finite magnitude."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    mag = np.abs(np.where(fin, ref, 0.0))
    if per_particle and ref.ndim:
        mag = np.maximum(mag, mag.max(axis=-1, keepdims=True))
    bound = tol["atol"] + tol["rtol"] * mag
    diff = np.abs(np.where(fin, got - np.where(fin, ref, 0.0), 0.0))
    bad = diff > bound
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} entries outside {tol}"
        f"{' per particle' if per_particle else ''}: got {got[bad][:4]}, "
        f"expected {ref[bad][:4]}")


def _equal(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------- train.py


def _jax_train(topo, w, o, x, y):
    """Every train.py function of the JAX package on a batch, one jit."""
    jt = _jt(topo)
    ww = topo.variant == "weightwise"

    def run(w, o, x, y):
        v = jax.vmap
        out = {
            "predict": v(lambda a, b: jtrain.predict(jt, a, b))(w, x),
            "fit_epoch": v(lambda a, b, c: jtrain.fit_epoch(
                jt, a, b, c))(w, x, y),
            "fit_epoch_full": v(lambda a, b, c: jtrain.fit_epoch(
                jt, a, b, c, mode="full_batch"))(w, x, y),
            "fit_epochs_flat": v(lambda a: jtrain.fit_epochs_flat(
                jt, a, 3))(w),
            "fit_epochs_flat_xy": v(lambda a, b, c: jtrain.fit_epochs_flat(
                jt, a, 2, xy=(b, c)))(w, x, y),
            "train_step": v(lambda a: jtrain.train_step(jt, a))(w),
            "learn_from": v(lambda a, b: jtrain.learn_from(jt, a, b))(w, o),
        }
        if ww:
            out["fit_epochs_flat_full"] = v(lambda a: jtrain.fit_epochs_flat(
                jt, a, 3, mode="full_batch"))(w)
            out["train_step_full"] = v(lambda a: jtrain.train_step(
                jt, a, mode="full_batch"))(w)
            out["learn_from_full"] = v(lambda a, b: jtrain.learn_from(
                jt, a, b, mode="full_batch"))(w, o)
        return out

    return jax.tree.map(np.asarray, jax.jit(run)(w, o, x, y))


def _port_train(topo, name, w, o, x, y):
    f = {
        "predict": lambda: train.predict(topo, w, x),
        "fit_epoch": lambda: train.fit_epoch(topo, w, x, y),
        "fit_epoch_full": lambda: train.fit_epoch(topo, w, x, y,
                                                  mode="full_batch"),
        "fit_epochs_flat": lambda: train.fit_epochs_flat(topo, w, 3),
        "fit_epochs_flat_xy": lambda: train.fit_epochs_flat(topo, w, 2,
                                                            xy=(x, y)),
        "train_step": lambda: train.train_step(topo, w),
        "learn_from": lambda: train.learn_from(topo, w, o),
        "fit_epochs_flat_full": lambda: train.fit_epochs_flat(
            topo, w, 3, mode="full_batch"),
        "train_step_full": lambda: train.train_step(topo, w,
                                                    mode="full_batch"),
        "learn_from_full": lambda: train.learn_from(topo, w, o,
                                                    mode="full_batch"),
    }
    return f[name]()


@pytest.fixture(scope="module")
def train_runs():
    out = {}
    for variant, topo in VARIANTS.items():
        w, o = _pop(topo, N, 1, 0.5), _pop(topo, N, 2, 0.5)
        x, y = jax.vmap(lambda a: j_samples(_jt(topo), a))(jnp.asarray(o))
        x, y = np.asarray(x), np.asarray(y)
        out[variant] = ((w, o, x, y), _jax_train(topo, w, o, x, y))
    return out


TRAIN_FNS = ["predict", "fit_epoch", "fit_epoch_full", "fit_epochs_flat",
             "fit_epochs_flat_xy", "train_step", "learn_from"]
TRAIN_CASES = [(v, f) for v in VARIANTS for f in TRAIN_FNS] + [
    ("weightwise", f) for f in ("fit_epochs_flat_full", "train_step_full",
                                "learn_from_full")]


@pytest.mark.parametrize("variant,fn", TRAIN_CASES,
                         ids=[f"{v}-{f}" for v, f in TRAIN_CASES])
def test_train_matches_jax(train_runs, variant, fn):
    """Each train.py function on a batch of nets against its JAX twin
    (vmapped); the sequential self-training and learn_from calls run the
    SGD kernels' plain chains here."""
    topo = VARIANTS[variant]
    args, ref = train_runs[variant]
    got = _port_train(topo, fn, *(_t(a) for a in args))
    ref = ref[fn]
    if fn == "predict":
        _close(got, ref, W_TOL)
        return
    _close(got[0], ref[0], W_TOL)
    _close(got[1], ref[1], L_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_single_net_shapes(train_runs, variant):
    """A single net (P,) gives back (P,) and a scalar loss, equal to its
    row of the batch."""
    topo = VARIANTS[variant]
    (w, o, x, y), ref = train_runs[variant]
    for fn in ("train_step", "learn_from", "fit_epoch"):
        got = _port_train(topo, fn, _t(w[3]), _t(o[3]), _t(x[3]), _t(y[3]))
        assert got[0].shape == (topo.num_weights,) and got[1].shape == ()
        _close(got[0], ref[fn][0][3], W_TOL)
        _close(got[1], ref[fn][1][3], L_TOL)


def test_train_unported_and_fences():
    topo = VARIANTS["weightwise"]
    w = torch.zeros(2, 14)
    # keras' shuffled epoch runs (tests/test_torch_shuffled_epoch.py holds
    # it against the JAX package); an order of the wrong shape raises
    gen = torch.Generator().manual_seed(0)
    assert train.train_step(topo, w, key=gen)[0].shape == w.shape
    assert engine.run_training(topo, w, epochs=1,
                               shuffle_key=gen).losses.shape == (1, 2)
    with pytest.raises(ValueError, match="order"):
        engine.run_training(topo, w, epochs=2,
                            order=torch.zeros(1, 14, 2, dtype=torch.uint8))
    for fn in (lambda: train.train_step(topo, w, mode="adam"),
               lambda: engine.run_training(topo, w, 1, train_mode="adam")):
        with pytest.raises(ValueError, match="unknown train mode"):
            fn()
    got, loss = train.fit_epochs_flat(topo, w, 0)
    assert got is w and loss.shape == (2,)


# ------------------------------------------------------- netops, fixtures


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_netops_match_jax(variant):
    topo = VARIANTS[variant]
    jt = _jt(topo)
    w, o = _pop(topo, 4, 5), _pop(topo, 4, 6)
    jw, jo = jnp.asarray(w), jnp.asarray(o)
    for name in ("attack", "fuck", "absorb", "meet"):
        ref = jax.vmap(lambda a, b: getattr(jnetops, name)(jt, a, b))(jw, jo)
        _close(getattr(netops, name)(topo, _t(w), _t(o)), ref, W_TOL)
    ref = jax.vmap(lambda a: jnetops.self_attack(jt, a, 1))(jw)
    _close(netops.self_attack(topo, _t(w), 1), ref, W_TOL)
    # iterated, it re-reads its own output as net and target: two
    # iterations are held against JAX at the engines' bound; from the third
    # the weightwise and recurrent nets reach 4e9 and 7e26, where a small
    # entry is the difference of large ones and the two packages' rounding
    # leaves it about 1e-4 relative apart, so three are held bitwise to the
    # port's own composed application
    ref = jax.vmap(lambda a: jnetops.self_attack(jt, a, 2))(jw)
    _close(netops.self_attack(topo, _t(w), 2), ref, E_TOL)
    chain = _t(w)
    for _ in range(3):
        chain = apply_to_weights(topo, chain, chain)
    _equal(netops.self_attack(topo, _t(w), 3), chain.numpy())
    np.testing.assert_array_equal(
        netops.are_weights_within(_t(w), -0.5, 0.5).numpy(),
        np.asarray(jnetops.are_weights_within(jw, -0.5, 0.5)))
    for row in (w[0], np.zeros_like(w[0]), -w[1] * 1e3):
        assert netops.weights_to_string(topo, _t(row)) == \
            jnetops.weights_to_string(jt, jnp.asarray(row))


def test_flatten_round_trip():
    from srnn_tpu.ops.flatten import flatten_mats as j_flatten_mats
    from srnn_tpu.ops.flatten import unflatten as j_unflatten
    from srnn_tpu_torch.ops.flatten import flatten_mats, unflatten

    for topo in VARIANTS.values():
        w = _pop(topo, 3, 7)
        mats = unflatten(topo, _t(w))
        for got, ref in zip(mats, j_unflatten(_jt(topo), jnp.asarray(w))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(flatten_mats(mats).numpy(), w)
        np.testing.assert_array_equal(
            np.asarray(j_flatten_mats([jnp.asarray(m.numpy())
                                       for m in mats])), w)


def test_identity_fixpoint_exact():
    topo = VARIANTS["weightwise"]
    flat = fixtures.identity_fixpoint_flat(topo, "cpu")
    _equal(flat, jfixtures.identity_fixpoint_flat(_jt(topo)))
    assert bool(is_fixpoint(lambda t: apply_to_weights(topo, flat, t), flat,
                            1, 1e-6))
    _equal(apply_to_weights(topo, flat, flat), flat.numpy())
    with pytest.raises(ValueError, match="weightwise"):
        fixtures.identity_fixpoint_flat(VARIANTS["aggregating"], "cpu")


def _jax_draws(keys, p):
    """The two uniforms JAX's ``vary`` draws from each key."""
    def one(k):
        k_sign, k_mag = jax.random.split(k)
        return (jax.random.uniform(k_sign, (p,)),
                jax.random.uniform(k_mag, (p,)))
    return tuple(np.array(d) for d in jax.vmap(one)(keys))


def test_vary_on_jax_draws():
    topo = VARIANTS["weightwise"]
    jt = _jt(topo)
    keys = jax.random.split(jax.random.key(3), 8)
    flat = jfixtures.identity_fixpoint_flat(jt)
    for e in (1.0, 1e-3):
        ref = jax.vmap(lambda k: jfixtures.vary(k, flat, e))(keys)
        draws = _jax_draws(keys, topo.num_weights)
        base = fixtures.identity_fixpoint_flat(topo, "cpu").expand(8, -1)
        _equal(fixtures.vary(None, base, e, draws=draws), ref)
    gen = torch.Generator().manual_seed(0)
    got = fixtures.vary(gen, base, 0.5)
    delta = (got - base).abs()
    assert bool((delta <= 0.5).all()) and bool((delta > 0).all())
    with pytest.raises(ValueError, match="generator"):
        fixtures.vary(None, base)


# ------------------------------------------------------------------ engines


def _variation_pop(topo):
    """The known-fixpoint sweep's trials: the identity fixpoint perturbed on
    JAX's draws at four scales (weightwise), damped nets otherwise."""
    if topo.variant != "weightwise":
        return _pop(topo, N, 8, 0.05)
    jt = _jt(topo)
    keys = jax.random.split(jax.random.key(9), N)
    flat = jfixtures.identity_fixpoint_flat(jt)
    scales = np.repeat([1.0, 1e-2, 1e-5, 1e-8], N // 4)
    return np.asarray(jax.vmap(lambda k, e: jfixtures.vary(k, flat, e))(
        keys, jnp.asarray(scales, jnp.float32)))


@pytest.fixture(scope="module")
def engine_runs():
    out = {}
    for variant, topo in VARIANTS.items():
        jt = _jt(topo)
        pop = _engine_pop(topo)
        var_pop = _variation_pop(topo)
        jp = jnp.asarray(pop)
        runs = {
            "fixpoint": (pop, jengine.run_fixpoint(jt, jp, step_limit=20,
                                                   record=True)),
            "training": (pop, jengine.run_training(jt, jp, epochs=10,
                                                   record=True)),
            "mixed": (pop, jengine.run_mixed_fixpoint(
                jt, jp, trains_per_application=5, step_limit=4)),
            "variation": (var_pop, jengine.run_known_fixpoint_variation(
                jt, jnp.asarray(var_pop), max_steps=20)),
            "density": (pop, jengine.fixpoint_density(jt, jp)),
        }
        if variant == "weightwise":
            runs["training_full"] = (pop, jengine.run_training(
                jt, jp, epochs=5, train_mode="full_batch"))
            runs["mixed_full"] = (pop, jengine.run_mixed_fixpoint(
                jt, jp, trains_per_application=3, step_limit=3,
                train_mode="full_batch", record=True))
        out[variant] = {k: (p, jax.tree.map(
            lambda a: None if a is None else np.asarray(a), r))
            for k, (p, r) in runs.items()}
    return out


def _port_engine(topo, name, pop):
    return {
        "fixpoint": lambda: engine.run_fixpoint(topo, pop, step_limit=20,
                                                record=True),
        "training": lambda: engine.run_training(topo, pop, epochs=10,
                                                record=True),
        "mixed": lambda: engine.run_mixed_fixpoint(
            topo, pop, trains_per_application=5, step_limit=4),
        "variation": lambda: engine.run_known_fixpoint_variation(
            topo, pop, max_steps=20),
        "density": lambda: engine.fixpoint_density(topo, pop),
        "training_full": lambda: engine.run_training(
            topo, pop, epochs=5, train_mode="full_batch"),
        "mixed_full": lambda: engine.run_mixed_fixpoint(
            topo, pop, trains_per_application=3, step_limit=3,
            train_mode="full_batch", record=True),
    }[name]()


ENGINES = ["fixpoint", "training", "mixed", "variation", "density"]
ENGINE_CASES = [(v, e) for v in VARIANTS for e in ENGINES] + [
    ("weightwise", "training_full"), ("weightwise", "mixed_full")]
_INT_FIELDS = ("steps", "classes", "counts", "time_to_vergence",
               "time_as_fixpoint")


@pytest.mark.parametrize("variant,name", ENGINE_CASES,
                         ids=[f"{v}-{e}" for v, e in ENGINE_CASES])
def test_engine_matches_jax(engine_runs, variant, name):
    topo = VARIANTS[variant]
    pop, ref = engine_runs[variant][name]
    got = _port_engine(topo, name, _t(pop))
    if name == "density":
        _equal(got, ref)
        assert int(got.sum()) == pop.shape[0]
        return
    assert got._fields == ref._fields
    for field, g, r in zip(got._fields, got, ref):
        if r is None:
            assert g is None, field
        elif field in _INT_FIELDS:
            _equal(g, r)
        else:
            # the full-batch step sums its gradient over the samples in
            # another order than XLA, and the attacks amplify that rounding
            # at the particle's scale
            _close(g, r, L_TOL if field == "losses" else E_TOL,
                   per_particle=name.endswith("_full"))
    if hasattr(got, "counts"):
        assert int(got.counts.sum()) == pop.shape[0]


def test_engine_populations_exercise_the_classes(engine_runs):
    """The test populations reach every class the engines decide between,
    and the variation sweep counts steps as a fixpoint."""
    seen = set()
    for runs in engine_runs.values():
        seen |= set(np.flatnonzero(runs["fixpoint"][1].counts))
        seen |= set(np.flatnonzero(runs["density"][1]))
    assert {0, 1, 2, 4} <= seen
    assert engine_runs["weightwise"]["variation"][1].time_as_fixpoint.max() > 0


@pytest.mark.parametrize("name,steps,applications", [
    ("fixpoint", 7, 7), ("mixed", 5, 5), ("variation", 6, 7)])
def test_engines_apply_once_a_step(monkeypatch, name, steps, applications):
    """Each step's fixpoint test reads the application the step makes (one
    self-application a step; the variation engine one more, for its last
    step's test), with results unchanged."""
    topo = VARIANTS["weightwise"]
    pop = _t(_engine_pop(topo))
    calls = []
    real = engine._self_apply

    def counted(t, w):
        calls.append(1)
        return real(t, w)

    monkeypatch.setattr(engine, "_self_apply", counted)
    run = {"fixpoint": lambda: engine.run_fixpoint(topo, pop, steps),
           "mixed": lambda: engine.run_mixed_fixpoint(topo, pop, 2, steps),
           "variation": lambda: engine.run_known_fixpoint_variation(
               topo, pop, steps)}[name]
    run()
    assert len(calls) == applications


def test_layouts_agree_bitwise_but_recurrent():
    """Why the engines self-apply the recurrent variant row-major: on the
    CPU the population-major transforms (K1's and the k-vector's plain
    versions) equal the row-major ones bitwise, while the recurrent one
    (K6's plain chain) rounds otherwise: measured on 2048 fresh nets
    (seed 3), 68% of the entries differ, by up to 2.4e-4 absolute and
    1.1% relative, enough to move fixpoint class counts off the JAX
    package's.  Only the inequality is asserted, so a recurrence that
    summed in the row-major order would fail here and show that K6 can
    take this path."""
    from srnn_tpu_torch.ops.popmajor import apply_popmajor

    for variant, topo in VARIANTS.items():
        w = st.init_population(topo, 3, 2048, "cpu")
        wT = w.t().contiguous()
        rows = apply_to_weights(topo, w, w)
        lanes = apply_popmajor(topo, wT, wT).t()
        if variant != "recurrent":
            assert torch.equal(rows, lanes), variant
            continue
        assert not torch.equal(rows, lanes)
