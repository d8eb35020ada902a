"""The row-major transforms of the aggregating, fft and recurrent variants
(``nets/``) and the fixpoint engine on them, against the JAX package: the
same numpy inputs through ``srnn_tpu.nets.apply_to_weights`` /
``compute_samples`` (vmapped) and ``srnn_tpu.engine``.  Transforms within
rtol 1e-5 / atol 1e-6 (tests/test_pallas_ww.py's bound, with the FFT's
float noise), the atol scaled by each particle's largest output magnitude
where that exceeds 1: the linear recurrence grows a sequence to ~1e2, and
its small entries are differences of such values, so their rounding is the
particle's scale's, not their own (the JAX package's own row-major and lane
recurrences differ by that much).  Class ids, class counts and executed
steps exactly equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import engine as jengine
from srnn_tpu.init import init_population as j_init_population
from srnn_tpu.nets import apply_to_weights as j_apply
from srnn_tpu.nets import compute_samples as j_samples
import srnn_tpu_torch as st
from srnn_tpu_torch.nets import apply_to_weights, compute_samples

TOL = dict(rtol=1e-5, atol=1e-6)
TOPOS = {
    "agg-avg": st.Topology("aggregating"),
    "agg-max": st.Topology("aggregating", aggregator="max"),
    "agg-maxbuggy": st.Topology("aggregating", aggregator="max_buggy"),
    "fft": st.Topology("fft"),
    "rfft": st.Topology("fft", fft_mode="rfft"),
    "fft-target": st.Topology("fft", fft_use_target=True),
    "recurrent": st.Topology("recurrent"),
    "recurrent-tanh": st.Topology("recurrent", activation="tanh"),
}


def _jt(topo):
    return JTopology(**dataclasses.asdict(topo))


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.maximum(1.0, np.abs(ref).max(axis=-1, keepdims=True))
    np.testing.assert_array_less(np.abs(got - ref),
                                 TOL["rtol"] * np.abs(ref)
                                 + TOL["atol"] * scale + 1e-30)


def _init(topo, n, seed):
    """(n, P) float32 fresh nets of the variant's own init law (the JAX
    package's draw, handed to both packages)."""
    return np.array(j_init_population(_jt(topo), jax.random.key(seed), n))


@pytest.mark.parametrize("name", list(TOPOS))
def test_apply_and_samples_match_jax(name):
    topo = TOPOS[name]
    jt = _jt(topo)
    w, t = _init(topo, 64, 1), _init(topo, 64, 2)
    # a zero weight, so that max_buggy's falsy rule is exercised
    w[:, 0] = 0.0
    ref_self = jax.vmap(lambda a: j_apply(jt, a, a))(jnp.asarray(w))
    ref_attack = jax.vmap(lambda a, b: j_apply(jt, a, b))(jnp.asarray(w),
                                                          jnp.asarray(t))
    tw, tt = torch.from_numpy(w), torch.from_numpy(t)
    _close(apply_to_weights(topo, tw, tw).numpy(), ref_self)
    _close(apply_to_weights(topo, tw, tt).numpy(), ref_attack)
    ref_x, ref_y = jax.vmap(lambda a: j_samples(jt, a))(jnp.asarray(w))
    got_x, got_y = compute_samples(topo, tw)
    assert tuple(got_x.shape) == ref_x.shape
    _close(got_x.numpy(), ref_x)
    _close(got_y.numpy(), ref_y)


@pytest.mark.parametrize("name", ["agg-avg", "agg-maxbuggy", "fft", "rfft",
                                  "recurrent"])
def test_classify_and_run_fixpoint_match_jax(name):
    topo = TOPOS[name]
    pop = _init(topo, 200, 12)
    ref = jengine.run_fixpoint(_jt(topo), jnp.asarray(pop), step_limit=40)
    got = st.run_fixpoint(topo, torch.from_numpy(pop), step_limit=40)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(ref.steps))
    np.testing.assert_array_equal(
        st.classify_batch(topo, torch.from_numpy(pop)).numpy(),
        np.asarray(jengine.classify_batch(_jt(topo), jnp.asarray(pop))))


def test_nonfinite_and_unported_options():
    """An Inf weight poisons the other aggregates of the row-major
    aggregating transform (0 * Inf through the one-hot chains), as through
    the JAX package's matmul; a random shuffler without a permutation
    raises, as the JAX package's keyless transform does."""
    topo = TOPOS["agg-avg"]
    w = _init(topo, 4, 3)
    w[:, 2] = np.inf  # segment 0
    ref = np.asarray(jax.vmap(lambda a: j_apply(_jt(topo), a, a))(
        jnp.asarray(w)))
    got = apply_to_weights(topo, torch.from_numpy(w), torch.from_numpy(w))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    assert np.isnan(ref).all()
    x = torch.zeros(2, 20)
    with pytest.raises(ValueError, match="shuffler"):
        apply_to_weights(st.Topology("aggregating", shuffler="random"), x, x)
    # the associative scan is ported: on zero weights it is zero
    assert torch.equal(apply_to_weights(
        st.Topology("recurrent", rnn_scan="associative"),
        torch.zeros(2, 17), torch.zeros(2, 17)), torch.zeros(2, 17))
