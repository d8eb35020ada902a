"""Cross-architecture attacks in the port against the JAX package: the
row-major ``cross_apply`` for every (attacker, victim) pair of the four
width-2 topologies, its population-major twin ``cross_apply_popmajor``,
K6's plain version at the cross victims' lengths T = 14 and T = 20 against
the Pallas kernel in interpret mode, and the average's Inf poisoning.

Inputs are made with numpy and handed to both packages.  Tolerances:
weights rtol 1e-5 / atol 1e-6 (tests/test_torch_rnn.py's: the two packages
sum the MLP's products and the FFT's terms in their own orders), the
non-finite pattern exact."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu.nets.cross import cross_apply as j_cross_apply
from srnn_tpu.ops.pallas_rnn_apply import rnn_apply_pallas
from srnn_tpu.ops.popmajor_cross import \
    cross_apply_popmajor as j_cross_apply_popmajor
from srnn_tpu_torch import Topology
from srnn_tpu_torch.nets.cross import cross_apply
from srnn_tpu_torch.nets.dispatch import apply_to_weights
from srnn_tpu_torch.ops import cuda_rnn_apply as cra
from srnn_tpu_torch.ops.popmajor_cross import cross_apply_popmajor

TOPOS = {
    "weightwise": Topology("weightwise", width=2, depth=2),
    "aggregating": Topology("aggregating", width=2, depth=2, aggregates=4),
    "fft": Topology("fft", width=2, depth=2, aggregates=4),
    "recurrent": Topology("recurrent", width=2, depth=2),
}
PAIRS = list(itertools.product(sorted(TOPOS), repeat=2))
W_TOL = dict(rtol=1e-5, atol=1e-6)
N = 64


def _jt(topo: Topology) -> JTopology:
    return JTopology(**dataclasses.asdict(topo))


def _rows(shape, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    np.testing.assert_allclose(got[fin], ref[fin], **W_TOL)


@pytest.mark.parametrize("att,vic", PAIRS, ids=[f"{a}-{v}" for a, v in PAIRS])
def test_cross_apply_matches_jax(att, vic):
    """Row-major, a batch of 8 particles (the JAX function vmapped)."""
    ta, tv = TOPOS[att], TOPOS[vic]
    a = _rows((8, ta.num_weights), 1)
    v = _rows((8, tv.num_weights), 2)
    ref = jax.vmap(lambda x, y: j_cross_apply(_jt(ta), x, _jt(tv), y))(
        jnp.asarray(a), jnp.asarray(v))
    got = cross_apply(ta, torch.from_numpy(a), tv, torch.from_numpy(v))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("variant", sorted(TOPOS))
def test_cross_apply_reduces_to_apply(variant):
    """With equal topologies the cross transform is the variant's own
    (tests/test_cross.py's contract), bit for bit."""
    topo = TOPOS[variant]
    a = torch.from_numpy(_rows((8, topo.num_weights), 3, 0.5))
    v = torch.from_numpy(_rows((8, topo.num_weights), 4, 0.5))
    assert torch.equal(cross_apply(topo, a, topo, v),
                       apply_to_weights(topo, a, v))


@pytest.mark.parametrize("att,vic", PAIRS, ids=[f"{a}-{v}" for a, v in PAIRS])
def test_cross_apply_popmajor_matches_jax(att, vic):
    """Population-major at N = 64, against the JAX lane program and
    against the port's own row-major transform."""
    ta, tv = TOPOS[att], TOPOS[vic]
    selfT = _rows((ta.num_weights, N), 5)
    targetT = _rows((tv.num_weights, N), 6)
    ref = j_cross_apply_popmajor(_jt(ta), jnp.asarray(selfT), _jt(tv),
                                 jnp.asarray(targetT))
    got = cross_apply_popmajor(ta, torch.from_numpy(selfT), tv,
                               torch.from_numpy(targetT))
    _close(got.numpy(), ref)
    rowmajor = cross_apply(ta, torch.from_numpy(selfT.T.copy()), tv,
                           torch.from_numpy(targetT.T.copy()))
    _close(got.numpy(), rowmajor.numpy().T)


@pytest.mark.parametrize("victim", ["weightwise", "aggregating"])
def test_rnn_apply_plain_matches_pallas_at_cross_lengths(victim):
    """K6's plain version for the cross victims' lengths (T = 14, T = 20),
    the wrapper's CPU route, against rnn_apply_pallas in interpret mode;
    these lengths are in the default build on the card."""
    att = TOPOS["recurrent"]
    t_len = TOPOS[victim].num_weights
    assert t_len in cra.DEFAULT_T_LENGTHS
    selfT = _rows((att.num_weights, N), 7, 0.8)
    targetT = _rows((t_len, N), 8, 0.8)
    targetT[4, 5] = np.inf  # a non-finite victim weight
    ref = rnn_apply_pallas(_jt(att), jnp.asarray(selfT),
                           jnp.asarray(targetT), interpret=True)
    before = cra.RNN_APPLY_BY_T[t_len].launches
    got = cross_apply_popmajor(att, torch.from_numpy(selfT), TOPOS[victim],
                               torch.from_numpy(targetT))
    _close(got.numpy(), ref)
    assert cra.RNN_APPLY_BY_T[t_len].launches == before  # CPU: plain


@pytest.mark.parametrize("victim", ["weightwise", "recurrent"])
def test_cross_average_inf_poisons_every_aggregate(victim):
    """One +Inf victim weight: the JAX matmul's 0 * Inf terms make every
    aggregate NaN, and so every rewritten weight; the port's multiply-add
    chain keeps that, row-major and population-major."""
    ta, tv = TOPOS["aggregating"], TOPOS[victim]
    selfT = _rows((ta.num_weights, N), 9)
    targetT = _rows((tv.num_weights, N), 10)
    targetT[0, 3] = np.inf
    ref = np.asarray(j_cross_apply_popmajor(
        _jt(ta), jnp.asarray(selfT), _jt(tv), jnp.asarray(targetT)))
    assert np.isnan(ref[:, 3]).all() and np.isfinite(np.delete(ref, 3, 1)).all()
    got = cross_apply_popmajor(ta, torch.from_numpy(selfT), tv,
                               torch.from_numpy(targetT))
    _close(got.numpy(), ref)
    row = cross_apply(ta, torch.from_numpy(selfT.T.copy()), tv,
                      torch.from_numpy(targetT.T.copy()))
    _close(row.numpy().T, ref)


def test_card_fences(monkeypatch):
    """What the card's kernels do not take raises before any launch: a
    victim longer than K6's fence of 64 weights; and the random shuffler
    raises without a permutation (row-major, as the JAX package's keyless
    attack does) and in the population-major layout (the JAX package's
    refusal)."""
    att = TOPOS["recurrent"]
    selfT = torch.from_numpy(_rows((att.num_weights, N), 11))
    monkeypatch.setattr(cra, "is_cpu", lambda t: False)  # as for the card
    with pytest.raises(ValueError, match="up to 64 weights"):
        cra.rnn_apply(att, selfT, torch.from_numpy(_rows((65, N), 12)))
    assert sum(k.launches for k in cra.RNN_APPLY_BY_T.values()) == 0
    shuffled = Topology("aggregating", shuffler="random")
    for fn in (lambda: cross_apply(shuffled, torch.zeros(20), att,
                                   torch.zeros(17)),
               lambda: cross_apply_popmajor(shuffled, torch.zeros(20, 4), att,
                                            torch.zeros(17, 4))):
        with pytest.raises(ValueError, match="shuffler='random'"):
            fn()
