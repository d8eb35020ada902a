"""The recurrent variant's kernels' plain versions against the JAX
package: K5's hand BPTT chain against ``rnn_*_epochs_pallas`` in interpret
mode, K6's forward against ``rnn_apply_pallas`` in interpret mode (victims
of the attacker's length and of other lengths), the port's autograd chain
(``popmajor_rnn``) against the hand chain, and the orthogonal init's law.
Tolerances: weights rtol 1e-5 / atol 1e-6, losses rtol 1e-4 / atol 1e-6
(tests/test_pallas_train.py keeps 1e-6 / 1e-7 between two JAX spellings;
across the two packages the activations' float noise gets one decade)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu.ops.pallas_rnn_apply import rnn_apply_pallas
from srnn_tpu.ops.pallas_rnn_train import (rnn_learn_epochs_pallas,
                                           rnn_train_epochs_pallas)
from srnn_tpu_torch import Topology
from srnn_tpu_torch.init import (fresh_lanes, init_population,
                                 orthogonal_lanes)
from srnn_tpu_torch.ops import cuda_rnn_apply as cra
from srnn_tpu_torch.ops import cuda_rnn_train as crt
from srnn_tpu_torch.ops import popmajor, popmajor_rnn

N, EPOCHS, SEVERITY = 24, 3, 2
W_TOL = dict(rtol=1e-5, atol=1e-6)
L_TOL = dict(rtol=1e-4, atol=1e-6)


def _rows(p, n, seed, scale=0.3):
    """(p, n) float32 uniform(-scale, scale) from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (p, n)) * scale).astype(np.float32)


def _jt(topo: Topology) -> JTopology:
    return JTopology(**dataclasses.asdict(topo))


def _close(got, ref):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **W_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **L_TOL)


@pytest.mark.parametrize("activation", ["linear", "tanh", "relu"])
def test_plain_bptt_matches_pallas_interpret(activation):
    topo = Topology("recurrent", activation=activation)
    wT = _rows(topo.num_weights, N, 0)
    ref = rnn_train_epochs_pallas(_jt(topo), jnp.asarray(wT), EPOCHS,
                                  interpret=True)
    _close(crt.rnn_train_epochs(topo, torch.from_numpy(wT), EPOCHS), ref)
    _close(popmajor_rnn.rnn_train_epochs_popmajor(
        topo, torch.from_numpy(wT), EPOCHS), ref)
    assert crt.RNN_SGD.launches == 0  # CPU tensors never launch


def test_plain_learn_matches_pallas_interpret():
    topo = Topology("recurrent")
    wT, other = _rows(17, N, 0), _rows(17, N, 1)
    ref = rnn_learn_epochs_pallas(_jt(topo), jnp.asarray(wT),
                                  jnp.asarray(other), SEVERITY,
                                  interpret=True)
    for mode in ("sequential", "full_batch"):
        _close(popmajor.learn_epochs_popmajor(
            topo, torch.from_numpy(wT), torch.from_numpy(other), SEVERITY,
            mode=mode), ref)
        _close(popmajor_rnn.rnn_learn_epochs_popmajor(
            topo, torch.from_numpy(wT), torch.from_numpy(other), SEVERITY,
            mode=mode), ref)


@pytest.mark.parametrize("t_len", [17, 10, 30])
def test_attack_matches_pallas_interpret(t_len):
    """K6's plain version, including victims of another length than the
    attacker's P (the card's kernel has T = P only)."""
    topo = Topology("recurrent", activation="tanh")
    selfT, targetT = _rows(17, N, 2, 0.8), _rows(t_len, N, 3, 0.8)
    targetT[4, 5] = np.inf  # a non-finite victim weight
    ref = np.asarray(rnn_apply_pallas(_jt(topo), jnp.asarray(selfT),
                                      jnp.asarray(targetT), interpret=True))
    got = cra.rnn_apply(topo, torch.from_numpy(selfT),
                        torch.from_numpy(targetT)).numpy()
    assert got.shape == (t_len, N)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], **W_TOL)
    # the soup's attack dispatch goes to K6's wrapper
    if t_len == 17:
        np.testing.assert_array_equal(
            popmajor.apply_popmajor(topo, torch.from_numpy(selfT),
                                    torch.from_numpy(targetT)).numpy(), got)
    assert cra.RNN_APPLY.launches == 0


@pytest.mark.parametrize("activation", ["linear", "sigmoid", "tanh", "relu"])
def test_hand_bptt_matches_autograd(activation):
    topo = Topology("recurrent", activation=activation)
    wT = torch.from_numpy(_rows(17, 64, 6, 0.5))
    other = torch.from_numpy(_rows(17, 64, 7, 0.5))
    for got, ref in (
            (crt.rnn_train_epochs(topo, wT, 2),
             popmajor_rnn.rnn_train_epochs_popmajor(topo, wT, 2)),
            (crt.rnn_learn_epochs(topo, wT, other, 2),
             popmajor_rnn.rnn_learn_epochs_popmajor(topo, wT, other, 2))):
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), **W_TOL)
        np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), **L_TOL)
    # the explicit zero h_{-1}: an Inf recurrent weight gives NaN at once
    w = wT.clone()
    w[5, 0] = float("inf")  # a recurrent weight of layer 0
    out = cra.rnn_apply(topo, w, wT)
    assert bool(torch.isnan(out[:, 0]).all()) and bool(
        torch.isfinite(out[:, 1:]).all())


def _gram(m):
    """m^T m per particle, in float64."""
    return torch.einsum("nij,nik->njk", m.double(), m.double())


def test_orthogonal_init_law():
    """The recurrent kernels are Haar-orthogonal: Q^T Q = I, signs of the
    entries balanced, the (1, 1) kernel a fair +-1; the input kernels stay
    glorot_uniform.  (A law, not a stream: rule 3 of the port.)"""
    topo = Topology("recurrent")
    n = 20000
    gen = torch.Generator().manual_seed(0)
    w = init_population(topo, gen, n, "cpu")
    assert w.shape == (n, 17) and bool(torch.isfinite(w).all())
    offs = topo.offsets
    for i, (a, b) in enumerate(topo.layer_shapes):
        m = w[:, offs[i]:offs[i + 1]].reshape(n, a, b)
        if i % 2 == 1:
            eye = torch.eye(b, dtype=torch.float64).expand(n, b, b)
            torch.testing.assert_close(_gram(m), eye, rtol=0, atol=1e-5)
            frac = float((m > 0).float().mean())
            assert abs(frac - 0.5) < 0.02, (i, frac)
        else:
            lim = float(np.sqrt(6.0 / (a + b)))
            assert float(m.abs().max()) <= lim
            assert float(m.abs().max()) > 0.95 * lim
    assert set(w[:, 16].unique().tolist()) == {-1.0, 1.0}
    dets = torch.linalg.det(w[:, 2:6].reshape(n, 2, 2).double())
    assert abs(float((dets > 0).double().mean()) - 0.5) < 0.02
    # a wide kernel (a < b) transposes; the respawn draw has the same law
    q = orthogonal_lanes(gen, 500, (2, 3), "cpu").permute(2, 0, 1)
    torch.testing.assert_close(_gram(q.transpose(1, 2)),
                               torch.eye(2, dtype=torch.float64).expand(
                                   500, 2, 2), rtol=0, atol=1e-5)
    fresh = fresh_lanes(topo, gen, 64, "fused", "cpu")
    assert fresh.shape == (17, 64) and fresh.is_contiguous()
    assert set(fresh[16].unique().tolist()) <= {-1.0, 1.0}


def test_fences():
    topo = Topology("recurrent")
    wT = torch.from_numpy(_rows(17, 8, 9))
    w, loss = crt.rnn_train_epochs(topo, wT, 0)
    assert torch.equal(w, wT) and torch.equal(loss, torch.zeros(8))
    with pytest.raises(ValueError, match="variant"):
        crt.rnn_train_epochs(Topology("weightwise"), wT, 1)
    with pytest.raises(ValueError, match="rnn_scan"):
        crt.rnn_train_epochs(Topology("recurrent", rnn_scan="associative"),
                             wT, 1)
    with pytest.raises(ValueError, match="derivative"):
        cra.rnn_apply(Topology("recurrent", activation="gelu"), wT, wT)
    with pytest.raises(ValueError):
        cra.rnn_apply(topo, wT, wT[:, :4].contiguous())
