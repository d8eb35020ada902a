"""K2's plain chain (hand-derived backward) and the port's autograd chain
against the JAX package: the Pallas chain in interpret mode and the
``jax.grad`` chain ``_ww_seq_sgd_flat``.  Tolerances of
tests/test_pallas_ww.py (rtol 1e-5, atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu.ops.pallas_ww_train import (ww_learn_epochs_pallas,
                                          ww_train_epochs_pallas)
from srnn_tpu.ops.popmajor import (ww_learn_epochs_popmajor as
                                   j_learn_popmajor,
                                   ww_train_epochs_popmajor as
                                   j_train_popmajor)
from srnn_tpu_torch import Topology
from srnn_tpu_torch.ops import cuda_ww_train, popmajor
from tests.test_torch_ww_apply import _pop

RTOL, ATOL = 1e-5, 1e-6
ACTIVATIONS = ["linear", "sigmoid", "tanh", "relu"]
N = 40


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("activation", ["linear", "tanh"])
def test_plain_chain_matches_pallas_interpret(activation):
    topo = Topology("weightwise", activation=activation)
    jt = JTopology("weightwise", activation=activation)
    wT, other = _pop(topo, N, 2, 0.3), _pop(topo, N, 3, 0.3)

    got_w, got_l = cuda_ww_train.ww_train_epochs(topo, torch.from_numpy(wT), 3)
    ref_w, ref_l = ww_train_epochs_pallas(jt, jnp.asarray(wT), 3,
                                          interpret=True)
    _close(got_w, ref_w)
    _close(got_l, ref_l)

    got_w, got_l = cuda_ww_train.ww_learn_epochs(
        topo, torch.from_numpy(wT), torch.from_numpy(other), 2)
    ref_w, ref_l = ww_learn_epochs_pallas(jt, jnp.asarray(wT),
                                          jnp.asarray(other), 2,
                                          interpret=True)
    _close(got_w, ref_w)
    _close(got_l, ref_l)
    assert cuda_ww_train.WW_SGD.launches == 0


@pytest.mark.parametrize("activation", ["linear", "relu"])
def test_chains_match_jax_grad_chain(activation):
    """Both port chains (hand-derived and autograd) against jax.grad's."""
    topo = Topology("weightwise", activation=activation)
    jt = JTopology("weightwise", activation=activation)
    wT, other = _pop(topo, N, 4, 0.3), _pop(topo, N, 5, 0.3)
    ref_w, ref_l = j_train_popmajor(jt, jnp.asarray(wT), 3)
    ref2_w, ref2_l = j_learn_popmajor(jt, jnp.asarray(wT), jnp.asarray(other),
                                      2)
    # the soup's dispatchers (the SGD kernel's plain chain on the CPU) and
    # the autograd chain
    for train, learn in ((popmajor.train_epochs_popmajor,
                          popmajor.learn_epochs_popmajor),
                         (popmajor.ww_train_epochs_popmajor,
                          popmajor.ww_learn_epochs_popmajor)):
        got_w, got_l = train(topo, torch.from_numpy(wT), 3)
        _close(got_w, ref_w)
        _close(got_l, ref_l)
        got_w, got_l = learn(topo, torch.from_numpy(wT),
                             torch.from_numpy(other), 2)
        _close(got_w, ref2_w)
        _close(got_l, ref2_l)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_hand_backward_matches_autograd(activation):
    topo = Topology("weightwise", activation=activation)
    wT = torch.from_numpy(_pop(topo, 64, 6, 0.5))
    other = torch.from_numpy(_pop(topo, 64, 7, 0.5))
    for got, ref in (
            (cuda_ww_train.ww_train_epochs(topo, wT, 2),
             popmajor.ww_train_epochs_popmajor(topo, wT, 2)),
            (cuda_ww_train.ww_learn_epochs(topo, wT, other, 2),
             popmajor.ww_learn_epochs_popmajor(topo, wT, other, 2))):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL,
                                       atol=ATOL)


def test_zero_epochs_and_fences():
    topo = Topology("weightwise")
    wT = torch.from_numpy(_pop(topo, 8, 8, 1.0))
    w, loss = cuda_ww_train.ww_train_epochs(topo, wT, 0)
    assert torch.equal(w, wT) and torch.equal(loss, torch.zeros(8))
    # the full batch runs its own step (no kernel); the autograd oracle of
    # the sequential chain refuses it
    w, loss = popmajor.train_epochs_popmajor(topo, wT, 1, mode="full_batch")
    ref = popmajor.ww_full_batch_epochs(topo, wT, 1)
    assert torch.equal(w, ref[0]) and torch.equal(loss, ref[1])
    assert not torch.equal(w, wT)
    with pytest.raises(ValueError, match="full_batch"):
        popmajor.ww_train_epochs_popmajor(topo, wT, 1, mode="full_batch")
    with pytest.raises(ValueError, match="derivative"):
        cuda_ww_train.ww_train_epochs(
            Topology("weightwise", activation="elu"), wT, 1)
    with pytest.raises(ValueError, match="derivative"):
        popmajor.learn_epochs_popmajor(
            Topology("weightwise", activation="elu"), wT, wT, 1)
