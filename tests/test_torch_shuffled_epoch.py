"""keras' shuffled epoch on the CPU against the JAX package: the port's
``run_training(order=)``, ``train_step`` / ``learn_from`` / ``fit_epoch``
(``order=``) fed the JAX package's ``jax.random.permutation`` draws
(``engine._run_training``: per epoch e, trial i takes
``permutation(split(fold_in(shuffle_key, e), N)[i], P)``; ``train.fit_epoch``:
``permutation(key, S)``).

The weightwise particle inside the kernels' instantiations runs K2's
shuffled plain twin here (its kernel on the card), an elu one the autograd
chain; the JAX package runs ``jax.grad`` in XLA.  Weights rtol 2e-5 / atol
1e-6, losses rtol 1e-4 / atol 1e-6, classes and counts exact.  The
aggregating, fft and recurrent variants have one sample per epoch, and the
full batch takes no order: there the shuffle is a bitwise no-op, as in the
JAX package.  The plain twin in the identity order is the unshuffled chain
bit for bit, and in any order within the bound of the autograd oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import engine as jengine
from srnn_tpu import train as jtrain
from srnn_tpu.nets import compute_samples as j_samples
import srnn_tpu_torch as st
from srnn_tpu_torch import engine, train
from srnn_tpu_torch.ops import cuda_ww_train, popmajor

W_TOL = dict(rtol=2e-5, atol=1e-6)
L_TOL = dict(rtol=1e-4, atol=1e-6)
N = 8
EPOCHS = 3


def _jt(topo) -> JTopology:
    return JTopology(**dataclasses.asdict(topo))


def _pop(topo, n, seed, scale=0.8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, topo.num_weights)) * scale).astype(
        np.float32)


@jax.jit
def _epoch_perms(key, e):
    """The JAX engine's per-trial orders of epoch ``e``: (N, P)."""
    ks = jax.random.split(jax.random.fold_in(key, e), N)
    return jax.vmap(lambda k: jax.random.permutation(k, 14))(ks)


def _jax_orders(key) -> np.ndarray:
    """uint8 (EPOCHS, P, N): the lane layout of JAX's draws."""
    return np.stack([np.asarray(_epoch_perms(key, e)).T
                     for e in range(EPOCHS)]).astype(np.uint8)


@pytest.mark.parametrize("activation", ["linear", "elu"])
def test_run_training_shuffled_matches_jax(activation):
    topo = st.Topology("weightwise", activation=activation)
    pop = _pop(topo, N, 3)
    key = jax.random.key(9)
    ref = jengine.run_training(_jt(topo), jnp.asarray(pop), epochs=EPOCHS,
                               shuffle_key=key)
    got = engine.run_training(topo, torch.from_numpy(pop), epochs=EPOCHS,
                              order=_jax_orders(key))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                               **W_TOL)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(ref.losses),
                               **L_TOL)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(ref.classes))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    # the unshuffled run differs: the order acts
    plain = engine.run_training(topo, torch.from_numpy(pop), epochs=EPOCHS)
    assert not torch.equal(plain.weights, got.weights)


@jax.jit
def _one_epoch(flat, other, key):
    topo = JTopology("weightwise")
    a = jax.vmap(lambda w, k: jtrain.train_step(topo, w, key=k))(
        flat, jax.random.split(key, N))
    b = jax.vmap(lambda w, o, k: jtrain.learn_from(topo, w, o, key=k))(
        flat, other, jax.random.split(key, N))
    return a, b


def test_train_step_learn_from_and_fit_epoch_match_jax():
    """One shuffled epoch per net of a batch, and a lone net's
    ``fit_epoch`` on fixed samples, in JAX's orders."""
    topo = st.Topology("weightwise")
    w, o = _pop(topo, N, 4), _pop(topo, N, 5)
    key = jax.random.key(2)
    (aw, al), (bw, bl) = _one_epoch(jnp.asarray(w), jnp.asarray(o), key)
    perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 14))(
        jax.random.split(key, N)))  # (N, P)
    got = train.train_step(topo, torch.from_numpy(w), order=perms)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(aw), **W_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(al), **L_TOL)
    got = train.learn_from(topo, torch.from_numpy(w), torch.from_numpy(o),
                           order=perms)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(bw), **W_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(bl), **L_TOL)
    # fit_epoch on a lone net's own samples, autograd on the rows
    jx, jy = (np.array(a) for a in j_samples(_jt(topo), jnp.asarray(w[0])))
    ref = jtrain.fit_epoch(_jt(topo), jnp.asarray(w[0]), jnp.asarray(jx),
                           jnp.asarray(jy), key=key)
    got = train.fit_epoch(topo, torch.from_numpy(w[0]), torch.from_numpy(jx),
                          torch.from_numpy(jy),
                          order=np.asarray(jax.random.permutation(key, 14)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **W_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **L_TOL)


@pytest.mark.parametrize("topo,mode", [
    (st.Topology("aggregating"), "sequential"),
    (st.Topology("fft"), "sequential"),
    (st.Topology("recurrent"), "sequential"),
    (st.Topology("aggregating", aggregates=6, activation="elu"),
     "sequential"),
    (st.Topology("weightwise"), "full_batch")],
    ids=["aggregating", "fft", "recurrent", "agg-autograd",
         "ww-full_batch"])
def test_shuffle_is_a_bitwise_noop(topo, mode):
    """One sample an epoch (or no batch-1 order): the shuffle changes no
    bit, through the engine and through ``train_step``."""
    pop = torch.from_numpy(_pop(topo, N, 6, 0.5))
    gen = torch.Generator().manual_seed(1)
    a = engine.run_training(topo, pop, epochs=2, train_mode=mode,
                            shuffle_key=gen)
    b = engine.run_training(topo, pop, epochs=2, train_mode=mode)
    assert torch.equal(a.weights, b.weights)
    assert torch.equal(a.losses, b.losses)
    assert torch.equal(a.classes, b.classes)
    for x, y in zip(train.train_step(topo, pop, mode=mode, key=gen),
                    train.train_step(topo, pop, mode=mode)):
        assert torch.equal(x, y)


def test_plain_twin_orders():
    """K2's plain twin: the identity order is the unshuffled chain
    bitwise; a random order agrees with the autograd oracle; the wrapper
    checks the order it is handed."""
    topo = st.Topology("weightwise", activation="tanh")
    wT = torch.from_numpy(_pop(topo, N, 7).T.copy())
    oT = torch.from_numpy(_pop(topo, N, 8).T.copy())
    p = topo.num_weights
    ident = torch.arange(p, dtype=torch.uint8)[None, :, None].expand(
        2, p, N).contiguous()
    for other in (None, oT):
        got = cuda_ww_train.ww_sgd_plain(topo, wT, other, 2, 0.01, ident)
        ref = cuda_ww_train.ww_sgd_plain(topo, wT, other, 2, 0.01)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    order = train.sample_order(torch.Generator().manual_seed(3), 2, p, N,
                               "cpu")
    assert order.dtype == torch.uint8 and order.shape == (2, p, N)
    assert torch.equal(order.sort(dim=1).values.long(),
                       torch.arange(p)[None, :, None].expand(2, p, N))
    got = cuda_ww_train.ww_train_epochs(topo, wT, 2, order=order)
    ref = popmajor.ww_train_epochs_popmajor(topo, wT, 2, order=order)
    torch.testing.assert_close(got[0], ref[0], **W_TOL)
    torch.testing.assert_close(got[1], ref[1], **L_TOL)
    for bad in (order[:1], order.long(), torch.full_like(order, p)):
        with pytest.raises(ValueError, match="order"):
            cuda_ww_train.ww_train_epochs(topo, wT, 2, order=bad)
    with pytest.raises(ValueError, match="full_batch"):
        popmajor.ww_train_epochs_popmajor(topo, wT, 2, mode="full_batch",
                                          order=order)
