"""The prototype nets and the hill climber (``srnn_tpu_torch/proto.py``,
``optimize.py``) against the JAX package's, on the same numpy inputs.

Tolerances:

  * ``proto``: shapes, counts and offsets exact; ``fit``'s weights and
    losses rtol 2e-5 where finite, the non-finite pattern exact.  JAX's
    products are XLA dots at precision 'highest' (the SimpleRNN a
    ``lax.scan``), the port's ordered multiply-add chains; the linear
    prototypes collapse to 0 or overflow within a few epochs, which
    amplifies the last bits (1.1e-5 relative seen in the overflowing
    feed-forward run).
  * ``fixpoint_loss``: rtol 1e-6 (2.1e-7 seen: JAX's mean against an
    ordered sum).
  * ``hillclimb`` on JAX's noise: the shots chosen are JAX's (the traces
    within rtol 5e-6, the non-finite pattern exact), the best weights
    within rtol 5e-6 (XLA contracts ``w + noise * std`` into an FMA, and
    the losses differ by up to 2.1e-7 a round; 2.1e-6 seen after six).
    The diverging net is one whose every product overflows on its own:
    between about 3e9 and 1e20 an XLA dot, which contracts its
    multiply-adds into FMAs, sums an overflowed product and a finite one
    to inf, where separate multiplies and adds would sum two overflowed
    products to NaN.  The port's climber scores with the same fused
    chains (``optimize._fma_matmul``: the product and the sum in float64,
    rounded once), so ``test_hillclimb_overflow_band_differs_from_jax``
    holds the two to the same shots at std 1e10 and 1e12 (ROADMAP.md, C,
    fixed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import optimize as joptimize
from srnn_tpu import proto as jproto
from srnn_tpu_torch import convert, optimize, proto
from torch_lazy import Lazy

EPOCHS = 40
SHOTS, ROUNDS = 16, 6

PROTOS = {
    "ff": dict(),
    "ff-wide": dict(features=3, cells=3, layers=3),
    "rnn": dict(recurrent=True),
    "rnn-wide": dict(features=4, cells=2, layers=2, recurrent=True),
}


@pytest.mark.parametrize("name", list(PROTOS))
def test_proto_topology_matches_jax(name):
    jpt, pt = jproto.ProtoTopology(**PROTOS[name]), \
        proto.ProtoTopology(**PROTOS[name])
    assert pt.layer_shapes == jpt.layer_shapes
    assert pt.num_weights == jpt.num_weights
    assert pt.offsets() == jpt.offsets()
    # the builder's count: equal for recurrent nets, an over-count of the
    # feed-forward head (methods.py:36,50)
    assert pt.builder_parameter_count == jpt.builder_parameter_count
    assert (pt.builder_parameter_count == pt.num_weights) == pt.recurrent
    if pt.recurrent:
        assert pt.seq_len == jpt.seq_len


@pytest.fixture(scope="module")
def jax_fits():
    """JAX's fit of each prototype from its own init, at a scale that
    collapses to 0 and one that overflows."""
    def run(key):
        name, scale = key
        jpt = jproto.ProtoTopology(**PROTOS[name])
        w0 = np.asarray(jproto.init_proto(jpt, jax.random.key(1))) \
            * np.float32(scale)
        final, losses = jproto.fit(jpt, jnp.asarray(w0), EPOCHS)
        return w0, np.asarray(final), np.asarray(losses)

    return Lazy(run)


def _close(got, want, rtol):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


@pytest.mark.parametrize("scale", [0.5, 1.5])
@pytest.mark.parametrize("name", ["ff", "rnn"])
def test_fit_matches_jax(jax_fits, name, scale):
    w0, jfinal, jlosses = jax_fits[name, scale]
    pt = proto.ProtoTopology(**PROTOS[name])
    final, losses = proto.fit(pt, torch.from_numpy(w0), EPOCHS)
    assert losses.shape == (EPOCHS,)
    _close(losses.numpy(), jlosses, 2e-5)
    _close(final.numpy(), jfinal, 2e-5)
    # the loss is taken before each update: epoch 0 scores w0 itself
    y, loss0 = proto.apply_self(pt, torch.from_numpy(w0))
    assert float(loss0) == float(losses[0])
    assert torch.equal(proto.fit(pt, torch.from_numpy(w0), 1)[0], y)


@pytest.mark.parametrize("name", list(PROTOS))
def test_forward_and_init(name):
    """Forward shapes against JAX's on the same weights (rtol 1e-6, the
    recurrent stack 2e-5: 5.1e-6 seen along its 10-step chain), and
    the init's law: glorot kernels inside their limits, the recurrent
    kernels orthogonal."""
    jpt, pt = jproto.ProtoTopology(**PROTOS[name]), \
        proto.ProtoTopology(**PROTOS[name])
    w = proto.init_proto(pt, 3, device="cpu")
    assert w.shape == (pt.num_weights,) and w.dtype == torch.float32
    assert torch.equal(w, proto.init_proto(pt, 3, device="cpu"))
    offs = pt.offsets()
    for i, (a, b) in enumerate(pt.layer_shapes):
        k = w[offs[i]:offs[i + 1]].reshape(a, b)
        if pt.recurrent and i < 2 * pt.layers and i % 2 == 1:
            torch.testing.assert_close(k.T @ k, torch.eye(b), rtol=0,
                                       atol=1e-6)
        else:
            assert float(k.abs().max()) <= np.sqrt(6.0 / (a + b))
    wn = w.numpy()
    if pt.recurrent:
        seq = wn.reshape(pt.seq_len, pt.features)
        got = proto.forward_rnn(pt, w, torch.from_numpy(seq)).numpy()
        want = np.asarray(jproto.forward_rnn(jpt, jnp.asarray(wn),
                                             jnp.asarray(seq)))
        assert got.shape == (pt.seq_len, pt.features)
    else:
        x = np.random.default_rng(0).normal(
            size=(5, pt.features)).astype(np.float32)
        got = proto.forward_ff(pt, w, torch.from_numpy(x)).numpy()
        want = np.asarray(jproto.forward_ff(jpt, jnp.asarray(wn),
                                            jnp.asarray(x)))
        assert got.shape == (5, 1)
    np.testing.assert_allclose(got, want, rtol=2e-5 if pt.recurrent
                               else 1e-6, atol=1e-7)


TOPOS = {
    "weightwise": dict(variant="weightwise", width=2, depth=2),
    "aggregating": dict(variant="aggregating", width=2, depth=2,
                        aggregates=4),
}


@pytest.mark.parametrize("variant", list(TOPOS))
def test_fixpoint_loss_matches_jax(variant):
    jtopo = JTopology(**TOPOS[variant])
    topo = convert.topology_from_fields(TOPOS[variant])
    c = np.random.default_rng(4).normal(
        size=(6, topo.num_weights)).astype(np.float32)
    want = np.asarray(jax.vmap(
        lambda x: joptimize.fixpoint_loss(jtopo, x))(jnp.asarray(c)))
    got = optimize.fixpoint_loss(topo, torch.from_numpy(c))
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # one net at a time gives the batch's bits
    assert float(optimize.fixpoint_loss(topo, torch.from_numpy(c[3]))) \
        == float(got[3])


@pytest.mark.parametrize("losses", [
    [1.0, np.nan, 0.0, np.nan], [np.inf, 1.0, -np.inf, -np.inf],
    [2.0, 1.0, 1.0, 3.0], [np.inf, np.inf], [np.nan, np.nan, 0.0],
    [0.5, np.inf, np.nan]])
def test_argmin_is_jnp_argmin(losses):
    losses = np.asarray(losses, np.float32)
    assert int(optimize._argmin(torch.from_numpy(losses))) \
        == int(jnp.argmin(jnp.asarray(losses)))


@pytest.fixture(scope="module")
def jax_climbs():
    """JAX's hill climber and its noise (rounds, shots, P), drawn as its
    scan draws them: one normal block per key of ``split(key, rounds)``."""
    def run(key):
        variant, scale, std = key
        jtopo = JTopology(**TOPOS[variant])
        p = jtopo.num_weights
        w0 = (np.random.default_rng(1).normal(size=p) * scale).astype(
            np.float32)
        k = jax.random.key(2)
        best, trace = joptimize.hillclimb(jtopo, jnp.asarray(w0), k, SHOTS,
                                          ROUNDS, std)
        noise = jax.vmap(lambda kk: jax.random.normal(
            kk, (SHOTS, p), jnp.float32))(jax.random.split(k, ROUNDS))
        return w0, np.asarray(noise), np.asarray(best), np.asarray(trace)

    return Lazy(run)


@pytest.mark.parametrize("variant,scale,std", [
    ("weightwise", 0.5, 0.05), ("aggregating", 0.5, 0.05),
    # a finite incumbent whose shots diverge: a NaN shot beats it
    ("weightwise", 0.5, 1e21)], ids=["weightwise", "aggregating", "nan-shot"])
def test_hillclimb_matches_jax(jax_climbs, variant, scale, std):
    w0, noise, jbest, jtrace = jax_climbs[variant, scale, std]
    topo = convert.topology_from_fields(TOPOS[variant])
    best, trace = optimize.hillclimb(topo, torch.from_numpy(w0), None,
                                     SHOTS, ROUNDS, std, noise=noise)
    _close(trace.numpy(), jtrace, 5e-6)
    np.testing.assert_allclose(best.numpy(), jbest, rtol=5e-6, atol=0)
    if std > 1:
        assert np.isnan(jtrace[0])
        assert not np.isnan(float(optimize.fixpoint_loss(
            topo, torch.from_numpy(w0))))
    else:
        t = trace.numpy()
        assert (np.diff(t) <= 0).all() and t[-1] < t[0]


def test_hillclimb_overflow_band_differs_from_jax(jax_climbs):
    """The band where the two once differed (ROADMAP.md, C, fixed): shots
    of weights about 1e10 and 1e12 overflow every product on its own.
    JAX's dot contracts its multiply-adds into FMAs, which sum an
    overflowed product to inf; the port's climber scores with the same
    fused chains (``optimize._fma_matmul``), so its losses are the same
    classes of non-finite (all inf), JAX keeps the finite incumbent every
    round, and so does the port."""
    for std in (1e10, 1e12):
        w0, noise, jbest, jtrace = jax_climbs["weightwise", 0.5, std]
        jtopo = JTopology(**TOPOS["weightwise"])
        topo = convert.topology_from_fields(TOPOS["weightwise"])
        w = torch.from_numpy(w0)
        cands = torch.cat([w[None], w[None] + torch.tensor(noise[0]) * std])
        jloss = np.asarray(jax.vmap(lambda x: joptimize.fixpoint_loss(
            jtopo, x))(jnp.asarray(cands.numpy())))
        loss = optimize.fixpoint_loss(topo, cands).numpy()
        # the incumbent alone is finite, every shot inf, on both sides
        assert np.isfinite(jloss[0]) and np.isposinf(jloss[1:]).all()
        np.testing.assert_array_equal(np.isposinf(loss), np.isposinf(jloss))
        assert not np.isnan(loss).any()
        best, trace = optimize.hillclimb(topo, w, None, SHOTS, ROUNDS, std,
                                         noise=noise)
        np.testing.assert_array_equal(jbest, w0)
        np.testing.assert_array_equal(best.numpy(), jbest)
        _close(trace.numpy(), jtrace, 5e-6)


def test_hillclimb_own_draws():
    """With a generator: reproducible, monotone, and refused without one."""
    topo = convert.topology_from_fields(TOPOS["weightwise"])
    w0 = torch.from_numpy(np.random.default_rng(1).normal(
        size=topo.num_weights).astype(np.float32) * 0.5)
    runs = [optimize.hillclimb(topo, w0, torch.Generator().manual_seed(7),
                               SHOTS, ROUNDS) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert (runs[0][1].diff() <= 0).all()
    with pytest.raises(ValueError, match="generator= or noise="):
        optimize.hillclimb(topo, w0)
    with pytest.raises(ValueError, match="noise must have shape"):
        optimize.hillclimb(topo, w0, noise=np.zeros((1, 2, 3), np.float32))
