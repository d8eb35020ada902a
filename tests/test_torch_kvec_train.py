"""K4's plain chain (hand-derived backward, cos-basis DFT, poison chains)
and the port's autograd chain (``popmajor_kvec``, ``torch.fft``) against
the JAX package's k-vector SGD chain: the Pallas kernel in interpret mode
and its XLA twin.  Tolerances of tests/test_pallas_train.py:72-76: weights
rtol 1e-5 / atol 1e-6, losses rtol 1e-4 / atol 1e-6 (the fft rows compare
a cos-basis chain with an FFT: float noise only)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu.ops.pallas_kvec_train import (kvec_learn_epochs_pallas,
                                            kvec_train_epochs_pallas)
from srnn_tpu.ops.popmajor_kvec import (kvec_reduce_popmajor as j_reduce,
                                        kvec_train_epochs_popmajor as
                                        j_train_popmajor)
from srnn_tpu_torch import Topology
from srnn_tpu_torch.ops import cuda_kvec_train as ck
from srnn_tpu_torch.ops import popmajor, popmajor_kvec
from tests.test_torch_ww_apply import _pop

N, EPOCHS, SEVERITY = 24, 3, 2
W_TOL = dict(rtol=1e-5, atol=1e-6)
L_TOL = dict(rtol=1e-4, atol=1e-6)
# the six topologies of tests/test_pallas_train.py:60-67
TOPOS = {
    "agg-avg": Topology("aggregating"),
    "agg-maxbuggy": Topology("aggregating", aggregator="max_buggy"),
    "agg-sigmoid": Topology("aggregating", activation="sigmoid"),
    "agg-relu": Topology("aggregating", activation="relu"),
    "fft": Topology("fft"),
    "rfft": Topology("fft", fft_mode="rfft"),
}
LEARN = ("agg-avg", "rfft")


def _jt(topo: Topology) -> JTopology:
    return JTopology(**dataclasses.asdict(topo))


@pytest.fixture(scope="module")
def jax_runs():
    """Per topology: (wT, other, Pallas train result, Pallas learn result
    or None), all at N = 24 in interpret mode."""
    runs = {}
    for name, topo in TOPOS.items():
        wT, other = _pop(topo, N, 0, 0.3), _pop(topo, N, 1, 0.3)
        train = kvec_train_epochs_pallas(_jt(topo), jnp.asarray(wT), EPOCHS,
                                         interpret=True)
        learn = None
        if name in LEARN:
            learn = kvec_learn_epochs_pallas(_jt(topo), jnp.asarray(wT),
                                             jnp.asarray(other), SEVERITY,
                                             interpret=True)
        runs[name] = (wT, other, train, learn)
    return runs


def _close(got, ref):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **W_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **L_TOL)


@pytest.mark.parametrize("name", list(TOPOS))
def test_plain_chain_matches_pallas_interpret(jax_runs, name):
    topo = TOPOS[name]
    wT, other, train, learn = jax_runs[name]
    _close(ck.kvec_train_epochs(topo, torch.from_numpy(wT), EPOCHS), train)
    if learn is not None:
        _close(ck.kvec_learn_epochs(topo, torch.from_numpy(wT),
                                    torch.from_numpy(other), SEVERITY), learn)
    assert ck.KVEC_SGD.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("name", list(TOPOS))
def test_autograd_chain_matches_pallas_interpret(jax_runs, name):
    """The independent oracle: autograd through the torch.fft / one-hot
    chain reduce, both train modes (one program for these variants)."""
    topo = TOPOS[name]
    wT, other, train, learn = jax_runs[name]
    for mode in ("sequential", "full_batch"):
        _close(popmajor_kvec.kvec_train_epochs_popmajor(
            topo, torch.from_numpy(wT), EPOCHS, mode=mode), train)
        if learn is not None:
            _close(popmajor_kvec.kvec_learn_epochs_popmajor(
                topo, torch.from_numpy(wT), torch.from_numpy(other),
                SEVERITY, mode=mode), learn)


def test_nonfinite_propagation_matches_jax():
    """tests/test_pallas_train.py:79-107: an Inf inside segment 0 stays Inf
    in its own aggregate and turns every other aggregate NaN (0 * Inf), in
    the plain reduce, the autograd reduce and through training."""
    topo = TOPOS["agg-avg"]
    wT = _pop(topo, 8, 0, 0.3)
    wT[3, 2] = np.inf  # row 3 lies inside segment 0 (P = 20, k = 4)
    ref_k = np.asarray(j_reduce(_jt(topo), jnp.asarray(wT)))
    assert np.isinf(ref_k[0, 2]) and np.isnan(ref_k[1:, 2]).all()
    rows = list(torch.from_numpy(wT).unbind(0))
    for got_k in (torch.stack(ck.reduce_rows_plain(topo, rows)).numpy(),
                  popmajor_kvec.kvec_reduce_popmajor(
                      topo, torch.from_numpy(wT)).numpy()):
        np.testing.assert_array_equal(np.isinf(got_k), np.isinf(ref_k))
        np.testing.assert_array_equal(np.isnan(got_k), np.isnan(ref_k))
    ref_w, ref_l = (np.asarray(a) for a in j_train_popmajor(
        _jt(topo), jnp.asarray(wT), 2))
    got_w, got_l = (a.numpy() for a in ck.kvec_train_epochs(
        topo, torch.from_numpy(wT), 2))
    np.testing.assert_array_equal(np.isnan(got_w), np.isnan(ref_w))
    np.testing.assert_array_equal(np.isnan(got_l), np.isnan(ref_l))
    fin = np.isfinite(ref_w)
    np.testing.assert_allclose(got_w[fin], ref_w[fin], **W_TOL)


@pytest.mark.parametrize("activation", ["linear", "sigmoid", "tanh", "relu"])
@pytest.mark.parametrize("kind", [
    dict(variant="aggregating"), dict(variant="aggregating", aggregator="max"),
    dict(variant="aggregating", aggregator="max_buggy"),
    dict(variant="fft"), dict(variant="fft", fft_mode="rfft")],
    ids=["avg", "max", "maxbuggy", "fft", "rfft"])
def test_hand_chain_matches_autograd(kind, activation):
    topo = Topology(activation=activation, **kind)
    wT = torch.from_numpy(_pop(topo, 64, 6, 0.5))
    other = torch.from_numpy(_pop(topo, 64, 7, 0.5))
    for got, ref in (
            (ck.kvec_train_epochs(topo, wT, 2),
             popmajor_kvec.kvec_train_epochs_popmajor(topo, wT, 2)),
            (ck.kvec_learn_epochs(topo, wT, other, 2),
             popmajor_kvec.kvec_learn_epochs_popmajor(topo, wT, other, 2))):
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), **W_TOL)
        np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), **L_TOL)


def test_zero_epochs_dispatch_and_fences():
    topo = TOPOS["agg-avg"]
    wT = torch.from_numpy(_pop(topo, 8, 8, 1.0))
    w, loss = ck.kvec_train_epochs(topo, wT, 0)
    assert torch.equal(w, wT) and torch.equal(loss, torch.zeros(8))
    # the soup's dispatchers route both train modes to K4's wrapper
    for mode in ("sequential", "full_batch"):
        got = popmajor.train_epochs_popmajor(topo, wT, 2, mode=mode)
        ref = ck.kvec_train_epochs(topo, wT, 2)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="train mode"):
        popmajor.train_epochs_popmajor(topo, wT, 1, mode="minibatch")
    with pytest.raises(ValueError, match="derivative"):
        ck.kvec_train_epochs(Topology("aggregating", activation="elu"), wT, 1)
    with pytest.raises(ValueError, match="variant"):
        ck.kvec_train_epochs(Topology("weightwise"), wT, 1)
    with pytest.raises(ValueError, match="population"):
        ck.kvec_learn_epochs(topo, wT, wT[:14].contiguous(), 1)


@pytest.mark.parametrize("topo", [Topology("fft", width=3, depth=3),
                                  Topology("fft", width=3, depth=3,
                                           fft_mode="rfft")],
                         ids=["fft-w3d3", "rfft-w3d3"])
def test_kvec_build_once_per_topology(monkeypatch, topo):
    """Every launch asks ``kvec_build`` for its build: an fft topology's
    DFT table is generated on the first ask only, and the next asks (an
    equal topology, not the same object) get an equal build."""
    made = []
    real = ck.dft_table_header

    def header(t):
        made.append(t)
        return real(t)

    ck.kvec_build.cache_clear()
    monkeypatch.setattr(ck, "dft_table_header", header)
    first = ck.kvec_build(topo)
    again = ck.kvec_build(dataclasses.replace(topo))
    assert again == first and first.headers
    assert len(made) == 1
    assert first.headers[0][1] == real(topo)
    ck.kvec_build.cache_clear()
