"""K3's plain version, every variant body, against the JAX package's
generation kernel in interpret mode, with the gate construction of
tests/test_fused_generation.py (some imitation targets were attacked this
generation, so the in-kernel recompute is exercised).  Dead masks exact;
weights within rtol 2e-5 / atol 1e-6, losses within rtol 1e-4 / atol 1e-6
(tests/test_fused_generation.py's generation tolerance)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu.ops.pallas_generation import \
    generation_popmajor as j_generation
from srnn_tpu_torch import Topology
from srnn_tpu_torch.ops import cuda_generation as cg
from srnn_tpu_torch.ops import popmajor, popmajor_kvec, popmajor_rnn
from srnn_tpu_torch.ops.popmajor import apply_popmajor, train_epochs_popmajor
from srnn_tpu_torch.ops.predicates import is_diverged, is_zero
from tests.test_torch_ww_apply import _pop

N, SEV, TRAIN, LR, EPS = 40, 1, 2, 0.01, 1e-4
#: the other variants' bodies, at N = 24 in interpret mode
BODIES = {
    "agg-avg": Topology("aggregating"),
    "agg-maxbuggy-relu": Topology("aggregating", aggregator="max_buggy",
                                  activation="relu"),
    "fft": Topology("fft"),
    "rfft-target": Topology("fft", fft_mode="rfft", fft_use_target=True),
    "recurrent-tanh": Topology("recurrent", activation="tanh"),
}


def _lanes(topo, n, seed, scale):
    """(P, n) float32 population from numpy: glorot rows, or uniform rows
    for the recurrent variant (whose orthogonal law has no per-row
    limit)."""
    if topo.variant != "recurrent":
        return _pop(topo, n, seed, scale)
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (topo.num_weights, n)) * scale).astype(
        np.float32)


def _operands(topo, scale=0.4, n=N):
    wT = _lanes(topo, n, 10, scale)
    wT[:, 5] = np.inf     # a divergent lane
    wT[:, 6] = 0.0        # a zero lane (no gate touches it, see below)
    lanes = np.arange(n)
    att_idx = np.where(lanes % 3 == 0, (lanes * 7) % n, -1)
    att_idx[6] = -1
    has_attacker = att_idx >= 0
    learn_gate = (lanes % 4) == 1
    learn_tgt = (lanes * 3) % n
    fresh = _lanes(topo, n, 11, 1.0)
    assert has_attacker[learn_tgt][learn_gate].any()
    oa = att_idx[learn_tgt]
    ops = dict(wT=wT, freshT=fresh, attackerT=wT[:, np.clip(att_idx, 0, None)],
               has_attacker=has_attacker, otherT=wT[:, learn_tgt],
               other_attackerT=wT[:, np.clip(oa, 0, None)],
               other_attacked=oa >= 0, learn_gate=learn_gate)
    return ops, att_idx, learn_tgt


#: variant -> the port's autograd (train, learn) chains, the phase chain's
#: independent oracle
_AUTOGRAD = {
    "weightwise": (popmajor.ww_train_epochs_popmajor,
                   popmajor.ww_learn_epochs_popmajor),
    "aggregating": (popmajor_kvec.kvec_train_epochs_popmajor,
                    popmajor_kvec.kvec_learn_epochs_popmajor),
    "fft": (popmajor_kvec.kvec_train_epochs_popmajor,
            popmajor_kvec.kvec_learn_epochs_popmajor),
    "recurrent": (popmajor_rnn.rnn_train_epochs_popmajor,
                  popmajor_rnn.rnn_learn_epochs_popmajor),
}

KW = dict(severity=SEV, train=TRAIN, lr=LR, remove_divergent=True,
          remove_zero=True, epsilon=EPS)


def _torch_ops(ops):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ops.items()}


def _check_against_pallas(topo, n):
    ops, _, _ = _operands(topo, n=n)
    ref = j_generation(JTopology(**dataclasses.asdict(topo)),
                       **{k: jnp.asarray(v) for k, v in ops.items()},
                       interpret=True, **KW)
    got = cg.generation_popmajor(topo, **_torch_ops(ops), **KW)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[2][5]
    if topo.activation in ("linear", "relu"):  # a zero net stays zero
        assert got[3][6]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-6)
    for k in (cg.GENERATION, cg.GENERATION_KVEC, cg.GENERATION_RNN):
        assert k.launches == 0


@pytest.mark.parametrize("activation", ["linear", "sigmoid"])
def test_plain_matches_pallas_interpret(activation):
    _check_against_pallas(Topology("weightwise", activation=activation), N)


@pytest.mark.parametrize("name", list(BODIES))
def test_bodies_match_pallas_interpret(name):
    """The aggregating, fft and recurrent bodies (N = 24)."""
    _check_against_pallas(BODIES[name], 24)


@pytest.mark.parametrize("topo", [Topology("weightwise")] + [
    BODIES[k] for k in ("agg-avg", "rfft-target", "recurrent-tanh")],
    ids=["weightwise", "agg-avg", "rfft-target", "recurrent-tanh"])
def test_plain_matches_port_phase_chain(topo):
    """The fused spelling against the port's own phase chain (the autograd
    SGD chains; torch.fft for the fft transform), built from indices as the
    soup builds it."""
    ops, att_idx, learn_tgt = _operands(topo)
    t = _torch_ops(ops)
    wT, has = t["wT"], t["has_attacker"]
    att = torch.from_numpy(np.clip(att_idx, 0, None))
    ref = torch.where(has[None], apply_popmajor(topo, wT[:, att], wT), wT)
    learned, _ = _AUTOGRAD[topo.variant][1](
        topo, ref, ref[:, torch.from_numpy(learn_tgt)], SEV, LR)
    ref = torch.where(t["learn_gate"][None], learned, ref)
    ref, ref_loss = _AUTOGRAD[topo.variant][0](topo, ref, TRAIN, LR)
    div = is_diverged(ref, axis=0)
    zero = is_zero(ref, EPS, axis=0) & ~div
    ref = torch.where((div | zero)[None], t["freshT"], ref)
    got = cg.generation_popmajor(topo, **t, **KW)
    assert torch.equal(got[2], div) and torch.equal(got[3], zero)
    np.testing.assert_allclose(got[0].numpy(), ref.numpy(), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), ref_loss.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_phases_off():
    """No attack and no learners: the generation is self-training plus
    respawn, and disabled removals kill nothing."""
    topo = Topology("weightwise")
    ops, _, _ = _operands(topo)
    t = _torch_ops(ops)
    out, loss, div, zero = cg.generation_popmajor(
        topo, t["wT"], t["freshT"], train=TRAIN, lr=LR)
    ref, ref_loss = train_epochs_popmajor(topo, t["wT"], TRAIN, LR)
    assert not div.any() and not zero.any()
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(loss, ref_loss, rtol=0, atol=0, equal_nan=True)
    assert not cg.fused_kernel_supported(
        Topology("weightwise", activation="elu"), "sequential")
    assert not cg.fused_kernel_supported(topo, "full_batch")
