"""K3's plain version against the JAX package's generation kernel in
interpret mode, with the gate construction of
tests/test_fused_generation.py (some imitation targets were attacked this
generation, so the in-kernel recompute is exercised)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu.ops.pallas_generation import \
    generation_popmajor as j_generation
from srnn_tpu_torch import Topology
from srnn_tpu_torch.ops import cuda_generation as cg
from srnn_tpu_torch.ops.popmajor import (apply_popmajor,
                                         learn_epochs_popmajor,
                                         train_epochs_popmajor)
from srnn_tpu_torch.ops.predicates import is_diverged, is_zero
from tests.test_torch_ww_apply import _pop

N, SEV, TRAIN, LR, EPS = 40, 1, 2, 0.01, 1e-4


def _operands(topo, scale=0.4):
    wT = _pop(topo, N, 10, scale)
    wT[:, 5] = np.inf     # a divergent lane
    wT[:, 6] = 0.0        # a zero lane (no gate touches it, see below)
    lanes = np.arange(N)
    att_idx = np.where(lanes % 3 == 0, (lanes * 7) % N, -1)
    att_idx[6] = -1
    has_attacker = att_idx >= 0
    learn_gate = (lanes % 4) == 1
    learn_tgt = (lanes * 3) % N
    fresh = _pop(topo, N, 11, 1.0)
    assert has_attacker[learn_tgt][learn_gate].any()
    oa = att_idx[learn_tgt]
    ops = dict(wT=wT, freshT=fresh, attackerT=wT[:, np.clip(att_idx, 0, None)],
               has_attacker=has_attacker, otherT=wT[:, learn_tgt],
               other_attackerT=wT[:, np.clip(oa, 0, None)],
               other_attacked=oa >= 0, learn_gate=learn_gate)
    return ops, att_idx, learn_tgt


KW = dict(severity=SEV, train=TRAIN, lr=LR, remove_divergent=True,
          remove_zero=True, epsilon=EPS)


def _torch_ops(ops):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ops.items()}


@pytest.mark.parametrize("activation", ["linear", "sigmoid"])
def test_plain_matches_pallas_interpret(activation):
    topo = Topology("weightwise", activation=activation)
    ops, _, _ = _operands(topo)
    ref = j_generation(JTopology("weightwise", activation=activation),
                       **{k: jnp.asarray(v) for k, v in ops.items()},
                       interpret=True, **KW)
    got = cg.generation_popmajor(topo, **_torch_ops(ops), **KW)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[2][5]
    if activation == "linear":  # a zero linear net stays zero; a sigmoid one not
        assert got[3][6]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-6)
    assert cg.GENERATION.launches == 0


def test_plain_matches_port_phase_chain():
    """The fused spelling against the port's own phase chain (autograd SGD),
    built from indices as the soup builds it."""
    topo = Topology("weightwise")
    ops, att_idx, learn_tgt = _operands(topo)
    t = _torch_ops(ops)
    wT, has = t["wT"], t["has_attacker"]
    att = torch.from_numpy(np.clip(att_idx, 0, None))
    ref = torch.where(has[None], apply_popmajor(topo, wT[:, att], wT), wT)
    learned, _ = learn_epochs_popmajor(topo, ref,
                                       ref[:, torch.from_numpy(learn_tgt)],
                                       SEV, LR)
    ref = torch.where(t["learn_gate"][None], learned, ref)
    ref, ref_loss = train_epochs_popmajor(topo, ref, TRAIN, LR)
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
