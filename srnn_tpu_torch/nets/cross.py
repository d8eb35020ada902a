"""Cross-architecture self-application, row-major: any attacker variant
against any victim topology.  Port of ``srnn_tpu/nets/cross.py``.

The reference's ``attack(other)`` (``network.py:116-118``) only ever meets
same-class nets, but each transform is defined for any victim: the
weightwise net rewrites every victim weight from the VICTIM's own coordinate
table; the aggregating net chunks the victim's weight count into the
ATTACKER's k collections (``segments_for``); the fft net inverse-expands to
the victim's length; the recurrent net reads the victim's weights as a
sequence of any length.  Decisions kept from the JAX package:

  * cross-shape max is the REAL max, for 'max_buggy' too -- the falsy-max
    quirk is reproduced only for same-topology application
    (``aggregating.apply``);
  * the average collects with a one-hot product over every victim weight
    (a multiply-add chain here, so a non-finite weight poisons every
    aggregate as the JAX package's matmul does); deaggregation is a gather;
  * the fft arm always runs the plain DFT (``fft_mode`` is not read):
    ``fft(src, n=k).real``, then ``ifft(., n=P_victim).real``, ``src`` the
    attacker's own weights unless ``fft_use_target``.

The attacker's MLP runs as the explicit multiply-add chains of the
self-application (``ops/mlp.mlp_apply``), which round alike on the card
and the CPU; so the row-major mixed soup, like the homogeneous one, is the
same soup on either device (the fft arm's ``torch.fft`` apart).
``cross_apply(t, a, t, v)`` with equal topologies equals
``apply_to_weights(t, a, v)`` for every variant but the max aggregators'
quirk.  An aggregating or fft attacker with ``shuffler='random'`` permutes
the victim's new weights (``aggregating.shuffle``: ``perm=``, (...,
P_victim), or ``generator=``; without either it raises, as the JAX
package's row-major soup does, which passes no key).  Every function takes
flat weights (..., P); leading dims are a batch of particles.
"""

import numpy as np
import torch

from ..ops.mlp import mlp_apply
from ..topology import Topology, segments_for
from . import recurrent as rnn_mod
from . import weightwise as ww_mod
from .aggregating import onehot_chain, shuffle


def cross_aggregate(attacker: Topology,
                    victim_flat: torch.Tensor) -> torch.Tensor:
    """Chunk (..., P_victim) weights into the attacker's k collections and
    reduce each -> (..., k)."""
    p = victim_flat.shape[-1]
    seg, counts = segments_for(p, attacker.aggregates)
    if attacker.aggregator == "average":
        onehot = np.eye(attacker.aggregates, dtype=np.float32)[seg]
        cnt = torch.as_tensor(counts, dtype=victim_flat.dtype,
                              device=victim_flat.device)
        return onehot_chain(victim_flat, onehot) / cnt
    if attacker.aggregator in ("max", "max_buggy"):
        starts = np.searchsorted(seg, np.arange(attacker.aggregates))
        return torch.stack([victim_flat[..., s:s + c].amax(dim=-1)
                            for s, c in zip(starts, counts)], dim=-1)
    raise ValueError(f"unknown aggregator {attacker.aggregator!r}")


def cross_apply(attacker: Topology, attacker_flat: torch.Tensor,
                victim: Topology, victim_flat: torch.Tensor, perm=None,
                generator=None) -> torch.Tensor:
    """The attacker's transform applied to the victim's weights; returns
    the victim's new (..., P_victim) weights."""
    p_vic = victim_flat.shape[-1]
    if attacker.variant == "weightwise":
        pts = ww_mod.points(victim, victim_flat)
        return mlp_apply(attacker, attacker_flat, pts)[..., 0]
    if attacker.variant == "aggregating":
        aggs = cross_aggregate(attacker, victim_flat)
        new = mlp_apply(attacker, attacker_flat, aggs[..., None, :])
        seg, _ = segments_for(p_vic, attacker.aggregates)
        return shuffle(attacker, new[..., 0, torch.as_tensor(
            seg, dtype=torch.long, device=new.device)], perm, generator)
    if attacker.variant == "fft":
        src = victim_flat if attacker.fft_use_target else attacker_flat
        coeffs = torch.fft.fft(src, n=attacker.aggregates).real.to(
            victim_flat.dtype)
        new = mlp_apply(attacker, attacker_flat, coeffs[..., None, :])
        return shuffle(attacker, torch.fft.ifft(new[..., 0, :], n=p_vic)
                       .real.to(victim_flat.dtype), perm, generator)
    if attacker.variant == "recurrent":
        return rnn_mod.forward(attacker, attacker_flat,
                               victim_flat[..., None])[..., 0]
    raise ValueError(f"unknown variant {attacker.variant!r}")
