"""Population-major cross-architecture attacks: the lane-layout twin of
``nets/cross.py``; port of ``srnn_tpu/ops/popmajor_cross.py``.

The mixed-type soup (``multisoup.py``) lets any attacker variant rewrite
any victim type.  The victims are a (P_vic, N) matrix and the attackers'
parameters a (P_att, N) column gather (attacker n rewrites victim n); each
pair runs the per-lane program of the attacker's variant with the shape
constants taken from the victim side, decision for decision as in
``nets/cross.py``:

  * weightwise: the VICTIM's normalised duplex coordinates, the attacker's
    MLP (``ww_forward_popmajor`` with the victim's table);
  * aggregating: the victim's weight count chunked into the attacker's k
    collections.  The average is the one-hot product written as a
    multiply-add chain over all P_vic rows, the 0.0-weighted terms too, so
    one non-finite victim weight poisons every aggregate (0 * Inf = NaN)
    as the JAX package's matmul does -- no segment sum, no matmul that
    might skip them.  Cross-shape max is the real max.  Expansion is the
    row gather;
  * fft: always the plain DFT along axis 0 (``fft_mode`` is not read),
    ``src`` the attacker's own weights unless ``fft_use_target``;
  * recurrent: the victim's weights as the input sequence, through K6's
    wrapper (``apply_popmajor`` -> ``rnn_apply``), which the card runs for
    victims of length 14, 17 and 20.

The weightwise, aggregating and fft arms are plain torch, as they are XLA
in the JAX package (it has no kernel for them).  ``shuffler='random'``
stays row-major-only, as in the JAX package: a per-particle permutation is
a per-lane gather, and an attacker with it raises here (the
population-major soups refuse it upfront).
"""

import numpy as np
import torch

from ..topology import Topology, segments_for
from .popmajor import apply_popmajor, ww_forward_popmajor
from .popmajor_kvec import onehot_rows, mlp_forward_lanes


def _agg_cross(att: Topology, selfT: torch.Tensor,
               targetT: torch.Tensor) -> torch.Tensor:
    p = targetT.shape[0]
    seg, counts = segments_for(p, att.aggregates)
    if att.aggregator == "average":
        onehotT = np.eye(att.aggregates, dtype=np.float32)[seg].T
        cnt = torch.as_tensor(counts, dtype=targetT.dtype,
                              device=targetT.device)
        aggs = onehot_rows(onehotT, targetT) / cnt[:, None]
    elif att.aggregator in ("max", "max_buggy"):
        # cross-shape max is the real max (nets/cross.py)
        starts = np.searchsorted(seg, np.arange(att.aggregates))
        aggs = torch.stack([targetT[s:s + c].amax(dim=0)
                            for s, c in zip(starts, counts)])
    else:
        raise ValueError(f"unknown aggregator {att.aggregator!r}")
    new_aggs = mlp_forward_lanes(att, selfT, aggs)
    return new_aggs[torch.as_tensor(seg, dtype=torch.long,
                                    device=targetT.device)]


def _fft_cross(att: Topology, selfT: torch.Tensor,
               targetT: torch.Tensor) -> torch.Tensor:
    src = targetT if att.fft_use_target else selfT
    coeffs = torch.fft.fft(src, n=att.aggregates, dim=0).real.to(
        targetT.dtype)
    new_coeffs = mlp_forward_lanes(att, selfT, coeffs)
    return torch.fft.ifft(new_coeffs, n=targetT.shape[0], dim=0).real.to(
        targetT.dtype).contiguous()


def _check_lane_capable(att: Topology) -> None:
    if att.shuffler == "random":
        raise ValueError(
            "shuffler='random' is a per-lane permutation — use the "
            "row-major multisoup layout")


def cross_apply_popmajor(att: Topology, selfT: torch.Tensor, vic: Topology,
                         targetT: torch.Tensor) -> torch.Tensor:
    """Attacker n (parameters ``selfT[:, n]``, (P_att, N)) rewrites victim
    n (``targetT[:, n]``, (P_vic, N)); returns the victims' new (P_vic, N)
    weights."""
    _check_lane_capable(att)
    if att.variant == "weightwise":
        return ww_forward_popmajor(att, selfT, targetT, coords_of=vic)
    if att.variant == "aggregating":
        return _agg_cross(att, selfT, targetT)
    if att.variant == "fft":
        return _fft_cross(att, selfT, targetT)
    if att.variant == "recurrent":
        return apply_popmajor(att, selfT, targetT)
    raise ValueError(f"unknown variant {att.variant!r}")
