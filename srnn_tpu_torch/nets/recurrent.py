"""Recurrent variant, row-major: a SimpleRNN stack reading the weight
vector as a length-P sequence.  Port of ``srnn_tpu/nets/recurrent.py``
(the serial scan).

Reference: ``RecurrentNeuralNetwork`` (``network.py:524-574``).  The
target's flat weights become a (T = P, features = 1) sequence; the stack
(units = width per layer, a final layer of one unit, ``return_sequences``
everywhere, ``network.py:526-535``) maps it to a new length-P sequence
written back positionally.  Keras' update is h_t = act(x_t @ K + h_{t-1} @
R), no bias, h_{-1} = 0.  Both products are written as explicit
multiply-add chains, so that 0 * Inf = NaN holds for the zero initial
state too.  ``rnn_scan='associative'`` is not ported and raises.
"""

import torch

from ..ops.activations import resolve_activation
from ..ops.mlp import unflatten
from ..topology import Topology


def check_scan(topo: Topology) -> None:
    if topo.rnn_scan != "sequential":
        raise ValueError(
            f"rnn_scan={topo.rnn_scan!r} is not ported; srnn_tpu_torch runs "
            "the serial scan (rnn_scan='sequential')")


def _vecmat(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., a) row vector times (..., a, b) -> (..., b), summed in order
    i = 0..a-1."""
    acc = x[..., 0:1] * m[..., 0, :]
    for i in range(1, m.shape[-2]):
        acc = acc + x[..., i:i + 1] * m[..., i, :]
    return acc


def forward(topo: Topology, self_flat: torch.Tensor,
            seq: torch.Tensor) -> torch.Tensor:
    """Run the stacked RNN over ``seq`` (..., T, 1) -> (..., T, 1)."""
    check_scan(topo)
    act = resolve_activation(topo.activation)
    mats = unflatten(topo, self_flat)
    x = seq
    for layer, (_, units) in enumerate(topo.rnn_layer_dims):
        kernel, recurrent = mats[2 * layer], mats[2 * layer + 1]
        lead = torch.broadcast_shapes(x.shape[:-2], self_flat.shape[:-1])
        h = torch.zeros(*lead, units, dtype=seq.dtype, device=seq.device)
        outs = []
        for t in range(x.shape[-2]):
            h = act(_vecmat(x[..., t, :], kernel) + _vecmat(h, recurrent))
            outs.append(h)
        x = torch.stack(outs, dim=-2)
    return x


def apply(topo: Topology, self_flat: torch.Tensor,
          target_flat: torch.Tensor) -> torch.Tensor:
    """One predict over the whole weight sequence (``network.py:544-564``)."""
    return forward(topo, self_flat, target_flat[..., None])[..., 0]


def samples(topo: Topology, flat: torch.Tensor):
    """x = y = the (..., 1, T, 1) weight sequence (``compute_samples``,
    ``network.py:566-574``)."""
    seq = flat[..., None, :, None]
    return seq, seq
