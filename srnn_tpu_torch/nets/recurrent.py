"""Recurrent variant, row-major: a SimpleRNN stack reading the weight
vector as a length-P sequence.  Port of ``srnn_tpu/nets/recurrent.py``.

Reference: ``RecurrentNeuralNetwork`` (``network.py:524-574``).  The
target's flat weights become a (T = P, features = 1) sequence; the stack
(units = width per layer, a final layer of one unit, ``return_sequences``
everywhere, ``network.py:526-535``) maps it to a new length-P sequence
written back positionally.  Keras' update is h_t = act(x_t @ K + h_{t-1} @
R), no bias, h_{-1} = 0.  Both products are written as explicit
multiply-add chains, so that 0 * Inf = NaN holds for the zero initial
state too.

``rnn_scan='associative'`` (linear activation only, ``Topology`` checks)
solves each layer as an associative scan over the affine maps h -> h @ A +
b (A = R, b_t = x_t @ K), composed ``(A1, b1) . (A2, b2) = (A1 @ A2, b1 @
A2 + b2)``: the recursion of ``jax.lax.associative_scan`` (pairs combined,
the half-length scan recursed, the even elements completed, the two
interleaved) with every product an explicit multiply-add chain.  The same
map as the serial scan up to float reassociation; on the CPU it follows
the JAX package's combine order step for step.
"""

import torch

from ..ops.activations import resolve_activation
from ..ops.flatten import unflatten
from ..topology import Topology


def _vecmat(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., a) row vector times (..., a, b) -> (..., b), summed in order
    i = 0..a-1."""
    acc = x[..., 0:1] * m[..., 0, :]
    for i in range(1, m.shape[-2]):
        acc = acc + x[..., i:i + 1] * m[..., i, :]
    return acc


def _matmat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) times (..., k, n) -> (..., m, n), every entry summed in
    order i = 0..k-1."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., :, i:i + 1] * b[..., i:i + 1, :]
    return acc


def _combine(lhs, rhs):
    """The affine map ``lhs`` then ``rhs``: (A1 @ A2, b1 @ A2 + b2)."""
    (a1, b1), (a2, b2) = lhs, rhs
    return _matmat(a1, a2), _vecmat(b1, a2) + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 0 (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[0]
    both = torch.stack([even[:n], odd], dim=1).flatten(0, 1)
    return torch.cat([both, even[n:]]) if even.shape[0] > n else both


def _associative_scan(elems):
    """Inclusive scan of the affine maps ``elems`` = (A, b), time on axis 0,
    by ``jax.lax.associative_scan``'s recursion."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = _combine([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = _combine(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[0:1], r]) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _forward_associative(topo: Topology, self_flat: torch.Tensor,
                         seq: torch.Tensor) -> torch.Tensor:
    """The linear stack by associative scans (``_forward_associative`` of
    the JAX package): h0 = 0, so h_t is the scan's accumulated offset."""
    mats = unflatten(topo, self_flat)
    x = seq
    for layer, (_, units) in enumerate(topo.rnn_layer_dims):
        kernel, recurrent = mats[2 * layer], mats[2 * layer + 1]
        t_len = x.shape[-2]
        # time leads: each step's b_t = x_t @ K and a stacked copy of R per
        # step, so that no gradient sums over a time axis broadcast in the
        # forward (a reduction the card and the CPU may order apart)
        b = torch.stack([_vecmat(x[..., t, :], kernel)
                         for t in range(t_len)])          # (T, ..., units)
        a = torch.stack([recurrent] * t_len).expand(*b.shape, units)
        _, h = _associative_scan([a, b])
        x = h.movedim(0, -2)
    return x


def forward(topo: Topology, self_flat: torch.Tensor,
            seq: torch.Tensor) -> torch.Tensor:
    """Run the stacked RNN over ``seq`` (..., T, 1) -> (..., T, 1)."""
    if topo.rnn_scan == "associative":
        return _forward_associative(topo, self_flat, seq)
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
          target_flat: torch.Tensor, perm=None,
          generator=None) -> torch.Tensor:
    """One predict over the whole weight sequence (``network.py:544-564``);
    ``perm`` and ``generator`` are not read (no shuffler acts here, as in
    the JAX package)."""
    return forward(topo, self_flat, target_flat[..., None])[..., 0]


def samples(topo: Topology, flat: torch.Tensor):
    """x = y = the (..., 1, T, 1) weight sequence (``compute_samples``,
    ``network.py:566-574``)."""
    seq = flat[..., None, :, None]
    return seq, seq
