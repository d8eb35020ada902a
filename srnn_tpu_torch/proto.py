"""Second-generation prototype networks ("methods.py" family); port of
``srnn_tpu/proto.py``.

Reference: ``code/methods.py`` — a later, experiment-unused redesign where
"fit" is **repeated self-application with a delta loss and no gradients**:
per epoch, predict the flat weights through the net, write the outputs back
positionally, and record loss = MSE(f(w_t), w_t) *before* the update
(``RecurrentNetwork.fit``, ``methods.py:106-129``;
``FeedForwardNetwork.fit``, ``methods.py:141-174``).

Semantics kept bit-faithful:

  * the feed-forward positional feature is ``index / cells`` — divided by
    the cell count, NOT normalized by the parameter count
    (``methods.py:154``; quirk noted in SURVEY §2 methods row);
  * the topology builder's parameter-count formula over-counts the
    feed-forward head (it assumes a ``features×cells`` output layer while
    the model ends in Dense(1), ``methods.py:36,50``) — the reference
    comments out the consistency assert for FF (``methods.py:139``).
    :meth:`ProtoTopology.builder_parameter_count` reproduces that formula;
    :meth:`ProtoTopology.num_weights` is the true count.

The products are explicit multiply-add chains summed in order
(``ops/mlp.ordered_matmul``, as every MLP of the port is), the SimpleRNN an
explicit time loop and the mean an ordered sum divided by a tensor
(``ordered_mean``), so the card and the CPU round alike.  ``fit`` runs its epochs on the weights' device with no
read on the host.
"""

from dataclasses import dataclass
from typing import Tuple

import torch

from .init import glorot, make_generator, orthogonal_lanes
from .ops.mlp import ordered_matmul, ordered_mean


@dataclass(frozen=True)
class ProtoTopology:
    """Mirror of the ``Network`` builder (``methods.py:17-54``):
    ``features`` inputs, ``cells`` wide, ``layers`` deep, Dense or
    SimpleRNN body, no biases, linear activations."""

    features: int = 2
    cells: int = 2
    layers: int = 2
    recurrent: bool = False

    @property
    def layer_shapes(self) -> Tuple[Tuple[int, int], ...]:
        f, c, l = self.features, self.cells, self.layers
        if self.recurrent:
            shapes = [(f, c), (c, c)]                    # RNN 1: input + recurrent
            shapes += [(c, c), (c, c)] * (l - 1)         # further RNN layers
            shapes += [(c, f)]                           # Dense(features) head
            return tuple(shapes)
        return ((f, c),) + ((c, c),) * (l - 1) + ((c, 1),)

    @property
    def num_weights(self) -> int:
        return int(sum(a * b for a, b in self.layer_shapes))

    @property
    def builder_parameter_count(self) -> int:
        """The reference's printed/announced count (``methods.py:27-37``) —
        equals :attr:`num_weights` for recurrent nets (asserted there), but
        over-counts feed-forward heads (assert commented out)."""
        f, c, l = self.features, self.cells, self.layers
        if self.recurrent:
            p1 = f * c + c * c
            pn = (c * c + c * c) * (l - 1)
        else:
            p1 = f * c
            pn = (c * c) * (l - 1)
        return p1 + pn + f * c

    @property
    def seq_len(self) -> int:
        """RNN input sequence length (``methods.py:40``: parameters //
        features, on the true count for recurrent nets)."""
        assert self.recurrent
        return self.num_weights // self.features

    def offsets(self):
        offs = [0]
        for a, b in self.layer_shapes:
            offs.append(offs[-1] + a * b)
        return offs


def _kernels(pt: ProtoTopology, flat: torch.Tensor):
    offs = pt.offsets()
    return [flat[offs[i]:offs[i + 1]].reshape(shape)
            for i, shape in enumerate(pt.layer_shapes)]


def forward_ff(pt: ProtoTopology, flat: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """(B, features) -> (B, 1): linear Dense chain (``methods.py:43-50``)."""
    h = x
    for k in _kernels(pt, flat):
        h = ordered_matmul(h, k)
    return h


def forward_rnn(pt: ProtoTopology, flat: torch.Tensor,
                seq: torch.Tensor) -> torch.Tensor:
    """(T, features) -> (T, features): linear SimpleRNN stack +
    Dense(features) head over the sequence (``methods.py:43-50``), the
    recurrence an explicit time loop from h = 0."""
    ks = _kernels(pt, flat)
    h = seq
    for layer in range(pt.layers):
        wx, wh = ks[2 * layer], ks[2 * layer + 1]
        hprev = torch.zeros((1, wh.shape[0]), dtype=flat.dtype,
                            device=flat.device)
        outs = []
        for t in range(h.shape[0]):
            hprev = (ordered_matmul(h[t:t + 1], wx)
                     + ordered_matmul(hprev, wh))
            outs.append(hprev)
        h = torch.cat(outs)
    return ordered_matmul(h, ks[-1])


def apply_self(pt: ProtoTopology, flat: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One prototype self-application: (new_flat, loss) with
    loss = MSE(new, old) computed before the update lands
    (``methods.py:116-126`` / ``:152-171``)."""
    if pt.recurrent:
        seq = flat.reshape(pt.seq_len, pt.features)
        y = forward_rnn(pt, flat, seq).reshape(-1)
    else:
        p = pt.num_weights
        # positional feature = index / cells, the reference's un-normalized
        # divisor quirk (methods.py:154); a tensor divisor, as in
        # ordered_mean
        idx = torch.arange(p, dtype=flat.dtype, device=flat.device)
        idx = idx / torch.full_like(idx, pt.cells)
        cols = [flat, idx] + [torch.zeros_like(flat)] * (pt.features - 2)
        x = torch.stack(cols, dim=1)
        y = forward_ff(pt, flat, x)[:, 0]
    loss = ordered_mean((y - flat) ** 2)
    return y, loss


def fit(pt: ProtoTopology, flat: torch.Tensor, epochs: int = 500
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prototype "training" loop: ``epochs`` self-applications,
    returning (final_flat, (epochs,) losses) — no gradients anywhere
    (``methods.py:110-129``).  Runs on ``flat``'s device."""
    losses = torch.empty(epochs, dtype=flat.dtype, device=flat.device)
    w = flat
    for e in range(epochs):
        w, losses[e] = apply_self(pt, w)
    return w, losses


def init_proto(pt: ProtoTopology, generator, device="cuda") -> torch.Tensor:
    """Glorot-uniform kernels / orthogonal recurrent kernels, matching the
    keras defaults the prototype inherits (``methods.py:43-50``), drawn
    kernel by kernel from ``generator`` (a ``torch.Generator`` or an int
    seed) on ``device``: (P,) float32."""
    gen = make_generator(generator, device)
    parts = []
    for i, shape in enumerate(pt.layer_shapes):
        recurrent_kernel = pt.recurrent and i < 2 * pt.layers and i % 2 == 1
        if recurrent_kernel:
            parts.append(orthogonal_lanes(gen, 1, shape,
                                          gen.device).reshape(-1))
        else:
            parts.append(glorot(shape, gen, gen.device).reshape(-1))
    return torch.cat(parts)
