"""Population-major (P, N) ops of the recurrent variant in plain torch;
port of ``srnn_tpu/ops/popmajor_rnn.py``.

The SimpleRNN transform is serial over its length-T weight sequence
(reference ``network.py:544-564``), but the particle axis is parallel: the
hidden state is a (units, N) lane matrix and each parameter a per-lane
scalar (a row of the (P, N) population).  Self-training has ONE sample per
epoch (x = y = the whole weight sequence, ``network.py:566-574``), so a
batch-1 epoch is one full-batch step and 'sequential' and 'full_batch' are
the same program.

The gradients here come from autograd through the time loop: this module
is the autograd route of the recurrent particles outside K5's envelope
(``popmajor.train_route``), on either device, and the independent
oracle that the tests hold the hand-derived BPTT of K5
(``cuda_rnn_train``) against.  With ``scan='associative'`` (a row-major
particle with ``rnn_scan='associative'``, whose JAX train differentiates
through the associative forward) the forward is the row-major transform's
associative scan (``nets/recurrent.py``) on the lanes' transpose.
"""

from typing import Optional, Tuple

import torch

from ..nets import recurrent
from ..topology import Topology
from .activations import resolve_layer_activation

DEFAULT_LR = 0.01  # keras SGD default


def rnn_forward_popmajor(topo: Topology, wT: torch.Tensor,
                         xT: torch.Tensor) -> torch.Tensor:
    """Stacked SimpleRNN over lanes: ``wT`` (P, N) per-lane parameters,
    ``xT`` (T, N) the one-feature input sequence.  Keras law
    h_t = act(x_t @ K + h_{t-1} @ R), K[i, u] at flat ``ko + i*units + u``
    and R[v, u] at ``ro + v*units + u``.  Returns the last layer's (T, N)
    output sequence."""
    act = resolve_layer_activation(topo.activation)
    x = [[row] for row in xT.unbind(0)]  # (T, in = 1) lane vectors
    for layer, (ind, units) in enumerate(topo.rnn_layer_dims):
        ko = topo.offsets[2 * layer]
        ro = topo.offsets[2 * layer + 1]
        h = [torch.zeros_like(xT[0])] * units
        out = []
        for x_t in x:
            accs = []
            for u in range(units):
                acc = x_t[0] * wT[ko + u]
                for i in range(1, ind):
                    acc = acc + x_t[i] * wT[ko + i * units + u]
                for v in range(units):
                    acc = acc + h[v] * wT[ro + v * units + u]
                accs.append(acc)
            nxt = act(accs)
            out.append(nxt)
            h = nxt
        x = out
    return torch.stack([x_t[0] for x_t in x])


def _forward(topo: Topology, wT: torch.Tensor, xT: torch.Tensor,
             scan: str) -> torch.Tensor:
    """The (T, N) prediction: the serial lane scan, or the row-major
    associative scan on the transpose."""
    if scan == "associative":
        return recurrent.forward(topo, wT.t(), xT.t()[..., None])[..., 0].t()
    if scan != "sequential":
        raise ValueError(f"unknown rnn scan {scan!r}")
    return rnn_forward_popmajor(topo, wT, xT)


def _epoch_grad(topo: Topology, wT: torch.Tensor, xT: torch.Tensor,
                scan: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MSE-SGD gradient on the single sequence sample x = y = ``xT``
    (T, N).  Returns (grads, per-particle pre-update loss (N,))."""
    xT = xT.detach()
    wi = wT.detach().requires_grad_(True)
    with torch.enable_grad():
        pred = _forward(topo, wi, xT, scan)
        per_particle = ((pred - xT) ** 2).mean(dim=0)
        (grads,) = torch.autograd.grad(per_particle.sum(), wi)
    return grads, per_particle.detach()


def _check_mode(mode: str) -> None:
    if mode not in ("sequential", "full_batch"):
        raise ValueError(f"unknown train mode {mode!r}")


def _epochs(topo: Topology, wT: torch.Tensor, epochs: int, lr: float,
            fixed_xT: Optional[torch.Tensor], scan: str):
    w = wT.detach()
    last = torch.zeros(wT.shape[1], dtype=wT.dtype, device=wT.device)
    for _ in range(epochs):
        grads, last = _epoch_grad(topo, w, w if fixed_xT is None else fixed_xT,
                                  scan)
        w = w - lr * grads
    return w, last


def rnn_train_epochs_popmajor(topo: Topology, wT: torch.Tensor, epochs: int,
                              lr: float = DEFAULT_LR,
                              mode: str = "sequential",
                              scan: str = "sequential"):
    """``epochs`` self-training calls, the sample sequence re-snapshotted
    from the CURRENT weights before every epoch (``network.py:613-618``).
    Returns (new_wT, last epoch per-particle loss (N,))."""
    _check_mode(mode)
    return _epochs(topo, wT, max(epochs, 0), lr, None, scan)


def rnn_learn_epochs_popmajor(topo: Topology, wT: torch.Tensor,
                              otherT: torch.Tensor, severity: int,
                              lr: float = DEFAULT_LR,
                              mode: str = "sequential",
                              scan: str = "sequential"):
    """``severity`` imitation epochs toward the counterparts' sequence,
    fixed across the call (``network.py:620-626``)."""
    _check_mode(mode)
    return _epochs(topo, wT, max(severity, 0), lr, otherT.detach(), scan)
