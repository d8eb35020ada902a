"""Self-training and imitation ("learn_from") as SGD steps; port of
``srnn_tpu/train.py``.

Reference semantics (``TrainingNeuralNetworkDecorator``,
``network.py:577-626``):

  * ``train()`` = one keras ``fit`` epoch on ``compute_samples()`` with
    ``loss='mse'``, plain SGD (keras default lr=0.01) and **batch_size=1**
    (``network.py:613-618``): one sequential gradient step per sample, with
    x/y computed ONCE from the current weights at call time.
  * ``learn_from(other)`` = the same single epoch on *other's* samples
    (``network.py:620-626``).
  * the reported loss is the mean of per-batch losses over the epoch, each
    taken at the weights *before* that batch's update (keras history).

Every function takes a single net ``(P,)`` or a batch ``(N, P)`` and gives
back the same shape, with a scalar or ``(N,)`` loss.

Routes:
  * ``'sequential'`` (the default) self-training and ``learn_from`` go to
    the population-major dispatch (``ops/popmajor.train_epochs_popmajor``
    / ``learn_epochs_popmajor``) on the ``(P, N)`` transpose: on a CUDA
    tensor the variant's SGD kernel (K2 weightwise, K4 aggregating/fft, K5
    recurrent), on a CPU tensor its plain chain.
  * ``'full_batch'``: one gradient step on the mean loss over the samples
    (a documented deviation).  The aggregating, fft and recurrent variants
    have one sample per epoch, so there it is the sequential program and
    takes the same kernels; the weightwise variant takes the
    population-major full-batch step on the transpose
    (``ops/popmajor.ww_full_batch_epochs``: the hand-derived gradient in
    plain torch, which no kernel computes and which rounds alike on the
    card and the CPU), or, for an activation without an output-expressible
    derivative, one autograd step on the rows, as the JAX package's
    ``jax.value_and_grad`` does.  For a batch the gradient of the summed
    per-net losses is each net's own gradient.
  * ``fit_epoch`` on an arbitrary ``(x, y)`` (and ``fit_epochs_flat`` with
    ``xy``) is autograd in both modes: no kernel computes it.

The JAX package's ``key`` (keras' per-epoch sample shuffle) is not ported:
no kernel takes a per-lane order.
"""

from typing import Optional, Tuple

import torch

from .nets.dispatch import _MODULES, compute_samples
from .ops.activations import output_grad_activations
from .ops.popmajor import learn_epochs_popmajor, train_epochs_popmajor
from .topology import Topology

DEFAULT_LR = 0.01  # keras SGD default learning rate


def _check_key(key) -> None:
    if key is not None:
        raise NotImplementedError(
            "the shuffled epoch (key=) is not ported to srnn_tpu_torch: no "
            "kernel takes a per-lane sample order (ROADMAP.md, queue A)")


def on_lanes(topo: Topology, mode: str) -> bool:
    """True where an epoch runs population-major (``ops/popmajor``'s
    dispatch: the SGD kernels on the card, and the weightwise full batch's
    hand-derived step): everything but the weightwise full batch of an
    activation without an output-expressible derivative, which takes
    autograd."""
    if mode not in ("sequential", "full_batch"):
        raise ValueError(f"unknown train mode {mode!r}")
    return not (topo.variant == "weightwise" and mode == "full_batch" and
                topo.activation not in output_grad_activations())


def _lanes(flat: torch.Tensor) -> torch.Tensor:
    """(P,) or (N, P) -> contiguous (P, N)."""
    return (flat[:, None] if flat.dim() == 1 else flat.t()).contiguous()


def _unlanes(flat: torch.Tensor, wT: torch.Tensor, loss: torch.Tensor):
    """Back to ``flat``'s shape: (P,) and a scalar loss, or (N, P) and
    (N,)."""
    if flat.dim() == 1:
        return wT[:, 0], loss[0]
    return wT.t().contiguous(), loss


def predict(topo: Topology, flat: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """Batched forward pass on training samples, per variant.

    weightwise: x (B, 4) -> (B, 1); aggregating/fft: x (B, k) -> (B, k);
    recurrent: x (B, T, 1) -> (B, T, 1).  A batch of nets (N, P) takes
    x (N, B, ...)."""
    if topo.variant == "recurrent" and flat.dim() > 1:
        flat = flat.unsqueeze(-2)  # against the sample axis of x
    return _MODULES[topo.variant].forward(topo, flat, x)


def _mse(topo: Topology, flat: torch.Tensor, xb: torch.Tensor,
         yb: torch.Tensor) -> torch.Tensor:
    """Mean squared error of each net: a scalar, or (N,) for a batch."""
    pred = predict(topo, flat, xb)
    err = (pred - yb.reshape(pred.shape)) ** 2
    return err.mean() if flat.dim() == 1 else err.flatten(1).mean(dim=1)


def _grad_step(topo: Topology, flat: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor, lr: float):
    """One SGD step on the mean loss over (x, y): (new_flat, loss)."""
    w = flat.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = _mse(topo, w, x, y)
        (grad,) = torch.autograd.grad(loss.sum(), w)
    return flat.detach() - lr * grad, loss.detach()


def fit_epoch(topo: Topology, flat: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor, lr: float = DEFAULT_LR,
              mode: str = "sequential",
              key=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch of mse-SGD on fixed (x, y), autograd.  Returns
    (new_flat, epoch_loss)."""
    _check_key(key)
    x, y = x.detach(), y.detach()
    if mode == "full_batch":
        return _grad_step(topo, flat, x, y, lr)
    if mode != "sequential":
        raise ValueError(f"unknown train mode {mode!r}")
    axis = 0 if flat.dim() == 1 else 1  # the sample axis of x and y
    losses = []
    for i in range(x.shape[axis]):
        flat, loss = _grad_step(topo, flat, x.narrow(axis, i, 1),
                                y.narrow(axis, i, 1), lr)
        losses.append(loss)
    return flat, torch.stack(losses).mean(dim=0)


def train_epochs(topo: Topology, w: torch.Tensor, epochs: int,
                 lr: float = DEFAULT_LR, mode: str = "sequential",
                 lanes: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``epochs`` repeated ``train()`` calls, the samples recomputed from
    the current weights before every epoch (``network.py:613-618``), of a
    net (P,) or a batch held row-major (N, P), or population-major (P, N)
    where ``lanes``.  Returns (new weights in the same layout, the last
    epoch's mean pre-update loss).  The one place that picks the
    population-major chains or autograd (``on_lanes``); ``epochs`` >= 1."""
    if on_lanes(topo, mode):
        wT = w if lanes else _lanes(w)
        wT, loss = train_epochs_popmajor(topo, wT, epochs, lr, mode)
        return (wT, loss) if lanes else _unlanes(w, wT, loss)
    rows = w.t().contiguous() if lanes else w
    for _ in range(epochs):
        x, y = compute_samples(topo, rows)
        rows, loss = fit_epoch(topo, rows, x, y, lr, mode)
    return (rows.t().contiguous() if lanes else rows), loss


def fit_epochs_flat(topo: Topology, flat: torch.Tensor, epochs: int,
                    lr: float = DEFAULT_LR, mode: str = "sequential",
                    xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``epochs`` repeated ``train()`` calls (``xy=None``, ``train_epochs``)
    or epochs on the fixed sample set ``xy``.  Returns (new_flat, the last
    epoch's mean pre-update loss)."""
    if epochs <= 0:
        shape = () if flat.dim() == 1 else flat.shape[:1]
        return flat, torch.zeros(shape, dtype=flat.dtype, device=flat.device)
    if xy is None:
        return train_epochs(topo, flat, epochs, lr, mode)
    for _ in range(epochs):
        flat, loss = fit_epoch(topo, flat, *xy, lr, mode)
    return flat, loss


def train_step(topo: Topology, flat: torch.Tensor, lr: float = DEFAULT_LR,
               mode: str = "sequential",
               key=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``train()`` call: fit one epoch on the net's own samples
    (self-training toward being a fixpoint)."""
    _check_key(key)
    return fit_epochs_flat(topo, flat, 1, lr, mode)


def learn_from(topo: Topology, flat: torch.Tensor, other_flat: torch.Tensor,
               lr: float = DEFAULT_LR, mode: str = "sequential",
               key=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``learn_from(other)`` call: fit one epoch on *other's*
    samples."""
    _check_key(key)
    if on_lanes(topo, mode):
        wT, loss = learn_epochs_popmajor(topo, _lanes(flat),
                                         _lanes(other_flat), 1, lr, mode)
        return _unlanes(flat, wT, loss)
    x, y = compute_samples(topo, other_flat)
    return fit_epoch(topo, flat, x, y, lr, mode)
