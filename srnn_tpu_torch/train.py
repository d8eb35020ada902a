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

Routes (``ops/popmajor.train_route`` with ``layout='rowmajor'``, decided
from the topology and train mode alone): ``train_epochs``,
``learn_epochs``, ``train_step`` and ``learn_from`` run on the
population-major ``(P, N)`` transpose

  * on the variant's SGD kernel (K2 weightwise, K4 aggregating/fft, K5
    recurrent) for a CUDA tensor, its plain chain for a CPU tensor, where
    the particle is inside the kernels' envelope;
  * on the weightwise full batch's hand-derived step
    (``ops/popmajor.ww_full_batch_epochs``, plain torch, rounding alike on
    the card and the CPU) for an output-expressible activation: one
    gradient step on the mean loss over the samples, a documented
    deviation.  The aggregating, fft and recurrent variants have one
    sample per epoch, so there 'full_batch' is the sequential program;
  * on the autograd chains, on either device, for every other particle:
    another activation (elu, softmax, swish, gelu), width, depth or
    aggregates; a recurrent particle with ``rnn_scan='associative'``
    differentiates through the associative forward, as the JAX package
    does.  For a batch the gradient of the summed per-net losses is each
    net's own gradient.

``fit_epoch`` on an arbitrary ``(x, y)`` (and ``fit_epochs_flat`` with
``xy``) is autograd on the rows: no kernel computes it.

keras' per-epoch sample shuffle: the JAX package's ``key`` is a
``torch.Generator`` here (``key=``, drawing each net's permutation of the
samples, ``sample_order``), or the permutation itself (``order=``: (S,)
for a net, (N, S) for a batch; ``train_epochs`` and ``learn_epochs`` take
the lane layout (epochs, S, N)).  Only the weightwise variant has more
than one sample an epoch, and the full batch takes no order, so elsewhere
it is a bitwise no-op, as in the JAX package.  On the card a shuffled
weightwise epoch inside the kernels' envelope is K2's shuffled
instantiation.
"""

from typing import Optional, Tuple

import torch

from .init import on_device
from .nets.dispatch import _MODULES
from .ops.popmajor import (check_train_mode, learn_epochs_popmajor,
                           train_epochs_popmajor)
from .topology import Topology

DEFAULT_LR = 0.01  # keras SGD default learning rate


def sample_order(generator: torch.Generator, epochs: int, samples: int,
                 n: int, device) -> torch.Tensor:
    """uint8 (epochs, samples, n): an independent uniform permutation of
    the samples per epoch and lane (an argsort of uniforms drawn on the
    generator's device), on ``device``."""
    u = torch.rand((epochs, samples, n), generator=generator,
                   device=generator.device)
    return u.argsort(dim=1).to(device=device, dtype=torch.uint8)


def shuffles(topo: Topology, mode: str) -> bool:
    """Does a sample order act on this epoch (more than one sample, the
    batch-1 mode)?"""
    check_train_mode(topo, mode)
    return topo.variant == "weightwise" and mode == "sequential"


def _lanes(flat: torch.Tensor) -> torch.Tensor:
    """(P,) or (N, P) -> contiguous (P, N)."""
    return (flat[:, None] if flat.dim() == 1 else flat.t()).contiguous()


def _unlanes(flat: torch.Tensor, wT: torch.Tensor, loss: torch.Tensor):
    """Back to ``flat``'s shape: (P,) and a scalar loss, or (N, P) and
    (N,)."""
    if flat.dim() == 1:
        return wT[:, 0], loss[0]
    return wT.t().contiguous(), loss


def _lane_order(topo: Topology, flat: torch.Tensor, mode: str, key,
                order) -> Optional[torch.Tensor]:
    """One epoch's order in the lane layout (1, P, N), from ``order`` ((P,)
    or (N, P)) or drawn from ``key``; None where no order acts."""
    if not shuffles(topo, mode) or (key is None and order is None):
        return None
    if order is None:
        p, n = topo.num_weights, (1 if flat.dim() == 1 else flat.shape[0])
        return sample_order(key, 1, p, n, flat.device)
    return _lanes(on_device(order, flat.device, torch.uint8))[None]


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
              mode: str = "sequential", key=None,
              order=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch of mse-SGD on fixed (x, y), autograd; the batch-1 steps
    in the sample ``order`` ((S,), or (N, S) for a batch) or in one drawn
    from ``key``.  Returns (new_flat, epoch_loss)."""
    x, y = x.detach(), y.detach()
    if mode == "full_batch":
        return _grad_step(topo, flat, x, y, lr)
    if mode != "sequential":
        raise ValueError(f"unknown train mode {mode!r}")
    axis = 0 if flat.dim() == 1 else 1  # the sample axis of x and y
    n_samples = x.shape[axis]
    if order is None and key is not None:
        order = sample_order(key, 1, n_samples, flat.shape[0] if axis else 1,
                             x.device)[0].t()
        order = order[0] if flat.dim() == 1 else order
    if order is not None:
        order = on_device(order, x.device, torch.long)

    def sample(t: torch.Tensor, i: int) -> torch.Tensor:
        if order is None:
            return t.narrow(axis, i, 1)
        idx = order[..., i].reshape(*order.shape[:-1], 1,
                                    *([1] * (t.dim() - axis - 1)))
        return torch.take_along_dim(t, idx, dim=axis)

    losses = []
    for i in range(n_samples):
        flat, loss = _grad_step(topo, flat, sample(x, i), sample(y, i), lr)
        losses.append(loss)
    return flat, torch.stack(losses).mean(dim=0)


def train_epochs(topo: Topology, w: torch.Tensor, epochs: int,
                 lr: float = DEFAULT_LR, mode: str = "sequential",
                 lanes: bool = False, order: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``epochs`` repeated ``train()`` calls, the samples recomputed from
    the current weights before every epoch (``network.py:613-618``), of a
    net (P,) or a batch held row-major (N, P), or population-major (P, N)
    where ``lanes``, on the route of ``topo`` (module docstring);
    ``order``, uint8 (epochs, P, N), each lane's sample order.  Returns
    (new weights in the same layout, the last epoch's mean pre-update
    loss); ``epochs`` >= 1."""
    wT = w if lanes else _lanes(w)
    wT, loss = train_epochs_popmajor(topo, wT, epochs, lr, mode, order,
                                     layout="rowmajor")
    return (wT, loss) if lanes else _unlanes(w, wT, loss)


def learn_epochs(topo: Topology, w: torch.Tensor, other: torch.Tensor,
                 severity: int, lr: float = DEFAULT_LR,
                 mode: str = "sequential", lanes: bool = False,
                 order: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``severity`` ``learn_from(other)`` epochs toward other's fixed
    samples, in the layouts ``train_epochs`` takes, on the route of
    ``topo``."""
    wT, oT = (w, other) if lanes else (_lanes(w), _lanes(other))
    wT, loss = learn_epochs_popmajor(topo, wT, oT, severity, lr, mode, order,
                                     layout="rowmajor")
    return (wT, loss) if lanes else _unlanes(w, wT, loss)


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
               mode: str = "sequential", key=None,
               order=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``train()`` call: fit one epoch on the net's own samples
    (self-training toward being a fixpoint), shuffled by ``key`` or
    ``order`` (module docstring)."""
    return train_epochs(topo, flat, 1, lr, mode,
                        order=_lane_order(topo, flat, mode, key, order))


def learn_from(topo: Topology, flat: torch.Tensor, other_flat: torch.Tensor,
               lr: float = DEFAULT_LR, mode: str = "sequential",
               key=None, order=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``learn_from(other)`` call: fit one epoch on *other's*
    samples, shuffled by ``key`` or ``order``."""
    return learn_epochs(topo, flat, other_flat, 1, lr, mode,
                        order=_lane_order(topo, flat, mode, key, order))
