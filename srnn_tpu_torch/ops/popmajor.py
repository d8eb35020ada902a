"""Population-major (P, N) weightwise ops in plain torch, and the
population-major dispatch of every variant; port of
``srnn_tpu/ops/popmajor.py``.

Row p of a (P, N) matrix holds weight p of every particle, so every op of
the tiny MLP is elementwise over the particle axis.  The batch-1 SGD chain
here (``_ww_seq_sgd_flat``, behind ``ww_train_epochs_popmajor`` and
``ww_learn_epochs_popmajor``) takes its gradients from autograd, like the
JAX package's ``jax.grad`` chain; it is the independent oracle the tests
hold the hand-derived backward of ``cuda_ww_train`` against, and no route
of the soup runs it.

The weightwise full batch (``ww_full_batch_epochs``: one step an epoch on
the mean loss over the P samples, ``ww_fit_epoch_popmajor``'s
``'full_batch'`` branch) has no TPU kernel: the JAX package takes its
gradient with ``jax.grad`` in XLA.  Here it is plain torch on either
device, the hand-derived backward of the SGD kernels summed over the
samples in order s = 0..P-1, every operation elementwise over the lanes,
so that the card and the CPU round alike.

The dispatchers at the bottom are the surface the soup calls.  The train
and learn_from chains go to the variant's SGD kernel wrapper (K2
weightwise, K4 aggregating/fft, K5 recurrent), the weightwise full batch
to ``ww_full_batch_epochs``, and the recurrent attack to K6's, where the
tensor's device picks the route: a CUDA tensor launches the kernel, a CPU
tensor runs its plain chain.  The weightwise and k-vector attacks are plain
torch, as in the JAX package (it has no kernel for them).  The aggregating,
fft and recurrent variants have one sample per epoch, so 'sequential' and
'full_batch' are one program there, and both take the kernels.
"""

from typing import Optional, Tuple

import torch

from ..topology import Topology, normalized_weight_coords
from .cuda_kvec_train import kvec_learn_epochs, kvec_train_epochs
from .cuda_rnn_apply import rnn_apply
from .activations import resolve_output_grad
from .cuda_rnn_train import rnn_learn_epochs, rnn_train_epochs
from .cuda_sgd_common import check_variant
from .cuda_ww_train import (mlp_backward_plain, ww_learn_epochs,
                            ww_train_epochs)
from .mlp import mlp_rows_plain, point_features
from .popmajor_kvec import kvec_apply_popmajor

DEFAULT_LR = 0.01  # keras SGD default


def ww_forward_popmajor(topo: Topology, wT: torch.Tensor,
                        xT: torch.Tensor,
                        coords_of: Optional[Topology] = None) -> torch.Tensor:
    """f_w(points(x)) for every particle, population-major.

    ``wT`` (P, N) holds the nets' parameters, ``xT`` (R, N) the weight
    feature of each duplex point; the coordinate features are the constants
    of ``coords_of`` (R weights; ``topo`` itself by default, a victim of
    another type in a cross attack).  Returns (R, N).  Self-application is
    ``ww_forward_popmajor(topo, wT, wT)``; an attack by a permuted
    population is ``ww_forward_popmajor(topo, wT[:, att], wT)``.
    """
    coords = normalized_weight_coords(coords_of or topo)
    p, n = xT.shape
    feats = [xT] + [
        torch.as_tensor(coords[:, k], dtype=xT.dtype,
                        device=xT.device)[:, None].expand(p, n)
        for k in range(3)
    ]
    return mlp_rows_plain(topo, wT.unbind(0), feats)[-1][0]


def _ww_seq_sgd_flat(topo: Topology, wT: torch.Tensor, epochs: int,
                     lr: float, fixed_xyT: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``epochs`` passes of batch-1 SGD over the P samples, in enumeration
    order, gradients from autograd.

    ``fixed_xyT is None`` is self-training: the sample set (x = y = weights)
    is re-snapshotted from the CURRENT weights at the top of every epoch
    (``network.py:613-618``).  Otherwise ``fixed_xyT`` (P, N) is a fixed
    imitation target (``learn_from``, ``network.py:620-626``).  Returns
    (new_wT, last epoch's mean pre-update loss (N,)).
    """
    p, n = wT.shape
    coords = normalized_weight_coords(topo)
    refresh = fixed_xyT is None
    w = wT.detach()
    snap = w if refresh else fixed_xyT.detach()
    last = torch.zeros(n, dtype=wT.dtype, device=wT.device)
    for _ in range(max(epochs, 0)):
        if refresh:
            snap = w
        accum = torch.zeros_like(last)
        for s in range(p):
            x_s = snap[s]
            wi = w.detach().requires_grad_(True)
            with torch.enable_grad():
                pred = mlp_rows_plain(topo, wi.unbind(0),
                                      point_features(coords, s, x_s))[-1][0]
                per_particle = (pred - x_s) ** 2
                (grads,) = torch.autograd.grad(per_particle.sum(), wi)
            w = w - lr * grads
            accum = accum + per_particle.detach()
        # a tensor divisor: on the card torch takes a Python scalar divisor as
        # a multiply by its reciprocal, not the kernels' division
        last = accum / torch.full_like(accum, p)
    return w, last


def _check_sequential(mode: str) -> None:
    if mode != "sequential":
        raise ValueError(f"the autograd oracle runs the sequential chain, "
                         f"not train mode {mode!r}")


def ww_full_batch_epochs(topo: Topology, wT: torch.Tensor, epochs: int,
                         lr: float = DEFAULT_LR,
                         otherT: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``epochs`` full-batch steps of every particle: each one step on the
    mean squared error over the P duplex points, x = y = the particle's
    weights at the epoch's top (self-training, ``otherT`` None) or the
    counterpart's fixed weights ``otherT`` (P, N) (imitation).  The
    gradient is the SGD kernels' hand-derived backward
    (``cuda_ww_train.mlp_backward_plain``) with dL/dpred = 2 (pred - y) / P,
    summed over the samples in order.  Returns (new_wT, the last epoch's
    PRE-update mean loss (N,))."""
    check_variant(topo, "weightwise")
    p, n = wT.shape
    if p != topo.num_weights or (otherT is not None and
                                 otherT.shape != wT.shape):
        raise ValueError(f"wT (and otherT) must be ({topo.num_weights}, N)")
    coords = normalized_weight_coords(topo)
    act_grad = resolve_output_grad(topo.activation)
    rows = list(wT.unbind(0))
    fixed = None if otherT is None else list(otherT.unbind(0))
    last = torch.zeros(n, dtype=wT.dtype, device=wT.device)
    # a tensor divisor: on the card torch takes a Python scalar divisor as a
    # multiply by its reciprocal, which would round otherwise than the CPU
    count = torch.full_like(last, p)
    inv = torch.full_like(last, 1.0 / p)
    for _ in range(max(epochs, 0)):
        snap = rows if fixed is None else fixed
        loss_acc = torch.zeros_like(last)
        grads = None
        for s in range(p):
            x = snap[s]
            acts = mlp_rows_plain(topo, rows, point_features(coords, s, x))
            err = acts[-1][0] - x
            loss_acc = loss_acc + err * err
            g = mlp_backward_plain(topo, rows, acts, [2.0 * err * inv],
                                   act_grad)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        rows = [r - lr * g for r, g in zip(rows, grads)]
        last = loss_acc / count
    return torch.stack(rows), last


def ww_train_epochs_popmajor(topo: Topology, wT: torch.Tensor, epochs: int,
                             lr: float = DEFAULT_LR,
                             mode: str = "sequential"):
    """``epochs`` self-training calls (samples recomputed from the current
    weights before every epoch).  Returns (new_wT, last epoch loss (N,))."""
    _check_sequential(mode)
    if epochs <= 0:
        return wT, torch.zeros(wT.shape[1], dtype=wT.dtype, device=wT.device)
    return _ww_seq_sgd_flat(topo, wT, epochs, lr)


def ww_learn_epochs_popmajor(topo: Topology, wT: torch.Tensor,
                             otherT: torch.Tensor, severity: int,
                             lr: float = DEFAULT_LR,
                             mode: str = "sequential"):
    """``severity`` imitation epochs toward the counterparts' samples
    (x = y = other's weights, fixed across the call)."""
    _check_sequential(mode)
    if severity <= 0:
        return wT, torch.zeros(wT.shape[1], dtype=wT.dtype, device=wT.device)
    return _ww_seq_sgd_flat(topo, wT, severity, lr, otherT)


# ---------------------------------------------------------------------------
# Dispatch: the population-major surface the soup calls.
# ---------------------------------------------------------------------------

#: variant -> (train wrapper, learn wrapper) of its SGD kernel
_SGD = {
    "weightwise": (ww_train_epochs, ww_learn_epochs),
    "aggregating": (kvec_train_epochs, kvec_learn_epochs),
    "fft": (kvec_train_epochs, kvec_learn_epochs),
    "recurrent": (rnn_train_epochs, rnn_learn_epochs),
}


def check_train_mode(topo: Topology, mode: str) -> None:
    """'sequential' or 'full_batch', for every variant."""
    if mode not in ("sequential", "full_batch"):
        raise ValueError(f"unknown train mode {mode!r}")


def apply_popmajor(topo: Topology, selfT: torch.Tensor,
                   targetT: torch.Tensor) -> torch.Tensor:
    """Population-major attack: particle n's net (parameters ``selfT[:, n]``)
    rewrites ``targetT[:, n]``.  The recurrent variant goes to K6's wrapper
    (``pallas_rnn_apply``'s port); the others are plain torch, as in the
    JAX package."""
    if topo.variant == "weightwise":
        return ww_forward_popmajor(topo, selfT, targetT)
    if topo.variant == "recurrent":
        return rnn_apply(topo, selfT, targetT)
    return kvec_apply_popmajor(topo, selfT, targetT)


def train_epochs_popmajor(topo: Topology, wT: torch.Tensor, epochs: int,
                          lr: float = DEFAULT_LR, mode: str = "sequential"):
    """``epochs`` self-training calls on the variant's SGD kernel (its
    plain chain for a CPU tensor), or the weightwise full batch.  Returns
    (new_wT, last epoch loss (N,))."""
    check_train_mode(topo, mode)
    if topo.variant == "weightwise" and mode == "full_batch":
        return ww_full_batch_epochs(topo, wT, epochs, lr)
    return _SGD[topo.variant][0](topo, wT, epochs, lr)


def learn_epochs_popmajor(topo: Topology, wT: torch.Tensor,
                          otherT: torch.Tensor, severity: int,
                          lr: float = DEFAULT_LR, mode: str = "sequential"):
    """``severity`` imitation epochs toward ``otherT`` on the variant's SGD
    kernel (its plain chain for a CPU tensor), or the weightwise full
    batch."""
    check_train_mode(topo, mode)
    if topo.variant == "weightwise" and mode == "full_batch":
        return ww_full_batch_epochs(topo, wT, severity, lr, otherT)
    return _SGD[topo.variant][1](topo, wT, otherT, severity, lr)
