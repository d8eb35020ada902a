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

The dispatchers at the bottom are the surface the soup calls.  The train
and learn_from chains always go to the variant's SGD kernel wrapper (K2
weightwise, K4 aggregating/fft, K5 recurrent), and the recurrent attack to
K6's, where the tensor's device picks the route: a CUDA tensor launches the
kernel, a CPU tensor runs its plain chain.  The weightwise and k-vector
attacks are plain torch, as in the JAX package (it has no kernel for
them).  The weightwise chain takes only the sequential (batch-1) train
mode; the other variants have one sample per epoch, so 'sequential' and
'full_batch' are one program there and both are accepted.
"""

from typing import Optional, Tuple

import torch

from ..topology import Topology, normalized_weight_coords
from .cuda_kvec_train import kvec_learn_epochs, kvec_train_epochs
from .cuda_rnn_apply import rnn_apply
from .cuda_rnn_train import rnn_learn_epochs, rnn_train_epochs
from .cuda_ww_train import ww_learn_epochs, ww_train_epochs
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
        last = accum / p
    return w, last


def ww_train_epochs_popmajor(topo: Topology, wT: torch.Tensor, epochs: int,
                             lr: float = DEFAULT_LR,
                             mode: str = "sequential"):
    """``epochs`` self-training calls (samples recomputed from the current
    weights before every epoch).  Returns (new_wT, last epoch loss (N,))."""
    check_train_mode(topo, mode)
    if epochs <= 0:
        return wT, torch.zeros(wT.shape[1], dtype=wT.dtype, device=wT.device)
    return _ww_seq_sgd_flat(topo, wT, epochs, lr)


def ww_learn_epochs_popmajor(topo: Topology, wT: torch.Tensor,
                             otherT: torch.Tensor, severity: int,
                             lr: float = DEFAULT_LR,
                             mode: str = "sequential"):
    """``severity`` imitation epochs toward the counterparts' samples
    (x = y = other's weights, fixed across the call)."""
    check_train_mode(topo, mode)
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
    """'sequential' for every variant; 'full_batch' too where an epoch has
    one sample (every variant but weightwise), since there it is the same
    program."""
    if mode not in ("sequential", "full_batch"):
        raise ValueError(f"unknown train mode {mode!r}")
    if mode == "full_batch" and topo.variant == "weightwise":
        raise ValueError(
            "train_mode='full_batch' is not ported for the weightwise "
            "variant; srnn_tpu_torch runs its sequential (batch-1) chain")


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
    plain chain for a CPU tensor).  Returns (new_wT, last epoch loss
    (N,))."""
    check_train_mode(topo, mode)
    return _SGD[topo.variant][0](topo, wT, epochs, lr)


def learn_epochs_popmajor(topo: Topology, wT: torch.Tensor,
                          otherT: torch.Tensor, severity: int,
                          lr: float = DEFAULT_LR, mode: str = "sequential"):
    """``severity`` imitation epochs toward ``otherT`` on the variant's SGD
    kernel (its plain chain for a CPU tensor)."""
    check_train_mode(topo, mode)
    return _SGD[topo.variant][1](topo, wT, otherT, severity, lr)
