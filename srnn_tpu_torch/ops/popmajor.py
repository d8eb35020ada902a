"""Population-major (P, N) weightwise ops in plain torch, and the
population-major dispatch of every variant; port of
``srnn_tpu/ops/popmajor.py``.

Row p of a (P, N) matrix holds weight p of every particle, so every op of
the tiny MLP is elementwise over the particle axis.  The batch-1 SGD chain
here (``_ww_seq_sgd_flat``, behind ``ww_train_epochs_popmajor`` and
``ww_learn_epochs_popmajor``) takes its gradients from autograd, like the
JAX package's ``jax.grad`` chain, as does the weightwise full batch's
autograd step (``_ww_full_batch_autograd``).  They are the autograd route
of the particles outside the kernels' envelope, and the independent
oracle the tests hold the hand-derived backward of ``cuda_ww_train``
against.

The weightwise full batch of an output-expressible activation
(``ww_full_batch_epochs``: one step an epoch on the mean loss over the P
samples) has no TPU kernel: the JAX package takes its gradient with
``jax.grad`` in XLA.  Here it is plain torch on either device, the
hand-derived backward of the SGD kernels summed over the samples in order
s = 0..P-1, every operation elementwise over the lanes, so that the card
and the CPU round alike.

The dispatchers at the bottom are the surface the soups and ``train.py``
call.  The route each particle's train and learn_from phases take is
decided from its configuration alone, before any launch
(``train_route``): the variant's SGD kernel (K2 weightwise, K4
aggregating/fft, K5 recurrent; on a CPU tensor its plain twin) for the
particles inside the kernels' envelope (the JAX package's Pallas one: an
output-expressible activation, up to 64 weights), the weightwise full
batch's hand-derived step, or the autograd chains (``popmajor_kvec``,
``popmajor_rnn`` and the two above) on either device for every other
particle.  The recurrent attack goes to K6's wrapper where the attacker
is inside the envelope and the victim has up to 64 weights, else to K6's
plain version; the weightwise and k-vector attacks are plain torch, as in the
JAX package (it has no kernel for them).  The aggregating, fft and
recurrent variants have one sample per epoch, so 'sequential' and
'full_batch' are one program there.  Nothing gives way to a plain version
at run time: a kernel that does not build or launch raises.
"""

from typing import Optional, Tuple

import torch

from ..topology import Topology, normalized_weight_coords
from .activations import output_grad_activations, resolve_output_grad
from .cuda_kvec_train import kvec_learn_epochs, kvec_train_epochs
from .cuda_rnn_apply import rnn_apply, rnn_apply_plain
from .cuda_rnn_train import rnn_learn_epochs, rnn_train_epochs
from .cuda_sgd_common import (KERNEL_ACT_CODES, KERNEL_MAX_WEIGHTS,
                              check_variant, kernel_supported)
from .cuda_ww_train import (mlp_backward_plain, ww_learn_epochs,
                            ww_train_epochs)
from .mlp import mlp_rows_plain, point_features, step_features
from .popmajor_kvec import (kvec_apply_popmajor, kvec_learn_epochs_popmajor,
                            kvec_train_epochs_popmajor)
from .popmajor_rnn import (rnn_learn_epochs_popmajor,
                           rnn_train_epochs_popmajor)

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
                     lr: float, fixed_xyT: Optional[torch.Tensor] = None,
                     order: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``epochs`` passes of batch-1 SGD over the P samples, in enumeration
    order or, where ``order`` (epochs, P, N) is given, in each lane's own
    order (keras' shuffled epoch), gradients from autograd.

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
    for e in range(max(epochs, 0)):
        if refresh:
            snap = w
        accum = torch.zeros_like(last)
        for s in range(p):
            x_s, feats = step_features(coords, snap.unbind(0), s,
                                       None if order is None else order[e, s],
                                       snap)
            wi = w.detach().requires_grad_(True)
            with torch.enable_grad():
                pred = mlp_rows_plain(topo, wi.unbind(0), feats)[-1][0]
                per_particle = (pred - x_s) ** 2
                (grads,) = torch.autograd.grad(per_particle.sum(), wi)
            w = w - lr * grads
            accum = accum + per_particle.detach()
        # a tensor divisor: on the card torch takes a Python scalar divisor as
        # a multiply by its reciprocal, not the kernels' division
        last = accum / torch.full_like(accum, p)
    return w, last


def _ww_full_batch_autograd(topo: Topology, wT: torch.Tensor, epochs: int,
                            lr: float,
                            fixed_xyT: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``epochs`` full-batch steps, each on the mean squared error over the
    P duplex points (the samples of the epoch's top, or the fixed
    ``fixed_xyT``), gradients from autograd: the JAX package's
    ``jax.grad`` of ``ww_fit_epoch_popmajor('full_batch')``, for any
    activation.  Returns (new_wT, the last epoch's pre-update mean loss)."""
    p, n = wT.shape
    coords = normalized_weight_coords(topo)
    w = wT.detach()
    last = torch.zeros(n, dtype=wT.dtype, device=wT.device)
    count = torch.full_like(last, p)
    for _ in range(max(epochs, 0)):
        snap = w if fixed_xyT is None else fixed_xyT.detach()
        wi = w.detach().requires_grad_(True)
        with torch.enable_grad():
            rows = wi.unbind(0)
            acc = None
            for s in range(p):
                pred = mlp_rows_plain(topo, rows, point_features(
                    coords, s, snap[s]))[-1][0]
                sq = (pred - snap[s]) ** 2
                acc = sq if acc is None else acc + sq
            per_particle = acc / count
            (grads,) = torch.autograd.grad(per_particle.sum(), wi)
        w = w - lr * grads
        last = per_particle.detach()
    return w, last


def _check_order(mode: str, order) -> None:
    if order is not None and mode != "sequential":
        raise ValueError("a sample order shuffles the sequential (batch-1) "
                         f"epoch; train mode {mode!r} has none")


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
                             mode: str = "sequential",
                             order: Optional[torch.Tensor] = None):
    """``epochs`` self-training calls (samples recomputed from the current
    weights before every epoch) on the autograd chains: batch-1
    ('sequential', in the per-lane ``order`` where given) or one full-batch
    step an epoch.  Returns (new_wT, last epoch loss (N,))."""
    _check_order(mode, order)
    if epochs <= 0:
        return wT, torch.zeros(wT.shape[1], dtype=wT.dtype, device=wT.device)
    if mode == "full_batch":
        return _ww_full_batch_autograd(topo, wT, epochs, lr)
    return _ww_seq_sgd_flat(topo, wT, epochs, lr, order=order)


def ww_learn_epochs_popmajor(topo: Topology, wT: torch.Tensor,
                             otherT: torch.Tensor, severity: int,
                             lr: float = DEFAULT_LR,
                             mode: str = "sequential",
                             order: Optional[torch.Tensor] = None):
    """``severity`` imitation epochs toward the counterparts' samples
    (x = y = other's weights, fixed across the call), autograd."""
    _check_order(mode, order)
    if severity <= 0:
        return wT, torch.zeros(wT.shape[1], dtype=wT.dtype, device=wT.device)
    if mode == "full_batch":
        return _ww_full_batch_autograd(topo, wT, severity, lr, otherT)
    return _ww_seq_sgd_flat(topo, wT, severity, lr, otherT, order)


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
#: variant -> (train, learn) of its autograd chain
_AUTOGRAD = {
    "weightwise": (ww_train_epochs_popmajor, ww_learn_epochs_popmajor),
    "aggregating": (kvec_train_epochs_popmajor, kvec_learn_epochs_popmajor),
    "fft": (kvec_train_epochs_popmajor, kvec_learn_epochs_popmajor),
    "recurrent": (rnn_train_epochs_popmajor, rnn_learn_epochs_popmajor),
}


def check_train_mode(topo: Topology, mode: str) -> None:
    """'sequential' or 'full_batch', for every variant."""
    if mode not in ("sequential", "full_batch"):
        raise ValueError(f"unknown train mode {mode!r}")


def train_route(topo: Topology, mode: str, layout: str = "popmajor") -> str:
    """The chain the train and learn_from phases of ``topo`` take under
    ``train_impl='plain'`` (the JAX package's 'xla'), from the
    configuration alone:

      * ``'kernel'``: the variant's SGD kernel (K2, K4, K5) on the card,
        its hand-derived plain twin on the CPU -- the particles inside the
        kernels' envelope (``cuda_sgd_common.kernel_supported``), the
        weightwise one in the sequential mode;
      * ``'plain'``: the weightwise full batch of an output-expressible
        activation, its hand-derived step (``ww_full_batch_epochs``) in
        plain torch on either device;
      * ``'autograd'``: the autograd chains, on either device -- every other
        particle, and a recurrent one with ``rnn_scan='associative'`` in
        the row-major layout (``layout='rowmajor'``: ``train.py``, the
        row-major and sequential soups), whose JAX train differentiates
        through the associative forward.  In the population-major layout
        the recurrent transform is the serial scan, as in the JAX package,
        so an associative particle takes the kernel there.
    """
    check_train_mode(topo, mode)
    if (layout == "rowmajor" and topo.variant == "recurrent"
            and topo.rnn_scan == "associative"):
        return "autograd"
    if topo.variant == "weightwise" and mode == "full_batch":
        return ("plain" if topo.activation in output_grad_activations()
                else "autograd")
    return "kernel" if kernel_supported(topo) else "autograd"


def resolved_train_impl(topo: Topology, mode: str, impl: str,
                        layout: str = "popmajor") -> str:
    """The route the train phase ACTUALLY takes for this type under
    ``train_impl=impl`` (``train_route``; the JAX package's
    ``resolved_train_impl``, whose 'pallas' is 'kernel' here and whose
    'xla' is 'plain' or 'autograd').  ``impl='kernel'`` asks for the
    hand-written kernels and raises, naming the fence, where the particle
    is outside their envelope (``cuda_sgd_common``), as the JAX package's
    'pallas' soup raises."""
    if impl not in ("plain", "kernel"):
        raise ValueError(f"unknown train_impl {impl!r}")
    route = train_route(topo, mode, layout)
    if impl == "kernel" and route != "kernel":
        raise ValueError(
            "train_impl='kernel' runs the hand-written SGD kernels (K2, K4, "
            f"K5): any variant, activation in {sorted(KERNEL_ACT_CODES)}, "
            f"particles up to {KERNEL_MAX_WEIGHTS} weights (the weightwise "
            "kernel additionally needs train_mode='sequential'); this config "
            f"(variant={topo.variant!r}, activation={topo.activation!r}, "
            f"train_mode={mode!r}, P={topo.num_weights}) needs "
            "train_impl='plain'")
    return route


def apply_route(topo: Topology, target_p: Optional[int] = None) -> str:
    """The attack's route for attacker ``topo`` on a victim of
    ``target_p`` weights (its own by default): 'kernel' for a recurrent
    attacker inside the kernels' envelope on a victim of up to
    ``KERNEL_MAX_WEIGHTS`` weights (the JAX package's ``_use_pallas_apply``
    under ``apply_impl='pallas'``); 'plain' otherwise (K6's plain version
    for a recurrent attacker, plain torch for the others, as XLA in the
    JAX package)."""
    t_len = topo.num_weights if target_p is None else target_p
    return ("kernel" if topo.variant == "recurrent" and kernel_supported(topo)
            and t_len <= KERNEL_MAX_WEIGHTS else "plain")


def apply_popmajor(topo: Topology, selfT: torch.Tensor,
                   targetT: torch.Tensor) -> torch.Tensor:
    """Population-major attack: particle n's net (parameters ``selfT[:, n]``)
    rewrites ``targetT[:, n]``.  The recurrent variant goes to K6's wrapper
    (``pallas_rnn_apply``'s port) on its route (``apply_route``), else to
    K6's plain version; the others are plain torch, as in the JAX
    package."""
    if topo.variant == "weightwise":
        return ww_forward_popmajor(topo, selfT, targetT)
    if topo.variant == "recurrent":
        if apply_route(topo, targetT.shape[0]) == "kernel":
            return rnn_apply(topo, selfT, targetT)
        return rnn_apply_plain(topo, selfT, targetT)
    return kvec_apply_popmajor(topo, selfT, targetT)


def _epochs_popmajor(topo: Topology, wT: torch.Tensor, otherT, epochs: int,
                     lr: float, mode: str, order, layout: str):
    """Train (``otherT`` None) or learn on the route of ``topo``."""
    route = train_route(topo, mode, layout)
    learn = otherT is not None
    if order is not None and (topo.variant != "weightwise"
                              or mode != "sequential"):
        order = None  # one sample per epoch, or no batch-1 order: a no-op
    if route == "plain":
        return ww_full_batch_epochs(topo, wT, epochs, lr, otherT)
    if route == "kernel":
        fn = _SGD[topo.variant][learn]
        kw = {} if order is None else {"order": order}
    else:
        fn = _AUTOGRAD[topo.variant][learn]
        kw = {"mode": mode}
        if order is not None:
            kw["order"] = order
        if topo.variant == "recurrent":
            kw["scan"] = topo.rnn_scan if layout == "rowmajor" \
                else "sequential"
    args = (topo, wT, otherT) if learn else (topo, wT)
    return fn(*args, epochs, lr, **kw)


def train_epochs_popmajor(topo: Topology, wT: torch.Tensor, epochs: int,
                          lr: float = DEFAULT_LR, mode: str = "sequential",
                          order: Optional[torch.Tensor] = None,
                          layout: str = "popmajor"):
    """``epochs`` self-training calls on the route of ``topo`` in
    ``layout`` (``train_route``); ``order`` (epochs, P, N), each lane's
    sample order of the weightwise batch-1 epoch (keras' shuffle; a
    bitwise no-op for the other variants and the full batch, as in the
    JAX package).  Returns (new_wT, last epoch loss (N,))."""
    return _epochs_popmajor(topo, wT, None, epochs, lr, mode, order, layout)


def learn_epochs_popmajor(topo: Topology, wT: torch.Tensor,
                          otherT: torch.Tensor, severity: int,
                          lr: float = DEFAULT_LR, mode: str = "sequential",
                          order: Optional[torch.Tensor] = None,
                          layout: str = "popmajor"):
    """``severity`` imitation epochs toward ``otherT`` on the route of
    ``topo`` in ``layout``."""
    return _epochs_popmajor(topo, wT, otherT, severity, lr, mode, order,
                            layout)
