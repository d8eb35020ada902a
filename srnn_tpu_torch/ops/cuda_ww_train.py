"""K2: the weightwise batch-1 SGD chain, self-training and imitation; port
of ``srnn_tpu/ops/pallas_ww_train.py``.

``ww_train_epochs`` / ``ww_learn_epochs`` launch ``csrc/ww_train.cu`` for
CUDA tensors and run the plain chain for CPU tensors.  The plain chain
(``sgd_chain_plain``) is the counterpart of ``_sgd_chain``: tensor ops over
(N,) rows with the same hand-derived backward and the same operation order
as the kernel, so that on the card the two round alike.

With h_{l+1}[j] = act(z[j]), z[j] = sum_i h_l[i] W_l[i, j]:

    dL/dpred       = 2 (pred - y)
    dz[j]          = dh_{l+1}[j] act'(h_{l+1}[j])
    dL/dW_l[i, j]  = dz[j] h_l[i]
    dh_l[i]        = sum_j dz[j] W_l[i, j]

The snapshot refreshes at each epoch top for self-training and stays fixed
for imitation; the loss is the last epoch's mean PRE-update loss.

Keras' shuffled epoch (``order``, uint8 (epochs, P, N): step j of epoch e
of lane n trains on sample ``order[e, j, n]``) launches K2's shuffled
instantiation (``srnn_ww_sgd_shuffled``, ``WW_SGD_SHUFFLED``); its plain
version gathers each step's sample and coordinates per lane.  The JAX
package runs that epoch in XLA (``train.fit_epoch(key=)``); here it is the
same kernel in another instantiation.
"""

from typing import List, Optional, Sequence, Tuple

import torch

from ..topology import Topology, normalized_weight_coords
from .activations import resolve_output_grad
from .cuda_sgd_common import (_P, SGD_ARGTYPES, LaneKernel, check_lanes,
                              check_variant, coords_arg, is_cpu, lane_call,
                              ptr, topo_args)
from .mlp import mlp_rows_plain, point_features, step_features

WW_SGD = LaneKernel(
    "ww_sgd", "ww_train", "srnn_ww_sgd", SGD_ARGTYPES,
    replaces="srnn_tpu/ops/pallas_ww_train.py:127")
WW_SGD_SHUFFLED = LaneKernel(
    "ww_sgd_shuffled", "ww_train", "srnn_ww_sgd_shuffled",
    SGD_ARGTYPES + [_P], replaces="srnn_tpu/ops/pallas_ww_train.py:127")


def apply_rows_plain(topo: Topology, self_rows: Sequence[torch.Tensor],
                     x_rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Self-application / attack on lane vectors
    (``pallas_generation.apply_rows``, weightwise body)."""
    coords = normalized_weight_coords(topo)
    return [mlp_rows_plain(topo, self_rows,
                           point_features(coords, s, x_rows[s]))[-1][0]
            for s in range(topo.num_weights)]


def mlp_backward_plain(topo: Topology, rows: Sequence[torch.Tensor],
                       acts: Sequence[Sequence[torch.Tensor]],
                       dh: List[torch.Tensor], act_grad) -> List[torch.Tensor]:
    """The hand-derived backward of the lane MLP: ``acts`` every layer's
    activations (``mlp_rows_plain``), ``dh`` dL/d(output); returns
    dL/d(rows), in the kernels' operation order."""
    shapes = topo.layer_shapes
    offs = topo.offsets
    grads = [None] * topo.num_weights
    for li in range(len(shapes) - 1, -1, -1):
        a, b = shapes[li]
        o = offs[li]
        prev = acts[li]
        if act_grad is not None:
            dh = [dh[j] * act_grad(acts[li + 1][j]) for j in range(b)]
        dprev = []
        for i in range(a):
            acc = dh[0] * rows[o + i * b + 0]
            for j in range(1, b):
                acc = acc + dh[j] * rows[o + i * b + j]
            dprev.append(acc)
            for j in range(b):
                grads[o + i * b + j] = dh[j] * prev[i]
        dh = dprev
    return grads


def sgd_chain_plain(topo: Topology, rows0: Sequence[torch.Tensor],
                    snap_rows: Optional[Sequence[torch.Tensor]], epochs: int,
                    lr: float, refresh: bool,
                    order: Optional[torch.Tensor] = None
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The flattened epochs x samples batch-1 SGD chain on lane vectors.
    ``snap_rows`` is the fixed imitation target when ``refresh`` is False;
    ``order`` (epochs, P, N), where given, each lane's sample order.
    Returns (rows, last-epoch loss (N,))."""
    p = topo.num_weights
    coords = normalized_weight_coords(topo)
    act_grad = resolve_output_grad(topo.activation)
    rows = list(rows0)
    last = torch.zeros_like(rows[0])
    for e in range(epochs):
        snap = list(rows) if refresh else snap_rows
        snapT = None if order is None else torch.stack(snap)
        loss_acc = torch.zeros_like(rows[0])
        for s in range(p):
            x, feats = step_features(coords, snap, s,
                                     None if order is None else order[e, s],
                                     snapT)
            acts = mlp_rows_plain(topo, rows, feats)
            pred = acts[-1][0]
            loss_acc = loss_acc + (pred - x) * (pred - x)
            grads = mlp_backward_plain(topo, rows, acts, [2.0 * (pred - x)],
                                       act_grad)
            for r in range(p):
                rows[r] = rows[r] - lr * grads[r]
        # a tensor divisor: on the card torch takes a Python scalar divisor as
        # a multiply by its reciprocal, not the kernels' division
        last = loss_acc / torch.full_like(loss_acc, p)
    return rows, last


def ww_sgd_plain(topo: Topology, wT: torch.Tensor,
                 otherT: Optional[torch.Tensor], epochs: int, lr: float,
                 order: Optional[torch.Tensor] = None):
    """The plain chain on a (P, N) population: self-training when
    ``otherT`` is None, else imitation of ``otherT``; in the per-lane
    sample ``order`` (epochs, P, N) where given."""
    snap = None if otherT is None else list(otherT.unbind(0))
    rows, loss = sgd_chain_plain(topo, list(wT.unbind(0)), snap, epochs, lr,
                                 otherT is None, order)
    return torch.stack(rows), loss


def check_order(topo: Topology, order: torch.Tensor, epochs: int,
                wT: torch.Tensor) -> None:
    """Raise unless ``order`` is a contiguous uint8 (epochs, P, N) tensor
    on ``wT``'s device of sample indices in [0, P)."""
    p, n = wT.shape
    if order.dtype != torch.uint8 or tuple(order.shape) != (epochs, p, n):
        raise ValueError(f"order must be uint8 ({epochs}, {p}, {n}), got "
                         f"{order.dtype} {tuple(order.shape)}")
    if order.device != wT.device or not order.is_contiguous():
        raise ValueError("order must be contiguous, on the population's "
                         "device")
    if order.numel() and int(order.max()) >= p:
        raise ValueError(f"order holds sample indices outside [0, {p})")


def _sgd(topo: Topology, arrays, epochs: int, lr: float,
         order: Optional[torch.Tensor]):
    """K2 on ``arrays`` ([wT] or [wT, otherT]), shuffled where ``order`` is
    given; the plain chain for CPU tensors."""
    check_variant(topo, "weightwise")
    check_lanes(topo, *arrays)
    wT = arrays[0]
    if order is not None:
        check_order(topo, order, epochs, wT)
    if is_cpu(wT):
        return ww_sgd_plain(topo, wT, arrays[1] if len(arrays) > 1 else None,
                            epochs, lr, order)
    coords = coords_arg(topo)
    if order is None:
        return lane_call(WW_SGD, topo, arrays, epochs, lr, *topo_args(topo),
                         coords.ctypes.data)
    return lane_call(WW_SGD_SHUFFLED, topo, arrays, epochs, lr,
                     *topo_args(topo), coords.ctypes.data, ptr(order))


def ww_train_epochs(topo: Topology, wT: torch.Tensor, epochs: int,
                    lr: float = 0.01, order: Optional[torch.Tensor] = None):
    """``epochs`` of batch-1 sequential self-training, in each lane's
    sample ``order`` (epochs, P, N) where given.  Returns (new_wT, last
    epoch per-particle loss (N,))."""
    return _sgd(topo, [wT], epochs, lr, order)


def ww_learn_epochs(topo: Topology, wT: torch.Tensor, otherT: torch.Tensor,
                    severity: int, lr: float = 0.01,
                    order: Optional[torch.Tensor] = None):
    """``severity`` imitation epochs toward the counterparts' fixed samples
    ``otherT`` (P, N), in each lane's sample ``order`` where given."""
    return _sgd(topo, [wT, otherT], severity, lr, order)
