"""K5: the recurrent variant's SGD chain (BPTT), self-training and
imitation; port of ``srnn_tpu/ops/pallas_rnn_train.py``.

``rnn_train_epochs`` / ``rnn_learn_epochs`` launch ``csrc/rnn_train.cu``
for CUDA tensors and run the plain chain for CPU tensors.  The plain chain
mirrors the kernel's (and ``pallas_rnn_train``'s) operation order: the
stacked SimpleRNN forward over T = P steps keeping every layer's sequence
(``rnn_forward_rows_plain``, with the explicit zero h_{-1} terms, so 0 * Inf
= NaN holds at the first step as in the XLA scan), then the hand-derived
backprop-through-time of ``_bptt_epoch`` (keras kernel order: K[i, u] at
``ko + i*units + u``, R[v, u] at ``ro + v*units + u``):

    dh_t[u]   = dOut_t[u] + sum_u' dz_{t+1}[u'] R[u, u']
    dz_t[u]   = dh_t[u] act'(h_t[u])
    dK[i, u] += x_t[i] dz_t[u]
    dR[v, u] += h_{t-1}[v] dz_t[u]
    dX_t[i]   = sum_u dz_t[u] K[i, u]        (the layer below's dOut)

One sample per epoch (x = y = the weight sequence): re-snapshotted from the
current rows at each epoch top for self-training, the counterpart's rows
for imitation.  The loss is the last epoch's pre-update MSE.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..topology import Topology
from .activations import resolve_layer_activation, resolve_output_grad
from .cuda_sgd_common import (_I, _P, SGD_HEAD, KERNEL_ACT_CODES, LaneKernel,
                              check_lanes, check_variant, is_cpu, lane_call)

RNN_SGD = LaneKernel(
    "rnn_sgd", "rnn_train", "srnn_rnn_sgd", SGD_HEAD + [_I, _I, _I, _P],
    replaces="srnn_tpu/ops/pallas_rnn_train.py:177")


def rnn_forward_rows_plain(topo: Topology, rows: Sequence[torch.Tensor],
                           x_rows: Sequence[torch.Tensor]):
    """Stacked SimpleRNN forward on lane rows (``rnn_forward_rows``):
    ``rows`` the net's P parameter rows, ``x_rows`` the length-T input
    sequence.  Returns every layer's output sequence, ``seqs[0]`` the input
    and ``seqs[-1][t][0]`` the prediction at step t."""
    act = resolve_layer_activation(topo.activation)
    t_len = len(x_rows)
    seqs = [[[x_rows[t]] for t in range(t_len)]]
    for layer, (ind, units) in enumerate(topo.rnn_layer_dims):
        ko = topo.offsets[2 * layer]
        ro = topo.offsets[2 * layer + 1]
        inp = seqs[-1]
        out = []
        h = [torch.zeros_like(rows[0])] * units  # explicit zero h_{-1}
        for t in range(t_len):
            accs = []
            for u in range(units):
                acc = inp[t][0] * rows[ko + u]
                for i in range(1, ind):
                    acc = acc + inp[t][i] * rows[ko + i * units + u]
                for v in range(units):
                    acc = acc + h[v] * rows[ro + v * units + u]
                accs.append(acc)
            nxt = act(accs)
            out.append(nxt)
            h = nxt
        seqs.append(out)
    return seqs


def _sum(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def bptt_epoch_plain(topo: Topology, rows: Sequence[torch.Tensor],
                     x_rows: Sequence[torch.Tensor]):
    """One full-batch MSE gradient (``_bptt_epoch``).  Returns (grads,
    per-particle pre-update loss)."""
    act_grad = resolve_output_grad(topo.activation)
    t_len = topo.num_weights
    seqs = rnn_forward_rows_plain(topo, rows, x_rows)
    err = [seqs[-1][t][0] - x_rows[t] for t in range(t_len)]
    loss = err[0] * err[0]
    for t in range(1, t_len):
        loss = loss + err[t] * err[t]
    # a tensor divisor: on the card torch takes a Python scalar divisor as
    # a multiply by its reciprocal, not the kernels' division
    loss = loss / torch.full_like(loss, t_len)
    zero = torch.zeros_like(rows[0])
    grads = [zero] * topo.num_weights
    scale = float(np.float32(2.0 / t_len))
    d_out = [[err[t] * scale] for t in range(t_len)]
    for layer in range(len(topo.rnn_layer_dims) - 1, -1, -1):
        ind, units = topo.rnn_layer_dims[layer]
        ko = topo.offsets[2 * layer]
        ro = topo.offsets[2 * layer + 1]
        inp, out = seqs[layer], seqs[layer + 1]
        d_inp = [None] * t_len
        dcarry = None  # the gradient reaching h_t from step t + 1
        for t in range(t_len - 1, -1, -1):
            dz = []
            for u in range(units):
                dh = d_out[t][u]
                if dcarry is not None:
                    dh = dh + dcarry[u]
                if act_grad is not None:
                    dh = dh * act_grad(out[t][u])
                dz.append(dh)
            for u in range(units):
                for i in range(ind):
                    gi = ko + i * units + u
                    grads[gi] = grads[gi] + inp[t][i] * dz[u]
                for v in range(units):
                    gr = ro + v * units + u
                    prev = out[t - 1][v] if t > 0 else zero
                    grads[gr] = grads[gr] + prev * dz[u]
            # layer 0's input gradient and the carry out of step 0 reach
            # nothing; like the kernel (and XLA), skip them
            if layer > 0:
                d_inp[t] = [_sum([dz[u] * rows[ko + i * units + u]
                                  for u in range(units)]) for i in range(ind)]
            if t > 0:
                dcarry = [_sum([dz[u] * rows[ro + v * units + u]
                                for u in range(units)]) for v in range(units)]
        d_out = d_inp
    return grads, loss


def rnn_sgd_chain_plain(topo: Topology, rows0: Sequence[torch.Tensor],
                        snap_rows: Optional[Sequence[torch.Tensor]],
                        epochs: int, lr: float, refresh: bool):
    """``epochs`` full-batch BPTT-SGD steps (``_sgd_epochs``); the sample
    re-snapshots from the rows (``refresh``) or stays ``snap_rows``.
    Returns (rows, last-epoch loss (N,))."""
    rows = list(rows0)
    loss = torch.zeros_like(rows[0])
    for _ in range(epochs):
        grads, loss = bptt_epoch_plain(topo, rows,
                                       rows if refresh else snap_rows)
        rows = [rows[r] - lr * grads[r] for r in range(topo.num_weights)]
    return rows, loss


def rnn_apply_rows_plain(topo: Topology, self_rows: Sequence[torch.Tensor],
                         x_rows: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """Attack / self-application on lane rows: the last layer's output
    sequence (``pallas_generation.apply_rows``, recurrent body)."""
    seqs = rnn_forward_rows_plain(topo, self_rows, x_rows)
    return [seqs[-1][t][0] for t in range(len(x_rows))]


def rnn_sgd_plain(topo: Topology, wT: torch.Tensor,
                  otherT: Optional[torch.Tensor], epochs: int, lr: float):
    """The plain chain on a (P, N) population: self-training when
    ``otherT`` is None, else imitation of ``otherT``."""
    snap = None if otherT is None else list(otherT.unbind(0))
    rows, loss = rnn_sgd_chain_plain(topo, list(wT.unbind(0)), snap, epochs,
                                     lr, otherT is None)
    return torch.stack(rows), loss


def _launch(topo: Topology, arrays, epochs: int, lr: float):
    return lane_call(RNN_SGD, topo, arrays, epochs, lr, topo.width,
                     topo.depth, KERNEL_ACT_CODES[topo.activation])


def rnn_train_epochs(topo: Topology, wT: torch.Tensor, epochs: int,
                     lr: float = 0.01):
    """``epochs`` of BPTT self-training.  Returns (new_wT, last epoch
    per-particle loss (N,))."""
    check_variant(topo, "recurrent")
    check_lanes(topo, wT)
    if is_cpu(wT):
        return rnn_sgd_plain(topo, wT, None, epochs, lr)
    return _launch(topo, [wT], epochs, lr)


def rnn_learn_epochs(topo: Topology, wT: torch.Tensor, otherT: torch.Tensor,
                     severity: int, lr: float = 0.01):
    """``severity`` imitation epochs toward the counterparts' fixed
    sequences ``otherT`` (P, N)."""
    check_variant(topo, "recurrent")
    check_lanes(topo, wT, otherT)
    if is_cpu(wT):
        return rnn_sgd_plain(topo, wT, otherT, severity, lr)
    return _launch(topo, [wT, otherT], severity, lr)
