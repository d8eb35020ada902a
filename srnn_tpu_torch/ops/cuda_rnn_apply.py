"""K6: the recurrent variant's attack transform; port of
``srnn_tpu/ops/pallas_rnn_apply.py`` (``rnn_apply_pallas``).

``rnn_apply`` launches ``csrc/rnn_apply.cu`` for CUDA tensors and runs
``rnn_apply_plain`` for CPU tensors: particle n's stacked SimpleRNN
(parameters ``selfT[:, n]``) rewrites the sequence ``targetT[:, n]``, with
the forward of K5 (``rnn_forward_rows_plain``, explicit zero h_{-1}
terms).  The victim's length T may differ from the attacker's P (the
mixed-type soup's cross attacks).  The card's kernel is instantiated for the
victims the width-2 / depth-2 topologies give, ``KERNEL_T_LENGTHS``: T = 14
(weightwise), 17 (recurrent) and 20 (aggregating, fft); each length has its
own launch count (``RNN_APPLY_BY_T[T]``; ``RNN_APPLY`` is T = 17's).  Any other T raises ``ValueError`` on
the card; the plain version takes any T.
"""

import torch

from ..topology import Topology
from .cuda_rnn_train import rnn_apply_rows_plain
from .cuda_sgd_common import (_I, _LL, _P, KERNEL_ACT_CODES, LaneKernel,
                              check_kernel_topology, check_lanes,
                              check_variant, is_cpu, ptr, stream_arg)

#: victim lengths the kernel is instantiated for (csrc/rnn_apply.cu)
KERNEL_T_LENGTHS = (14, 17, 20)
#: T -> the kernel's instantiation for victims of length T; T = 17 (the
#: homogeneous recurrent soup's) keeps the name it had before the others
RNN_APPLY_BY_T = {
    t: LaneKernel("rnn_apply" if t == 17 else f"rnn_apply_t{t}", "rnn_apply",
                  "srnn_rnn_apply", [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
                  replaces="srnn_tpu/ops/pallas_rnn_apply.py:50")
    for t in KERNEL_T_LENGTHS}
RNN_APPLY = RNN_APPLY_BY_T[17]


def rnn_apply_plain(topo: Topology, selfT: torch.Tensor,
                    targetT: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`rnn_apply`."""
    return torch.stack(rnn_apply_rows_plain(topo, list(selfT.unbind(0)),
                                            list(targetT.unbind(0))))


def rnn_apply(topo: Topology, selfT: torch.Tensor,
              targetT: torch.Tensor) -> torch.Tensor:
    """Population-major attack: ``selfT`` (P, N) attackers' parameters,
    ``targetT`` (T, N) victims' sequences -> (T, N)."""
    check_variant(topo, "recurrent")
    n = check_lanes(topo, selfT)
    check_lanes(topo, targetT, rows=targetT.shape[0])
    if targetT.shape[1] != n or targetT.device != selfT.device:
        raise ValueError("attackers and victims must be (., N) on one device")
    if is_cpu(selfT):
        return rnn_apply_plain(topo, selfT, targetT)
    check_kernel_topology(topo)
    t_len = targetT.shape[0]
    if t_len not in RNN_APPLY_BY_T:
        raise ValueError(
            f"the rnn_apply kernel is instantiated for victims of length T "
            f"in {KERNEL_T_LENGTHS}; T = {t_len} has no instantiation")
    out = torch.empty_like(targetT)
    if n:
        RNN_APPLY_BY_T[t_len].launch(
            ptr(selfT), ptr(targetT), ptr(out), n, t_len, topo.width,
            topo.depth, KERNEL_ACT_CODES[topo.activation], stream_arg(selfT))
    return out
