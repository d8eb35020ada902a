"""K6: the recurrent variant's attack transform; port of
``srnn_tpu/ops/pallas_rnn_apply.py`` (``rnn_apply_pallas``).

``rnn_apply`` launches ``csrc/rnn_apply.cu`` for CUDA tensors and runs
``rnn_apply_plain`` for CPU tensors: particle n's stacked SimpleRNN
(parameters ``selfT[:, n]``) rewrites the sequence ``targetT[:, n]``, with
the forward of K5 (``rnn_forward_rows_plain``, explicit zero h_{-1}
terms).  The victim's length T may differ from the attacker's P (the
mixed-type soup's cross attacks).  On the card the kernel takes, like the
JAX package's ``_use_pallas_apply``, an attacker inside the kernels'
envelope (``cuda_sgd_common``) and a victim of up to
``KERNEL_MAX_WEIGHTS`` weights: the default build holds the width-2 /
depth-2 attackers on the victims those topologies give, T = 14
(weightwise), 17 (recurrent) and 20 (aggregating, fft); any other pair
loads a build of its own.  Each length has its own launch count
(``rnn_apply_kernel(T)``, in ``RNN_APPLY_BY_T``; ``RNN_APPLY`` is T = 17's).
A longer victim raises ``ValueError`` on the card; the plain version takes
any T.
"""

import torch

from ..topology import Topology
from .cuda_rnn_train import rnn_apply_rows_plain
from .cuda_sgd_common import (_I, _LL, _P, DEFAULT_T_LENGTHS,
                              KERNEL_ACT_CODES, KERNEL_MAX_WEIGHTS,
                              LaneKernel, check_kernel_topology, check_lanes,
                              check_variant, is_cpu, kernel_build, ptr,
                              stream_arg)

#: T -> the kernel's launch count for victims of length T, made at the
#: length's first use; T = 17 (the homogeneous recurrent soup's) keeps the
#: name it had before the others
RNN_APPLY_BY_T = {}


def rnn_apply_kernel(t_len: int) -> LaneKernel:
    """K6 for victims of length ``t_len``."""
    kernel = RNN_APPLY_BY_T.get(t_len)
    if kernel is None:
        kernel = RNN_APPLY_BY_T[t_len] = LaneKernel(
            "rnn_apply" if t_len == 17 else f"rnn_apply_t{t_len}",
            "rnn_apply", "srnn_rnn_apply", [_P, _P, _P, _LL, _I, _I, _I, _I,
                                            _P],
            replaces="srnn_tpu/ops/pallas_rnn_apply.py:50")
    return kernel


for _t in DEFAULT_T_LENGTHS:
    rnn_apply_kernel(_t)
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
    if t_len > KERNEL_MAX_WEIGHTS:
        raise ValueError(
            f"the rnn_apply kernel takes victims of up to "
            f"{KERNEL_MAX_WEIGHTS} weights (the JAX package's Pallas fence);"
            f" T = {t_len} is longer")
    out = torch.empty_like(targetT)
    if n:
        rnn_apply_kernel(t_len).launch(
            kernel_build(topo, t_len=t_len), ptr(selfT), ptr(targetT),
            ptr(out), n, t_len, topo.width, topo.depth,
            KERNEL_ACT_CODES[topo.activation], stream_arg(selfT))
    return out
