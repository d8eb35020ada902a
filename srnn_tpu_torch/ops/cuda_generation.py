"""K3: one whole soup generation (attack, learn_from, self-train, respawn)
in one launch; port of the float32 bodies of
``srnn_tpu/ops/pallas_generation.py`` (``generation_popmajor``).

``generation_popmajor`` launches the variant's body for CUDA tensors --
``csrc/generation.cu`` (weightwise), ``csrc/generation_kvec.cu``
(aggregating, fft), ``csrc/generation_rnn.cu`` (recurrent), one
``LaneKernel`` each -- and runs ``generation_popmajor_plain`` for CPU
tensors.  The plain version is the phase chain the JAX package's tests use
as the kernel's oracle, composed from the plain versions of the variant's
transform and SGD chain (``pallas_generation.apply_rows`` / ``_chain_for``)
and written on the same operands as the kernel: the imitation target
arrives as its pre-attack column plus its attacker's column, and is
re-attacked where ``other_attacked`` says so; the k-vector imitation sample
is reduced once.

The gathers that build those operands, the draws and the uid bookkeeping
stay in plain torch in ``soup.py`` (XLA glue in the JAX package).
"""

from typing import Tuple

import torch

from ..topology import Topology
from .activations import KERNEL_ACT_CODES, output_grad_activations
from .cuda_kvec_train import (REDUCE_CODES, kvec_apply_rows_plain,
                              kvec_sgd_chain_plain, kvec_tables,
                              reduce_kind, reduce_rows_plain)
from .cuda_rnn_train import rnn_apply_rows_plain, rnn_sgd_chain_plain
from .cuda_sgd_common import (_F, _I, _LL, _P, LaneKernel,
                              check_kernel_topology, check_lanes,
                              check_variant, coords_arg, is_cpu, ptr,
                              stream_arg, topo_args)
from .cuda_ww_train import apply_rows_plain, sgd_chain_plain

_REPLACES = "srnn_tpu/ops/pallas_generation.py:382"
#: (gates, wT, fresh, atk, oth, oatk, out, loss, dead, n, severity, train,
#: lr, eps, remove_divergent, remove_zero): the head of every body's entry
_HEAD = [_P] * 9 + [_LL, _I, _I, _F, _F, _I, _I]

GENERATION = LaneKernel(
    "generation", "generation", "srnn_ww_generation",
    _HEAD + [_I, _I, _I, _P, _P], replaces=_REPLACES)
GENERATION_KVEC = LaneKernel(
    "generation_kvec", "generation_kvec", "srnn_kvec_generation",
    _HEAD + [_I, _I, _I, _I, _I, _P, _P], replaces=_REPLACES)
GENERATION_RNN = LaneKernel(
    "generation_rnn", "generation_rnn", "srnn_rnn_generation",
    _HEAD + [_I, _I, _I, _P], replaces=_REPLACES)

#: variant -> (plain transform, plain SGD chain, imitation-sample reduce)
_PLAIN_BODIES = {
    "weightwise": (apply_rows_plain, sgd_chain_plain, None),
    "aggregating": (kvec_apply_rows_plain, kvec_sgd_chain_plain,
                    reduce_rows_plain),
    "fft": (kvec_apply_rows_plain, kvec_sgd_chain_plain, reduce_rows_plain),
    "recurrent": (rnn_apply_rows_plain, rnn_sgd_chain_plain, None),
}


def fused_kernel_supported(topo: Topology, train_mode: str) -> bool:
    """Can this topology's generation run as the fused generation?  The
    JAX package's envelope (``pallas_generation.fused_kernel_supported``):
    an output-expressible activation, up to 64 weights, no random
    shuffler, and the sequential train mode for the weightwise variant."""
    if topo.activation not in output_grad_activations():
        return False
    if topo.num_weights > 64:
        return False
    if topo.variant == "weightwise" and train_mode != "sequential":
        return False
    return topo.shuffler != "random"


def _where_rows(mask, new, old):
    return [torch.where(mask, a, b) for a, b in zip(new, old)]


def generation_popmajor_plain(topo: Topology, wT, freshT, attackerT=None,
                              has_attacker=None, otherT=None,
                              other_attackerT=None, other_attacked=None,
                              learn_gate=None, *, severity: int = 0,
                              train: int = 0, lr: float = 0.01,
                              remove_divergent: bool = False,
                              remove_zero: bool = False,
                              epsilon: float = 1e-4):
    """Plain torch version of :func:`generation_popmajor` (same arguments,
    same results)."""
    apply_rows, chain, snap_fn = _PLAIN_BODIES[topo.variant]
    rows = list(wT.unbind(0))
    if attackerT is not None:
        attacked = apply_rows(topo, list(attackerT.unbind(0)), rows)
        rows = _where_rows(has_attacker, attacked, rows)
    if otherT is not None and severity > 0:
        oth = list(otherT.unbind(0))
        if other_attackerT is not None:
            oth_att = apply_rows(topo, list(other_attackerT.unbind(0)), oth)
            oth = _where_rows(other_attacked, oth_att, oth)
        snap = snap_fn(topo, oth) if snap_fn is not None else oth
        learned, _ = chain(topo, rows, snap, severity, lr, False)
        rows = _where_rows(learn_gate, learned, rows)
    rows, loss = chain(topo, rows, None, train, lr, True)
    w = torch.stack(rows)
    n = w.shape[1]
    div = torch.zeros(n, dtype=torch.bool, device=w.device)
    if remove_divergent:
        div = (~torch.isfinite(w)).any(dim=0)
    zero = torch.zeros_like(div)
    if remove_zero:
        zero = ((w >= -epsilon) & (w <= epsilon)).all(dim=0) & ~div
    dead = div | zero
    return torch.where(dead[None, :], freshT, w), loss, div, zero


def _gates(n, device, *masks) -> torch.Tensor:
    for m in masks:
        if m is not None and (m.shape != (n,) or m.device != device):
            raise ValueError(f"gate masks must be ({n},) on {device}")
    rows = [torch.zeros(n, dtype=torch.int32, device=device) if m is None
            else m.to(torch.int32) for m in masks]
    return torch.stack(rows).contiguous()


def generation_popmajor(topo: Topology, wT, freshT, attackerT=None,
                        has_attacker=None, otherT=None, other_attackerT=None,
                        other_attacked=None, learn_gate=None, *,
                        severity: int = 0, train: int = 0, lr: float = 0.01,
                        remove_divergent: bool = False,
                        remove_zero: bool = False, epsilon: float = 1e-4
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """One fused generation over a (P, N) float32 population.

    ``attackerT``/``has_attacker`` enable the attack phase (``attackerT[:,
    n]`` rewrites lane n where ``has_attacker``).  ``otherT``/``learn_gate``
    enable imitation (``severity`` epochs); ``other_attackerT``/
    ``other_attacked`` recompute the counterpart's own attack first, so
    learners imitate post-attack weights.  ``freshT`` supplies respawn
    replacements.  Returns ``(new_wT, last-train-loss (N,), dead_div (N,)
    bool, dead_zero (N,) bool)``.
    """
    check_variant(topo, "weightwise", "aggregating", "fft", "recurrent")
    if severity < 0 or train < 0:
        raise ValueError("severity and train must be >= 0")
    learn = otherT is not None and severity > 0
    recompute = learn and other_attackerT is not None
    operands = [wT, freshT]
    if attackerT is not None:
        operands.append(attackerT)
    if learn:
        operands.append(otherT)
        if recompute:
            operands.append(other_attackerT)
    n = check_lanes(topo, *operands)
    if is_cpu(wT):
        return generation_popmajor_plain(
            topo, wT, freshT, attackerT, has_attacker,
            otherT if learn else None,
            other_attackerT if recompute else None, other_attacked,
            learn_gate, severity=severity if learn else 0, train=train,
            lr=lr, remove_divergent=remove_divergent,
            remove_zero=remove_zero, epsilon=epsilon)
    check_kernel_topology(topo)
    dev = wT.device
    gates = _gates(n, dev, has_attacker if attackerT is not None else None,
                   learn_gate if learn else None,
                   other_attacked if recompute else None)
    out = torch.empty_like(wT)
    loss = torch.empty(n, dtype=torch.float32, device=dev)
    dead = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n:
        head = (ptr(gates), ptr(wT), ptr(freshT), ptr(attackerT),
                ptr(otherT if learn else None),
                ptr(other_attackerT if recompute else None),
                ptr(out), ptr(loss), ptr(dead), n, severity if learn else 0,
                int(train), float(lr), float(epsilon), int(remove_divergent),
                int(remove_zero))
        act = KERNEL_ACT_CODES[topo.activation]
        if topo.variant == "weightwise":
            coords = coords_arg(topo)
            GENERATION.launch(*head, *topo_args(topo), coords.ctypes.data,
                              stream_arg(wT))
        elif topo.variant == "recurrent":
            GENERATION_RNN.launch(*head, topo.width, topo.depth, act,
                                  stream_arg(wT))
        else:
            tables = kvec_tables(topo)
            GENERATION_KVEC.launch(*head, topo.width, topo.depth,
                                   topo.aggregates, act,
                                   REDUCE_CODES[reduce_kind(topo)],
                                   tables.ctypes.data, stream_arg(wT))
    return out, loss, dead[0] != 0, dead[1] != 0
