"""Population-major (P, N) ops of the k-vector variants (aggregating, fft)
in plain torch; port of ``srnn_tpu/ops/popmajor_kvec.py``.

Row p of a (P, N) matrix holds weight p of every particle.  Around the
tiny k -> k MLP sit a reduce (P weights -> k aggregates or DFT
coefficients) and an expand (k outputs -> P weights):

  * aggregating: collect and deaggregate are one-hot products (reference
    ``collect_weights``, ``network.py:388-403``; ``deaggregate_identically``,
    ``network.py:310-312``), written as explicit multiply-add chains so that
    the 0.0-weighted out-of-segment terms poison like the JAX package's
    matmul (0 * Inf = NaN);
  * fft: ``torch.fft`` along axis 0 (reference ``aggregate_fft``,
    ``network.py:444-448``).

Self-training has ONE sample per epoch (x = y = the k-vector,
``network.py:414-417``/``:518-521``), so a batch-1 epoch is one full-batch
step and 'sequential' and 'full_batch' are the same program.  The
gradients here come from autograd: this module is the independent oracle
that the tests hold the hand-derived chain of K4 (``cuda_kvec_train``)
against; the soup runs it only for the attack of the phase chain
(``kvec_apply_popmajor``).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from ..nets.aggregating import segment_onehot
from ..topology import Topology, aggregation_segments
from .mlp import mlp_rows_plain

DEFAULT_LR = 0.01  # keras SGD default


def segment_bounds(topo: Topology):
    """(starts, ends) of the k contiguous segments."""
    seg, counts = aggregation_segments(topo)
    starts = np.searchsorted(seg, np.arange(topo.aggregates))
    return starts, starts + counts


def _onehot_rows(onehot: np.ndarray, xT: torch.Tensor) -> torch.Tensor:
    """``onehot`` (B, A) times ``xT`` (A, N) as the chain
    sum_i onehot[:, i] * xT[i] in order i = 0..A-1 -> (B, N)."""
    oh = torch.as_tensor(onehot, dtype=xT.dtype, device=xT.device)
    acc = oh[:, 0:1] * xT[0:1]
    for i in range(1, oh.shape[1]):
        acc = acc + oh[:, i:i + 1] * xT[i:i + 1]
    return acc


def kvec_reduce_popmajor(topo: Topology,
                         targetT: torch.Tensor) -> torch.Tensor:
    """(P, N) weights -> (k, N) aggregates / DFT coefficients."""
    k = topo.aggregates
    if topo.variant == "fft":
        if topo.fft_mode == "rfft":
            spec = torch.fft.rfft(targetT, dim=0).real.to(targetT.dtype)
            if spec.shape[0] >= k:
                return spec[:k]
            return torch.nn.functional.pad(spec, (0, 0, 0, k - spec.shape[0]))
        return torch.fft.fft(targetT, n=k, dim=0).real.to(targetT.dtype)
    if topo.variant != "aggregating":
        raise ValueError(f"variant {topo.variant!r} has no k-vector reduce")
    _, counts = aggregation_segments(topo)
    if topo.aggregator == "average":
        cnt = torch.as_tensor(counts, dtype=targetT.dtype,
                              device=targetT.device)
        return _onehot_rows(segment_onehot(topo).T, targetT) / cnt[:, None]
    starts, ends = segment_bounds(topo)
    if topo.aggregator == "max":
        return torch.stack([targetT[s:e].amax(dim=0)
                            for s, e in zip(starts, ends)])
    if topo.aggregator == "max_buggy":
        rows = []
        for s, e in zip(starts, ends):
            acc = targetT[s]
            for r in range(s + 1, e):
                w = targetT[r]
                acc = torch.where((w > acc) & (w != 0.0), w, acc)
            rows.append(acc)
        return torch.stack(rows)
    raise ValueError(f"unknown aggregator {topo.aggregator!r}")


def kvec_expand_popmajor(topo: Topology, aggs: torch.Tensor) -> torch.Tensor:
    """(k, N) outputs -> (P, N) weights (replication / inverse FFT)."""
    p = topo.num_weights
    if topo.variant == "fft":
        if topo.fft_mode == "rfft":
            out = torch.fft.irfft(aggs, n=p, dim=0)
        else:
            out = torch.fft.ifft(aggs, n=p, dim=0).real
        return out.to(aggs.dtype).contiguous()
    return _onehot_rows(segment_onehot(topo), aggs)


def mlp_forward_lanes(topo: Topology, wT: torch.Tensor,
                      xk: torch.Tensor) -> torch.Tensor:
    """The tiny MLP with per-lane parameters ``wT`` (P, N) on per-lane
    inputs ``xk`` (k, N) -> (k, N)."""
    return torch.stack(mlp_rows_plain(topo, wT.unbind(0), xk.unbind(0))[-1])


def kvec_apply_popmajor(topo: Topology, selfT: torch.Tensor,
                        targetT: torch.Tensor) -> torch.Tensor:
    """Population-major self-application / attack: particle n's transform
    (parameters ``selfT[:, n]``) rewrites ``targetT[:, n]``.  The fft
    transform reads its own weights unless ``topo.fft_use_target``."""
    src = selfT if (topo.variant == "fft" and not topo.fft_use_target) \
        else targetT
    aggs = kvec_reduce_popmajor(topo, src)
    return kvec_expand_popmajor(topo, mlp_forward_lanes(topo, selfT, aggs))


def _epoch_grad(topo: Topology, wT: torch.Tensor,
                xk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MSE-SGD gradient on the single sample x = y = ``xk`` (k, N).
    Returns (grads, per-particle pre-update loss (N,))."""
    xk = xk.detach()
    wi = wT.detach().requires_grad_(True)
    with torch.enable_grad():
        pred = mlp_forward_lanes(topo, wi, xk)
        per_particle = ((pred - xk) ** 2).mean(dim=0)
        (grads,) = torch.autograd.grad(per_particle.sum(), wi)
    return grads, per_particle.detach()


def _check_mode(mode: str) -> None:
    if mode not in ("sequential", "full_batch"):
        raise ValueError(f"unknown train mode {mode!r}")


def _epochs(topo: Topology, wT: torch.Tensor, epochs: int, lr: float,
            fixed_xk: Optional[torch.Tensor]):
    w = wT.detach()
    last = torch.zeros(wT.shape[1], dtype=wT.dtype, device=wT.device)
    for _ in range(epochs):
        xk = kvec_reduce_popmajor(topo, w) if fixed_xk is None else fixed_xk
        grads, last = _epoch_grad(topo, w, xk)
        w = w - lr * grads
    return w, last


def kvec_train_epochs_popmajor(topo: Topology, wT: torch.Tensor, epochs: int,
                               lr: float = DEFAULT_LR,
                               mode: str = "sequential"):
    """``epochs`` self-training calls, the sample re-reduced from the
    CURRENT weights before every epoch (``network.py:613-618``).  Returns
    (new_wT, last epoch per-particle loss (N,))."""
    _check_mode(mode)
    return _epochs(topo, wT, max(epochs, 0), lr, None)


def kvec_learn_epochs_popmajor(topo: Topology, wT: torch.Tensor,
                               otherT: torch.Tensor, severity: int,
                               lr: float = DEFAULT_LR,
                               mode: str = "sequential"):
    """``severity`` imitation epochs toward the counterparts' sample (x = y
    = the other's k-vector, fixed across the call, ``network.py:620-626``)."""
    _check_mode(mode)
    return _epochs(topo, wT, max(severity, 0), lr,
                   kvec_reduce_popmajor(topo, otherT.detach()))
