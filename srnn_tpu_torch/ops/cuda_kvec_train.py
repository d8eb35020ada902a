"""K4: the k-vector (aggregating, fft) SGD chain, self-training and
imitation; port of ``srnn_tpu/ops/pallas_kvec_train.py``.

``kvec_train_epochs`` / ``kvec_learn_epochs`` launch ``csrc/kvec_train.cu``
for CUDA tensors and run the plain chain for CPU tensors.  The plain chain
mirrors the kernel's (and ``pallas_kvec_train``'s) operation order:

  * the reduce (``reduce_rows_plain``, twin of ``_reduce_rows``): the
    segment average with its prefix/suffix chains of 0.0-weighted rows, so
    a non-finite weight enters its own segment at full value and poisons
    every other aggregate (0 * Inf = NaN); max and max_buggy as comparison
    chains; the DFT as multiply-add chains over a real cos basis computed in
    float64 and rounded to float32 (``dft_cos_rows``), a coefficient of
    exactly 0.0 skipped and one of exactly 1.0 taken as the row itself --
    not ``torch.fft``, which ``popmajor_kvec`` uses as the independent
    oracle;
  * one sample per epoch, x = y = the k-vector, re-reduced from the current
    rows at each epoch top for self-training and reduced once from the
    counterpart for imitation; the loss is the last epoch's pre-update MSE.

``kvec_apply_rows_plain`` is the transform of K3's k-vector body (reduce,
MLP, expand), the twin of ``pallas_generation.apply_rows``: the fft expand
is a float64 inverse basis rounded to float32 (``kvec_expand_basis``), the
aggregating expand keeps a 0.0-weighted term for every out-of-segment
aggregate.

The kernels compile the fft bases in (``DftTable``): written out in
``csrc/kvec_common.cuh`` for width 2 / depth 2 / 4 aggregates, and for any
other fft topology generated from ``kvec_tables`` into its build
(``dft_table_header``).
"""

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..topology import Topology, aggregation_segments
from .activations import resolve_output_grad
from .cuda_sgd_common import (_I, _P, SGD_HEAD, KERNEL_ACT_CODES, LaneKernel,
                              check_lanes, check_variant, is_cpu,
                              kernel_build, lane_call)
from .cuda_ww_train import mlp_backward_plain
from .mlp import mlp_rows_plain
from .popmajor_kvec import segment_bounds

KVEC_SGD = LaneKernel(
    "kvec_sgd", "kvec_train", "srnn_kvec_sgd",
    SGD_HEAD + [_I, _I, _I, _I, _I, _P, _P],
    replaces="srnn_tpu/ops/pallas_kvec_train.py:202")

#: reduce kind -> the code of ``csrc/kvec_common.cuh`` (``enum Reduce``):
#: the aggregators, and the fft variant's DFT by ``fft_mode``
REDUCE_CODES = {"average": 0, "max": 1, "max_buggy": 2, "fft": 3, "rfft": 4}

#: kinds of a basis entry in the kernel's tables
_SKIP, _ONE, _MUL = 0.0, 1.0, 2.0


def reduce_kind(topo: Topology) -> str:
    return topo.fft_mode if topo.variant == "fft" else topo.aggregator


@functools.lru_cache(maxsize=None)
def dft_cos_rows(topo: Topology) -> np.ndarray:
    """(k, P) float64 real cos basis of the truncated DFT
    (``_dft_cos_rows``): 'fft' crops to min(k, P) weights with basis
    cos(2 pi j m / k); 'rfft' takes the first k bins of the length-P real
    FFT, basis cos(2 pi j m / P), zero beyond bin P // 2."""
    p, k = topo.num_weights, topo.aggregates
    rows = np.zeros((k, p), dtype=np.float64)
    if topo.fft_mode == "fft":
        for j in range(k):
            for m in range(min(k, p)):
                rows[j, m] = np.cos(2.0 * np.pi * j * m / k)
    else:
        for j in range(min(k, p // 2 + 1)):
            for m in range(p):
                rows[j, m] = np.cos(2.0 * np.pi * j * m / p)
    return rows


@functools.lru_cache(maxsize=None)
def kvec_expand_basis(topo: Topology) -> np.ndarray:
    """(P, k) float64 inverse basis of the fft variant
    (``_kvec_expand_basis``): column j is the real inverse transform of the
    j-th unit coefficient vector."""
    p, k = topo.num_weights, topo.aggregates
    basis = np.zeros((p, k), dtype=np.float64)
    for j in range(k):
        e = np.zeros(k)
        e[j] = 1.0
        basis[:, j] = (np.fft.irfft(e, n=p) if topo.fft_mode == "rfft"
                       else np.fft.ifft(e, n=p).real)
    return basis


def _f32(c: float) -> float:
    return float(np.float32(c))


@functools.lru_cache(maxsize=None)
def kvec_tables(topo: Topology) -> np.ndarray:
    """The kernels' constant tables as one float32 host array: reduce
    basis (k, P), expand basis (P, k), their entry kinds (0 skip, 1 the row
    itself, 2 times the coefficient), and whether the transform reads the
    target.  The kernels compile these tables in (``DftTable`` in
    ``csrc/kvec_common.cuh``) and refuse a host array that differs from
    them bit for bit (``tables_match``): the wrappers then raise."""
    p, k = topo.num_weights, topo.aggregates
    red = np.zeros((k, p))
    red_kind = np.zeros((k, p))
    exp = np.zeros((p, k))
    exp_kind = np.zeros((p, k))
    if topo.variant == "fft":
        cos = dft_cos_rows(topo)
        red = cos
        red_kind = np.where(cos == 0.0, _SKIP, np.where(cos == 1.0, _ONE,
                                                        _MUL))
        exp = kvec_expand_basis(topo)
        exp_kind = np.where(exp == 1.0, _ONE, _MUL)
    src_target = float(topo.variant == "aggregating" or topo.fft_use_target)
    return np.concatenate([red.ravel(), exp.ravel(), red_kind.ravel(),
                           exp_kind.ravel(), [src_target]]).astype(np.float32)


#: the (P, k) whose DftTable ``csrc/kvec_common.cuh`` writes out itself
_WRITTEN_TABLES = (20, 4)


def dft_table_header(topo: Topology) -> str:
    """``DftTable<P, k, DFT or RDFT>`` of the fft topology ``topo`` as C++
    source: ``kvec_tables``' float32 reduce and expand bases (float64,
    rounded once) as hex-float literals, the sign of zero kept, for the
    kernels' build of that topology to include."""
    p, k = topo.num_weights, topo.aggregates
    t = kvec_tables(topo)
    red, exp = t[:k * p].reshape(k, p), t[k * p:2 * k * p].reshape(p, k)
    kind = "DFT" if topo.fft_mode == "fft" else "RDFT"

    def rows(a):
        return ",\n".join(
            "      {" + ", ".join(float(v).hex() + "f" for v in r) + "}"
            for r in a)

    return (f"// DftTable of fft_mode {topo.fft_mode!r}, P = {p}, k = {k}: "
            "generated by srnn_tpu_torch/ops/cuda_kvec_train.py "
            "(dft_table_header)\n"
            f"template <>\nstruct DftTable<{p}, {k}, {kind}> {{\n"
            f"  static constexpr float red[{k}][{p}] = {{\n{rows(red)}}};\n"
            f"  static constexpr float exp[{p}][{k}] = {{\n{rows(exp)}}};\n"
            "};\n")


def kvec_build(topo: Topology):
    """The build of the k-vector sources that runs ``topo``
    (``cuda_sgd_common.kernel_build``), with its generated DFT table where
    it is an fft topology off the written-out one."""
    kind = reduce_kind(topo)
    headers = ()
    if topo.variant == "fft" and (topo.num_weights,
                                  topo.aggregates) != _WRITTEN_TABLES:
        headers = (("srnn_dft_table.cuh", dft_table_header(topo)),)
    b = kernel_build(topo, (kind, REDUCE_CODES[kind]), headers=headers)
    if headers:
        b = b._replace(defines=b.defines + (("SRNN_DFT_TABLE", 1),))
    return b


def reduce_rows_plain(topo: Topology, rows: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """P lane rows -> k lane aggregates / DFT coefficients, in the kernel's
    operation order (``_reduce_rows``)."""
    if topo.variant == "fft":
        out = []
        for coeffs in dft_cos_rows(topo):
            acc = None
            for m, c in enumerate(coeffs):
                if c == 0.0:
                    continue
                term = rows[m] if c == 1.0 else rows[m] * _f32(c)
                acc = term if acc is None else acc + term
            out.append(acc if acc is not None else torch.zeros_like(rows[0]))
        return out
    _, counts = aggregation_segments(topo)
    starts, ends = segment_bounds(topo)
    zpre = zsuf = None
    if topo.aggregator == "average":
        zero = torch.zeros_like(rows[0])
        zpre = [zero]
        for r in range(len(rows)):
            zpre.append(zpre[-1] + rows[r] * 0.0)
        zsuf = [zero]
        for r in range(len(rows) - 1, -1, -1):
            zsuf.append(zsuf[-1] + rows[r] * 0.0)
        zsuf = zsuf[::-1]  # zsuf[i] = sum of 0 * rows[i:]
    out = []
    for s, e, c in zip(starts, ends, counts):
        s, e = int(s), int(e)
        acc = rows[s]
        for r in range(s + 1, e):
            if topo.aggregator == "average":
                acc = acc + rows[r]
            elif topo.aggregator == "max":
                acc = torch.maximum(acc, rows[r])
            else:  # max_buggy: the reference's falsy max
                w = rows[r]
                acc = torch.where((w > acc) & (w != 0.0), w, acc)
        if topo.aggregator == "average":
            acc = (acc + zpre[s] + zsuf[e]) * _f32(1.0 / float(c))
        out.append(acc)
    return out


def kvec_sgd_chain_plain(topo: Topology, rows0: Sequence[torch.Tensor],
                         snap_xk: Optional[Sequence[torch.Tensor]],
                         epochs: int, lr: float, refresh: bool):
    """``epochs`` full-batch MSE-SGD steps on the k-vector sample
    (``_sgd_epochs``); ``snap_xk`` the fixed imitation sample when
    ``refresh`` is False.  Returns (rows, last-epoch loss (N,))."""
    k = topo.aggregates
    act_grad = resolve_output_grad(topo.activation)
    rows = list(rows0)
    loss = torch.zeros_like(rows[0])
    for _ in range(epochs):
        xk = reduce_rows_plain(topo, rows) if refresh else snap_xk
        acts = mlp_rows_plain(topo, rows, xk)
        err = [acts[-1][j] - xk[j] for j in range(k)]
        loss = err[0] * err[0]
        for j in range(1, k):
            loss = loss + err[j] * err[j]
        # a tensor divisor: on the card torch takes a Python scalar divisor as
        # a multiply by its reciprocal, not the kernels' division
        loss = loss / torch.full_like(loss, k)
        grads = mlp_backward_plain(topo, rows, acts,
                                   [err[j] * _f32(2.0 / k) for j in range(k)],
                                   act_grad)
        rows = [rows[r] - lr * grads[r] for r in range(topo.num_weights)]
    return rows, loss


def kvec_apply_rows_plain(topo: Topology, self_rows: Sequence[torch.Tensor],
                          x_rows: Sequence[torch.Tensor]
                          ) -> List[torch.Tensor]:
    """Attack / self-application on lane rows: reduce, MLP, expand
    (``pallas_generation.apply_rows``, k-vector body).  The fft transform
    reads its own rows unless ``topo.fft_use_target``."""
    src = x_rows if (topo.variant == "aggregating" or topo.fft_use_target) \
        else self_rows
    outk = mlp_rows_plain(topo, self_rows, reduce_rows_plain(topo, src))[-1]
    out = []
    if topo.variant == "fft":
        for coeffs in kvec_expand_basis(topo):
            acc = None
            for j, c in enumerate(coeffs):
                term = outk[j] if c == 1.0 else outk[j] * _f32(c)
                acc = term if acc is None else acc + term
            out.append(acc)
        return out
    seg, _ = aggregation_segments(topo)
    for m in range(topo.num_weights):
        acc = None
        for j in range(topo.aggregates):
            term = outk[j] if j == int(seg[m]) else outk[j] * 0.0
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def kvec_sgd_plain(topo: Topology, wT: torch.Tensor,
                   otherT: Optional[torch.Tensor], epochs: int, lr: float):
    """The plain chain on a (P, N) population: self-training when
    ``otherT`` is None, else imitation of ``otherT``'s k-vector."""
    snap = None if otherT is None else reduce_rows_plain(
        topo, list(otherT.unbind(0)))
    rows, loss = kvec_sgd_chain_plain(topo, list(wT.unbind(0)), snap, epochs,
                                      lr, otherT is None)
    return torch.stack(rows), loss


def _launch(topo: Topology, arrays, epochs: int, lr: float):
    tables = kvec_tables(topo)
    return lane_call(KVEC_SGD, topo, arrays, epochs, lr, topo.width,
                     topo.depth, topo.aggregates,
                     KERNEL_ACT_CODES[topo.activation],
                     REDUCE_CODES[reduce_kind(topo)], tables.ctypes.data,
                     build=kvec_build(topo))


def kvec_train_epochs(topo: Topology, wT: torch.Tensor, epochs: int,
                      lr: float = 0.01):
    """``epochs`` of self-training (one full-batch step on the k-vector
    sample each).  Returns (new_wT, last epoch per-particle loss (N,))."""
    check_variant(topo, "aggregating", "fft")
    check_lanes(topo, wT)
    if is_cpu(wT):
        return kvec_sgd_plain(topo, wT, None, epochs, lr)
    return _launch(topo, [wT], epochs, lr)


def kvec_learn_epochs(topo: Topology, wT: torch.Tensor,
                      otherT: torch.Tensor, severity: int, lr: float = 0.01):
    """``severity`` imitation epochs toward the counterparts' fixed
    k-vector sample, reduced from ``otherT`` (P, N)."""
    check_variant(topo, "aggregating", "fft")
    check_lanes(topo, wT, otherT)
    if is_cpu(wT):
        return kvec_sgd_plain(topo, wT, otherT, severity, lr)
    return _launch(topo, [wT, otherT], severity, lr)
