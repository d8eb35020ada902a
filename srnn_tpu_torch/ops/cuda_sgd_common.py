"""Shared plumbing of the port's CUDA kernels; counterpart of
``srnn_tpu/ops/pallas_sgd_common.py``.

``LaneKernel`` is one hand-written kernel: the ``csrc/`` source it builds
from, its C entry point, and its launch count (``launches`` goes up by one
where the kernel is launched, and nowhere else).  ``lane_call`` is the one
launcher of the SGD chains (K2, K4, K5), the counterpart of ``lane_call``:
it allocates the outputs and launches one thread per particle.  Unlike the
Pallas launcher it pads nothing: the kernels guard the ragged edge.

Rules every wrapper follows: a CPU tensor runs the plain torch version; a
CUDA tensor launches the kernel or raises -- never a fallback.  A topology,
dtype or layout the kernels do not take raises ``ValueError`` before any
launch.  Launches go on the current stream and do not synchronise.
"""

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from ..topology import Topology, normalized_weight_coords
from . import _build
from .activations import KERNEL_ACT_CODES

#: the topologies the kernel templates are instantiated for (every variant;
#: ``aggregates`` for the aggregating and fft variants)
KERNEL_WIDTHS = (2,)
KERNEL_DEPTHS = (2,)
KERNEL_AGGREGATES = (4,)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


#: every ``LaneKernel`` of the wrapper modules imported so far
KERNELS: List["LaneKernel"] = []


class LaneKernel:
    """One kernel of ``csrc/``: where it comes from and how often it ran."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: List,
                 replaces: str):
        self.name = name
        self.source = source      # csrc/<source>.cu
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces  # file:line of the Pallas kernel
        self.launches = 0
        KERNELS.append(self)

    def launch(self, *args) -> None:
        lib = _build.load(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        rc = fn(*args)
        if rc != 0:
            msg = lib.srnn_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} ({msg})")
        self.launches += 1


def is_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check_variant(topo: Topology, *variants: str) -> None:
    """Raise unless ``topo`` is one of ``variants`` with an activation the
    hand-derived chains can differentiate.  (The SGD chains read no
    deaggregation, so they take a random shuffler; the recurrent ones run
    the serial scan, which is the population-major layout's for either
    ``rnn_scan``, as in the JAX package.)"""
    if topo.variant not in variants:
        raise ValueError(
            f"variant {topo.variant!r} does not run on this kernel; it takes "
            f"{list(variants)}")
    if topo.activation not in KERNEL_ACT_CODES:
        raise ValueError(
            f"activation {topo.activation!r} has no output-expressible "
            f"derivative; the kernels take {sorted(KERNEL_ACT_CODES)}")


def kernel_supported(topo: Topology) -> bool:
    """Are the CUDA templates instantiated for ``topo`` (its activation,
    width, depth and, for the k-vector variants, aggregates)?"""
    try:
        check_kernel_topology(topo)
    except ValueError:
        return False
    return True


def check_kernel_topology(topo: Topology) -> None:
    """Raise unless the CUDA templates are instantiated for ``topo``."""
    check_variant(topo, "weightwise", "aggregating", "fft", "recurrent")
    if topo.width not in KERNEL_WIDTHS or topo.depth not in KERNEL_DEPTHS:
        raise ValueError(
            f"the CUDA kernels are instantiated for width in {KERNEL_WIDTHS}"
            f" and depth in {KERNEL_DEPTHS}; Topology(width={topo.width}, "
            f"depth={topo.depth}) has no instantiation")
    if topo.variant in ("aggregating", "fft") and \
            topo.aggregates not in KERNEL_AGGREGATES:
        raise ValueError(
            f"the k-vector kernels are instantiated for aggregates in "
            f"{KERNEL_AGGREGATES}; aggregates={topo.aggregates} has no "
            "instantiation")


def check_lanes(topo: Topology, *arrays: torch.Tensor, rows=None,
                dtype=torch.float32) -> int:
    """Every array is a contiguous (P, N) population of ``dtype`` on one
    device (``rows`` rows instead of P where given); returns N."""
    p = topo.num_weights if rows is None else rows
    first = arrays[0]
    for a in arrays:
        if a.dtype != dtype:
            raise ValueError(f"the kernels take {dtype} populations here, "
                             f"got {a.dtype}")
        if a.dim() != 2 or a.shape[0] != p or a.shape[1] != first.shape[1]:
            raise ValueError(f"expected ({p}, {first.shape[1]}) population, "
                             f"got {tuple(a.shape)}")
        if a.device != first.device:
            raise ValueError("operands lie on different devices")
        if not a.is_contiguous():
            raise ValueError("population operands must be contiguous")
    return first.shape[1]


def coords_arg(topo: Topology) -> np.ndarray:
    """The (P, 3) normalised coordinates as a float32 host array; the
    weightwise C entry points refuse to launch (``cudaErrorInvalidValue``)
    unless they equal the kernels' compile-time table bit for bit."""
    return np.ascontiguousarray(normalized_weight_coords(topo),
                                dtype=np.float32)


def stream_arg(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int:
    """Device pointer of a tensor, or null for None."""
    return None if t is None else t.data_ptr()


def topo_args(topo: Topology) -> Sequence:
    return (topo.width, topo.depth, KERNEL_ACT_CODES[topo.activation])


#: (wT, otherT, out, loss, n, epochs, lr): the head of every SGD entry
SGD_HEAD = [_P, _P, _P, _P, _LL, _I, _F]
#: K2's entry: the head, then width, depth, activation, coords
SGD_ARGTYPES = SGD_HEAD + [_I, _I, _I, _P, _P]


def lane_call(kernel: LaneKernel, topo: Topology, arrays, epochs: int,
              lr: float, *tail):
    """Launch an SGD-chain kernel over the lane axis: ``arrays`` is
    ``[wT]`` (self-training) or ``[wT, otherT]`` (imitation), CUDA float32
    (P, N); ``tail`` the kernel's topology arguments (host pointers in it
    are kept alive by the caller).  Returns (new (P, N) population, (N,)
    last-epoch loss)."""
    check_kernel_topology(topo)
    n = check_lanes(topo, *arrays)
    w = arrays[0]
    out = torch.empty_like(w)
    loss = torch.empty(n, dtype=w.dtype, device=w.device)
    if n == 0:
        return out, loss
    if epochs < 0:
        raise ValueError("epochs must be >= 0")
    other = arrays[1] if len(arrays) > 1 else None
    kernel.launch(ptr(w), ptr(other), ptr(out), ptr(loss), n, int(epochs),
                  float(lr), *tail, stream_arg(w))
    return out, loss
