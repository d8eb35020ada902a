"""Shared plumbing of the port's CUDA kernels; counterpart of
``srnn_tpu/ops/pallas_sgd_common.py``.

``LaneKernel`` is one hand-written kernel: the ``csrc/`` source it builds
from, its C entry point, and its launch count (``launches`` goes up by one
where the kernel is launched, and nowhere else; ``launches_by`` splits it
by build).  ``lane_call`` is the one
launcher of the SGD chains (K2, K4, K5), the counterpart of ``lane_call``:
it allocates the outputs and launches one thread per particle.  Unlike the
Pallas launcher it pads nothing: the kernels guard the ragged edge.

Rules every wrapper follows: a CPU tensor runs the plain torch version; a
CUDA tensor launches the kernel or raises -- never a fallback.  A topology,
dtype or layout the kernels do not take raises ``ValueError`` before any
launch.  Launches go on the current stream and do not synchronise.

The kernels' envelope is the JAX package's Pallas envelope: every variant,
an activation with an output-expressible derivative, and particles of up
to ``KERNEL_MAX_WEIGHTS`` weights.  Each source's default build holds the
width-2 / depth-2 / 4-aggregate topologies of the paper's setups; a launch
for any other topology loads the build of that topology (``kernel_build``),
compiled at its first use.
"""

import collections
import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..topology import Topology, normalized_weight_coords
from . import _build
from .activations import KERNEL_ACT_CODES

#: the fence of the kernels' envelope, the JAX package's
#: (``srnn_tpu/ops/pallas_generation.py:107``): particles of up to 64
#: weights.  Every chain is unrolled over the particle's rows in registers,
#: so its code grows with P (~P^2 an epoch for the weightwise and recurrent
#: chains), and so does its build.
KERNEL_MAX_WEIGHTS = 64
#: the topology of every source's default build (``csrc/lane_common.cuh``),
#: and K6's victim lengths there (``csrc/rnn_apply.cu``)
DEFAULT_WIDTH, DEFAULT_DEPTH, DEFAULT_AGGREGATES = 2, 2, 4
DEFAULT_T_LENGTHS = (14, 17, 20)

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
        #: build tag ('' for the default build) -> launches
        self.launches_by = collections.Counter()
        KERNELS.append(self)

    def launch(self, build: _build.Build, *args) -> None:
        """Launch the entry point of ``build`` (``kernel_build``) with the
        C arguments ``args``."""
        lib = _build.load(self.source, build)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        rc = fn(*args)
        if rc != 0:
            msg = lib.srnn_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} ({msg})")
        self.launches += 1
        self.launches_by[build.tag] += 1

    def reset(self) -> None:
        """Set the launch counts to 0."""
        self.launches = 0
        self.launches_by.clear()


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
    """Is ``topo`` inside the kernels' envelope (its variant, activation
    and weight count)?"""
    try:
        check_kernel_topology(topo)
    except ValueError:
        return False
    return True


def check_kernel_topology(topo: Topology) -> None:
    """Raise unless ``topo`` is inside the kernels' envelope."""
    check_variant(topo, "weightwise", "aggregating", "fft", "recurrent")
    if topo.num_weights > KERNEL_MAX_WEIGHTS:
        raise ValueError(
            f"the CUDA kernels take particles of up to {KERNEL_MAX_WEIGHTS} "
            f"weights (the JAX package's Pallas fence); this topology "
            f"(width={topo.width}, depth={topo.depth}, "
            f"aggregates={topo.aggregates}) has P={topo.num_weights}")


def kernel_build(topo: Topology, reduce: Optional[Tuple[str, int]] = None,
                 t_len: Optional[int] = None,
                 headers: Tuple[Tuple[str, str], ...] = ()) -> _build.Build:
    """The build of a kernel source that runs ``topo``: the default build
    (``_build.DEFAULT``) for width 2 / depth 2 (4 aggregates for a k-vector
    source, a victim of length 14, 17 or 20 for K6), else the build of this
    topology: its width, depth and activation, for a k-vector source
    (``reduce``: the reduce kind's name and code) its aggregates and reduce
    kind, for K6 the victim length ``t_len``, and the generated ``headers``
    it includes."""
    kvec = reduce is not None
    if ((topo.width, topo.depth) == (DEFAULT_WIDTH, DEFAULT_DEPTH)
            and (not kvec or topo.aggregates == DEFAULT_AGGREGATES)
            and (t_len is None or t_len in DEFAULT_T_LENGTHS)):
        return _build.DEFAULT
    shape = f"w{topo.width}d{topo.depth}"
    defines = [("SRNN_W", topo.width), ("SRNN_D", topo.depth),
               ("SRNN_ACT", KERNEL_ACT_CODES[topo.activation])]
    names = [topo.activation]
    if kvec:
        shape += f"k{topo.aggregates}"
        defines += [("SRNN_K", topo.aggregates), ("SRNN_REDUCE", reduce[1])]
        names.append(reduce[0])
    if t_len is not None:
        shape += f"t{t_len}"
        defines.append(("SRNN_T", t_len))
    return _build.Build("-".join([shape] + names), tuple(defines), headers)


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
              lr: float, *tail, build: Optional[_build.Build] = None):
    """Launch an SGD-chain kernel over the lane axis: ``arrays`` is
    ``[wT]`` (self-training) or ``[wT, otherT]`` (imitation), CUDA float32
    (P, N); ``tail`` the kernel's topology arguments (host pointers in it
    are kept alive by the caller); ``build`` the build to launch,
    ``kernel_build(topo)`` by default.  Returns (new (P, N) population,
    (N,) last-epoch loss)."""
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
    kernel.launch(kernel_build(topo) if build is None else build, ptr(w),
                  ptr(other), ptr(out), ptr(loss), n, int(epochs), float(lr),
                  *tail, stream_arg(w))
    return out, loss
