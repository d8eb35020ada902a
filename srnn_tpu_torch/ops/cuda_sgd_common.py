"""Shared plumbing of the port's CUDA kernels; counterpart of
``srnn_tpu/ops/pallas_sgd_common.py``.

``LaneKernel`` is one hand-written kernel: the ``csrc/`` source it builds
from, its C entry point, and its launch count (``launches`` goes up by one
where the kernel is launched, and nowhere else).  ``lane_call`` is the one
launcher of the SGD chains, the counterpart of ``lane_call``: it allocates
the outputs and launches one thread per particle.  Unlike the Pallas
launcher it pads nothing: the kernels guard the ragged edge.

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

#: the topologies the kernel templates are instantiated for
KERNEL_WIDTHS = (2,)
KERNEL_DEPTHS = (2,)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


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


def check_weightwise(topo: Topology) -> None:
    if topo.variant != "weightwise":
        raise ValueError(
            f"variant {topo.variant!r} has no kernel in srnn_tpu_torch yet; "
            "only 'weightwise' is ported")
    if topo.activation not in KERNEL_ACT_CODES:
        raise ValueError(
            f"activation {topo.activation!r} has no output-expressible "
            f"derivative; the kernels take {sorted(KERNEL_ACT_CODES)}")


def check_kernel_topology(topo: Topology) -> None:
    """Raise unless the CUDA templates are instantiated for ``topo``."""
    check_weightwise(topo)
    if topo.width not in KERNEL_WIDTHS or topo.depth not in KERNEL_DEPTHS:
        raise ValueError(
            f"the CUDA kernels are instantiated for width in {KERNEL_WIDTHS}"
            f" and depth in {KERNEL_DEPTHS}; Topology(width={topo.width}, "
            f"depth={topo.depth}) has no instantiation")


def check_lanes(topo: Topology, *arrays: torch.Tensor) -> int:
    """Every array is a contiguous float32 (P, N) population on one device;
    returns N."""
    p = topo.num_weights
    first = arrays[0]
    for a in arrays:
        if a.dtype != torch.float32:
            raise ValueError(f"the kernels take float32 populations, got "
                             f"{a.dtype}")
        if a.dim() != 2 or a.shape[0] != p or a.shape[1] != first.shape[1]:
            raise ValueError(f"expected ({p}, {first.shape[1]}) population, "
                             f"got {tuple(a.shape)}")
        if a.device != first.device:
            raise ValueError("operands lie on different devices")
        if not a.is_contiguous():
            raise ValueError("population operands must be contiguous")
    return first.shape[1]


def coords_arg(topo: Topology) -> np.ndarray:
    """The (P, 3) normalised coordinates as a float32 host array; the C
    entry points copy them into the kernel's argument."""
    return np.ascontiguousarray(normalized_weight_coords(topo),
                                dtype=np.float32)


def stream_arg(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int:
    """Device pointer of a tensor, or null for None."""
    return None if t is None else t.data_ptr()


def topo_args(topo: Topology) -> Sequence:
    return (topo.width, topo.depth, KERNEL_ACT_CODES[topo.activation])


SGD_ARGTYPES = [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _P, _P]


def lane_call(kernel: LaneKernel, topo: Topology, arrays, epochs: int,
              lr: float):
    """Launch an SGD-chain kernel over the lane axis: ``arrays`` is
    ``[wT]`` (self-training) or ``[wT, otherT]`` (imitation), CUDA float32
    (P, N).  Returns (new (P, N) population, (N,) last-epoch loss)."""
    check_kernel_topology(topo)
    n = check_lanes(topo, *arrays)
    w = arrays[0]
    out = torch.empty_like(w)
    loss = torch.empty(n, dtype=w.dtype, device=w.device)
    if n == 0:
        return out, loss
    other = arrays[1] if len(arrays) > 1 else None
    coords = coords_arg(topo)
    kernel.launch(ptr(w), ptr(other), ptr(out), ptr(loss), n, int(epochs),
                  float(lr), *topo_args(topo), coords.ctypes.data,
                  stream_arg(w))
    return out, loss
