"""K1: chained weightwise self-application of a population-major (P, N)
matrix; port of ``srnn_tpu/ops/pallas_ww.py`` (``ww_apply_population``).

``ww_apply_population`` launches ``csrc/ww_apply.cu`` for a CUDA tensor and
runs ``ww_apply_population_plain`` for a CPU tensor.  The plain version is
the counterpart of ``ww_apply_population_jnp`` iterated ``steps`` times.
"""

import torch

from ..topology import Topology
from .cuda_sgd_common import (LaneKernel, _I, _LL, _P, check_kernel_topology,
                              check_lanes, check_variant, coords_arg,
                              is_cpu, kernel_build, ptr, stream_arg,
                              topo_args)
from .popmajor import ww_forward_popmajor

WW_APPLY = LaneKernel(
    "ww_apply", "ww_apply", "srnn_ww_apply",
    [_P, _P, _LL, _I, _I, _I, _I, _P, _P],
    replaces="srnn_tpu/ops/pallas_ww.py:83")


def ww_apply_population_plain(topo: Topology, wT: torch.Tensor,
                              steps: int = 1) -> torch.Tensor:
    """``steps`` self-applications of every particle, plain torch."""
    for _ in range(steps):
        wT = ww_forward_popmajor(topo, wT, wT)
    return wT


def ww_apply_population(topo: Topology, wT: torch.Tensor,
                        steps: int = 1) -> torch.Tensor:
    """Self-apply every particle of a (P, N) float32 population ``steps``
    times, the whole chain in registers on the card."""
    check_variant(topo, "weightwise")
    n = check_lanes(topo, wT)
    if steps < 0:
        raise ValueError("steps must be >= 0")
    if is_cpu(wT):
        return ww_apply_population_plain(topo, wT, steps)
    check_kernel_topology(topo)
    out = torch.empty_like(wT)
    if n == 0:
        return out
    coords = coords_arg(topo)
    WW_APPLY.launch(kernel_build(topo), ptr(wT), ptr(out), n, int(steps),
                    *topo_args(topo), coords.ctypes.data, stream_arg(wT))
    return out
