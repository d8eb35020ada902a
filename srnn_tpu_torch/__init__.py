"""srnn_tpu_torch: the PyTorch/CUDA port of srnn_tpu.

Self-replicating neural networks on an NVIDIA H100: plain torch around
hand-written CUDA kernels (``csrc/``, built with nvcc for sm_90a at first
use).  The JAX package ``srnn_tpu`` is the reference; this package never
imports it, nor jax.  Entry points run on the card (``device='cuda'``)
unless the caller passes ``device='cpu'``.

Ported so far: the weightwise variant's main path -- topology, init, the
row-major transform, predicates, the fixpoint engine, and the
population-major parallel soup with its three kernels (chained
self-application, the batch-1 SGD chain, the fused generation).
"""

from .engine import FixpointRunResult, classify_batch, run_fixpoint
from .init import init_population
from .soup import (SoupConfig, SoupDraws, SoupEvents, SoupState, count,
                   evolve, evolve_step, seed)
from .topology import Topology

__all__ = [
    "Topology", "init_population", "run_fixpoint", "classify_batch",
    "FixpointRunResult", "SoupConfig", "SoupState", "SoupEvents",
    "SoupDraws", "seed", "evolve", "evolve_step", "count",
]
