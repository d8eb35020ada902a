"""srnn_tpu_torch: the PyTorch/CUDA port of srnn_tpu.

Self-replicating neural networks on an NVIDIA H100: plain torch around
hand-written CUDA kernels (``csrc/``, built with nvcc for sm_90a at first
use).  The JAX package ``srnn_tpu`` is the reference; this package never
imports it, nor jax.  Entry points run on the card (``device='cuda'``)
unless the caller passes ``device='cpu'``.

Ported so far: all four variants (weightwise, aggregating, fft,
recurrent) -- topology, init, the row-major transforms and the
cross-architecture ones, predicates, the fixpoint engine; the
population-major parallel soup in float32, bfloat16 and int8 storage; and
the population-major mixed-type soup (``multisoup``) -- on the kernels of
``csrc/`` (chained self-application, the SGD chains, the recurrent attack,
the fused generation).
"""

from .engine import FixpointRunResult, classify_batch, run_fixpoint
from .init import init_population
from .multisoup import (MultiSoupConfig, MultiSoupDraws, MultiSoupEvents,
                        MultiSoupState, count_multi, evolve_multi,
                        evolve_multi_step, seed_multi)
from .soup import (SoupConfig, SoupDraws, SoupEvents, SoupState, count,
                   evolve, evolve_step, seed)
from .topology import Topology

__all__ = [
    "Topology", "init_population", "run_fixpoint", "classify_batch",
    "FixpointRunResult", "SoupConfig", "SoupState", "SoupEvents",
    "SoupDraws", "seed", "evolve", "evolve_step", "count",
    "MultiSoupConfig", "MultiSoupState", "MultiSoupEvents",
    "MultiSoupDraws", "seed_multi", "evolve_multi", "evolve_multi_step",
    "count_multi",
]
