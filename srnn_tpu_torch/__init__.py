"""srnn_tpu_torch: the PyTorch/CUDA port of srnn_tpu.

Self-replicating neural networks on an NVIDIA H100: plain torch around
hand-written CUDA kernels (``csrc/``, built with nvcc for sm_90a at first
use).  The JAX package ``srnn_tpu`` is the reference; this package never
imports it, nor jax.  Entry points run on the card (``device='cuda'``)
unless the caller passes ``device='cpu'``.

Ported so far: all four variants (weightwise, aggregating, fft,
recurrent) -- topology, init, the row-major transforms and the
cross-architecture ones, predicates, row-major training (``train``), the
network verbs (``netops``), the known-fixpoint fixtures, the five
experiment engines, the run layer (``experiment``, with the checkpoints of
soups and mixed soups), the six fixpoint setups and the three soup setups
(``python -m srnn_tpu_torch.setups``); the parallel soup in both layouts
(row-major, the default, with ``record=True`` and stacked trials, and
population-major) in float32, bfloat16 and int8 storage, and the
sequential (strict-parity) soup; the mixed-type soup (``multisoup``) in
both layouts; both train modes everywhere -- on the kernels of ``csrc/``
(chained self-application, the SGD chains in enumeration order and in
keras' shuffled order, the recurrent attack, the fused generation) for
the particles inside their envelope (the JAX package's Pallas one: an
output-expressible activation, up to 64 weights), on the autograd chains
for every other particle the JAX package trains (any activation, width,
depth and aggregates; ``rnn_scan='associative'``; ``shuffler='random'`` where the
JAX package runs it).
"""

from .engine import (FixpointRunResult, TrainingRunResult, VariationResult,
                     classify_batch, fixpoint_density, run_fixpoint,
                     run_known_fixpoint_variation, run_mixed_fixpoint,
                     run_training)
from .init import init_population
from .multisoup import (MultiSoupConfig, MultiSoupDraws, MultiSoupEvents,
                        MultiSoupState, count_multi, evolve_multi,
                        evolve_multi_step, seed_multi)
from .soup import (SoupConfig, SoupDraws, SoupEvents, SoupState, count,
                   evolve, evolve_step, seed)
from .topology import Topology

__all__ = [
    "Topology", "init_population", "run_fixpoint", "classify_batch",
    "FixpointRunResult", "run_training", "TrainingRunResult",
    "run_mixed_fixpoint", "run_known_fixpoint_variation", "VariationResult",
    "fixpoint_density", "SoupConfig", "SoupState", "SoupEvents",
    "SoupDraws", "seed", "evolve", "evolve_step", "count",
    "MultiSoupConfig", "MultiSoupState", "MultiSoupEvents",
    "MultiSoupDraws", "seed_multi", "evolve_multi", "evolve_multi_step",
    "count_multi",
]
