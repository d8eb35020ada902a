"""Aggregating variant, row-major: an MLP f: R^k -> R^k over k weight
aggregates.  Port of ``srnn_tpu/nets/aggregating.py``.

Reference: ``AggregatingNeuralNetwork`` (``network.py:292-439``).  The P
weights are chunked in flat order into k collections of ``P // k``, the
trailing leftovers appended to the LAST collection (``collect_weights``,
``network.py:388-403``); each collection is reduced to one aggregate, the
k-vector goes through the net once, and each output aggregate is
replicated back over its collection (``deaggregate_identically``,
``network.py:310-312``).

The JAX package collects and deaggregates with a one-hot matmul, whose
0.0-weighted out-of-segment terms turn a non-finite weight into NaN in
every other aggregate (0 * Inf = NaN).  Here both are written as explicit
multiply-add chains over the one-hot constants, so that the poisoning does
not hang on a BLAS that skips zero operands.

``shuffler='random'`` permutes the deaggregated weights (the functional
analog of ``shuffle_random``, ``network.py:318-322``): the JAX package's
``jax.random.permutation(key, flat)`` is ``flat[perm]`` here, with the
permutation given (``perm=``, (..., P) indices, one per particle) or drawn
from a ``torch.Generator`` (``generator=``, one permutation per particle).
Without either it raises the JAX package's ``ValueError``.
"""

import functools
from typing import Optional

import numpy as np
import torch

from ..init import on_device
from ..ops.mlp import mlp_apply, mlp_forward
from ..topology import Topology, aggregation_segments


@functools.lru_cache(maxsize=None)
def segment_onehot(topo: Topology) -> np.ndarray:
    """(P, k) one-hot membership matrix in float32."""
    seg, _ = aggregation_segments(topo)
    return np.eye(topo.aggregates, dtype=np.float32)[seg]


def random_perm(generator: torch.Generator, lead, p: int,
                device) -> torch.Tensor:
    """One uniform permutation of ``p`` indices per particle, (*lead, p),
    drawn on the generator's device (argsort of uniforms) and moved to
    ``device``."""
    u = torch.rand((*lead, p), generator=generator, device=generator.device)
    return u.argsort(dim=-1).to(device)


def shuffle(topo: Topology, flat: torch.Tensor,
            perm: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``flat`` (..., P) as it leaves a transform of ``topo``: permuted
    per particle (``out[..., i] = flat[..., perm[..., i]]``) under
    ``shuffler='random'``, as it is under 'not'."""
    if topo.shuffler != "random":
        return flat
    if perm is None:
        if generator is None:
            raise ValueError("shuffler='random' requires a PRNG key (perm= "
                             "or generator=)")
        perm = random_perm(generator, flat.shape[:-1], flat.shape[-1],
                           flat.device)
    perm = on_device(perm, flat.device, torch.long)
    if perm.shape[-1] != flat.shape[-1]:
        raise ValueError(f"perm must permute the last axis of length "
                         f"{flat.shape[-1]}, got {tuple(perm.shape)}")
    return flat.gather(-1, perm.expand(flat.shape))


def onehot_chain(x: torch.Tensor, onehot: np.ndarray) -> torch.Tensor:
    """``x`` (..., A) times the constant ``onehot`` (A, B), as the chain
    sum_i x[..., i] * onehot[i] in order i = 0..A-1 (every product taken,
    the zero ones too)."""
    oh = torch.as_tensor(onehot, dtype=x.dtype, device=x.device)
    acc = x[..., 0:1] * oh[0]
    for i in range(1, oh.shape[0]):
        acc = acc + x[..., i:i + 1] * oh[i]
    return acc


def aggregate(topo: Topology, target_flat: torch.Tensor) -> torch.Tensor:
    """Reduce (..., P) weights -> (..., k) aggregates under
    ``topo.aggregator``."""
    seg, counts = aggregation_segments(topo)
    if topo.aggregator == "average":
        cnt = torch.as_tensor(counts, dtype=target_flat.dtype,
                              device=target_flat.device)
        return onehot_chain(target_flat, segment_onehot(topo)) / cnt
    starts = np.searchsorted(seg, np.arange(topo.aggregates))
    ends = starts + counts
    if topo.aggregator == "max":
        return torch.stack([target_flat[..., s:e].amax(dim=-1)
                            for s, e in zip(starts, ends)], dim=-1)
    if topo.aggregator == "max_buggy":
        # the reference's falsy max (network.py:303-308): a candidate wins
        # only when it is greater AND != 0.0
        out = []
        for s, e in zip(starts, ends):
            acc = target_flat[..., s]
            for r in range(s + 1, e):
                w = target_flat[..., r]
                acc = torch.where((w > acc) & (w != 0.0), w, acc)
            out.append(acc)
        return torch.stack(out, dim=-1)
    raise ValueError(f"unknown aggregator {topo.aggregator!r}")


def forward(topo: Topology, self_flat: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """MLP forward (..., S, k) -> (..., S, k)."""
    return mlp_forward(topo, self_flat, x)


def deaggregate(topo: Topology, aggs: torch.Tensor, perm=None,
                generator=None) -> torch.Tensor:
    """Replicate (..., k) aggregates back over their collections ->
    (..., P), permuted under ``shuffler='random'`` (``shuffle``)."""
    return shuffle(topo, onehot_chain(aggs, segment_onehot(topo).T), perm,
                   generator)


def apply(topo: Topology, self_flat: torch.Tensor,
          target_flat: torch.Tensor, perm=None,
          generator=None) -> torch.Tensor:
    """collect -> aggregate -> one forward -> deaggregate
    (``apply_to_weights``, ``network.py:359-386``)."""
    aggs = aggregate(topo, target_flat)
    new_aggs = mlp_apply(topo, self_flat, aggs[..., None, :])[..., 0, :]
    return deaggregate(topo, new_aggs, perm, generator)


def samples(topo: Topology, flat: torch.Tensor):
    """x = y = the (..., 1, k) aggregate vector (``compute_samples``,
    ``network.py:414-417``)."""
    aggs = aggregate(topo, flat)[..., None, :]
    return aggs, aggs
