"""Named network-level operators from the reference API surface; port of
``srnn_tpu/netops.py``.

``NeuralNetwork`` exposes four interaction verbs (``network.py:112-131``)
whose names are part of the paper's vocabulary; they are thin compositions
of ``apply_to_weights`` in functional form (weights in, weights out -- the
caller decides where results land, there is no hidden mutation):

  * :func:`attack`       -- self applied to OTHER; result replaces other
                            (``network.py:116-118``)
  * :func:`fuck`         -- self applied to other; result replaces SELF
                            (reference's name, ``network.py:120-122``)
  * :func:`self_attack`  -- ``attack`` on one's own weights, iterated
                            (``network.py:124-127``)
  * :func:`meet`         -- attack a copy; returns the transformed copy,
                            leaving both originals intact
                            (``network.py:129-131``)

Plus the static helpers ``weights_to_string`` (``network.py:31-41``) and
``are_weights_within`` (``network.py:54-62``).  Every operator takes flat
weights (..., P), a batch of particles along the leading dims.  The JAX
package's ``key`` (``shuffler='random'``) is ``perm=`` (the permutation,
(..., P), or for ``self_attack`` one per iteration, (iterations, ..., P))
or ``generator=`` (a ``torch.Generator`` that draws them) here
(``nets/aggregating.shuffle``).
"""

import torch

from .nets.dispatch import apply_to_weights
from .ops.flatten import unflatten
from .topology import Topology


def attack(topo: Topology, self_flat: torch.Tensor,
           other_flat: torch.Tensor, perm=None,
           generator=None) -> torch.Tensor:
    """Self applied to other's weights -> other's NEW weights.

    The caller stores the result into the victim's slot, which is what the
    reference's in-place ``other_network.set_weights(...)`` does."""
    return apply_to_weights(topo, self_flat, other_flat, perm, generator)


def fuck(topo: Topology, self_flat: torch.Tensor,
         other_flat: torch.Tensor, perm=None,
         generator=None) -> torch.Tensor:
    """Self applied to other's weights -> SELF's new weights
    (the reference's name for absorbing an other, ``network.py:120-122``)."""
    return apply_to_weights(topo, self_flat, other_flat, perm, generator)


absorb = fuck  # polite alias


def self_attack(topo: Topology, flat: torch.Tensor, iterations: int = 1,
                perm=None, generator=None) -> torch.Tensor:
    """``iterations`` rounds of attacking oneself (``network.py:124-127``).
    The reference re-reads its own (just-updated) weights each round, so
    iteration i+1 uses the output of iteration i as BOTH net and target.
    ``perm`` holds one permutation per iteration (the JAX package splits
    its key into ``iterations`` keys)."""
    w = flat
    for i in range(iterations):
        w = apply_to_weights(topo, w, w, None if perm is None else perm[i],
                             generator)
    return w


def meet(topo: Topology, self_flat: torch.Tensor,
         other_flat: torch.Tensor, perm=None,
         generator=None) -> torch.Tensor:
    """Attack a deepcopy of other (``network.py:129-131``): functionally
    identical to :func:`attack`, provided for API parity."""
    return apply_to_weights(topo, self_flat, other_flat, perm, generator)


def are_weights_within(flat: torch.Tensor, lower: float,
                       upper: float) -> torch.Tensor:
    """All weights inside [lower, upper] inclusive (``network.py:54-62``)."""
    return ((flat >= lower) & (flat <= upper)).all(dim=-1)


def weights_to_string(topo: Topology, flat) -> str:
    """Human-readable kernel dump (``weights_to_string``,
    ``network.py:31-41``): one block per layer, one bracketed row per cell;
    character for character the JAX package's text."""
    out = []
    for kernel in unflatten(topo, torch.as_tensor(flat)):
        rows = kernel.detach().cpu().numpy()
        out.append("\n".join(
            "[" + " ".join(f"{w:10.7f}" for w in row) + "]" for row in rows))
    return "\n\n".join(out)
