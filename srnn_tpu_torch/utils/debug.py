"""NaN/Inf provenance and checked execution; port of
``srnn_tpu/utils/debug.py``.

Divergence (NaN/Inf weights) is a *measured outcome* in this science, so it
must never be silently masked — but when it is unexpected, these tools
locate it:

  * :func:`checked_apply_to_weights` — self-application that raises
    :class:`NonFiniteOutputError` with a readable message if the output
    goes non-finite from finite inputs (the JAX package's ``checkify``
    check; the debug-mode analog of the reference's
    ``are_weights_diverged`` post-hoc predicate, ``network.py:43-52``).
    It costs one read on the host.
  * :func:`divergence_onset` — run a soup forward and report, per slot,
    the first generation its weights went non-finite (-1 if never).  The
    onsets are folded on the population's device: no read on the host
    until the caller reads them.
"""

from typing import Optional, Sequence, Tuple

import torch

from ..nets.dispatch import apply_to_weights
from ..ops.predicates import is_diverged
from ..soup import SoupConfig, SoupDraws, SoupState, evolve_step
from ..topology import Topology


class NonFiniteOutputError(RuntimeError):
    """A self-application produced NaN/Inf weights from finite inputs."""


def checked_apply_to_weights(topo: Topology, self_flat: torch.Tensor,
                             target_flat: torch.Tensor) -> torch.Tensor:
    """Self-application that *raises* on non-finite output.

    Returns the new weights; raises :class:`NonFiniteOutputError` with the
    variant and shape context if any output weight is NaN/Inf while all
    inputs were finite (a batch of (N, P) pairs: for any pair).
    """
    out = apply_to_weights(topo, self_flat, target_flat)
    inputs_ok = ~is_diverged(self_flat) & ~is_diverged(target_flat)
    if bool((inputs_ok & is_diverged(out)).any()):
        raise NonFiniteOutputError(
            f"apply_to_weights({topo.variant}) produced non-finite output "
            f"from finite inputs (|self|={float(self_flat.abs().max())}, "
            f"|target|={float(target_flat.abs().max())}; self "
            f"{tuple(self_flat.shape)}, target {tuple(target_flat.shape)})")
    return out


def divergence_onset(config: SoupConfig, state: SoupState, generations: int,
                     draws: Optional[Sequence[SoupDraws]] = None
                     ) -> Tuple[torch.Tensor, SoupState]:
    """(N,) int32 first generation (the 1-based ``time`` of the state it
    shows in) each SLOT went non-finite, 0 for a slot already non-finite
    in ``state``, -1 if never within ``generations``; and the final state.
    Runs ``config`` with respawn disabled so the onset is observable (a
    respawning soup replaces divergent particles in the same step,
    reference ``soup.py:77-86``), one ``soup.evolve_step`` a generation;
    ``draws`` (one ``SoupDraws`` a generation) replaces the generator's.
    ``state`` is left as it was."""
    probe_cfg = config._replace(remove_divergent=False, remove_zero=False)
    if draws is not None and len(draws) != generations:
        raise ValueError(f"draws holds {len(draws)} generations, expected "
                         f"{generations}")
    onset = torch.where(is_diverged(state.weights), 0, -1).to(torch.int32)
    for g in range(generations):
        state, _ev = evolve_step(probe_cfg, state,
                                 None if draws is None else draws[g])
        now_div = is_diverged(state.weights)
        onset = torch.where((onset < 0) & now_div,
                            state.time.to(torch.int32), onset)
    return onset, state
