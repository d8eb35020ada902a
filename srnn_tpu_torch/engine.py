"""Fixpoint engine in plain torch; port of ``classify_batch``,
``run_fixpoint`` and ``FixpointRunResult`` from ``srnn_tpu/engine.py``.

The reference drives each net through a while loop (``experiment.py:70-77``);
here a whole population of trials steps together with per-trial active
masks, so every trial retires at the step it would have in the reference.
Every variant runs through its row-major transform (``nets.dispatch``).
"""

from typing import NamedTuple, Optional

import torch

from .nets.dispatch import apply_to_weights
from .ops.predicates import (DEFAULT_EPSILON, classify, count_classes,
                             is_diverged, is_fixpoint)
from .topology import Topology


class FixpointRunResult(NamedTuple):
    weights: torch.Tensor      # (N, P) final weights
    steps: torch.Tensor        # (N,) self-attacks actually executed per trial
    classes: torch.Tensor      # (N,) 5-way class ids
    counts: torch.Tensor       # (5,) class histogram
    trajectory: Optional[torch.Tensor]  # (steps+1, N, P) history or None


def classify_batch(topo: Topology, w: torch.Tensor,
                   epsilon: float = DEFAULT_EPSILON) -> torch.Tensor:
    """(N, P) -> (N,) int32 class ids (the reference's ``count``,
    ``experiment.py:79-91``)."""
    return classify(lambda t: apply_to_weights(topo, w, t), w, epsilon)


def run_fixpoint(topo: Topology, pop: torch.Tensor, step_limit: int = 100,
                 epsilon: float = DEFAULT_EPSILON,
                 record: bool = False) -> FixpointRunResult:
    """Pure self-application to fixpoint, all trials at once.

    Per reference ``run_net`` (``experiment.py:70-77``): while under the step
    limit and neither diverged nor a (degree-1) fixpoint, self-attack.  The
    predicates are evaluated at the top of every iteration.  ``pop`` is
    row-major (N, P); it runs on its own device.
    """
    w = pop
    steps = torch.zeros(pop.shape[0], dtype=torch.int32, device=pop.device)
    traj = [pop] if record else None
    for _ in range(step_limit):
        fix = is_fixpoint(lambda t, w=w: apply_to_weights(topo, w, t), w, 1,
                          epsilon)
        active = ~is_diverged(w) & ~fix
        w = torch.where(active[:, None], apply_to_weights(topo, w, w), w)
        steps = steps + active.to(torch.int32)
        if record:
            traj.append(w)
    classes = classify_batch(topo, w, epsilon)
    trajectory = torch.stack(traj) if record else None
    return FixpointRunResult(w, steps, classes, count_classes(classes),
                             trajectory)
