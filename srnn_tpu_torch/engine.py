"""Experiment engines; port of ``srnn_tpu/engine.py``.

The reference drives each net through a Python while-loop, one at a time
(``FixpointExperiment.run_net``, ``experiment.py:70-77``;
``MixedFixpointExperiment.run_net``, ``experiment.py:94-109``;
``known-fixpoint-variation.py:66-87``).  Here a whole population of trials
steps together with per-trial active masks, so every trial retires at
exactly the step it would have in the reference.

Every engine takes and returns row-major (N, P) weights, on the device
they were given, and transposes once on the way in and once on the way
out to the layout its steps run in:

  * self-application: weightwise on K1 (``ops/cuda_ww``, one launch a
    step on the population-major (P, N) transpose), aggregating and fft in
    plain torch on the same layout (``ops/popmajor.apply_popmajor``, as in
    the JAX package).  The recurrent variant keeps its row-major transform:
    the population-major recurrence (K6's plain chain) rounds differently,
    which would move class counts off the JAX package's.
  * training: one population-major SGD call (K2 weightwise, K4
    aggregating/fft, K5 recurrent; their plain chains on a CPU tensor) per
    epoch where every epoch's loss is kept (``run_training``), per outer
    step where only the last is (``run_mixed_fixpoint``), all through
    ``train.train_epochs``, which picks the route.  Weightwise
    ``train_mode='full_batch'`` takes the population-major full-batch step
    (``ops/popmajor.ww_full_batch_epochs``, plain torch on either device).
    Where a run's training and self-application layouts differ (the
    recurrent variant), it transposes around each training call.
  * classification (the final classes, ``fixpoint_density``): plain torch
    in the self-application's layout; it launches no kernel.

On either device every step and the classification run the same IEEE
operations, so a run on the card equals the same run on the CPU.
``record=True`` stacks the whole (steps+1, N, P) history, as the JAX
package does: at a million particles, do not record.
"""

from typing import NamedTuple, Optional

import torch

from .nets.dispatch import apply_to_weights
from .ops.cuda_ww import ww_apply_population
from .ops.popmajor import apply_popmajor
from .ops.predicates import (DEFAULT_EPSILON, classify, count_classes,
                             is_close, is_diverged, is_zero)
from .topology import Topology
from .train import DEFAULT_LR, on_lanes, train_epochs


class FixpointRunResult(NamedTuple):
    weights: torch.Tensor      # (N, P) final weights
    steps: torch.Tensor        # (N,) self-attacks actually executed per trial
    classes: torch.Tensor      # (N,) 5-way class ids
    counts: torch.Tensor       # (5,) class histogram
    trajectory: Optional[torch.Tensor]  # (steps+1, N, P) history or None


class TrainingRunResult(NamedTuple):
    weights: torch.Tensor      # (N, P) final weights
    losses: torch.Tensor       # (E, N) per-epoch training loss
    classes: torch.Tensor      # (N,) 5-way class ids
    counts: torch.Tensor       # (5,) class histogram
    trajectory: Optional[torch.Tensor]  # (E+1, N, P) history or None


class VariationResult(NamedTuple):
    time_to_vergence: torch.Tensor  # (N,) steps until zero/divergence (or max)
    time_as_fixpoint: torch.Tensor  # (N,) steps still the initial fixpoint


def classify_batch(topo: Topology, w: torch.Tensor,
                   epsilon: float = DEFAULT_EPSILON) -> torch.Tensor:
    """(N, P) -> (N,) int32 class ids (the reference's ``count``,
    ``experiment.py:79-91``), through the row-major transform."""
    return classify(lambda t: apply_to_weights(topo, w, t), w, epsilon)


# --------------------------------------------------------------- layouts


def _applies_on_lanes(topo: Topology) -> bool:
    """Self-application runs population-major (P, N) for every variant but
    the recurrent one."""
    return topo.variant != "recurrent"


def _to(w: torch.Tensor, lanes: bool, to_lanes: bool) -> torch.Tensor:
    """``w`` from one layout to the other (a copy), or as it is."""
    return w.t().contiguous() if lanes != to_lanes else w


def _axis(lanes: bool) -> int:
    """The weight axis of a layout."""
    return 0 if lanes else -1


def _per_trial(mask: torch.Tensor, lanes: bool) -> torch.Tensor:
    """A (N,) mask broadcast against the weights of a layout."""
    return mask[None, :] if lanes else mask[:, None]


def _self_apply(topo: Topology, w: torch.Tensor) -> torch.Tensor:
    """Every trial applied to itself, in the self-application layout."""
    if topo.variant == "weightwise":
        return ww_apply_population(topo, w, 1)
    if _applies_on_lanes(topo):
        return apply_popmajor(topo, w, w)
    return apply_to_weights(topo, w, w)


def _classify(topo: Topology, w: torch.Tensor, lanes: bool,
              epsilon: float) -> torch.Tensor:
    """(N,) int32 class ids of ``w`` (in either layout), plain torch in the
    self-application layout."""
    if _applies_on_lanes(topo):
        wT = w if lanes else w.t()
        return classify(lambda t: apply_popmajor(topo, wT, t), wT, epsilon,
                        axis=0)
    rows = w.t() if lanes else w
    return classify(lambda t: apply_to_weights(topo, rows, t), rows, epsilon)


def _history(traj, lanes: bool) -> torch.Tensor:
    """Stacked weight history -> (steps+1, N, P)."""
    out = torch.stack(traj)
    return out.transpose(1, 2).contiguous() if lanes else out


def _fixpoint_result(topo, w, lanes, steps, epsilon, traj):
    classes = _classify(topo, w, lanes, epsilon)
    return FixpointRunResult(
        _to(w, lanes, False), steps, classes, count_classes(classes),
        None if traj is None else _history(traj, lanes))


# --------------------------------------------------------------- engines


def run_fixpoint(topo: Topology, pop: torch.Tensor, step_limit: int = 100,
                 epsilon: float = DEFAULT_EPSILON,
                 record: bool = False) -> FixpointRunResult:
    """Pure self-application to fixpoint, all trials at once.

    Per reference ``run_net`` (``experiment.py:70-77``): while under the step
    limit and neither diverged nor a (degree-1) fixpoint, self-attack.  The
    predicates are evaluated at the top of every iteration, on the same
    application that then becomes the step.  Weightwise: one K1 launch a
    step on the card.
    """
    lanes = _applies_on_lanes(topo)
    ax = _axis(lanes)
    w = _to(pop, False, lanes)
    steps = torch.zeros(pop.shape[0], dtype=torch.int32, device=pop.device)
    traj = [w] if record else None
    for _ in range(step_limit):
        new = _self_apply(topo, w)
        active = ~is_diverged(w, ax) & ~is_close(new, w, epsilon, ax)
        w = torch.where(_per_trial(active, lanes), new, w)
        steps = steps + active.to(torch.int32)
        if record:
            traj.append(w)
    return _fixpoint_result(topo, w, lanes, steps, epsilon, traj)


def run_mixed_fixpoint(topo: Topology, pop: torch.Tensor,
                       trains_per_application: int = 100,
                       step_limit: int = 100,
                       epsilon: float = DEFAULT_EPSILON,
                       lr: float = DEFAULT_LR,
                       train_mode: str = "sequential",
                       record: bool = False) -> FixpointRunResult:
    """Interleaved self-attack + self-training
    (``MixedFixpointExperiment.run_net``, ``experiment.py:94-109``): each
    outer step is one self-attack followed by ``trains_per_application``
    train epochs, gated by the same diverged/fixpoint mask.  On the card
    one self-application launch (weightwise) and one SGD launch per outer
    step (none where ``trains_per_application`` is 0)."""
    on_lanes(topo, train_mode)  # an unknown mode raises before a step
    lanes = _applies_on_lanes(topo)
    ax = _axis(lanes)
    w = _to(pop, False, lanes)
    steps = torch.zeros(pop.shape[0], dtype=torch.int32, device=pop.device)
    traj = [w] if record else None
    for _ in range(step_limit):
        attacked = _self_apply(topo, w)
        active = ~is_diverged(w, ax) & ~is_close(attacked, w, epsilon, ax)
        trained = attacked
        if trains_per_application:
            trained, _ = train_epochs(topo, attacked, trains_per_application,
                                      lr, train_mode, lanes)
        w = torch.where(_per_trial(active, lanes), trained, w)
        steps = steps + active.to(torch.int32)
        if record:
            traj.append(w)
    return _fixpoint_result(topo, w, lanes, steps, epsilon, traj)


def run_training(topo: Topology, pop: torch.Tensor, epochs: int = 1000,
                 epsilon: float = DEFAULT_EPSILON, lr: float = DEFAULT_LR,
                 train_mode: str = "sequential", record: bool = False,
                 shuffle_key=None) -> TrainingRunResult:
    """Pure self-training, all trials at once (``training-fixpoints.py:52-56``:
    N trials x ``epochs`` train calls, no self-attacks, then classify).  Each
    epoch recomputes the samples from the current weights, the reference's
    moving-target regression toward being a fixpoint
    (``network.py:613-618``).  On the card one SGD launch per epoch, which
    keeps every epoch's (N,) loss.  ``shuffle_key`` (keras' per-epoch
    sample shuffle) is not ported and raises."""
    if shuffle_key is not None:
        raise NotImplementedError(
            "shuffle_key is not ported to srnn_tpu_torch: no kernel takes a "
            "per-lane sample order (ROADMAP.md, queue A)")
    lanes = on_lanes(topo, train_mode)
    w = _to(pop, False, lanes)
    losses = []
    traj = [w] if record else None
    for _ in range(epochs):
        w, loss = train_epochs(topo, w, 1, lr, train_mode, lanes)
        losses.append(loss)
        if record:
            traj.append(w)
    classes = _classify(topo, w, lanes, epsilon)
    losses = torch.stack(losses) if losses else torch.zeros(
        (0, pop.shape[0]), dtype=pop.dtype, device=pop.device)
    return TrainingRunResult(
        _to(w, lanes, False), losses, classes, count_classes(classes),
        None if traj is None else _history(traj, lanes))


def run_known_fixpoint_variation(topo: Topology, pop: torch.Tensor,
                                 max_steps: int = 100,
                                 epsilon: float = DEFAULT_EPSILON
                                 ) -> VariationResult:
    """Perturbed-fixpoint decay measurement
    (``known-fixpoint-variation.py:66-87``).

    Per trial: self-attack up to ``max_steps``; break on zero/divergence;
    count ``time_to_something`` (steps before vergence) and
    ``time_as_fixpoint`` (steps counted only while the ``still_fixpoint``
    flag holds, with the reference's silent re-entry behavior preserved).
    The fixpoint test of a step applies the post-attack net to itself, which
    is the next step's attack of a trial still alive: one application serves
    both, so the run makes ``max_steps + 1`` (one K1 launch each on the
    card for the weightwise variant).
    """
    lanes = _applies_on_lanes(topo)
    ax = _axis(lanes)
    w = _to(pop, False, lanes)
    n = pop.shape[0]
    dev = pop.device
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    # starts True: the unperturbed net is the known fixpoint
    still_fix = torch.ones(n, dtype=torch.bool, device=dev)
    t_some = torch.zeros(n, dtype=torch.int32, device=dev)
    t_fix = torch.zeros(n, dtype=torch.int32, device=dev)
    applied = _self_apply(topo, w)
    for _ in range(max_steps):
        w = torch.where(_per_trial(alive, lanes), applied, w)
        verged = is_zero(w, epsilon, ax) | is_diverged(w, ax)
        # predicates evaluated on the post-attack net, as in the reference
        applied = _self_apply(topo, w)
        fix_now = is_close(applied, w, epsilon, ax)
        counted = alive & ~verged
        t_fix = t_fix + (counted & fix_now & still_fix).to(torch.int32)
        # the reference's flag algebra collapses to: after a counted step
        # the flag equals fix_now (re-entry sets it without counting, loss
        # of fixpointness clears it)
        still_fix = torch.where(counted, fix_now, still_fix)
        t_some = t_some + counted.to(torch.int32)
        alive = alive & ~verged
    return VariationResult(t_some, t_fix)


def fixpoint_density(topo: Topology, pop: torch.Tensor,
                     epsilon: float = DEFAULT_EPSILON) -> torch.Tensor:
    """Immediate classification of freshly-initialized nets, no dynamics
    (``fixpoint-density.py``).  Returns the (5,) int32 class histogram."""
    return count_classes(_classify(topo, pop, False, epsilon))
