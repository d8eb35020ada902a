"""Fixpoint predicates and the 5-way classification; port of
``srnn_tpu/ops/predicates.py``.

Semantics tracked from the reference:
  - ``are_weights_diverged``: any NaN/Inf anywhere      (``network.py:43-52``)
  - ``is_zero``: every weight within [-eps, +eps], *inclusive* bounds
    (``network.py:54-62,136-138``); NaN weights are never "zero" because the
    comparisons fail.
  - ``is_fixpoint(degree)``: apply the net ``degree`` times to its own
    weights; False if the result diverged, else True iff every
    ``|new - old| < eps`` (strict -- a delta of exactly eps fails)
    (``network.py:140-157``).
  - classification order: divergent > fix_zero > fix_other > fix_sec > other
    (``experiment.py:79-91``).

Every function reduces over the weight axis ``axis`` (last for row-major
(N, P) weights, 0 for population-major (P, N)).
"""

from typing import Callable

import torch

CLASS_NAMES = ("divergent", "fix_zero", "fix_other", "fix_sec", "other")
CLS_DIVERGENT, CLS_FIX_ZERO, CLS_FIX_OTHER, CLS_FIX_SEC, CLS_OTHER = range(5)

DEFAULT_EPSILON = 1e-4  # every reference experiment overrides the 1e-14
                        # constructor default to 1e-4


def is_diverged(flat: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """True if any weight is NaN or +-Inf."""
    return (~torch.isfinite(flat)).any(dim=axis)


def is_zero(flat: torch.Tensor, epsilon: float = DEFAULT_EPSILON,
            axis: int = -1) -> torch.Tensor:
    """True if all weights lie in the closed interval [-eps, eps]."""
    return ((flat >= -epsilon) & (flat <= epsilon)).all(dim=axis)


def is_close(new: torch.Tensor, old: torch.Tensor, epsilon: float,
             axis: int = -1) -> torch.Tensor:
    """The fixpoint test on an application already made: ``new`` finite
    and every ``|new - old| < eps``."""
    return ~is_diverged(new, axis) & ((new - old).abs() < epsilon).all(dim=axis)


def is_fixpoint(apply_self: Callable[[torch.Tensor], torch.Tensor],
                flat: torch.Tensor, degree: int = 1,
                epsilon: float = DEFAULT_EPSILON) -> torch.Tensor:
    """Degree-d fixpoint test: ``apply_self`` (target -> f_w(target), the
    net's own weights bound) iterated ``degree`` times from ``flat``
    (``network.py:140-157``).  Reduces over the last axis."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    new = flat
    for _ in range(degree):
        new = apply_self(new)
    return is_close(new, flat, epsilon)


def classify(apply_self: Callable[[torch.Tensor], torch.Tensor],
             flat: torch.Tensor,
             epsilon: float = DEFAULT_EPSILON,
             axis: int = -1) -> torch.Tensor:
    """5-way class id per particle (int32), the reference's elif chain as
    nested ``where``."""
    new1 = apply_self(flat)
    new2 = apply_self(new1)
    div = is_diverged(flat, axis)
    fix1 = is_close(new1, flat, epsilon, axis)
    fix2 = is_close(new2, flat, epsilon, axis)
    zero = is_zero(flat, epsilon, axis)
    cls = torch.full(div.shape, CLS_OTHER, dtype=torch.int32,
                     device=flat.device)
    cls = torch.where(fix2, CLS_FIX_SEC, cls)
    cls = torch.where(fix1, CLS_FIX_OTHER, cls)
    cls = torch.where(fix1 & zero, CLS_FIX_ZERO, cls)
    cls = torch.where(div, CLS_DIVERGENT, cls)
    return cls.to(torch.int32)


def count_classes(class_ids: torch.Tensor) -> torch.Tensor:
    """Histogram of class ids -> (5,) int32 counter vector."""
    return torch.bincount(class_ids.reshape(-1).long(),
                          minlength=5)[:5].to(torch.int32)
