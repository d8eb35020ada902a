"""Device-side metric carries of the soup; port of
``srnn_tpu/telemetry/device.py``.

The soup-science counters (attack / learn_from / train / respawn event
counts, summed train loss) and the population-health sentinels are folded
into small tensors on the population's device once a generation, and read
on the host only where a caller flushes them.  ``soup.evolve`` /
``multisoup.evolve_multi`` take them behind ``metrics=`` / ``health=``; the
host-side interpretation lives in :mod:`.soup_metrics` and :mod:`.flightrec`.

Every fold is compare-and-reduce: an (A, N) equality mask summed over the
particle axis.  ``torch.bincount`` would read its length off the card (a
host synchronisation a generation); this reads nothing back.  The carries
only read the event record and the stored weights, so a metered run evolves
bit for bit as an unmetered one.

Counters are int32 and ``loss_sum`` float32, as in the JAX package.  The
loss sum and the norm extrema reduce in torch's order, not XLA's: against
the JAX package they agree to float rounding, not bitwise.  The log2 bucket
of the health sketch is computed as the JAX package writes it (float32
``log2``, ``floor``), so it can differ from the JAX package's only where the
two libraries' ``log2`` round a norm just below a power of two to opposite
sides of an integer.

A sharded run (``parallel.sharded_soup``) folds each rank's lanes into
its own carries and reduces them once per ``sharded_evolve`` call, at the
shard boundary (:func:`psum_soup_metrics`, :func:`psum_health`, the JAX
package's ``device.py:87`` / ``:219``).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

#: length of the per-action histogram: ``len(soup.ACTION_NAMES)`` (a
#: literal, so that this module imports nothing of the soup; the tests
#: hold the two together)
N_ACTIONS = 7

#: log2-bucket layout of the weight-norm sketch: bucket ``i`` covers
#: max-|w| in ``[2^(LO + i*STEP), 2^(LO + (i+1)*STEP))``, clipped at both
#: ends, so the sketch spans 2^-64 .. 2^32.
N_HEALTH_BUCKETS = 24
HEALTH_BUCKET_LO = -64
HEALTH_BUCKET_STEP = 4


class SoupMetrics(NamedTuple):
    """Per-flush-interval science counters, accumulated on the device."""
    generations: torch.Tensor  # () int32 -- generations accumulated
    actions: torch.Tensor      # (N_ACTIONS,) int32 -- last-action histogram
    loss_sum: torch.Tensor     # () float32 -- sum of per-particle train losses


class HealthStats(NamedTuple):
    """Per-flush-interval population-health sentinels (the JAX package's
    ``HealthStats``): ``nonfinite`` / ``zero`` are end-of-window counts of
    particles whose max-|w| is NaN/Inf or at most epsilon, the ``*_peak``
    twins their window maxima, ``norm_min`` / ``norm_max`` the window
    extrema of the finite max-|w|, ``norm_hist`` its log2 sketch summed
    over the window's generations."""
    checks: torch.Tensor          # () int32 -- generations folded in
    nonfinite: torch.Tensor       # () int32
    nonfinite_peak: torch.Tensor  # () int32
    zero: torch.Tensor            # () int32
    zero_peak: torch.Tensor       # () int32
    norm_min: torch.Tensor        # () float32
    norm_max: torch.Tensor        # () float32
    norm_hist: torch.Tensor       # (N_HEALTH_BUCKETS,) int32


def host(x) -> np.ndarray:
    """A carry's tensor (on any device; a read of the card, a host
    synchronisation) or an array-like, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _i32(value: int, device) -> torch.Tensor:
    # a fill, not a copy from the host: no synchronisation on the card
    return torch.full((), value, dtype=torch.int32, device=device)


def _f32(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def rounded(epsilon: float, dtype: torch.dtype) -> float:
    """``epsilon`` rounded to ``dtype``, as the JAX package compares a
    ``dtype`` array with a Python float (a weakly typed scalar takes the
    array's dtype)."""
    return float(torch.tensor(epsilon, dtype=dtype))


def code_histogram(values: torch.Tensor, n: int,
                   include=None) -> torch.Tensor:
    """(n,) int32 counts of the integer codes ``0 .. n - 1`` in ``values``
    (the lanes where ``include`` holds, if given): compare and reduce."""
    if include is not None:
        values = torch.where(include, values, -1)
    codes = torch.arange(n, dtype=values.dtype, device=values.device)
    return (values[None, :] == codes[:, None]).sum(dim=1, dtype=torch.int32)


def log2_buckets(values: torch.Tensor, include: torch.Tensor) -> torch.Tensor:
    """(N,) log2 bucket of a nonnegative float32 statistic (exact zeros
    and excluded lanes in bucket 0; the caller masks the excluded ones)."""
    safe = torch.where(include & (values > 0), values,
                       2.0 ** HEALTH_BUCKET_LO)
    b = (torch.floor(torch.log2(safe)).to(torch.int32) - HEALTH_BUCKET_LO) \
        // HEALTH_BUCKET_STEP
    return b.clamp(0, N_HEALTH_BUCKETS - 1)


def zero_soup_metrics(device="cuda") -> SoupMetrics:
    """The identity element the carry starts from."""
    return SoupMetrics(
        generations=_i32(0, device),
        actions=torch.zeros(N_ACTIONS, dtype=torch.int32, device=device),
        loss_sum=_f32(0.0, device))


def accumulate_soup_metrics(m: SoupMetrics, action: torch.Tensor,
                            loss: torch.Tensor) -> SoupMetrics:
    """Fold one generation's ``SoupEvents`` fields (the (N,) action codes
    and (N,) train losses) into the carry."""
    return SoupMetrics(
        generations=m.generations + 1,
        actions=m.actions + code_histogram(action, N_ACTIONS),
        loss_sum=m.loss_sum + loss.sum(dtype=torch.float32))


def merge_soup_metrics(a: SoupMetrics, b: SoupMetrics) -> SoupMetrics:
    """Combine two disjoint accumulation windows."""
    return SoupMetrics(a.generations + b.generations, a.actions + b.actions,
                       a.loss_sum + b.loss_sum)


def count_events(action: torch.Tensor, loss: torch.Tensor) -> SoupMetrics:
    """One generation's metrics from an events record already in hand (the
    capture loop's captured step), on the record's device."""
    return accumulate_soup_metrics(zero_soup_metrics(action.device), action,
                                   loss)


def zero_health(device="cuda") -> HealthStats:
    """The identity element the carry starts from."""
    return HealthStats(
        checks=_i32(0, device), nonfinite=_i32(0, device),
        nonfinite_peak=_i32(0, device), zero=_i32(0, device),
        zero_peak=_i32(0, device), norm_min=_f32(float("inf"), device),
        norm_max=_f32(float("-inf"), device),
        norm_hist=torch.zeros(N_HEALTH_BUCKETS, dtype=torch.int32,
                              device=device))


def accumulate_health(h: HealthStats, w: torch.Tensor, axis: int,
                      epsilon: float) -> HealthStats:
    """Fold one generation's weights into the carry.  ``w`` is the stored
    view of the population, (N, P) with ``axis=-1`` or (P, N) with
    ``axis=0``; ``epsilon`` the zero-collapse bound.  Reads ``w`` and
    writes nothing."""
    norm = w.abs().amax(dim=axis)
    zero_at = norm <= rounded(epsilon, norm.dtype)
    norm = norm.float()  # a bfloat16 norm is exact in float32
    finite = torch.isfinite(norm)
    nonf = (~finite).sum(dtype=torch.int32)
    zero = (finite & zero_at).sum(dtype=torch.int32)
    hist = code_histogram(log2_buckets(norm, finite), N_HEALTH_BUCKETS,
                          include=finite)
    inf = float("inf")
    return HealthStats(
        checks=h.checks + 1,
        nonfinite=nonf,
        nonfinite_peak=torch.maximum(h.nonfinite_peak, nonf),
        zero=zero,
        zero_peak=torch.maximum(h.zero_peak, zero),
        norm_min=torch.minimum(h.norm_min,
                               torch.where(finite, norm, inf).amin()),
        norm_max=torch.maximum(h.norm_max,
                               torch.where(finite, norm, -inf).amax()),
        norm_hist=h.norm_hist + hist)


def merge_health(a: HealthStats, b: HealthStats) -> HealthStats:
    """Combine two CONSECUTIVE windows over one population (``b`` later):
    end-of-window counts take ``b``'s, peaks, extrema and sketch fold."""
    return HealthStats(
        checks=a.checks + b.checks,
        nonfinite=b.nonfinite,
        nonfinite_peak=torch.maximum(a.nonfinite_peak, b.nonfinite_peak),
        zero=b.zero,
        zero_peak=torch.maximum(a.zero_peak, b.zero_peak),
        norm_min=torch.minimum(a.norm_min, b.norm_min),
        norm_max=torch.maximum(a.norm_max, b.norm_max),
        norm_hist=a.norm_hist + b.norm_hist)


def probe_health(w: torch.Tensor, axis: int = -1,
                 epsilon: float = 1e-4) -> HealthStats:
    """One-shot health stats of a population already in hand, on its
    device."""
    return accumulate_health(zero_health(w.device), w, axis, epsilon)


def psum_soup_metrics(m: SoupMetrics, mesh,
                      loss_sum: Optional[torch.Tensor] = None) -> SoupMetrics:
    """The global carry from every rank's (``psum_soup_metrics``,
    ``device.py:87`` of the JAX package): the action histograms and loss
    sums summed, ``generations`` as it is (every rank stepped alike).
    ``loss_sum``, where given, replaces the summed one (the sharded soup
    passes the loss sum in the single-device run's order)."""
    acts = mesh.all_reduce(m.actions)
    if loss_sum is None:
        loss_sum = mesh.all_reduce(m.loss_sum)
    return SoupMetrics(m.generations, acts, loss_sum)


def psum_health(h: HealthStats, mesh,
                per_generation: Optional[torch.Tensor] = None
                ) -> HealthStats:
    """The global carry from every rank's (``psum_health``,
    ``device.py:219`` of the JAX package): counts and the sketch summed,
    the norm extrema reduced by min / max, ``checks`` as it is.  The
    peaks are the JAX package's shard-wise upper bound (the sum of the
    ranks' peaks), unless ``per_generation`` holds the rank's (G, 2)
    nonfinite and zero counts of each generation folded: then they are
    the maxima over the generations of the global counts, the
    single-device run's peaks."""
    ints = mesh.all_reduce(torch.cat([
        torch.stack([h.nonfinite, h.nonfinite_peak, h.zero, h.zero_peak]),
        h.norm_hist]))
    ext = mesh.all_reduce(torch.stack([-h.norm_min, h.norm_max]), "max")
    nonf_peak, zero_peak = ints[1], ints[3]
    if per_generation is not None:
        peaks = mesh.all_reduce(per_generation).amax(0)
        nonf_peak = torch.maximum(torch.zeros_like(peaks[0]), peaks[0])
        zero_peak = torch.maximum(torch.zeros_like(peaks[1]), peaks[1])
    return HealthStats(
        checks=h.checks, nonfinite=ints[0], nonfinite_peak=nonf_peak,
        zero=ints[2], zero_peak=zero_peak, norm_min=-ext[0],
        norm_max=ext[1], norm_hist=ints[4:])
