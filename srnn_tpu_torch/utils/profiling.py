"""Tracing / profiling harness; port of ``srnn_tpu/utils/profiling.py``.

The reference's only observability is ``tqdm`` progress bars
(``network.py:641``, ``experiment.py:101``).  Here:

  * :func:`timed` — wall-clock statistics of a callable with its warm-up
    (the first call's kernel builds) excluded.  Synchronization is by a
    scalar readback of the result's first tensor, as in the JAX package:
    the copy to the host waits for the work that made the tensor.
  * :func:`trace` — context manager around ``torch.profiler`` (host
    operators, and the card's kernels where there is a card) writing a
    TensorBoard-loadable trace file into a directory.
  * :func:`phase` — ``torch.profiler.record_function``: annotate apply /
    train / evolve phases so they are findable in traces (the JAX
    package's ``jax.named_scope``).
"""

import contextlib
import statistics
import time
from typing import Any, Callable, Dict, Optional

import torch

phase = torch.profiler.record_function


def _first_tensor(value) -> Optional[torch.Tensor]:
    """The first tensor leaf of ``value`` (tuples, lists, named tuples and
    dict values, in order), or None."""
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            leaf = _first_tensor(v)
            if leaf is not None:
                return leaf
    return None


def _sync(value) -> None:
    """Force completion of ``value``'s computation via a scalar readback."""
    leaf = _first_tensor(value)
    if leaf is not None and leaf.numel():
        float(leaf.reshape(-1)[0])


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2,
          **kwargs) -> Dict[str, Any]:
    """Time ``fn(*args, **kwargs)`` over ``iters`` runs after ``warmup``
    runs.  Returns mean/median/min/max seconds + per-run list.

    ``warmup=0`` runs NO warm-up call, so the first timed iteration pays
    the kernels' first-use build and load — the cold-start number."""
    for _ in range(max(warmup, 0)):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {
        "mean_s": statistics.fmean(times),
        "median_s": statistics.median(times),
        "min_s": min(times),
        "max_s": max(times),
        "iters": iters,
        "times_s": times,
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host (and, on a card, device) profile into ``log_dir``:
    one ``<host>_<pid>.<ns>.pt.trace.json`` file (TensorBoard's torch
    profiler plugin and chrome://tracing read it).  Yields the profiler.

    >>> with trace('/tmp/profile'):
    ...     state = evolve(cfg, state, generations=10)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
