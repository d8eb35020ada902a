"""Process-0 host I/O for distributed runs; port of
``srnn_tpu/distributed/hostio.py``.

The contract: a distributed mega run writes exactly the artifacts a
single-process run writes -- one ``log.txt``, ``events.jsonl``,
``metrics.prom``, ``lineage.jsonl`` and checkpoint stream -- and process 0
alone writes them.  Every other process contributes through the
collectives of the sharded evolve (its shard of each gather and
reduction) and through :func:`fetch_tree`'s host gathers here; its only
files are its heartbeats, ``events-p<i>.jsonl`` (:class:`WorkerLog`).

Collective discipline: :func:`fetch_tree` and :func:`broadcast_run_dir`
are collectives, so every process calls them at the same point of its
loop in the same order -- the mega loops call them on the loop thread,
never from the background writer (whose jobs run at a different time on
each process and would deadlock the group).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import torch

#: the collective span emitter a run installs (``setups.common.
#: make_spans``): every collective here times itself and emits a span
#: row per process; ``None`` (the default) costs one test a call
_SPAN_SINK = None

#: fields of the state, lineage and carry trees that hold the particle
#: axis (dim 0) sharded over the mesh; every other tensor is replicated
SHARDED_FIELDS = frozenset({"weights", "uids", "scales", "pid", "parent",
                            "birth", "basin"})


def set_span_sink(emit) -> None:
    """Install (or clear, with ``None``) the collective span emitter: a
    callable ``emit(name, dur_s, **labels)``."""
    global _SPAN_SINK
    _SPAN_SINK = emit


def _emit_span(name: str, t0: float, **labels) -> None:
    sink = _SPAN_SINK
    if sink is not None:
        try:
            sink(name, time.monotonic() - t0, **labels)
        except Exception:
            pass  # observability never takes down a collective path


def fetch_tree(tree, mesh):
    """The full value of a sharded tree on every rank (the checkpoint
    source of a distributed chunk): each tensor under a particle-axis
    field (:data:`SHARDED_FIELDS`, a tuple of per-type tensors included)
    gathered along dim 0 in rank order, every other leaf as it is (the
    generator is replicated).  A collective: same point, same order on
    every rank."""
    gathers = [0]

    def one(x, sharded):
        if isinstance(x, torch.Tensor):
            if not sharded:
                return x
            gathers[0] += 1
            return mesh.gather(x, 0)
        if isinstance(x, tuple):
            if hasattr(x, "_fields"):
                return type(x)(*(one(v, f in SHARDED_FIELDS)
                                 for f, v in zip(x._fields, x)))
            return type(x)(one(v, sharded) for v in x)
        return x

    t0 = time.monotonic()
    out = one(tree, False)
    _emit_span("hostio.fetch_tree", t0, collectives=gathers[0])
    return out


def broadcast_run_dir(run_dir) -> str:
    """Announce the primary's run directory to every process (process 0
    passes the path, every other process ``None``): the one piece of host
    state the workers need that only process 0 can mint (the Experiment's
    directory name holds a timestamp)."""
    import torch.distributed as dist

    box = [os.path.abspath(run_dir) if run_dir else None]
    t0 = time.monotonic()
    dist.broadcast_object_list(box, src=0)
    _emit_span("hostio.broadcast_run_dir", t0)
    path = box[0]
    if not path:
        raise RuntimeError("run-dir broadcast produced an empty path "
                           "(primary announced before creating its "
                           "Experiment?)")
    return path


class WorkerLog:
    """The Experiment-shaped sink of a non-primary process.

    ``log()`` prints to stderr with a ``[p<i>]`` prefix, and ``event()``
    appends to the per-process ``events-p<i>.jsonl``, where this process's
    heartbeats land.  Everything else an Experiment offers (artifact
    saves, the exit-time ``log.txt`` / ``meta.json``) is the primary's
    and does nothing here."""

    def __init__(self, run_dir: str, process_id: int):
        self.dir = run_dir
        self.process_id = int(process_id)
        self.seed = None
        self._t0 = time.time()
        self._lock = threading.Lock()
        self._events = open(
            os.path.join(run_dir, f"events-p{self.process_id}.jsonl"), "a")

    def log(self, message, **event_fields):
        print(f"[p{self.process_id}] {message}", file=sys.stderr, flush=True)
        if event_fields:
            self.event(message=str(message), **event_fields)

    def event(self, _fsync: bool = False, **fields):
        fields.setdefault("t", time.time() - self._t0)
        fields.setdefault("process", self.process_id)
        with self._lock:
            self._events.write(json.dumps(fields, default=str) + "\n")
            self._events.flush()
            if _fsync:
                os.fsync(self._events.fileno())

    def save(self, **kwargs):
        return {}

    def save_log(self, log_name: str = "log"):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self._events.close()
        return False
