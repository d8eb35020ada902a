"""Experiment runtime: run directories, logging, persistence; port of
``srnn_tpu/experiment.py`` (the checkpoints are not ported yet).

Reference layer L1 (``experiment.py:8-59``): a context manager that creates
``experiments/exp-{name}-{id}-{iteration}/``, collects log messages in RAM
(flushed to ``log.txt`` on exit), and dill-dumps arbitrary keyword objects.

As in the JAX package:

  * Artifacts are safe, inspectable formats instead of dill pickles:
    arrays and nested dicts/lists/tuples of arrays -> ``.npz`` (flattened
    path keys), plain JSON-able python -> ``.json``, written from numpy
    with the JAX package's key paths, so that each package reads the
    other's artifacts.
  * Logging is dual: human ``log.txt`` lines (reference parity) plus
    structured ``events.jsonl`` records for tooling.
  * Counters are (5,) histograms; ``format_counters`` renders them as the
    reference's dict repr, so log lines stay diffable against the committed
    baselines.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .ops.predicates import CLASS_NAMES

_SEP = "/"  # path separator for flattened keys inside npz files
_VALUE_KEY = "__value__"  # reserved npz key for a bare (non-nested) array


# ---------------------------------------------------------------------------
# artifact persistence (npz / json instead of dill)
# ---------------------------------------------------------------------------


def _is_arraylike(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(value, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...],
                                                           Any]]:
    """(key path, leaf) pairs in the JAX package's pytree order: dict
    keys sorted, sequence entries by index, namedtuple fields by name;
    None holds no leaf."""
    if value is None:
        return []
    if isinstance(value, dict):
        out = []
        for k in sorted(value):
            out += _flatten(value[k], path + (str(k),))
        return out
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        out = []
        for name in value._fields:
            out += _flatten(getattr(value, name), path + (name,))
        return out
    if isinstance(value, (list, tuple)):
        out = []
        for i, v in enumerate(value):
            out += _flatten(v, path + (str(i),))
        return out
    return [(path, value)]


def save_artifact(path: str, value: Any) -> str:
    """Persist one artifact; returns the full filename written.

    Nested values whose leaves are all arrays (numpy or torch, on any
    device) go to ``{path}.npz`` with flattened key paths; everything
    JSON-serializable goes to ``{path}.json``.
    """
    leaves = _flatten(value)
    # npz only when every leaf is an actual array: plain-python structures
    # (sweep dicts of lists, name lists) keep their shape better as JSON
    if leaves and all(_is_arraylike(v) for _, v in leaves):
        flat = {}
        for keypath, leaf in leaves:
            key = _SEP.join(keypath) or _VALUE_KEY
            if key in flat:
                raise ValueError(
                    f"flattened key collision at {key!r} (a dict key "
                    f"containing {_SEP!r} collides with nesting); rename the "
                    "offending key")
            flat[key] = _numpy(leaf)
        fname = path + ".npz"
        np.savez_compressed(fname, **flat)
        return fname
    fname = path + ".json"
    with open(fname, "w") as f:
        json.dump(_jsonify(value), f, indent=1, default=str)
    return fname


def _jsonify(v):
    if _is_arraylike(v):
        return _numpy(v).tolist()
    if isinstance(v, dict):
        return {str(k): _jsonify(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def load_artifact(path: str) -> Any:
    """Load an artifact written by :func:`save_artifact`.

    ``.npz`` artifacts come back as a flat ``{path_key: np.ndarray}`` dict
    (or a bare array when it was saved as a single value); ``.json`` as
    parsed JSON.  Accepts the basename or the full filename.
    """
    if os.path.exists(path + ".npz"):
        path = path + ".npz"
    elif os.path.exists(path + ".json"):
        path = path + ".json"
    if path.endswith(".npz"):
        with np.load(path) as z:
            out = {k: z[k] for k in z.files}
        if set(out) == {_VALUE_KEY}:
            return out[_VALUE_KEY]
        return out
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


def counters_dict(counts) -> Dict[str, int]:
    """(5,) histogram -> the reference's counter dict
    (``experiment.py:67``: keys divergent/fix_zero/fix_other/fix_sec/other)."""
    arr = _numpy(counts)
    return {name: int(arr[i]) for i, name in enumerate(CLASS_NAMES)}


def format_counters(counts) -> str:
    """Render a histogram exactly like the reference's logged dict repr, so
    log lines stay textually comparable to ``results/*/log.txt``."""
    return str(counters_dict(counts))


# ---------------------------------------------------------------------------
# the Experiment run-directory context
# ---------------------------------------------------------------------------


class Experiment:
    """Run-directory + log manager (reference ``Experiment``,
    ``experiment.py:8-59``).

    >>> with Experiment('applying_fixpoint', root='experiments') as exp:
    ...     exp.log('counters: ...')
    ...     exp.save(all_counters=counts)        # -> all_counters.npz

    On exit, ``log.txt`` (one line per ``log()`` call) and ``meta.json``
    are written.  ``next_iteration`` increments per ``with`` entry, giving
    ``-0``, ``-1``, ... suffixed sibling dirs like the reference.
    """

    def __init__(self, name: Optional[str] = None, ident: Optional[str] = None,
                 root: str = "experiments", seed: Optional[int] = None):
        self.experiment_name = name or "unnamed_experiment"
        self.experiment_id = f"{ident or ''}_{time.time()}"
        self.root = root
        self.next_iteration = 0
        self.seed = seed
        self.log_messages: list = []
        self.dir: Optional[str] = None
        self._t0: Optional[float] = None
        self._prior_wall = 0.0  # accumulated runtime of earlier attach()ed runs
        # events.jsonl may be written from more than one thread: serialize
        # the write+flush(+fsync) per record
        self._events_lock = threading.Lock()

    @classmethod
    def attach(cls, run_dir: str) -> "Experiment":
        """Re-attach to an existing run directory.

        Returns an entered Experiment whose ``log``/``event``/``save`` append
        to the existing ``log.txt``/``events.jsonl``/artifacts.  Exit it
        (``__exit__``) to flush the log as usual; a ``with`` block would
        enter it again and make a new run directory.
        """
        run_dir = os.path.normpath(run_dir)
        if not os.path.isdir(run_dir):
            raise FileNotFoundError(run_dir)
        base = os.path.basename(run_dir)
        self = cls(name=base, root=os.path.dirname(run_dir) or ".")
        meta_path = os.path.join(run_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.experiment_name = meta.get("name", base)
            self.experiment_id = meta.get("id", self.experiment_id)
            self.next_iteration = meta.get("iteration", 0)
            self.seed = meta.get("seed")
            # carry runtime forward so a resumed run's meta.json reports the
            # CUMULATIVE wall time of every attached run, not just the last one
            self._prior_wall = float(meta.get("wall_seconds") or 0.0)
        self.dir = run_dir
        self._t0 = time.time()
        log_path = os.path.join(run_dir, "log.txt")
        if os.path.exists(log_path):
            with open(log_path) as f:
                self.log_messages = [line.rstrip("\n") for line in f]
        self._events = open(os.path.join(run_dir, "events.jsonl"), "a")
        return self

    # -- context ---------------------------------------------------------

    def __enter__(self) -> "Experiment":
        self.dir = os.path.join(
            self.root,
            f"exp-{self.experiment_name}-{self.experiment_id}-{self.next_iteration}")
        os.makedirs(self.dir)
        self.log_messages = []
        self._t0 = time.time()
        self._events = open(os.path.join(self.dir, "events.jsonl"), "w")
        print(f"** created {self.dir} **")
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.save_log()
        meta = {
            "name": self.experiment_name,
            "id": self.experiment_id,
            "iteration": self.next_iteration,
            "seed": self.seed,
            "wall_seconds": self._prior_wall + (time.time() - self._t0),
            "error": repr(exc_value) if exc_value is not None else None,
        }
        with open(os.path.join(self.dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        self._events.close()
        self.next_iteration += 1
        return False

    # -- logging ---------------------------------------------------------

    def log(self, message, **event_fields):
        """Print + record a log line (``experiment.py:35-37``); any keyword
        fields additionally emit a structured jsonl event."""
        self.log_messages.append(message)
        print(message)
        if event_fields:
            self.event(message=str(message), **event_fields)

    def event(self, **fields):
        """Append one structured record to ``events.jsonl``; every write is
        flushed so a killed run keeps its structured tail."""
        fields.setdefault("t", time.time() - self._t0)
        with self._events_lock:
            self._events.write(json.dumps(_jsonify(fields), default=str) + "\n")
            self._events.flush()

    def save_log(self, log_name: str = "log"):
        with open(os.path.join(self.dir, f"{log_name}.txt"), "w") as f:
            for message in self.log_messages:
                print(str(message), file=f)

    # -- artifacts -------------------------------------------------------

    def save(self, **kwargs) -> Dict[str, str]:
        """Persist each keyword artifact into the run dir
        (``experiment.py:56-59``); returns {name: filename}."""
        out = {}
        for name, value in kwargs.items():
            out[name] = save_artifact(os.path.join(self.dir, name), value)
        return out

    def load(self, name: str) -> Any:
        return load_artifact(os.path.join(self.dir, name))
