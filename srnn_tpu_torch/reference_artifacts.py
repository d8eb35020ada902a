"""Loader + golden-replay helpers for the reference's committed 2019 dill
artifacts; a copy of ``srnn_tpu/reference_artifacts.py``.

The reference repo ships 35 ``.dill`` files under ``code/results/`` and
``code/setups/experiments/`` (dated 2019-03).  Several of them contain
*actual recorded weight trajectories* computed by the 2019 tf.keras code —
per-step flat-weight snapshots in ``ParticleDecorator.make_state`` format
(the reference's ``code/network.py:185-198``):

    {'class': <variant name>, 'weights': np.ndarray (P,),
     'time': int, 'action': str|absent, 'counterpart': uid|None|absent}

Those recorded ``w_t -> w_{t+1}`` pairs are the strongest parity evidence
available anywhere: replaying them through this repo's transforms checks our
math against the *reference's own 2019 TF numerics*, step by step, rather
than against distributions.  ``tests/test_golden_replay.py`` does exactly
that for the JAX package; RESULTS.md carries the error statistics.

Loading needs no keras/TF, and ``dill`` only when a pickle is loaded (it
is imported inside :func:`load_artifact`, so the module imports without
it): the pickles only reference the reference's class *names*
(``experiment.Experiment``, ``network.ParticleDecorator``, ...) plus
numpy.  We inject stub modules with attribute-bag shim classes before
``dill.load``.  Two wrinkles:

* The soup artifacts (``soup.dill``) embed the soup's ``generator`` closure,
  pickled by 2019 dill as a raw Python-3.6/3.7 **code object** (15
  constructor args; modern CPython wants 18).  We patch
  ``dill._dill._create_code`` during the load to rebuild those legacy tuples
  into inert modern code objects — the closure is never *called* during
  analysis, it only has to unpickle.
* ``Experiment.historical_particles`` values are either shim
  ``ParticleDecorator`` instances (attr ``states``) or plain state lists,
  depending on whether ``without_particles()`` ran; ``particle_states``
  normalizes both.

Public surface:
  load_artifact(path)          -> shim object tree (no keras required)
  particle_states(obj)         -> {uid: [state dict, ...]} normalized
  trajectory_artifact(obj)     -> {"weights": (T, N, P), "uids": (T, N)}
                                  NaN-padded, viz.particle_trajectories-ready
  scan(root)                   -> inventory of every .dill under root
  step_pairs(states)           -> consecutive (state_t, state_{t+1}) pairs
"""

from __future__ import annotations

import contextlib
import glob
import os
import sys
import types
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

# Class names the 2019 pickles may reference, per reference module
# (``experiment.py``, ``network.py``, ``soup.py``, ``util.py``).
_SHIM_CLASSES = {
    "experiment": (
        "Experiment", "FixpointExperiment", "MixedFixpointExperiment",
        "SoupExperiment", "IdentLearningExperiment",
    ),
    "network": (
        "NeuralNetwork", "WeightwiseNeuralNetwork", "AggregatingNeuralNetwork",
        "FFTNeuralNetwork", "RecurrentNeuralNetwork", "ParticleDecorator",
        "TrainingNeuralNetworkDecorator", "SaveStateCallback",
    ),
    "soup": ("Soup",),
    "util": ("PrintingObject",),
}


class _Shim:
    """Attribute bag standing in for any reference class during unpickle."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover - no reference class uses non-dict state
            self.__dict__["_state"] = state

    def __repr__(self):
        keys = ", ".join(sorted(self.__dict__)[:6])
        return f"<ref {type(self).__name__} {keys}>"


def _adapted_code(*args):
    """Build an inert modern code object from a 2019-era (py3.6/3.7, 15-arg)
    ``CodeType`` call recorded in the pickle stream.

    The 2019 dill pickled code objects as ``_load_type('CodeType')(*args)``
    with the 3.7 constructor order: (argcount, kwonlyargcount, nlocals,
    stacksize, flags, code, consts, names, varnames, filename, name,
    firstlineno, lnotab, freevars, cellvars).  Modern CPython inserts
    posonlyargcount (3.8) and qualname/exceptiontable (3.11), so the raw
    call raises.  The bytecode itself is stale — these closures (e.g. the
    Soup ``generator`` lambda, ``soup.py:37-40``) are never executed by
    analysis code, they only have to unpickle.  ``co_freevars`` must
    survive so ``_create_function`` can attach the pickled closure cells.
    """
    try:
        return types.CodeType(*args)
    except TypeError:
        pass
    if len(args) == 15:  # py3.6/3.7 layout
        (argcount, kwonly, nlocals, stacksize, flags, code, consts, names,
         varnames, filename, name, firstlineno, lnotab, freevars,
         cellvars) = args
        try:
            return types.CodeType(
                argcount, 0, kwonly, nlocals, stacksize, flags, code,
                consts, names, varnames, filename, name, name,
                firstlineno, lnotab, b"", freevars, cellvars)
        except Exception:
            # last resort: placeholder preserving the closure arity
            placeholder = (lambda: None).__code__
            try:
                return placeholder.replace(co_freevars=tuple(freevars))
            except Exception:
                return placeholder
    raise TypeError(f"unadaptable legacy code tuple of len {len(args)}")


def _legacy_load_type(orig_load_type):
    """Wrap dill's ``_load_type`` so lookups of ``CodeType`` hand back the
    adapting constructor above instead of the raw type."""

    def load_type(name, *args, **kwargs):
        if name == "CodeType":
            return _adapted_code
        return orig_load_type(name, *args, **kwargs)

    return load_type


@contextlib.contextmanager
def _shimmed_modules(dill_impl):
    """Temporarily install the reference's module/class namespace (plus the
    legacy-code patch of ``dill._dill``), restoring any real modules
    afterwards."""

    saved = {}
    for mod_name, class_names in _SHIM_CLASSES.items():
        saved[mod_name] = sys.modules.get(mod_name)
        mod = types.ModuleType(mod_name)
        for cls_name in class_names:
            setattr(mod, cls_name, type(cls_name, (_Shim,), {}))
        sys.modules[mod_name] = mod
    orig_load_type = dill_impl._load_type
    dill_impl._load_type = _legacy_load_type(orig_load_type)
    try:
        yield
    finally:
        dill_impl._load_type = orig_load_type
        for mod_name, prev in saved.items():
            if prev is None:
                sys.modules.pop(mod_name, None)
            else:
                sys.modules[mod_name] = prev


def load_artifact(path: str) -> Any:
    """dill-load one reference artifact with the class shims installed."""
    import dill
    import dill._dill as dill_impl

    with _shimmed_modules(dill_impl):
        with open(path, "rb") as fh:
            return dill.load(fh)


def particle_states(obj: Any) -> Dict[Any, List[dict]]:
    """Normalize ``historical_particles`` to {uid: [state, ...]}.

    Values are state lists already when the artifact went through
    ``without_particles()`` (``experiment.py:50-54``); live
    ``ParticleDecorator`` shims keep them under ``.states``
    (``network.py:193-198``).  Particles with no recorded states are
    dropped.
    """
    hp = getattr(obj, "historical_particles", None)
    if hp is None and isinstance(obj, dict):
        hp = obj
    if hp is None:
        raise TypeError(f"no historical_particles on {type(obj).__name__}")
    out = {}
    for uid, particle in hp.items():
        states = particle if isinstance(particle, list) else \
            getattr(particle, "states", None)
        if states:
            out[uid] = states
    return out


def step_pairs(states: List[dict]) -> Iterator[Tuple[dict, dict]]:
    """Consecutive recorded (state_t, state_{t+1}) pairs."""
    return zip(states, states[1:])


def trajectory_artifact(obj: Any) -> Dict[str, np.ndarray]:
    """Reference experiment/soup object -> the repo's rectangular trajectory
    artifact ``{"weights": (T, N, P), "uids": (T, N)}``.

    Histories are ragged two ways: runs stop early (divergence), and mixed
    experiments can hold particles of different weight counts.  *Missing
    time steps* pad with NaN rows — ``viz.particle_trajectories`` drops
    non-finite rows per particle, so that padding (like the reference's own
    NaN-state skip, ``network.py:186-188``) never renders.  *Missing weight
    dims* of a smaller-than-max particle pad with 0.0 instead: a NaN
    anywhere in a row would make the finite filter erase the whole
    particle, while a constant 0 merely embeds its trajectory in a
    lower-dimensional slice of the PCA space.
    """
    by_uid = particle_states(obj)
    if not by_uid:
        raise ValueError("artifact has no recorded particle states")
    uids = sorted(by_uid, key=lambda u: (str(type(u)), u))
    p = max(len(np.ravel(s["weights"]))
            for states in by_uid.values() for s in states)
    t_len = max(len(states) for states in by_uid.values())
    weights = np.full((t_len, len(uids), p), np.nan, dtype=np.float32)
    uid_grid = np.zeros((t_len, len(uids)), dtype=np.int64)
    for col, uid in enumerate(uids):
        uid_grid[:, col] = col if not isinstance(uid, (int, np.integer)) else uid
        for row, state in enumerate(by_uid[uid]):
            w = np.ravel(np.asarray(state["weights"], dtype=np.float32))
            weights[row, col, :len(w)] = w
            weights[row, col, len(w):] = 0.0
    return {"weights": weights, "uids": uid_grid}


def scan(root: str) -> List[dict]:
    """Inventory every ``.dill`` under ``root``: loadability, type, particle
    counts, per-class state statistics.  Used by the golden-replay tests to
    prove claims like "no RNN trajectories exist anywhere in the reference
    artifacts" against the full artifact set rather than one file."""
    rows = []
    for path in sorted(glob.glob(os.path.join(root, "**", "*.dill"),
                                 recursive=True)):
        row = {"path": path, "size": os.path.getsize(path), "loads": False,
               "type": None, "particles": 0, "classes": {}, "step_pairs": 0}
        try:
            obj = load_artifact(path)
        except Exception as e:  # noqa: BLE001 - inventory must not die
            row["error"] = f"{type(e).__name__}: {e}"
            rows.append(row)
            continue
        row["loads"] = True
        row["type"] = type(obj).__name__
        try:
            by_uid = particle_states(obj)
        except (TypeError, ValueError):
            by_uid = {}
        row["particles"] = len(by_uid)
        for states in by_uid.values():
            cls = states[0].get("class", "?")
            row["classes"][cls] = row["classes"].get(cls, 0) + 1
            row["step_pairs"] += max(0, len(states) - 1)
        rows.append(row)
    return rows


#: the reference repository's ``code/`` directory: ``SRNN_REFERENCE_ROOT``,
#: else ``reference/code`` under the working directory
REFERENCE_ROOT = os.environ.get("SRNN_REFERENCE_ROOT",
                                os.path.join("reference", "code"))

# The artifacts with real recorded trajectories (verified by ``scan``; the
# rest are sweep-curve dicts, name lists, or ``without_particles()`` shells
# whose ``historical_particles`` is empty).
WW_SELF_APPLICATION = (
    "setups/experiments/"
    "exp-weightwise_self_application-_1552664922.4501734-0/trajectorys.dill")
AGG_SELF_APPLICATION = (
    "results/self_application_aggregation_network/trajectorys.dill")
WW_SELF_TRAINING = (
    "results/self_training_weightwise_network/trajectorys.dill")
SOUP_RUNS = (
    "results/Soup/soup.dill",
    "results/exp-learn-from-soup-_1552658566.5572753-0/soup.dill",
)


def reference_path(rel: str) -> str:
    return os.path.join(REFERENCE_ROOT, rel)
