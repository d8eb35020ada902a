"""Shared plumbing for the paper-experiment entry points; port of the
local-run part of ``srnn_tpu/setups/common.py``.

Each module in this package is the equivalent of one reference
``code/setups/*.py`` script (SURVEY §2.2): same experiment, same knobs, same
artifact names, with trials run as one batch on the card.  Every script
exposes ``build_parser()``, ``run(args)`` and ``main(argv)``, and registers
itself so ``python -m srnn_tpu_torch.setups <name>`` dispatches.
``--smoke`` shrinks every knob to a seconds-scale sanity run.

Runs go on the card; ``SRNN_SETUPS_PLATFORM=cpu`` runs them on the CPU
instead.  Without that and without a card a run fails (``NoDeviceError``):
there is no fallback.  Initial populations are drawn on the CPU from a
``torch.Generator`` seeded from the run's ``--seed`` and the trial batch's
place in the sweep (variant index, sweep index, batch offset), then moved to
the device, so a seed gives the same populations on either device; they
cannot reproduce the JAX package's threefry streams.  ``--service`` (the
experiment service, not ported yet: ROADMAP.md, queue A) is refused.
"""

import argparse
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..experiment import Experiment, format_counters
from ..init import init_population
from ..topology import Topology

REGISTRY: Dict[str, Callable] = {}

#: the environment variable that puts the setups on the CPU
PLATFORM_ENV = "SRNN_SETUPS_PLATFORM"


class NoDeviceError(RuntimeError):
    """No CUDA card, and the CPU was not asked for."""


def register(name: str):
    def deco(main_fn):
        REGISTRY[name] = main_fn
        return main_fn
    return deco


# the three standard archs every sweep iterates, in the reference's order
# and with its display names (e.g. mixed-self-fixpoints.py:63-66)
STANDARD_VARIANTS: Tuple[Tuple[str, Topology], ...] = (
    ("WeightwiseNeuralNetwork activation='linear' use_bias=False",
     Topology("weightwise", width=2, depth=2)),
    ("AggregatingNeuralNetwork activation='linear' use_bias=False",
     Topology("aggregating", width=2, depth=2, aggregates=4)),
    ("RecurrentNeuralNetwork activation='linear' use_bias=False",
     Topology("recurrent", width=2, depth=2)),
)


class _Parser(argparse.ArgumentParser):
    """Refuses ``--service``: a run never silently ignores it."""

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        if ns.service is not None:
            self.error("--service: the experiment service is not ported to "
                       "srnn_tpu_torch (ROADMAP.md, queue A); run without "
                       "--service")
        return ns


def base_parser(description: str) -> argparse.ArgumentParser:
    p = _Parser(description=description)
    p.add_argument("--root", default="experiments",
                   help="parent directory for run dirs")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed")
    p.add_argument("--epsilon", type=float, default=1e-4,
                   help="fixpoint epsilon (every reference experiment uses 1e-4)")
    p.add_argument("--smoke", action="store_true",
                   help="shrink all knobs to a seconds-scale sanity run")
    p.add_argument("--service", default=None, metavar="SOCKET",
                   help="not ported: the experiment service; refused")
    return p


def device() -> torch.device:
    """The device the setups run on: the card, or the CPU under
    ``SRNN_SETUPS_PLATFORM=cpu``.  Raises ``NoDeviceError`` without a card
    otherwise."""
    if os.environ.get(PLATFORM_ENV) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA card is available; set SRNN_SETUPS_PLATFORM=cpu to run "
            "the setups on the CPU")
    return torch.device("cuda")


def generator(seed: int, *where: int) -> torch.Generator:
    """A CPU generator seeded from the run's seed and a place in its sweep
    (numpy's ``SeedSequence`` mixes them)."""
    state = np.random.SeedSequence([seed, *where]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state >> np.uint64(1)))


def population(topo: Topology, n: int, dev: torch.device, seed: int,
               *where: int) -> torch.Tensor:
    """``n`` fresh (n, P) nets of ``topo``'s init law, drawn on the CPU
    from ``generator(seed, *where)`` and moved to ``dev``."""
    return init_population(topo, generator(seed, *where), n, "cpu").to(dev)


def log_sweep(exp: Experiment, name: str, data: dict):
    """Reference logging shape: name line, data dict line, blank line
    (``mixed-self-fixpoints.py:98-101``)."""
    exp.log(name)
    exp.log(data)
    exp.log("\n")


def log_counters(exp: Experiment, name: str, counts) -> None:
    arr = counts.cpu().numpy() if isinstance(counts, torch.Tensor) \
        else np.asarray(counts)
    exp.log(f"{name}: {format_counters(arr)}", counts=arr, name=name)


def save_run_config(run_dir: str, args, fields, extra=None) -> None:
    """Persist the run's knobs (and optional ``extra`` metadata) as
    config.json, atomically, with the JAX package's ``execution_mode``
    field: always ``"process"``, since ``--service`` is refused."""
    import json

    doc = {k: getattr(args, k) for k in fields}
    doc.setdefault("execution_mode", "process")
    doc.update(extra or {})
    atomic_write_text(os.path.join(run_dir, "config.json"),
                      json.dumps(doc, indent=1))


def atomic_write_text(path: str, text: str) -> str:
    """Publish ``text`` at ``path`` atomically: write a tmp file beside it,
    fsync, rename over the target, fsync the directory (where the
    filesystem allows); a run killed mid-write never leaves a torn file
    (``srnn_tpu/utils/atomicio.py``)."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(text.encode("utf-8"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        fd = os.open(os.path.dirname(path),
                     os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return path
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
    return path
