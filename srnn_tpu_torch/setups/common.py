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
cannot reproduce the JAX package's threefry streams.  The soup setups'
soups carry such CPU generators too and draw there (``evolve_trials``), so
a seed gives one soup on either device wherever their arithmetic agrees.
``--service`` (the experiment service, not ported yet: ROADMAP.md, queue
A) is refused.
"""

import argparse
import os
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .. import soup
from ..experiment import (CKPT_OK_MARKER, CKPT_STATE, Experiment,
                          atomic_write_text, format_counters)
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


def evolve_trials(cfg: soup.SoupConfig, trials: int, generations: int,
                  dev: torch.device, seed: int, *where: int
                  ) -> soup.SoupState:
    """Seed and evolve ``trials`` independent soups as one stacked batch,
    as the JAX package's ``vmap`` does (the reference loops soups one at a
    time, e.g. ``mixed-soup.py:79-92``); every phase is one kernel launch
    per generation for the whole batch.  Trial ``t`` draws from its own
    generator, ``generator(seed, *where, t)`` on the CPU, its draws moved
    to ``dev``: so trial ``t`` equals, bitwise, the soup
    ``soup.seed(cfg, generator(seed, *where, t), dev)`` evolved alone, on
    either device.  Returns the stacked state (``soup.stack``)."""
    states = [soup.seed(cfg, generator(seed, *where, t), dev)
              for t in range(trials)]
    return soup.evolve(cfg, soup.stack(states), generations)


def count_soup_trials(cfg: soup.SoupConfig,
                      states: soup.SoupState) -> np.ndarray:
    """(5,) histogram over all particles of all trial soups, the setups'
    per-particle ``count(counters, soup)`` accumulation
    (``mixed-soup.py:27-52``)."""
    return soup.count(cfg, states).cpu().numpy().astype(np.int64)


def checkpoint_intact(path: str) -> bool:
    """Is ``path`` a checkpoint directory a resume may trust (a soup's or
    a mixed soup's)?  Its ``SRNN_CKPT_OK`` marker, published after the
    state file, is the proof,
    with a state file that is not empty.  The port writes no checkpoint
    without the marker, so a directory without one is torn (the JAX
    package's structural test of pre-marker orbax trees has nothing to
    read here)."""
    state = os.path.join(path, CKPT_STATE)
    return (os.path.exists(os.path.join(path, CKPT_OK_MARKER))
            and os.path.isfile(state) and os.path.getsize(state) > 0)


def latest_checkpoint(run_dir: str) -> str:
    """The newest intact ``ckpt-gen<N>`` directory of ``run_dir``.  A torn
    one (:func:`checkpoint_intact` fails) is skipped with a warning, so a
    resume falls back to the newest checkpoint that is whole."""
    import glob

    ckpts = sorted(
        (p for p in glob.glob(os.path.join(run_dir, "ckpt-gen*"))
         if p.rsplit("gen", 1)[1].isdigit()),
        key=lambda p: int(p.rsplit("gen", 1)[1]))
    for p in reversed(ckpts):
        if checkpoint_intact(p):
            return p
        print(f"latest_checkpoint: skipping torn checkpoint {p}",
              file=sys.stderr, flush=True)
    raise FileNotFoundError(
        f"no finalized ckpt-gen* checkpoints under {run_dir}"
        + (f" ({len(ckpts)} torn candidate(s) skipped)" if ckpts else ""))


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
