"""Paper-experiment entry points, the port's equivalents of the
reference's ``code/setups/*.py`` scripts (SURVEY §2.2) for the six fixpoint
experiments and the three soup experiments, and the two mega runs
(``mega_soup``, ``mega_multisoup``); port of ``srnn_tpu/setups``.

Run one with ``python -m srnn_tpu_torch.setups <name> [flags]``; every
script supports ``--smoke`` for a seconds-scale sanity run and writes a
reference-style run directory (log.txt + npz/json artifacts, readable by
either package's ``load_artifact``) under ``--root``.  The mega runs are
supervised (``srnn_tpu_torch.resilience``): the CLI exits 0 clean, 3
recovered after a restart, 69 when the retries are spent or the card is
unusable, 75 preempted by SIGTERM (resumable with ``--resume``).
"""

from . import (  # noqa: F401  (import for registration side effect)
    applying_fixpoints,
    fixpoint_density,
    known_fixpoint_variation,
    learn_from_soup,
    mega_multisoup,
    mega_soup,
    mixed_self_fixpoints,
    mixed_soup,
    network_trajectorys,
    soup_trajectorys,
    training_fixpoints,
)
from .common import REGISTRY

__all__ = ["REGISTRY"]
