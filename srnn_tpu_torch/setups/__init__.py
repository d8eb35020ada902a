"""Paper-experiment entry points, the port's equivalents of the
reference's ``code/setups/*.py`` scripts (SURVEY §2.2) for the six fixpoint
experiments and the three soup experiments; port of ``srnn_tpu/setups``.

Run one with ``python -m srnn_tpu_torch.setups <name> [flags]``; every
script supports ``--smoke`` for a seconds-scale sanity run and writes a
reference-style run directory (log.txt + npz/json artifacts, readable by
either package's ``load_artifact``) under ``--root``.  ``mega_soup`` and
``mega_multisoup`` are not ported yet.
"""

from . import (  # noqa: F401  (import for registration side effect)
    applying_fixpoints,
    fixpoint_density,
    known_fixpoint_variation,
    learn_from_soup,
    mixed_self_fixpoints,
    mixed_soup,
    network_trajectorys,
    soup_trajectorys,
    training_fixpoints,
)
from .common import REGISTRY

__all__ = ["REGISTRY"]
