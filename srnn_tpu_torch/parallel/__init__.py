"""The sharded soups on ``torch.distributed``; port of
``srnn_tpu/parallel`` (see ``mesh``, ``sharded_soup``,
``sharded_multisoup`` and ``multihost``).  The weight-axis sharding of
one giant particle (``sharded_apply``, ``ring_rnn``) is not ported yet
(ROADMAP.md, A.6)."""

from .mesh import (SOUP_AXIS, SoupMesh, global_device_put,
                   initialize_distributed, probe_devices, replicate,
                   shard_population, soup_mesh)
from .multihost import (DCN_AXIS, multislice_soup_mesh, reramp_layout,
                        reramp_process_count, reramp_soup_mesh, slice_groups)
from .sharded_multisoup import (make_sharded_multi_state,
                                place_sharded_multi_state,
                                sharded_count_multi, sharded_evolve_multi,
                                sharded_evolve_multi_donated,
                                sharded_evolve_multi_step,
                                sharded_evolve_multi_step_donated)
from .sharded_soup import (make_sharded_state, place_sharded_state,
                           sharded_count, sharded_evolve,
                           sharded_evolve_donated, sharded_evolve_step,
                           sharded_evolve_step_donated)

__all__ = [
    "DCN_AXIS",
    "SOUP_AXIS",
    "SoupMesh",
    "global_device_put",
    "initialize_distributed",
    "make_sharded_multi_state",
    "make_sharded_state",
    "multislice_soup_mesh",
    "place_sharded_multi_state",
    "place_sharded_state",
    "probe_devices",
    "replicate",
    "reramp_layout",
    "reramp_process_count",
    "reramp_soup_mesh",
    "shard_population",
    "sharded_count",
    "sharded_count_multi",
    "sharded_evolve",
    "sharded_evolve_donated",
    "sharded_evolve_multi",
    "sharded_evolve_multi_donated",
    "sharded_evolve_multi_step",
    "sharded_evolve_multi_step_donated",
    "sharded_evolve_step",
    "sharded_evolve_step_donated",
    "slice_groups",
    "soup_mesh",
]
