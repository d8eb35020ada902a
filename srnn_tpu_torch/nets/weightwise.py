"""Weightwise variant, row-major: an MLP f: R^4 -> R^1 applied once per
scalar weight.  Port of ``srnn_tpu/nets/weightwise.py``.

Reference: ``WeightwiseNeuralNetwork`` (``network.py:213-289``).  Each weight
produces a point ``[w, layer_id, cell_id, weight_id]`` (ids normalized per
``normalize_id``) and is rewritten by the net.  Every function takes flat
weights (..., P); leading dims are a batch of particles.
"""

import torch

from ..ops.mlp import mlp_apply, mlp_forward
from ..topology import Topology, normalized_weight_coords


def forward(topo: Topology, self_flat: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """Batched MLP forward: x (..., S, 4) -> (..., S, 1)."""
    return mlp_forward(topo, self_flat, x)


def points(topo: Topology, target_flat: torch.Tensor) -> torch.Tensor:
    """Normalized duplex weight points (..., P, 4): [w, layer, cell, weight]
    (``compute_all_duplex_weight_points``, ``network.py:239-255``)."""
    coords = torch.as_tensor(normalized_weight_coords(topo),
                             dtype=target_flat.dtype,
                             device=target_flat.device)
    coords = coords.expand(*target_flat.shape[:-1], *coords.shape)
    return torch.cat([target_flat[..., None], coords], dim=-1)


def apply(topo: Topology, self_flat: torch.Tensor,
          target_flat: torch.Tensor) -> torch.Tensor:
    """Self-application: rewrite every target weight via the net
    (``apply_to_weights``, ``network.py:265-279``)."""
    return mlp_apply(topo, self_flat, points(topo, target_flat))[..., 0]


def samples(topo: Topology, flat: torch.Tensor):
    """Training pairs: x = all normalized points, y = current weights
    (``compute_samples``, ``network.py:281-289``)."""
    return points(topo, flat), flat
