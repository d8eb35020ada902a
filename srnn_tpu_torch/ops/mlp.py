"""Shared MLP forward; port of ``srnn_tpu/ops/mlp.py``.

Row-major: one matmul chain with the topology's activation after every
layer (keras builds each Dense with the same ``keras_params`` -- reference
``network.py:226-230``).  No biases.  Float32 matmuls run in full float32 on
the card too (``torch.backends.cuda.matmul.allow_tf32`` is False by
default), which the 1e-4 fixpoint thresholds need.

Lane form (``mlp_rows_plain``): the same net unrolled over per-lane
parameter rows, one elementwise multiply and add at a time, in the order
the CUDA kernels use (``pallas_generation._mlp_rows``).  Every plain
version of a kernel forwards through it, so they all round alike.
"""

from typing import List, Sequence

import numpy as np
import torch

from .activations import resolve_activation
from .flatten import unflatten


def mlp_forward(topo, self_flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., S, in) through the net whose weights are ``self_flat``
    (..., P); leading dims broadcast (a batch of particles)."""
    act = resolve_activation(topo.activation)
    h = x
    for m in unflatten(topo, self_flat):
        h = act(torch.matmul(h, m))
    return h


def mlp_rows_plain(topo, rows: Sequence[torch.Tensor],
                   feats: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The MLP on lane vectors: ``rows`` the per-lane flat parameters (each
    (N,)), ``feats`` the input features (each broadcasting against a row).
    Returns every layer's activations, the input features first, so that a
    backward pass can read them; ``[-1][0]`` is the net's output."""
    act = resolve_activation(topo.activation)
    layers = [list(feats)]
    for (a, b), o in zip(topo.layer_shapes, topo.offsets):
        h = layers[-1]
        nxt = []
        for j in range(b):
            acc = h[0] * rows[o + j]
            for i in range(1, a):
                acc = acc + h[i] * rows[o + i * b + j]
            nxt.append(act(acc))
        layers.append(nxt)
    return layers


def point_features(coords: np.ndarray, s: int,
                   x: torch.Tensor) -> List[torch.Tensor]:
    """The features of duplex point ``s``: its weight ``x`` and the three
    normalised coordinates ``coords[s]``, each filled out like ``x``."""
    return [x] + [torch.full_like(x, float(coords[s, k])) for k in range(3)]
