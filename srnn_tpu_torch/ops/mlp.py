"""Shared MLP forward; port of ``srnn_tpu/ops/mlp.py``.

Row-major: one matmul chain with the topology's activation after every
layer (keras builds each Dense with the same ``keras_params`` -- reference
``network.py:226-230``); the self-application takes the same net as
explicit multiply-add chains (``mlp_apply``).  No biases.  Float32 matmuls run in full float32 on
the card too (``torch.backends.cuda.matmul.allow_tf32`` is False by
default), which the 1e-4 fixpoint thresholds need.

Lane form (``mlp_rows_plain``): the same net unrolled over per-lane
parameter rows, one elementwise multiply and add at a time, in the order
the CUDA kernels use (``pallas_generation._mlp_rows``).  Every plain
version of a kernel forwards through it, so they all round alike.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch

from .activations import resolve_activation, resolve_layer_activation
from .flatten import unflatten


def mlp_forward(topo, self_flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., S, in) through the net whose weights are ``self_flat``
    (..., P); leading dims broadcast (a batch of particles)."""
    act = resolve_activation(topo.activation)
    h = x
    for m in unflatten(topo, self_flat):
        h = act(torch.matmul(h, m))
    return h


def mlp_apply(topo, self_flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``mlp_forward`` written as explicit multiply-add chains, summed in
    order i = 0..in-1 with every product taken: the forward of the
    self-application, which no autograd reads.  On the CPU it equals
    ``mlp_forward`` bit for bit; on the card a matmul contracts its
    products into FMAs and rounds otherwise, where these elementwise chains
    round as on the CPU."""
    act = resolve_activation(topo.activation)
    h = x
    for m in unflatten(topo, self_flat):
        acc = h[..., 0:1] * m[..., 0:1, :]
        for i in range(1, m.shape[-2]):
            acc = acc + h[..., i:i + 1] * m[..., i:i + 1, :]
        h = act(acc)
    return h


def mlp_rows_plain(topo, rows: Sequence[torch.Tensor],
                   feats: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The MLP on lane vectors: ``rows`` the per-lane flat parameters (each
    (N,)), ``feats`` the input features (each broadcasting against a row).
    Returns every layer's activations, the input features first, so that a
    backward pass can read them; ``[-1][0]`` is the net's output."""
    act = resolve_layer_activation(topo.activation)
    layers = [list(feats)]
    for (a, b), o in zip(topo.layer_shapes, topo.offsets):
        h = layers[-1]
        accs = []
        for j in range(b):
            acc = h[0] * rows[o + j]
            for i in range(1, a):
                acc = acc + h[i] * rows[o + i * b + j]
            accs.append(acc)
        layers.append(act(accs))
    return layers


def point_features(coords: np.ndarray, s: int,
                   x: torch.Tensor) -> List[torch.Tensor]:
    """The features of duplex point ``s``: its weight ``x`` and the three
    normalised coordinates ``coords[s]``, each filled out like ``x``."""
    return [x] + [torch.full_like(x, float(coords[s, k])) for k in range(3)]


def step_features(coords: np.ndarray, snap: Sequence[torch.Tensor], s: int,
                  order: Optional[torch.Tensor] = None,
                  snapT: Optional[torch.Tensor] = None):
    """The weight feature x and the input features of step ``s`` of a
    batch-1 epoch over the snapshot ``snap`` (P rows, each (N,)): sample s
    (``point_features``), or, in a shuffled epoch, sample ``order[n]`` of
    each lane n (``order`` the step's (N,) sample indices, ``snapT`` the
    snapshot stacked (P, N)), its coordinates gathered per lane.  Returns
    (x, features)."""
    if order is None:
        return snap[s], point_features(coords, s, snap[s])
    idx = order.long()
    x = snapT.gather(0, idx[None])[0]
    table = torch.as_tensor(coords, dtype=x.dtype, device=x.device)
    return x, [x] + [table[:, k][idx] for k in range(3)]
