"""Known-fixpoint fixtures and fault injection; port of
``srnn_tpu/fixtures.py``.

The reference's canonical regression fixture is the analytically-known
identity fixpoint of the weightwise net
(``setups/known-fixpoint-variation.py:20-25``, reused by ``test.py:95-99``):
with kernels ``[[1,0],[0,0],...]`` the net computes f([w, ids]) = w, so
self-application reproduces every weight exactly.  ``vary`` is the
reference's fault-injection operator (``known-fixpoint-variation.py:37-46``):
perturb each weight by +-U(0,1)*e with a fair sign coin.

Generalized beyond the hardcoded 2x2 case: the identity chain routes input
feature 0 (the weight value) through unit 0 of every hidden layer.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from .init import resolve_device
from .topology import Topology


def identity_fixpoint_flat(topo: Topology, device="cuda") -> torch.Tensor:
    """The exact identity fixpoint of a weightwise net as a (P,) float32
    vector on ``device``.

    Layer 0 kernel (4, w): route input 0 (the weight value) to unit 0;
    hidden kernels (w, w): identity on unit 0; final kernel (w, 1): read
    unit 0.  For width=2, depth=2 this is the reference's fixture matrices
    bit for bit (``known-fixpoint-variation.py:20-25``).
    """
    if topo.variant != "weightwise":
        raise ValueError("the known identity fixpoint exists for the "
                         "weightwise variant only (reference note at "
                         "known-fixpoint-variation.py:29)")
    parts = []
    for a, b in topo.layer_shapes:
        k = np.zeros((a, b), np.float32)
        k[0, 0] = 1.0
        parts.append(k.reshape(-1))
    return torch.as_tensor(np.concatenate(parts),
                           device=resolve_device(device))


def vary(generator: Optional[torch.Generator], flat: torch.Tensor,
         e: float = 1.0,
         draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
         ) -> torch.Tensor:
    """Perturb every weight by +-U(0,1)*e, the sign a fair coin
    (``known-fixpoint-variation.py:37-46``).

    The two uniforms (sign coin, magnitude), each of ``flat``'s shape, come
    from ``generator`` (on ``flat``'s device), or are given as ``draws``
    (for instance the JAX package's, to reproduce its perturbation)."""
    if draws is None:
        if generator is None:
            raise ValueError("vary needs a generator or draws=")
        u_sign = torch.rand(flat.shape, generator=generator,
                            device=flat.device)
        u_mag = torch.rand(flat.shape, generator=generator,
                           device=flat.device)
    else:
        u_sign, u_mag = (torch.as_tensor(d, dtype=flat.dtype,
                                         device=flat.device) for d in draws)
    sign = torch.where(u_sign < 0.5, 1.0, -1.0).to(flat.dtype)
    return flat + sign * u_mag * e
