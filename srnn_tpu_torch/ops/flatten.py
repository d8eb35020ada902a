"""Flat-vector <-> kernel-matrix conversion; port of
``srnn_tpu/ops/flatten.py``.

The reference keeps weights as keras' list of 2-D kernels and flattens with
``np.hstack([w.flatten() for w in weights])`` (``network.py:103-104``); its
``fill_weights`` writes a flat list back in layer -> row -> column order
(``network.py:64-74``).  Here the flat ``(P,)`` vector is the canonical
representation and these helpers give the per-layer matrix views.
"""

from typing import List, Sequence

import torch


def unflatten(topo, flat: torch.Tensor) -> List[torch.Tensor]:
    """(..., P) flat weights -> list of (..., a, b) kernels, keras order
    (row-major reshape: the reference's layer -> cell -> weight
    enumeration, ``network.py:64-74``)."""
    lead = flat.shape[:-1]
    return [flat[..., o:o + a * b].reshape(*lead, a, b)
            for (a, b), o in zip(topo.layer_shapes, topo.offsets)]


def flatten_mats(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`unflatten` (``get_weights_flat``,
    ``network.py:103-104``)."""
    lead = mats[0].shape[:-2]
    return torch.cat([m.reshape(*lead, -1) for m in mats], dim=-1)
