"""Carry weights and configurations across from the JAX package.

Everything here takes plain values -- numpy arrays, ints, dicts of fields
(``dataclasses.asdict(topo)``, ``config._asdict()``) -- so it needs no
import of the JAX package.  The JAX config names its implementations 'xla'
and 'pallas'; here they are 'plain' and 'kernel', with the JAX package's
meaning: 'plain' (the default, as 'xla' is there) runs every particle, on
the hand-written kernels inside their envelope and on the
autograd chains elsewhere (``ops/popmajor.train_route``); 'kernel' asks
for the kernels and raises upfront where a particle is outside them, as
'pallas' raises outside the Pallas envelope.  Weights keep their
storage dtype: float32, bfloat16 (numpy's ``ml_dtypes`` bfloat16, as
``np.asarray`` gives it for a JAX bfloat16 array) or int8 codes, the last
with their per-particle float32 ``scales``.
"""

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .init import make_generator
from .multisoup import MultiSoupConfig, MultiSoupState
from .soup import SoupConfig, SoupState
from .topology import Topology

_IMPL_NAMES = {"xla": "plain", "pallas": "kernel"}


def topology_from_fields(fields: Mapping) -> Topology:
    """A ``Topology`` from the fields of a JAX ``Topology``."""
    known = {f.name for f in dataclasses.fields(Topology)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown Topology fields {sorted(unknown)}")
    return Topology(**dict(fields))


def _config_fields(cls, fields: Mapping) -> dict:
    unknown = set(fields) - set(cls._fields)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields {sorted(unknown)}")
    kw = dict(fields)
    for name in ("train_impl", "apply_impl"):
        if name in kw:
            kw[name] = _IMPL_NAMES.get(kw[name], kw[name])
    return kw


def soup_config_from_fields(fields: Mapping) -> SoupConfig:
    """A ``SoupConfig`` from the fields of a JAX ``SoupConfig``, ``topo``
    given as the dict of its own fields."""
    kw = _config_fields(SoupConfig, fields)
    kw["topo"] = topology_from_fields(kw["topo"])
    return SoupConfig(**kw)


def multisoup_config_from_fields(fields: Mapping) -> MultiSoupConfig:
    """A ``MultiSoupConfig`` from the fields of a JAX ``MultiSoupConfig``,
    ``topos`` given as a sequence of dicts of their own fields."""
    kw = _config_fields(MultiSoupConfig, fields)
    kw["topos"] = tuple(topology_from_fields(t) for t in kw["topos"])
    kw["sizes"] = tuple(int(n) for n in kw["sizes"])
    return MultiSoupConfig(**kw)


def _weights(weights, dev) -> torch.Tensor:
    """A row-major (N, P) population in its storage dtype."""
    w = np.asarray(weights)
    if w.ndim != 2:
        raise ValueError(f"weights must be (N, P), got {w.shape}")
    if w.dtype == np.int8:
        return torch.as_tensor(w.copy(), device=dev)
    t = torch.as_tensor(np.array(w, dtype=np.float32), device=dev)
    # bfloat16 values are exact in float32, so this round trip is too
    return t.to(torch.bfloat16) if w.dtype.name == "bfloat16" else t


def _scales(scales, w: torch.Tensor) -> Optional[torch.Tensor]:
    if (scales is None) != (w.dtype != torch.int8):
        raise ValueError("int8 weights need their scales, and only they do")
    if scales is None:
        return None
    sc = np.array(scales, dtype=np.float32)
    if sc.shape != (w.shape[0],):
        raise ValueError(f"scales must be ({w.shape[0]},), got {sc.shape}")
    return torch.as_tensor(sc, device=w.device)


def _uids(uids, n: int, dev) -> torch.Tensor:
    u = np.asarray(uids)
    if u.shape != (n,):
        raise ValueError(f"uids must be ({n},), got {u.shape}")
    return torch.as_tensor(u.astype(np.int32), device=dev)


def soup_state_from_arrays(weights, uids, next_uid, time, seed: int = 0,
                           device="cuda", scales=None) -> SoupState:
    """A ``SoupState`` from a row-major (N, P) population (float32,
    bfloat16, or int8 codes with their (N,) ``scales``) and its uids,
    next_uid and time; ``seed`` seeds the generator the state carries (the
    JAX key cannot be carried over)."""
    gen = make_generator(seed, device)
    w = _weights(weights, gen.device)
    return SoupState(
        weights=w, uids=_uids(uids, w.shape[0], gen.device),
        next_uid=torch.tensor(int(next_uid), dtype=torch.int32,
                              device=gen.device),
        time=torch.tensor(int(time), dtype=torch.int32, device=gen.device),
        key=gen, scales=_scales(scales, w))


def multisoup_state_from_arrays(weights: Sequence, uids: Sequence, next_uid,
                                time, seed: int = 0, device="cuda",
                                scales: Optional[Sequence] = None
                                ) -> MultiSoupState:
    """A ``MultiSoupState`` from per-type row-major populations (and, for
    int8 codes, per-type scales), per-type uids, next_uid and time."""
    gen = make_generator(seed, device)
    ws = [_weights(w, gen.device) for w in weights]
    if len(uids) != len(ws) or (scales is not None and
                                len(scales) != len(ws)):
        raise ValueError("weights, uids and scales need one entry per type")
    scs = [_scales(None if scales is None else scales[t], w)
           for t, w in enumerate(ws)]
    return MultiSoupState(
        weights=tuple(ws),
        uids=tuple(_uids(u, w.shape[0], gen.device)
                   for u, w in zip(uids, ws)),
        next_uid=torch.tensor(int(next_uid), dtype=torch.int32,
                              device=gen.device),
        time=torch.tensor(int(time), dtype=torch.int32, device=gen.device),
        key=gen, scales=None if scales is None else tuple(scs))
