"""Carry weights and configurations across from the JAX package.

Everything here takes plain values -- numpy arrays, ints, dicts of fields
(``dataclasses.asdict(topo)``, ``config._asdict()``) -- so it needs no
import of the JAX package.  The JAX config names its implementations 'xla'
and 'pallas'; here they are 'plain' and 'kernel'.
"""

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .init import make_generator
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


def soup_config_from_fields(fields: Mapping) -> SoupConfig:
    """A ``SoupConfig`` from the fields of a JAX ``SoupConfig``, ``topo``
    given as the dict of its own fields."""
    unknown = set(fields) - set(SoupConfig._fields)
    if unknown:
        raise ValueError(f"unknown SoupConfig fields {sorted(unknown)}")
    kw = dict(fields)
    kw["topo"] = topology_from_fields(kw["topo"])
    for name in ("train_impl", "apply_impl"):
        if name in kw:
            kw[name] = _IMPL_NAMES.get(kw[name], kw[name])
    return SoupConfig(**kw)


def soup_state_from_arrays(weights, uids, next_uid, time, seed: int = 0,
                           device="cuda") -> SoupState:
    """A ``SoupState`` from a row-major (N, P) population and its uids,
    next_uid and time; ``seed`` seeds the generator the state carries (the
    JAX key cannot be carried over)."""
    gen = make_generator(seed, device)
    dev = gen.device
    w = np.array(weights, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"weights must be (N, P), got {w.shape}")
    u = np.asarray(uids)
    if u.shape != (w.shape[0],):
        raise ValueError(f"uids must be ({w.shape[0]},), got {u.shape}")
    return SoupState(
        weights=torch.as_tensor(w, device=dev).contiguous(),
        uids=torch.as_tensor(u.astype(np.int32), device=dev),
        next_uid=torch.tensor(int(next_uid), dtype=torch.int32, device=dev),
        time=torch.tensor(int(time), dtype=torch.int32, device=dev),
        key=gen)
