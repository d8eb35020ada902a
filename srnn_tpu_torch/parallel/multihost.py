"""Multi-slice meshes; port of ``srnn_tpu/parallel/multihost.py``.

Beyond one slice (several hosts, each with its cards) the mesh gains an
outer ``"slices"`` dimension: a 2-D ``DeviceMesh`` ``(slices, soup)``
(:func:`multislice_soup_mesh`).  The particle axis is sharded over the
mesh flattened row-major (the JAX package's ``P((DCN_AXIS,
SOUP_AXIS))``), so each slice owns a contiguous block and the bodies of
``sharded_soup`` run unchanged on it.

:func:`slice_groups` partitions devices by the slice they live on and
:func:`reramp_soup_mesh` picks the largest regular mesh that a set of
devices supports and whose size divides every published shard; both
take the JAX package's device records (anything with ``slice_index`` /
``process_index`` attributes) as well as this package's.  The launcher
uses the same divisor rule (:func:`reramp_process_count`) to choose the
world it relaunches after a lost host.  The in-process re-ramp onto
surviving cards is not ported yet (ROADMAP.md, A.6).
"""

import os
from typing import Optional, Sequence

import numpy as np

from .mesh import SOUP_AXIS, SoupMesh, _default_device, _dist, _ensure_group

DCN_AXIS = "slices"

#: bring-up override: partition an otherwise flat topology into N equal
#: contiguous slice groups (see :func:`slice_groups`)
FORCE_SLICES_ENV = "SRNN_FORCE_SLICES"


def multislice_soup_mesh(num_slices: int, device=None) -> SoupMesh:
    """(slices, soup) mesh over every rank of the run: rank ``r`` sits at
    ``(r // per_slice, r % per_slice)``, so each slice owns a contiguous
    block of the particle axis."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _default_device(device)
    owns = _ensure_group(dev)
    world = _dist().get_world_size()
    if num_slices < 1 or world % num_slices:
        if owns:
            _dist().destroy_process_group()
        raise ValueError(
            f"{world} devices do not split into {num_slices} slices")
    grid = np.arange(world).reshape(num_slices, world // num_slices)
    mesh = SoupMesh(DeviceMesh(dev.type, grid.tolist(),
                               mesh_dim_names=(DCN_AXIS, SOUP_AXIS)), dev)
    mesh.owns_group = owns
    return mesh


def _device_key(d, attr: str):
    return getattr(d, attr, None)


def slice_groups(devices, force_slices: Optional[int] = None) -> "list[list]":
    """Partition devices by the slice they live on, read from the
    topology attributes the devices expose (``slice_index`` where it
    varies, else ``process_index``; one group when neither varies).

    ``force_slices`` (or ``SRNN_FORCE_SLICES``) splits an otherwise flat
    topology into N equal contiguous groups.  A real topology always wins
    over the override, and an override that does not divide the device
    count is ignored."""
    devices = list(devices)
    slice_keys = [_device_key(d, "slice_index") for d in devices]
    use_slice = not any(k is None for k in slice_keys) \
        and len(set(slice_keys)) > 1
    groups: "dict[int, list]" = {}
    for d in devices:
        key = _device_key(d, "slice_index") if use_slice else None
        if key is None:
            key = _device_key(d, "process_index") or 0
        groups.setdefault(int(key), []).append(d)
    out = [groups[k] for k in sorted(groups)]
    if len(out) == 1:
        if force_slices is None:
            force_slices = int(os.environ.get(FORCE_SLICES_ENV, "0") or 0)
        flat = out[0]
        if force_slices > 1 and len(flat) >= force_slices \
                and len(flat) % force_slices == 0:
            per = len(flat) // force_slices
            out = [flat[i * per:(i + 1) * per] for i in range(force_slices)]
    return out


def reramp_layout(devices, shard_sizes: Sequence[int] = ()):
    """The largest regular mesh the devices support whose size divides
    every shard size: ``(axis names, grid of devices)`` -- whole slices
    of the modal size as a ``(slices, soup)`` grid while at least two
    remain (dropping trailing slices until the total divides), else the
    largest single group shrunk to a divisor, 1-D.  Raises ``ValueError``
    when nothing survives (``reramp_soup_mesh``, ``multihost.py:92``)."""
    devs = list(devices)
    if not devs:
        raise ValueError("no surviving devices to re-ramp onto")
    sizes = tuple(int(s) for s in shard_sizes)

    def divides(n: int) -> bool:
        return n > 0 and not any(s % n for s in sizes)

    groups = slice_groups(devs)
    lens = [len(g) for g in groups]
    modal = max(set(lens), key=lambda s: (lens.count(s), s))
    whole = [g for g in groups if len(g) == modal]
    while len(whole) >= 2 and not divides(len(whole) * modal):
        whole.pop()
    if len(whole) >= 2:
        return (DCN_AXIS, SOUP_AXIS), whole
    best = max(groups, key=len)
    n = len(best)
    while n > 1 and not divides(n):
        n -= 1
    return (SOUP_AXIS,), best[:n]


def reramp_soup_mesh(devices=None, shard_sizes: Sequence[int] = (),
                     device=None) -> SoupMesh:
    """The live mesh of a sharded run over the ranks of its process group
    (device records with the rank as ``id``; by default every rank on one
    host, one slice group, which ``SRNN_FORCE_SLICES`` splits):
    :func:`reramp_layout` of them, which must span every rank (a process
    group's membership is fixed for its lifetime; a smaller world is the
    launcher's re-ramp, :func:`reramp_process_count`)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _default_device(device)
    owns = _ensure_group(dev)
    world = _dist().get_world_size()
    if devices is None:
        devices = [_Rank(r) for r in range(world)]
    names, grid = reramp_layout(devices, shard_sizes)
    ranks = np.asarray([[d.id for d in g] for g in grid]) \
        if len(names) == 2 else np.asarray([d.id for d in grid])
    if sorted(ranks.flatten().tolist()) != list(range(world)):
        if owns:
            _dist().destroy_process_group()
        raise ValueError(
            f"the re-ramped mesh holds {ranks.size} of the run's {world} "
            "processes; relaunch with that many "
            "(python -m srnn_tpu_torch.distributed.launch re-ramps so)")
    mesh = SoupMesh(DeviceMesh(dev.type, ranks.tolist(),
                               mesh_dim_names=names), dev)
    mesh.owns_group = owns
    return mesh


class _Rank:
    """A rank of the run as a device record: ``id`` the rank,
    ``process_index`` its host (its slice group)."""

    def __init__(self, rank: int, host: int = 0):
        self.id = rank
        self.process_index = host


def reramp_process_count(processes: int,
                         shard_sizes: Sequence[int] = ()) -> int:
    """The process count the launcher relaunches after a lost host: the
    size of :func:`reramp_layout` over ``processes`` one-card processes
    (one slice group each), the largest that divides every shard."""
    names, grid = reramp_layout([_Rank(r, host=r) for r in range(processes)],
                                shard_sizes)
    return int(np.asarray([d.id for g in grid for d in g]
                          if len(names) == 2
                          else [d.id for d in grid]).size)
