"""Device meshes and the collectives of the sharded soups; port of
``srnn_tpu/parallel/mesh.py``.

The JAX package drives D devices from one process and shards with
``shard_map``.  The port follows PyTorch's idiom instead: one process per
card (a rank of a ``torch.distributed`` process group, brought up by
``distributed.bootstrap``), and a :class:`SoupMesh` that names this rank's
block of the particle axis.  The mesh wraps a
``torch.distributed.device_mesh.DeviceMesh`` with one dimension ``"soup"``
(:func:`soup_mesh`) or two, ``("slices", "soup")``
(``multihost.multislice_soup_mesh``); the particle axis is sharded over
the mesh flattened row-major, which is the JAX package's
``P((DCN_AXIS, SOUP_AXIS))`` order: rank ``r`` of the flattened mesh owns
lanes ``[r * N / D, (r + 1) * N / D)``.

The bodies of ``sharded_soup`` / ``sharded_multisoup`` call nothing of
``torch.distributed`` but the few collectives here: :meth:`SoupMesh.gather`
(JAX's ``all_gather(x, axes, axis=k, tiled=True)``), :meth:`SoupMesh.
all_reduce` (sum / min / max), and the rank and size.  A tiled gather is
one collective into a contiguous (D, *block) buffer; along axis 0 that is
already the gathered tensor, along another axis (the (P, N / D) lane
blocks of the population-major layout) one permute copies it into
(P, N): the gathered bytes are written once by the collective and read and
written once more by the permute.  The gather is written once, for
both backends: ``all_gather_single`` where torch has it, else
``all_gather_into_tensor``, into a flat buffer (gloo takes no other
shape).  NCCL moves CUDA tensors, gloo CPU tensors (and CUDA tensors,
staged through host memory, where a run asks for it:
``distributed.bootstrap``); both take every dtype the soups gather
(float32, bfloat16, int8, int32, bool).  A gloo
failure that says a peer went away is re-raised as
``distributed.HostLost``; every other error, NCCL's included, propagates
unchanged.

The placement helpers keep the JAX package's contract (``mesh.py:58-81``):
every rank holds the same full host value (seeds come from a generator
seeded alike on every rank; a restore reads the same checkpoint files),
and each keeps its own block, so placing moves no data between ranks.
"""

import os
import re
from typing import Optional

import torch

SOUP_AXIS = "soup"

#: a collective that failed because its peer went away (gloo's spellings;
#: a lost NCCL peer surfaces as a timeout or an abort, classified by the
#: supervisor)
_PEER_LOSS_RE = re.compile(
    r"connection (closed|reset)|connect failure|broken pipe"
    r"|peer.*(closed|gone|lost)|socket.*(closed|timed out)", re.IGNORECASE)

def _dist():
    import torch.distributed as dist

    return dist


def _collective(name: str, fn):
    """Run one collective, turning a peer's loss into ``HostLost``."""
    try:
        return fn()
    except RuntimeError as e:
        if _PEER_LOSS_RE.search(str(e)):
            from ..distributed.bootstrap import HostLost

            raise HostLost(f"{name}: a peer of the process group is gone "
                           f"({type(e).__name__}: {e})") from e
        raise


class SoupMesh:
    """The sharded soups' mesh: a ``DeviceMesh`` over the run's ranks and
    this rank's place on the particle axis (the mesh flattened row-major).

    ``size`` is the number of shards, ``rank`` this process's block,
    ``device`` its card (or the CPU), ``axis_names`` / ``shape`` the
    mesh's dimensions."""

    def __init__(self, device_mesh, device):
        dist = _dist()
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = tuple(device_mesh.mesh.shape)
        ranks = device_mesh.mesh.flatten().tolist()
        if ranks != list(range(dist.get_world_size())):
            raise ValueError(
                f"a soup mesh spans every rank of the run in order; got "
                f"ranks {ranks} of a world of {dist.get_world_size()}")
        self.size = len(ranks)
        self.rank = ranks.index(dist.get_rank())
        self.backend = dist.get_backend()
        #: whether this mesh formed its own world of one (``close`` ends it)
        self.owns_group = False

    def close(self) -> None:
        """End the world of one this mesh formed, if it formed one (a
        launched run's group is the bootstrap's to end)."""
        if self.owns_group and _dist().is_initialized():
            _dist().destroy_process_group()
        self.owns_group = False

    def __repr__(self):
        dims = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                   self.shape))
        return (f"SoupMesh(({dims}), rank {self.rank}/{self.size}, "
                f"{self.device}, {self.backend})")

    def block(self, n: int) -> slice:
        """This rank's lanes of an ``n``-particle axis."""
        if n % self.size:
            raise ValueError(
                f"soup size {n} must be divisible by the mesh's {self.size} "
                "devices (each device owns an equal shard)")
        n_loc = n // self.size
        return slice(self.rank * n_loc, (self.rank + 1) * n_loc)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The blocks of every rank side by side along ``dim`` (JAX's
        tiled ``all_gather``), in rank order."""
        dist = _dist()
        src = x.contiguous()
        out = torch.empty((self.size, *src.shape), dtype=src.dtype,
                          device=src.device)
        into = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        _collective("gather", lambda: into(out.view(-1), src.view(-1)))
        if x.dim() == 0:
            return out
        dim = dim % x.dim()
        if dim != 0:
            out = out.movedim(0, dim)  # the permute: one copy below
        shape = list(x.shape)
        shape[dim] *= self.size
        return out.reshape(shape)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks (``'sum'`` | ``'min'`` |
        ``'max'``), in a new tensor."""
        dist = _dist()
        out = x.clone().contiguous()
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        _collective("all_reduce", lambda: dist.all_reduce(out, op=red))
        return out

    def exclusive_prefix(self, count: torch.Tensor):
        """(sum of ``count`` over the ranks before this one, the total):
        a global rank base from per-rank counts, in one gather."""
        counts = self.gather(count.reshape(1))
        return counts[:self.rank].sum(dtype=count.dtype), \
            counts.sum(dtype=count.dtype)


def _default_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    from ..distributed.bootstrap import context

    return context().device


def _ensure_group(device: torch.device) -> bool:
    """A process group to hang a mesh on: the bootstrap's, or a world of
    one formed here on an in-process store (a ``--sharded`` run without a
    launcher is one shard); True where it formed one."""
    dist = _dist()
    if dist.is_initialized():
        return False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return True


def soup_mesh(n_devices: Optional[int] = None, device=None) -> SoupMesh:
    """1-D mesh over the particle ('soup') axis, one shard per rank.

    Uses every rank of the run by default.  Requesting more devices than
    the run has fails fast (a mis-scheduled job must not silently run with
    halved shards); so does requesting fewer, since every rank of the run
    takes part in the soup's collectives."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _default_device(device)
    owns = _ensure_group(dev)
    world = _dist().get_world_size()
    try:
        if n_devices is not None and not 0 < n_devices <= world:
            raise ValueError(
                f"requested {n_devices} devices but {world} are available")
        if n_devices is not None and n_devices < world:
            raise ValueError(
                f"requested {n_devices} devices of a run of {world} "
                f"processes: every process owns one shard; launch "
                f"{n_devices} processes instead")
        mesh = SoupMesh(DeviceMesh(dev.type, list(range(world)),
                                   mesh_dim_names=(SOUP_AXIS,)), dev)
    except Exception:
        if owns:
            _dist().destroy_process_group()
        raise
    mesh.owns_group = owns
    return mesh


def probe_devices(verify: bool = False):
    """The devices this process can see right now: its cards, or the CPU.
    ``verify=True`` also round-trips one scalar through each and drops any
    that fail."""
    if torch.cuda.is_available() and os.environ.get(
            "SRNN_SETUPS_PLATFORM") != "cpu":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    if not verify:
        return devices
    alive = []
    for d in devices:
        try:
            torch.zeros((), dtype=torch.int32, device=d).cpu()
            alive.append(d)
        except Exception:
            continue
    return alive


def global_device_put(x, mesh: SoupMesh, dim: Optional[int] = None):
    """This rank's part of a value every rank holds in full: its block
    along ``dim`` (the particle axis), or the whole value replicated
    (``dim=None``), on the mesh's device."""
    if not isinstance(x, torch.Tensor):
        return x
    if dim is not None:
        idx = [slice(None)] * x.dim()
        idx[dim] = mesh.block(x.shape[dim])
        x = x[tuple(idx)]
    return x.to(mesh.device).contiguous()


def shard_population(mesh: SoupMesh, pop: torch.Tensor) -> torch.Tensor:
    """This rank's block of an (N, ...) population."""
    return global_device_put(pop, mesh, 0)


def replicate(mesh: SoupMesh, x):
    """A value placed whole on this rank's device."""
    return global_device_put(x, mesh)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Multi-process bring-up by explicit arguments: a spelling of
    ``distributed.bootstrap.ensure_initialized``, whose
    ``--dist-coordinator`` / ``--dist-processes`` / ``--dist-process-id``
    the arguments are (the same priority over the launcher's
    ``SRNN_DIST_*`` variables, partial-spec refusal, backend and
    deadline).  True where this process is now a rank of a multi-process
    group; a no-op (False) without arguments or variables, and for a
    world of one, so single-process runs and tests never pay for it."""
    from argparse import Namespace

    from ..distributed.bootstrap import ensure_initialized

    return ensure_initialized(Namespace(
        dist_coordinator=coordinator_address, dist_processes=num_processes,
        dist_process_id=process_id, dist_backend=None)).active
