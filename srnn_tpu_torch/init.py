"""Weight initialization matching keras defaults; port of
``srnn_tpu/init.py``.

The reference never sets initializers, so Dense kernels are glorot_uniform
(``network.py:226-230``).  The weightwise variant's law is pure per-weight
glorot: weight p of a particle is U(-limit_p, limit_p) with
``limit_p = sqrt(6 / (fan_in + fan_out))`` of its kernel.  So the JAX
package's per-particle draw (``init_population``) and its one-call lane draw
(``init_popmajor_fused``) are the same law, and here both are one
``uniform_`` call.  Streams differ from JAX's threefry: tests that compare
the two packages hand the same numbers to both.  Orthogonal recurrent
kernels are not ported yet.

Randomness comes from an explicit ``torch.Generator`` (or an int that seeds
one); nothing reads the global generator.
"""

import functools
from typing import Union

import numpy as np
import torch

from .topology import Topology

SeedLike = Union[int, torch.Generator]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  The default is the card; asking
    for CUDA where there is none raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def make_generator(seed: SeedLike, device="cuda") -> torch.Generator:
    """A generator on ``device``: an int seeds a new one, a generator is
    checked against the device and returned as is."""
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        if seed.device.type != dev.type:
            raise ValueError(
                f"generator lives on {seed.device}, tensors on {dev}")
        return seed
    return torch.Generator(device=dev).manual_seed(int(seed))


@functools.lru_cache(maxsize=None)
def glorot_limit_rows(topo: Topology) -> np.ndarray:
    """(P,) per-weight glorot_uniform limits, in flat order (float32)."""
    if topo.variant == "recurrent":
        raise ValueError(
            f"variant {topo.variant!r} has orthogonal kernels, whose init "
            "is not ported yet")
    rows = [np.full(a * b, np.sqrt(6.0 / (a + b)), np.float32)
            for (a, b) in topo.layer_shapes]
    return np.concatenate(rows)


def _glorot(topo: Topology, gen: torch.Generator, shape, device,
            lanes: bool) -> torch.Tensor:
    lim = torch.as_tensor(glorot_limit_rows(topo), device=device)
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(-1.0, 1.0, generator=gen)
    return u * (lim[:, None] if lanes else lim[None, :])


def init_population(topo: Topology, seed: SeedLike, n: int,
                    device="cuda") -> torch.Tensor:
    """Sample ``n`` particles -> row-major (n, P) float32."""
    gen = make_generator(seed, device)
    return _glorot(topo, gen, (n, topo.num_weights), gen.device, lanes=False)


def init_popmajor_fused(topo: Topology, seed: SeedLike, n: int,
                        device="cuda") -> torch.Tensor:
    """Sample ``n`` particles as one population-major (P, n) draw of
    U(-1, 1) times the per-row limit."""
    gen = make_generator(seed, device)
    return _glorot(topo, gen, (topo.num_weights, n), gen.device, lanes=True)


def _check_draws(draws: str) -> None:
    if draws not in ("perparticle", "fused"):
        raise ValueError(f"unknown respawn_draws {draws!r}")


def fresh_lanes(topo: Topology, seed: SeedLike, n: int,
                draws: str = "perparticle", device="cuda") -> torch.Tensor:
    """Respawn replacements in lane-major (P, n) layout.  Both ``draws``
    spellings draw the same law for the pure-glorot variants."""
    _check_draws(draws)
    return init_popmajor_fused(topo, seed, n, device)


def fresh_rows(topo: Topology, seed: SeedLike, n: int,
               draws: str = "perparticle", device="cuda") -> torch.Tensor:
    """Respawn replacements in row-major (n, P) layout."""
    _check_draws(draws)
    return init_population(topo, seed, n, device)
