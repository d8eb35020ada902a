"""Weight initialization matching keras defaults; port of
``srnn_tpu/init.py``.

The reference never sets initializers, so Dense kernels and SimpleRNN
input kernels are glorot_uniform, SimpleRNN recurrent kernels orthogonal
(``network.py:226-230,329-333,531-535``).  Weight p of a pure-glorot
particle (weightwise, aggregating, fft) is U(-limit_p, limit_p) with
``limit_p = sqrt(6 / (fan_in + fan_out))`` of its kernel, so the JAX
package's per-particle draw (``init_population``) and its one-call lane
draw (``init_popmajor_fused``) are the same law, and here both are one
``uniform_`` call.  A recurrent particle draws kernel by kernel: the odd
kernels of ``layer_shapes`` are Haar-random orthogonal matrices
(``jax.nn.initializers.orthogonal``: the Q of a Gaussian matrix's QR with
the signs of diag(R) folded in), made here by Gram-Schmidt elementwise over
the particle axis -- for a (1, 1) kernel that is a fair +-1.  Streams
differ from JAX's threefry: tests that compare the two packages hand the
same numbers to both, and hold the init to its law.

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


def on_device(x, device, dtype) -> torch.Tensor:
    """A caller's tensor or array (a numpy array copied: one from a JAX
    array is read-only) as a contiguous ``dtype`` tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))
    return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()


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


def supports_fused_init(topo: Topology) -> bool:
    """True when the variant's init law is pure glorot_uniform (no
    orthogonal kernels), i.e. the one-call lane draw is the same law."""
    return topo.variant != "recurrent"


@functools.lru_cache(maxsize=None)
def glorot_limit_rows(topo: Topology) -> np.ndarray:
    """(P,) per-weight glorot_uniform limits, in flat order (float32)."""
    if not supports_fused_init(topo):
        raise ValueError(
            f"variant {topo.variant!r} has orthogonal kernels; the per-row "
            "glorot law is only defined for pure-glorot variants")
    rows = [np.full(a * b, np.sqrt(6.0 / (a + b)), np.float32)
            for (a, b) in topo.layer_shapes]
    return np.concatenate(rows)


def orthogonal_lanes(gen: torch.Generator, n: int, shape,
                     device) -> torch.Tensor:
    """``n`` Haar-random orthogonal (a, b) matrices, lane-major: (a, b, n)
    float32.  The law of ``jax.nn.initializers.orthogonal()``: a Gaussian
    (rows, cols) matrix with rows >= cols (transposed after when a < b),
    its columns orthonormalised by Gram-Schmidt -- the Q of its QR with
    diag(R) > 0 -- each projection taken twice, so that float32 keeps
    Q^T Q = I for nearly parallel columns too.  Elementwise over the
    particle axis, so no batched QR is needed.  A column of norm exactly 0
    (a null event of the Gaussian law) divides by the smallest normal float
    instead of 0, so no draw is ever NaN."""
    a, b = shape
    rows, cols = (b, a) if a < b else (a, b)
    g = torch.empty((rows, cols, n), dtype=torch.float32, device=device)
    g.normal_(generator=gen)
    qs = []
    for c in range(cols):
        v = g[:, c]
        for _ in range(2):
            for q in qs:
                v = v - (q * v).sum(dim=0) * q
        norm = torch.sqrt((v * v).sum(dim=0))
        qs.append(v / norm.clamp_min(torch.finfo(torch.float32).tiny))
    q = torch.stack(qs, dim=1)  # (rows, cols, n)
    return q.transpose(0, 1) if a < b else q


def _per_kernel_lanes(topo: Topology, gen: torch.Generator, n: int,
                      device) -> torch.Tensor:
    """Kernel-by-kernel draw, lane-major -> (P, n): glorot_uniform, and
    orthogonal for the recurrent kernels (odd entries of
    ``layer_shapes``)."""
    parts = []
    for i, (a, b) in enumerate(topo.layer_shapes):
        if topo.variant == "recurrent" and i % 2 == 1:
            parts.append(orthogonal_lanes(gen, n, (a, b), device)
                         .reshape(a * b, n))
        else:
            u = torch.empty((a * b, n), dtype=torch.float32, device=device)
            u.uniform_(-1.0, 1.0, generator=gen)
            parts.append(u * float(np.float32(np.sqrt(6.0 / (a + b)))))
    return torch.cat(parts, dim=0)


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
    if not supports_fused_init(topo):
        return _per_kernel_lanes(topo, gen, n, gen.device).t().contiguous()
    return _glorot(topo, gen, (n, topo.num_weights), gen.device, lanes=False)


def init_popmajor_fused(topo: Topology, seed: SeedLike, n: int,
                        device="cuda") -> torch.Tensor:
    """Sample ``n`` particles as one population-major (P, n) draw of
    U(-1, 1) times the per-row limit (pure-glorot variants only)."""
    gen = make_generator(seed, device)
    return _glorot(topo, gen, (topo.num_weights, n), gen.device, lanes=True)


def _check_draws(draws: str) -> None:
    if draws not in ("perparticle", "fused"):
        raise ValueError(f"unknown respawn_draws {draws!r}")


def fresh_lanes(topo: Topology, seed: SeedLike, n: int,
                draws: str = "perparticle", device="cuda") -> torch.Tensor:
    """Respawn replacements in lane-major (P, n) layout.  Both ``draws``
    spellings draw the same law for the pure-glorot variants; the recurrent
    variant falls back to the kernel-by-kernel draw for both."""
    _check_draws(draws)
    if not supports_fused_init(topo):
        gen = make_generator(seed, device)
        return _per_kernel_lanes(topo, gen, n, gen.device)
    return init_popmajor_fused(topo, seed, n, device)


def fresh_rows(topo: Topology, seed: SeedLike, n: int,
               draws: str = "perparticle", device="cuda") -> torch.Tensor:
    """Respawn replacements in row-major (n, P) layout."""
    _check_draws(draws)
    return init_population(topo, seed, n, device)
