"""Gradient-free fixpoint search: the stochastic hill climber; port of
``srnn_tpu/optimize.py``.

Prior-art parity for the EP prototype (``related/EP/src/NeuralNetwork.py``,
``fitByStochasticHillClimberV3``): repeatedly propose
noise-perturbed weight candidates around the incumbent, score each by how
close the net is to being its own fixpoint, and keep the best.  The EP
feature reductions {fft, rfft, mean, meanShuffled} map onto the main
framework's FFT / aggregating variants (SURVEY scope note), so the climber
here scores in the variant's own sample space via ``compute_samples``.

All shots of a round score as ONE batch of nets, ``(shots + 1, P)`` with
the incumbent first (the JAX package's ``vmap``); rounds are a host loop
that reads nothing back.  The forward and the mean are elementwise chains
in a fixed order (the MLP products fused into their sums, as XLA's dot
contracts them), so a net's loss is the same bits wherever it sits in the
batch and on the card as on the CPU.
"""

from typing import Optional, Tuple

import torch

from .init import on_device
from .nets.dispatch import compute_samples
from .ops.activations import resolve_activation
from .ops.flatten import unflatten
from .ops.mlp import ordered_mean
from .topology import Topology
from .train import predict


def _fma_matmul(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., a) times (..., a, b) -> (..., b) as the chain of fused
    multiply-adds that XLA's dot runs: the first product rounded, then each
    further product and its sum taken in float64 (the product of two
    float32 values is exact there) and rounded once to float32.  The same
    IEEE operations on either device, so the card equals the CPU."""
    acc = h[..., 0:1] * m[..., 0:1, :]
    for i in range(1, m.shape[-2]):
        acc = (acc.double() + h[..., i:i + 1].double()
               * m[..., i:i + 1, :].double()).to(acc.dtype)
    return acc


def _predict(topo: Topology, flat: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``train.predict`` with the MLP variants' forward as chains of fused
    multiply-adds (:func:`_fma_matmul`), as the JAX package's dot
    contracts them: a product past float32's range then sums to inf as
    there, not to NaN.  The recurrent forward is ``train.predict``'s
    chain."""
    if topo.variant == "recurrent":
        return predict(topo, flat, x)
    act = resolve_activation(topo.activation)
    h = x
    for m in unflatten(topo, flat):
        h = act(_fma_matmul(h, m))
    return h


def fixpoint_loss(topo: Topology, flat: torch.Tensor) -> torch.Tensor:
    """MSE between the net's prediction on its own samples and the targets —
    0 iff the net is exactly its own fixpoint in sample space (the EP
    climber's objective, predictions vs feature-reduced weights).  ``flat``
    (P,) gives a scalar, a batch (N, P) the (N,) losses."""
    x, y = compute_samples(topo, flat)
    pred = _predict(topo, flat, x)
    err = ((pred - y.reshape(pred.shape)) ** 2).reshape(
        *flat.shape[:-1], -1)
    return ordered_mean(err)


def _argmin(losses: torch.Tensor) -> torch.Tensor:
    """``jnp.argmin``: the first NaN if there is one, else the first
    minimum, decided on the device."""
    nan = torch.isnan(losses)
    pick = torch.where(nan.any(), nan, losses == losses.min())
    idx = torch.arange(losses.shape[0], device=losses.device)
    return torch.where(pick, idx, losses.shape[0]).min()


def hillclimb(
    topo: Topology,
    flat: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    shots: int = 20,
    rounds: int = 100,
    std: float = 0.01,
    noise=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic hill climbing toward a self-application fixpoint.

    Per round: draw ``shots`` gaussian perturbations (σ=``std``) of the
    incumbent (EP's ``standardDeviation``/``numberOtRandomShots`` knobs),
    score incumbent + shots in one batch, keep the argmin.  Returns
    (best_flat, (rounds,) best-loss trace), on ``flat``'s device.
    Monotone non-increasing by construction.

    The standard normal draws come from ``generator`` (on ``flat``'s
    device), one (shots, P) block a round; ``noise`` (rounds, shots, P)
    replaces them (the tests hand over the JAX package's draws).
    """
    w = flat
    p = w.shape[-1]
    if noise is not None:
        noise = on_device(noise, w.device, w.dtype)
        if tuple(noise.shape) != (rounds, shots, p):
            raise ValueError(f"noise must have shape ({rounds}, {shots}, "
                             f"{p}), got {tuple(noise.shape)}")
    elif generator is None:
        raise ValueError("hillclimb needs generator= or noise=")
    trace = torch.empty(rounds, dtype=w.dtype, device=w.device)
    for r in range(rounds):
        z = noise[r] if noise is not None else torch.randn(
            (shots, p), generator=generator, dtype=w.dtype, device=w.device)
        cands = torch.cat([w[None], w[None] + z * std], dim=0)
        losses = fixpoint_loss(topo, cands)
        best = _argmin(losses).reshape(1)
        w = cands.index_select(0, best)[0]
        trace[r] = losses.index_select(0, best)[0]
    return w, trace
