"""FFT variant, row-major: an MLP f: R^k -> R^k over truncated Fourier
coefficients.  Port of ``srnn_tpu/nets/fft.py``.

Reference: ``FFTNeuralNetwork`` (``network.py:442-521``), with the JAX
package's deliberate choices:

  * the transform reads the net's OWN current weights and ignores the
    target (``network.py:494-499``) unless ``topo.fft_use_target``;
  * the complex -> float32 casts keep the real parts
    (``network.py:503-508``);
  * ``fft_mode='rfft'`` takes the first k real-FFT bins (zero-padded when
    the spectrum is shorter), inverted with ``irfft``.

The forward transform truncates to k coefficients (``fft(flat, n=k)``), the
inverse expands back to P samples: a low-pass reconstruction.
``shuffler='random'`` is not ported and raises.
"""

import torch

from ..ops.mlp import mlp_apply, mlp_forward
from ..topology import Topology
from .aggregating import check_shuffler


def coefficients(topo: Topology, flat: torch.Tensor) -> torch.Tensor:
    """Real parts of the first k DFT coefficients of (..., P) weights."""
    k = topo.aggregates
    if topo.fft_mode == "rfft":
        spec = torch.fft.rfft(flat).real.to(flat.dtype)
        n = spec.shape[-1]
        if n >= k:
            return spec[..., :k]
        return torch.nn.functional.pad(spec, (0, k - n))
    return torch.fft.fft(flat, n=k).real.to(flat.dtype)


def forward(topo: Topology, self_flat: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    return mlp_forward(topo, self_flat, x)


def apply(topo: Topology, self_flat: torch.Tensor,
          target_flat: torch.Tensor) -> torch.Tensor:
    """FFT -> one forward over k coefficients -> inverse FFT to P weights
    (``apply_to_weights``, ``network.py:494-516``)."""
    check_shuffler(topo)
    src = target_flat if topo.fft_use_target else self_flat
    coeffs = coefficients(topo, src)
    new = mlp_apply(topo, self_flat, coeffs[..., None, :])[..., 0, :]
    if topo.fft_mode == "rfft":
        out = torch.fft.irfft(new, n=topo.num_weights)
    else:
        out = torch.fft.ifft(new, n=topo.num_weights).real
    return out.to(target_flat.dtype)


def samples(topo: Topology, flat: torch.Tensor):
    """x = y = the (..., 1, k) coefficient vector (the JAX package's
    deliberate deviation from the reference's dead ``compute_samples``,
    ``nets/fft.py:70-81``)."""
    coeffs = coefficients(topo, flat)[..., None, :]
    return coeffs, coeffs
