"""Self-application transforms of the four variants, row-major."""

from .dispatch import apply_to_weights, compute_samples

__all__ = ["apply_to_weights", "compute_samples"]
