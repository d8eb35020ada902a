"""Tensor ops of the port: plain torch versions and the wrappers of the
hand-written CUDA kernels (``cuda_*.py``, sources in ``../csrc``)."""
