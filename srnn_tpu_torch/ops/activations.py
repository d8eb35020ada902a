"""Activation registry matching keras activation-string semantics
(reference passes activation names through ``keras_params``,
``network.py:80``).  Port of ``srnn_tpu/ops/activations.py``."""

import torch
import torch.nn.functional as F


def _linear(x):
    return x


_ACTIVATIONS = {
    "linear": _linear,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "elu": F.elu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "swish": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def resolve_activation(name):
    if callable(name):
        return name
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}"
        ) from None


# Activations whose derivative is expressible from the OUTPUT alone -- what
# the hand-derived backward of the SGD chains needs, since it keeps
# post-activation values, not pre-activations.  relu's gradient at exactly 0
# is 0, matching the JAX package's VJP.
_OUTPUT_GRADS = {
    "linear": None,                    # multiplier 1 -- callers skip the mul
    "sigmoid": lambda h: h * (1.0 - h),
    "tanh": lambda h: 1.0 - h * h,
    "relu": lambda h: (h > 0.0).to(h.dtype),
}

#: activation name -> the integer code the CUDA kernels are instantiated for
#: (``csrc/ww_common.cuh``, ``enum Act``)
KERNEL_ACT_CODES = {"linear": 0, "sigmoid": 1, "tanh": 2, "relu": 3}


def output_grad_activations():
    """Activation names the hand-derived SGD chains can differentiate."""
    return tuple(sorted(_OUTPUT_GRADS))


def resolve_output_grad(name):
    """act'(z) as a function of h = act(z); returns None for 'linear'
    (identity multiplier)."""
    try:
        return _OUTPUT_GRADS[name]
    except KeyError:
        raise ValueError(
            f"activation {name!r} has no output-expressible derivative; "
            f"the fused kernels support {sorted(_OUTPUT_GRADS)}") from None
