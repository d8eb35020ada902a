"""Activation registry matching keras activation-string semantics
(reference passes activation names through ``keras_params``,
``network.py:80``).  Port of ``srnn_tpu/ops/activations.py``."""

import numpy as np
import torch


def _linear(x):
    return x


# elu, swish, gelu and softmax are written as jax.nn writes them, their
# transcendental functions taken in float64 and rounded once to float32:
# the correctly rounded value, so that the card and the CPU agree bit for
# bit (their float32 exp / expm1 / tanh kernels may round apart in the last
# bit, and the CPU's vectorized and scalar paths too, which the autograd
# chains of a far-from-fixpoint particle amplify several hundred times; and
# torch's own CUDA elu takes exp(x) - 1, losing the digits of a small
# negative x).  Gradients flow through the float64 operations alike.


def _rounded(fn, x):
    """``fn`` of ``x`` in float64, rounded once to ``x``'s dtype."""
    return fn(x.double()).to(x.dtype)


def _elu(x):
    """jax.nn.elu: x where x > 0, else expm1(x) (expm1 of a masked input,
    so that the unselected branch's gradient stays finite)."""
    return torch.where(x > 0, x,
                       _rounded(torch.expm1, torch.where(x > 0, 0.0, x)))


def _swish(x):
    """jax.nn.swish: x * sigmoid(x)."""
    return x * _rounded(torch.sigmoid, x)


_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def _gelu(x):
    """jax.nn.gelu's default tanh approximation."""
    cdf = 0.5 * (1.0 + _rounded(torch.tanh, _SQRT_2_OVER_PI *
                                (x + 0.044715 * (x ** 3))))
    return x * cdf


def softmax(x, dim=-1):
    """jax.nn.softmax: exp(x - max) over its sum, the max held constant
    for the gradient."""
    e = _rounded(torch.exp, x - x.amax(dim=dim, keepdim=True).detach())
    return e / e.sum(dim=dim, keepdim=True)


_ACTIVATIONS = {
    "linear": _linear,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "elu": _elu,
    "softmax": softmax,
    "swish": _swish,
    "gelu": _gelu,
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


def resolve_layer_activation(name):
    """The activation of a layer whose units are separate tensors (the lane
    layouts: one (N,) vector of the N particles per unit), as a function
    of the list of the layer's pre-activations: elementwise for every
    activation but softmax, which normalizes across the layer's units, as
    keras' Dense does and as the row-major transforms do (the JAX
    package's population-major layout takes ``jax.nn.softmax`` of each
    unit's lane vector, across the particles; the port does not follow
    it there)."""
    if name == "softmax":
        return lambda units: list(softmax(torch.stack(units), dim=0)
                                  .unbind(0))
    act = resolve_activation(name)
    return lambda units: [act(u) for u in units]


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
