"""Variant dispatch: a Topology to its transform functions.  Port of
``srnn_tpu/nets/dispatch.py``.

Every variant has the same surface:

  ``apply_to_weights(topo, self_flat, target_flat, perm=None,
  generator=None) -> new_target``
      the self-application operator (reference ``apply_to_weights``,
      ``network.py:265/359/494/544``); ``perm`` / ``generator`` stand in
      for the JAX package's ``key`` (``shuffler='random'``,
      ``aggregating.shuffle``);
  ``compute_samples(topo, flat) -> (x, y)``
      the self-training data (reference ``compute_samples``).
"""

from . import aggregating, fft, recurrent, weightwise

_MODULES = {
    "weightwise": weightwise,
    "aggregating": aggregating,
    "fft": fft,
    "recurrent": recurrent,
}


def apply_to_weights(topo, self_flat, target_flat, perm=None,
                     generator=None):
    return _MODULES[topo.variant].apply(topo, self_flat, target_flat, perm,
                                        generator)


def compute_samples(topo, flat):
    return _MODULES[topo.variant].samples(topo, flat)
