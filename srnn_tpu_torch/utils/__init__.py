"""Utilities of the port (``srnn_tpu/utils`` of the JAX package): the
trajectory store, the async pipeline and streaming capture, the profiling
harness, NaN/Inf provenance and the silence-gated printing mixin."""

from .capture import evolve_captured, evolve_multi_captured
from .trajstore import (TrajStore, native_available, read_sharded_store,
                        read_store, read_store_artifact, read_store_sampled,
                        shard_path, truncate_frames, truncate_sharded_frames)
from .profiling import phase, timed, trace
from .debug import (NonFiniteOutputError, checked_apply_to_weights,
                    divergence_onset)
from .printing import PrintingObject

__all__ = [
    "TrajStore", "native_available", "read_store", "read_store_artifact",
    "read_store_sampled", "truncate_frames", "read_sharded_store",
    "shard_path", "truncate_sharded_frames", "evolve_captured",
    "evolve_multi_captured", "phase", "timed", "trace",
    "NonFiniteOutputError", "checked_apply_to_weights", "divergence_onset",
    "PrintingObject",
]
