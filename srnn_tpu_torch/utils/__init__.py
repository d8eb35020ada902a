"""Host-side utilities of the port: the trajectory store, the async
pipeline and streaming capture (``srnn_tpu/utils`` of the JAX package)."""

from .capture import evolve_captured, evolve_multi_captured
from .trajstore import (TrajStore, native_available, read_sharded_store,
                        read_store, read_store_artifact, read_store_sampled,
                        shard_path, truncate_frames, truncate_sharded_frames)

__all__ = [
    "TrajStore", "native_available", "read_store", "read_store_artifact",
    "read_store_sampled", "truncate_frames", "read_sharded_store",
    "shard_path", "truncate_sharded_frames", "evolve_captured",
    "evolve_multi_captured",
]
