"""Distribution (port of snappydata_tpu/parallel): the partitioner, the
bucket map and the slot mesh.

- PARTITION_BY + murmur3 buckets (StoreHashFunction) -> hashing / buckets
- the data mesh over shard slots, its placement and multi-host world
  -> mesh / placement / multihost
- partial aggregation + driver merge -> the per-slot partial lane and its
  merges (engine/mesh_exec.py)
"""

from snappydata_tpu_torch.parallel.hashing import murmur3_hash_np  # noqa: F401
from snappydata_tpu_torch.parallel.mesh import (  # noqa: F401
    data_mesh, shard_batches, MeshContext,
)
from snappydata_tpu_torch.parallel.buckets import BucketMap  # noqa: F401
