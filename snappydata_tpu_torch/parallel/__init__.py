"""Distribution (port of snappydata_tpu/parallel).

Only the hashing the AQP sketches need is ported so far: Spark-compatible
murmur3 (`hashing.py`).  The bucket map, the device mesh, multi-host
execution and placement come with multi-device execution.
"""

from snappydata_tpu_torch.parallel.hashing import murmur3_hash_np  # noqa: F401
