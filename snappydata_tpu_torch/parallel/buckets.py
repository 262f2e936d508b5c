"""Bucket map: table -> buckets -> placement.

Port of snappydata_tpu/parallel/buckets.py, the equivalent of the
reference's partitioned-region bucket metadata (StoreUtils.
getPartitionsPartitionedTable core/.../store/StoreUtils.scala:179-196):
a PARTITION_BY table hashes rows into `num_buckets` murmur3 buckets;
buckets are assigned round-robin to members with `redundancy` extra
copies; COLOCATE_WITH = share the bucket map.

Placement metadata only: the in-process mesh shards stacked batches
positionally (storage/device.py), and the distributed session routes by
its own bucket map (cluster/distributed.py).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from snappydata_tpu_torch.parallel.hashing import bucket_of_np


@dataclasses.dataclass
class BucketMap:
    num_buckets: int
    num_members: int
    redundancy: int = 0

    def primary_member(self, bucket: int) -> int:
        return bucket % self.num_members

    def members_of(self, bucket: int) -> List[int]:
        return [(bucket + r) % self.num_members
                for r in range(self.redundancy + 1)]

    def buckets_of_member(self, member: int) -> List[int]:
        return [b for b in range(self.num_buckets)
                if member in self.members_of(b)]

    def bucket_for_rows(self, key_values: np.ndarray) -> np.ndarray:
        return bucket_of_np(key_values, self.num_buckets)

    def member_for_rows(self, key_values: np.ndarray) -> np.ndarray:
        return self.bucket_for_rows(key_values) % self.num_members

    def collocated_with(self, other: "BucketMap") -> bool:
        return (self.num_buckets == other.num_buckets
                and self.num_members == other.num_members)
