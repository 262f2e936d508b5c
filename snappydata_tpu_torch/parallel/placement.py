"""Shard placement: bucket -> slot assignment for the data mesh.

Port of snappydata_tpu/parallel/placement.py.  A mesh-sharded table's
batch axis divides into `num_buckets` logical buckets (contiguous batch
runs — batch ~ bucket is the storage layer's own contract), and every
bucket is owned by exactly one mesh slot.  The placement makes a mesh
RESIZE a bucket *rebalance* instead of a world invalidation: when slots
leave (`rebalance(new_slots)`) the survivors take over their buckets and
the device caches migrate (storage/device.migrate_mesh_cache) instead of
rebuilding from the host; a rejoin hands the buckets back the same way
(ref: GemFire bucket rebalance + PartitionedRegion redundancy recovery).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from snappydata_tpu_torch.utils import locks

_lock = locks.named_lock("parallel.placement")
_next_generation = [0]


@dataclasses.dataclass(frozen=True)
class ShardPlacement:
    """Immutable bucket->slot assignment over `num_devices` slots.

    Buckets are contiguous runs of the (padded) batch axis, so the
    assignment is a plain block split — no batch permutation, which keeps
    the bind path identical with and without a placement.  `generation`
    is process-unique and monotone: caches and dashboards use it to tell
    two placements apart."""

    num_devices: int
    num_buckets: int
    assignment: Tuple[int, ...]     # bucket -> slot
    generation: int
    moved_from_previous: int = 0    # buckets that changed slot

    @classmethod
    def balanced(cls, num_devices: int,
                 num_buckets: int = 0) -> "ShardPlacement":
        from snappydata_tpu_torch import config

        nb = int(num_buckets or config.global_properties().get(
            "mesh_num_buckets", 32) or 32)
        nb = max(nb, num_devices)
        assign = tuple(b * num_devices // nb for b in range(nb))
        with _lock:
            _next_generation[0] += 1
            gen = _next_generation[0]
        return cls(num_devices, nb, assign, gen)

    def rebalance(self, new_num_devices: int) -> "ShardPlacement":
        """New balanced assignment over `new_num_devices` slots, tracking
        how many buckets moved (the rebalance cost the dashboard shows)."""
        nb = self.num_buckets
        new_assign = tuple(b * new_num_devices // nb for b in range(nb))
        moved = sum(1 for a, b in zip(self.assignment, new_assign)
                    if a != b)
        with _lock:
            _next_generation[0] += 1
            gen = _next_generation[0]
        return ShardPlacement(new_num_devices, nb, new_assign, gen,
                              moved_from_previous=moved)

    def device_of_bucket(self, bucket: int) -> int:
        return self.assignment[bucket % self.num_buckets]

    def bucket_of_batch(self, batch: int, num_batches: int) -> int:
        """Bucket of one (padded) batch slot: contiguous equal blocks."""
        n = max(1, num_batches)
        return min(self.num_buckets - 1, batch * self.num_buckets // n)

    def buckets_of_device(self, device: int) -> List[int]:
        return [b for b, d in enumerate(self.assignment) if d == device]

    def bucket_map(self) -> Dict[int, int]:
        """bucket -> slot, for /status/api/v1/mesh."""
        return {b: d for b, d in enumerate(self.assignment)}
