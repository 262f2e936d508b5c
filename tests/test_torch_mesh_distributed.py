"""Multi-slot execution of whole queries and the mesh x cluster
composition through the port, each case run with the reference's
assertions (`torch_parity.port_cases`) on 8 shard slots of the CPU:

- all of tests/test_distributed.py: Spark's murmur3 vectors, the bucket
  map's redundancy, Q1 / Q3 and a replicated row-table join under an
  8-slot mesh equal to the single-device rows, and plates that span the
  slots;
- tests/test_rebalance_mesh.py: two servers with 4-slot submeshes
  (`ServerNode(mesh_devices=...)`) under a distributed session, and the
  kill -> rejoin -> rebalance of a redundant table.

Edits: the reference builds a device table with `(data, manifest, cols)`
and reads `array.sharding.device_set`; the port's bind takes `(data,
cols, device)` and the context's `shards(tensor)` lists the slots.  The
reference marks test_rebalance_mesh.py slow at module level; its two
cases take a few seconds here, so the copies are unmarked."""

import pytest

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          eight_slots, port_cases)


@pytest.fixture(scope="module", autouse=True)
def _slots(eight_slots):  # noqa: F811
    yield


globals().update(port_cases("test_distributed.py", [
    "loaded", "test_murmur3_matches_spark_vectors",
    "test_bucket_map_redundancy", "test_distributed_q1_matches_single_device",
    "test_distributed_q3_join_matches",
    "test_distributed_row_table_replicated_join",
    "test_sharded_inputs_actually_span_devices"], edits=[
        ("dt = build_device_table(info.data, None, [4])",
         "dt = build_device_table(info.data, [4], ctx.home)"),
        ("assert len(arr.sharding.device_set) == 8",
         "assert len(ctx.shards(arr)) == 8"),
    ]))
globals().update(port_cases("test_rebalance_mesh.py", [
    "test_mesh_cluster_composed_topology", "test_kill_rejoin_rebalance"]))
