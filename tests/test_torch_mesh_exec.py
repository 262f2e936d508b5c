"""Mesh execution through the port (snappydata_tpu_torch/engine/mesh_exec.py,
parallel/mesh.py): every case of the reference's tests/test_mesh_exec.py
but its bench.py guard, run against the port with the reference's
assertions (`torch_parity.port_cases`) on 8 shard slots of the CPU — the
padding ladder, the per-slot partial lane for Q1 / Q6 and the
min / max / avg / HAVING shape, NULL group keys, empty slots, `?` binds on
the single-device lane, encoded plates per slot, broadcast and shuffle
joins, a pinned scan beside ingest, a live resize under traffic, and the
REST mesh route.

Edits: the reference builds a device table with `(data, manifest, cols)`
and reads `array.sharding.device_set`; the port's bind takes `(data,
cols, device)` and a context's `shards(tensor)` lists the slots holding
a plate (`dt.valid.size` is `numel()` in torch)."""

import pytest

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          eight_slots, port_cases)


@pytest.fixture(scope="module", autouse=True)
def _slots(eight_slots):  # noqa: F811
    yield


globals().update(port_cases("test_mesh_exec.py", [
    "loaded", "mesh8",
    "test_shard_bucket_ladder",
    "test_placement_rebalance_moves_minimum_metadata",
    "test_mesh_q1_q6_value_equivalence_and_lane_evidence",
    "test_mesh_aggregate_shapes", "test_mesh_null_group_keys",
    "test_mesh_empty_shards", "test_mesh_param_binds_stay_correct",
    "test_mesh_encoded_plates_resident_per_device",
    "test_join_broadcast_default_and_shuffle_forced",
    "test_shuffle_ineligible_declines_to_broadcast",
    "test_mesh_pinned_scan_isolated_from_sharded_ingest",
    "test_rebalance_under_traffic",
    "test_mesh_snapshot_and_rest_surface"], edits=[
        ("dt = build_device_table(info.data, None, [4])  # l_quantity",
         "dt = build_device_table(info.data, [4], ctx.home)  # l_quantity"),
        ("assert len(col.codes.sharding.device_set) == 8",
         "assert len(ctx.shards(col.codes)) == 8"),
        ("decoded = dt.valid.size * 8", "decoded = dt.valid.numel() * 8"),
    ]))
