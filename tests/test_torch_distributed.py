"""The distributed session through the port (snappydata_tpu_torch/cluster/
distributed.py and the Flight bucket actions it drives): every case of
the reference's tests/test_distributed_cluster.py (routing, partial
aggregation and merge, scan concat, replicated and collocated joins,
UPDATE / DELETE fan-out, broadcast and shuffle exchanges and their
caches, failover with exact counts, a failover mid-load, redundancy
restored after successive failures), each run against the port with the
reference's assertions (`torch_parity.port_cases`) over three port
servers on the CPU.

The reference marks the file slow at module level; the port's copies take
about ten seconds together here, so none of them is marked slow."""

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          port_cases)

globals().update(port_cases("test_distributed_cluster.py", [
    "dist", "loaded", "tpch_nc", "_mini_cluster",
    "test_rows_sharded_across_servers", "test_distributed_global_aggregate",
    "test_distributed_group_by_with_filter", "test_distributed_scan_concat",
    "test_distributed_replicated_join", "test_distributed_update_delete",
    "test_collocated_join_allowed_non_collocated_rejected",
    "test_broadcast_exchange_group_by", "test_shuffle_exchange_q3",
    "test_shuffle_exchange_q10_shape", "test_shuffle_exchange_q5_shape",
    "test_shuffle_exchange_invalidates_on_update",
    "test_outer_join_via_repartition", "test_composite_key_shuffle_join",
    "test_exchange_cache_invalidated_by_recreate",
    "test_replica_failover_exact_counts",
    "test_replica_failover_mid_load_auto_detect",
    "test_collocated_join_survives_failover",
    "test_redundancy_restored_after_successive_failures"]))
