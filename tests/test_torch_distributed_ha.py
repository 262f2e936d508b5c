"""Redundancy and HA of the distributed session through the port, each a
reference case run with its own assertions (`torch_parity.port_cases`):
the cases of tests/test_ha.py that tests/test_torch_cluster.py and
tests/test_torch_rest.py do not run (the deadline of a stalled scatter,
hedged reads, rejoin with and without a death snapshot, lost buckets
restored, a kill under the serving path), the seeded cluster chaos
schedule of tests/test_chaos_faults.py and the short profiles of
tests/test_endurance_ha.py.

The reference marks the hedge-ineligible case, the snapshot-less rejoin
and the three short endurance profiles slow on their own; the port's
copies take under eight seconds each here, so none of them is marked
slow."""

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          port_cases, unslow)


globals().update(port_cases("test_ha.py", [
    "_clean_faults", "_counter", "_cluster", "_teardown",
    "test_deadline_cuts_stalled_scatter",
    "test_hedged_read_takes_first_answer",
    "test_hedge_ineligible_without_redundancy",
    "test_rejoin_resyncs_and_restores_redundancy",
    "test_rejoin_without_snapshot_full_resync",
    "test_rejoin_restores_lost_buckets",
    "test_chaos_kill_under_serving_path"]))
globals().update(port_cases("test_chaos_faults.py", [
    "_clean_registry", "test_chaos_cluster_schedule"]))
globals().update(port_cases("test_endurance_ha.py", [
    "_lead_ha_battery", "test_lead_ha_under_load_short",
    "_eviction_pressure_battery", "test_eviction_pressure_short",
    "_client_scale_battery", "test_client_scale_short"]))
for _obj in (test_hedge_ineligible_without_redundancy,
             test_rejoin_without_snapshot_full_resync,
             test_lead_ha_under_load_short, test_eviction_pressure_short,
             test_client_scale_short):
    unslow(_obj)
