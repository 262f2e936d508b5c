"""The distributed session's other surfaces through the port, each a
reference case run with its own assertions (`torch_parity.port_cases`):
plan shipping (tests/test_plan_shipping.py's cluster cases: ship-first
by default with counted downgrades, and with the SQL renderer disabled),
the streamed exchanges (tests/test_streamed_exchange.py), the fan-out
error's failed addresses and attempts (tests/test_failpoints.py), exact
decimal sums across servers (tests/test_decimal_exact.py), the trace id
of a DistributedError and one lead trace across two servers
(tests/test_observability.py), the advisor's distributed findings and
WITH ERROR over a cluster (tests/test_round4_advisor.py).

The reference marks tests/test_streamed_exchange.py slow at module level
and the plan-shipping, decimal, advisor and estimator cases on their own; the
port's copies take seconds here (the forced-shipping TPC-H battery about
six), so none of them is marked slow."""

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          port_cases, unslow)


globals().update(port_cases("test_plan_shipping.py", [
    "test_ship_first_is_the_default_path", "TestForcedPlanShipping",
    "test_tpch_distributed_forced_shipping"]))
globals().update(port_cases("test_streamed_exchange.py", [
    "cluster", "test_iter_table_chunks_bounded_and_complete",
    "test_scan_table_streams_record_batches",
    "test_streamed_broadcast_join_correct",
    "test_streamed_shuffle_join_correct"]))
globals().update(port_cases("test_failpoints.py", [
    "test_fan_error_carries_failed_addresses_and_attempts"], edits=[
    ("""from snappydata_tpu.fault.failpoints import (FailpointRegistry,
                                             FaultConnectionDropped,
                                             FaultError)
""", "")]))
globals().update(port_cases("test_decimal_exact.py", [
    "_money", "test_distributed_sum_exact"]))
globals().update(port_cases("test_observability.py", [
    "test_errors_carry_trace_id",
    "test_trace_propagates_across_two_server_cluster"]))
globals().update(port_cases("test_round4_advisor.py", [
    "TestDistributedAdvisorFindings",
    "test_with_error_distributed_estimation"]))
for _obj in (test_ship_first_is_the_default_path, TestForcedPlanShipping,
             test_tpch_distributed_forced_shipping, test_distributed_sum_exact,
             TestDistributedAdvisorFindings,
             test_with_error_distributed_estimation):
    unslow(_obj)
