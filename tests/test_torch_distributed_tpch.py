"""All 22 TPC-H queries at SF 0.004 through the port's DistributedSession
over three port servers, each equal to the port's single session, and the
file's four other cases (the over-budget refusal, the gather cache's
invalidation, windows, ROLLUP): the reference's
tests/test_tpch_distributed.py run against the port with its own
assertions (`torch_parity.port_cases`).

The reference marks the file slow at module level; the port's copies take
about fifteen seconds together here, so none of them is marked slow."""

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          port_cases)

globals().update(port_cases("test_tpch_distributed.py", [
    "cluster", "_norm", "test_tpch_query_distributed_equals_single_node",
    "test_unsupported_over_budget_is_explicit",
    "test_gather_cache_invalidates_on_mutation",
    "test_distributed_windows_equal_single_node",
    "test_distributed_rollup_equals_single_node"]))
