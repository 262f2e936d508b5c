"""The port's mesh fences and the mesh cases of other reference files,
each run against the port with the reference's assertions
(`torch_parity.port_cases`) on 8 shard slots of the CPU:

- all of tests/test_mesh_fence.py: the join artifact's eager sort and
  expansion bound hold `parallel.mesh_dispatch` under a mesh and not
  without one, and two threads' meshed joins agree with the oracle;
- tests/test_reliability_failpoints.py's `mesh.dispatch` cases (the seam
  is a known point, and a sleep there delays);
- test_agg_on_codes.py::test_mesh_lane_matches_single_device and
  test_decimal_exact.py::test_mesh_sharded_sum_exact (an exact DECIMAL
  sum under the mesh declines the per-slot lane and stays exact)."""

import pytest

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          eight_slots, port_cases)


@pytest.fixture(scope="module", autouse=True)
def _slots(eight_slots):  # noqa: F811
    yield


globals().update(port_cases("test_mesh_fence.py", [
    "fence_spy", "test_eager_join_binds_fenced_under_mesh",
    "test_eager_join_binds_unfenced_without_mesh",
    "test_concurrent_meshed_joins_do_not_interleave"]))
globals().update(port_cases("test_reliability_failpoints.py", [
    "_clean", "test_sleep_action_delays",
    "test_known_points_cover_the_seams"]))
globals().update(port_cases("test_agg_on_codes.py", [
    "_restore_knobs", "test_mesh_lane_matches_single_device"]))
globals().update(port_cases("test_decimal_exact.py", [
    "test_mesh_sharded_sum_exact"]))
