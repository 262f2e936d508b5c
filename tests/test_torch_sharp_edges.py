"""All of tests/test_round3_sharp_edges.py run against the port with the
reference's assertions (`torch_parity.port_cases`), each on a port
session in place of conftest.py's `session` fixture: count-scalar
correlated subqueries, the per-table eviction budget, critical-memory
fail-fast and string murmur3 bucketing."""

import pytest

from torch_parity import (_ledger_per_test, case_names,  # noqa: F401
                          front_door_env, port_cases)


@pytest.fixture()
def session():
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog

    sess = SnappySession(catalog=Catalog(), device="cpu")
    yield sess
    sess.stop()


globals().update(port_cases("test_round3_sharp_edges.py",
                            case_names("test_round3_sharp_edges.py")))
