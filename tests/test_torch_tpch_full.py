"""All of tests/test_tpch_full.py run against the port with the
reference's assertions (`torch_parity.port_cases`): the TPC-H queries
against pandas oracles.  The reference file is marked `slow` as a whole,
and so is this one: tier-1 leaves it out, as it leaves the reference's."""

import pytest

from torch_parity import (_ledger_per_test, case_names,  # noqa: F401
                          front_door_env, port_cases)

pytestmark = pytest.mark.slow

globals().update(port_cases("test_tpch_full.py",
                            case_names("test_tpch_full.py")))
