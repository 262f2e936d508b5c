"""All of tests/test_tpu_numerics.py run against the port with the
reference's assertions (`torch_parity.port_cases`): under the float32
plate policy a million-row sum and TPC-H Q1's aggregates stay within
1e-6 of float64 oracles."""

from torch_parity import (_ledger_per_test, case_names,  # noqa: F401
                          front_door_env, port_cases)

globals().update(port_cases("test_tpu_numerics.py",
                            case_names("test_tpu_numerics.py")))
