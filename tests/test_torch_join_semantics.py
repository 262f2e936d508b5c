"""All of tests/test_join_semantics.py run against the port with the
reference's assertions (`torch_parity.port_cases`): non-equi inner joins,
outer joins with residual predicates, pure non-equi outer joins and
EXISTS, cross joins and NULL keys in outer joins."""

from torch_parity import (_ledger_per_test, case_names,  # noqa: F401
                          front_door_env, port_cases)

globals().update(port_cases("test_join_semantics.py",
                            case_names("test_join_semantics.py")))
