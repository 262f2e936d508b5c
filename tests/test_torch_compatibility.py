"""All of tests/test_compatibility.py run against the port with the
reference's assertions (`torch_parity.port_cases`): SQL operators, string
and math functions, stddev / variance, count(DISTINCT), GROUP BY
expressions, identifiers, ORDER BY, UNION, BETWEEN / IN, CASE, coalesce,
date parts, self joins, derived tables, LIMIT 0 and prepared parameters,
each against the reference's pandas frame."""

from torch_parity import (_ledger_per_test, case_names,  # noqa: F401
                          front_door_env, port_cases)

globals().update(port_cases("test_compatibility.py",
                            case_names("test_compatibility.py")))
