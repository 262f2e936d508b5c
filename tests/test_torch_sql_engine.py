"""All of tests/test_sql_engine.py run against the port with the
reference's assertions (`torch_parity.port_cases`): DDL, filters and
projections, string and generic GROUP BY, joins, DML, row tables, NULLs,
IN / BETWEEN / LIKE, DISTINCT and UNION, the plan cache, subqueries in
FROM, date functions, count(DISTINCT), the device-cache budget, batch
skipping, views and the early-stopping take."""

from torch_parity import (_ledger_per_test, case_names,  # noqa: F401
                          front_door_env, port_cases)

globals().update(port_cases("test_sql_engine.py",
                            case_names("test_sql_engine.py")))
