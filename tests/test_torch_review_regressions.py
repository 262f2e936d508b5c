"""All of tests/test_review_regressions.py run against the port with the
reference's assertions (`torch_parity.port_cases`): numeric NULLs through
insert, rollover, UPDATE and row tables, lag over NULLs, prepared
parameters, the plan cache after a re-create, self joins, CTAS IF NOT
EXISTS and duplicate build keys."""

from torch_parity import (_ledger_per_test, case_names,  # noqa: F401
                          front_door_env, port_cases)

globals().update(port_cases("test_review_regressions.py",
                            case_names("test_review_regressions.py")))
