"""All of tests/test_disk_full_and_socket.py run against the port with
the reference's assertions (`torch_parity.port_cases`): ENOSPC in the
middle of a durable ingest and of a checkpoint leaves a store that
reopens consistent, and the socket stream source."""

from torch_parity import (_ledger_per_test, case_names,  # noqa: F401
                          front_door_env, port_cases)

globals().update(port_cases("test_disk_full_and_socket.py",
                            case_names("test_disk_full_and_socket.py")))
