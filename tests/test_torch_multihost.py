"""Multi-host wiring of the port on torch.distributed
(snappydata_tpu_torch/parallel/multihost.py), each case run with the
reference's assertions (`torch_parity.port_cases`):

- all of tests/test_multihost.py: the no-op without a coordinator, the
  SNAPPY_* env and the flag precedence, and the local slot indices of one
  host (8 shard slots on the CPU) with a 4-slot submesh;
- tests/test_multihost_real.py: two real processes join one gloo world
  through `initialize_multihost` (4 slots each, 8 global) and all-reduce
  across the process boundary; then two `python -m snappydata_tpu_torch
  server --coordinator ...` processes each take their rank's local slots
  as their submesh under a distributed session.

Edits: the reference monkeypatches `jax.distributed.initialize`; the
port's cases patch `torch.distributed.init_process_group` (the
coordinator read back off its `tcp://` init method).  The single-host
slot list is `parallel.mesh.slots()`, not `jax.devices()`.  The real
worker's collective is a `torch.distributed.all_reduce` over gloo of each
rank's half of the same 800-value range, the processes get
`SNAPPY_MESH_SLOTS` instead of `XLA_FLAGS`, and the servers run with
`--device cpu`.  The reference marks test_multihost_real.py slow at
module level; its two cases take seconds here, so the copies are
unmarked."""

import re

import pytest

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          eight_slots, port_cases)


@pytest.fixture(scope="module", autouse=True)
def _slots(eight_slots):  # noqa: F811
    yield


globals().update(port_cases("test_multihost.py", [
    "fresh", "test_noop_without_coordinator", "test_env_configuration",
    "test_flag_overrides_env", "test_local_device_indices_single_host"],
    edits=[
        ("""    def fake_init(coordinator_address, num_processes, process_id):
        calls.update(coordinator=coordinator_address,
                     n=num_processes, pid=process_id)

    import jax

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)""",
         """    def fake_init(backend, init_method, world_size, rank, timeout):
        calls.update(coordinator=init_method[len("tcp://"):],
                     n=world_size, pid=rank)

    import torch.distributed as tdist

    monkeypatch.setattr(tdist, "init_process_group", fake_init)"""),
        ("""    import jax

    monkeypatch.setattr(
        jax.distributed, "initialize",
        lambda coordinator_address, num_processes, process_id:
        calls.update(c=coordinator_address, n=num_processes,
                     p=process_id))""",
         """    import torch.distributed as tdist

    monkeypatch.setattr(
        tdist, "init_process_group",
        lambda backend, init_method, world_size, rank, timeout:
        calls.update(c=init_method[len("tcp://"):], n=world_size,
                     p=rank))"""),
        ("""    import jax

    assert idx == list(range(len(jax.devices())))""",
         """    from snappydata_tpu.parallel import mesh as _mesh

    assert idx == list(range(len(_mesh.slots())))"""),
    ]))

_WORKER = '''
import sys
rank = int(sys.argv[1]); port = sys.argv[2]
from snappydata_tpu_torch.parallel.multihost import (initialize_multihost,
                                                     local_device_indices,
                                                     shutdown)
assert initialize_multihost(f"127.0.0.1:{port}", 2, rank)
import torch, torch.distributed as dist
from snappydata_tpu_torch.parallel import mesh
devs = mesh.slots()
assert len(devs) == 8, devs
local = local_device_indices()
assert local == list(range(rank * 4, rank * 4 + 4)), (rank, local)
n = 800
part = torch.arange(n, dtype=torch.float64)[rank * 400:(rank + 1) * 400]
total = part.sum()
dist.all_reduce(total)
got = float(total)
assert got == n * (n - 1) / 2, got
print(f"rank {rank}: OK global=8 local={local} sum={got}", flush=True)
shutdown()
'''

globals().update(port_cases("test_multihost_real.py", [
    "test_two_process_jax_distributed_collective",
    "test_cli_cluster_multihost_composed"], edits=[
        (re.compile(r"_WORKER = '''.*?'''", re.S),
         lambda _m: "_WORKER = " + repr(_WORKER)),
        ('''            "XLA_FLAGS":
            f"--xla_force_host_platform_device_count={n_local}"}''',
         '''            "SNAPPY_MESH_SLOTS": str(n_local),
            "SNAPPY_DIST_TIMEOUT_S": "120"}'''),
        ('''                 "--num-processes", "2", "--process-id", str(rank)],''',
         '''                 "--num-processes", "2", "--process-id", str(rank),
                 "--device", "cpu"],'''),
    ], rename={"test_two_process_jax_distributed_collective":
               "test_two_process_torch_distributed_collective"}))
