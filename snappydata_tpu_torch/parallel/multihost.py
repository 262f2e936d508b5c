"""Multi-host initialization on torch.distributed.

Port of snappydata_tpu/parallel/multihost.py.  The reference joins its
processes with `jax.distributed.initialize`, after which `jax.devices()`
spans every host.  The port joins them into one `torch.distributed`
process group (`tcp://` rendezvous at the coordinator; gloo on the CPU,
NCCL for CUDA), after which the global slot list (parallel/mesh.py
`slots()`) is world size x local slots, rank-major, and
`local_device_indices()` gives this rank's.

Topology composition with the cluster plane:
- one snappydata server process per HOST, each joining the locator;
- each process calls `initialize_multihost()` at boot with the shared
  coordinator address;
- the server's submesh (`ServerNode(mesh_devices=...)`) then selects its
  LOCAL slots out of the global list (`local_device_indices()`), while
  cross-server exchanges keep riding Arrow Flight.

Configuration (flags or environment; flags win):
  SNAPPY_COORDINATOR=host:port   the rank-0 rendezvous endpoint
  SNAPPY_NUM_PROCESSES=N         world size
  SNAPPY_PROCESS_ID=i            this process's rank
  SNAPPY_DIST_TIMEOUT_S=s        how long `init_process_group` waits for
                                 every rank to join (default 120)

NCCL refuses two ranks on one GPU, so a CUDA world needs a card per rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

_initialized = False


def _dist():
    import torch.distributed as dist

    return dist


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device=None) -> bool:
    """Join the torch.distributed world from args or SNAPPY_* env.
    Returns False (no-op) when no coordinator is configured — single-host
    deployments need nothing.  Safe to call twice (the second call is a
    no-op).  Blocks until every rank has joined or the timeout passes.
    The backend follows the device the process runs on (`device`; by
    default cuda where there is a card): gloo for cpu, NCCL for cuda."""
    global _initialized
    if _initialized:
        return True
    coordinator = coordinator or os.environ.get("SNAPPY_COORDINATOR")
    if not coordinator:
        return False
    num_processes = num_processes if num_processes is not None else \
        int(os.environ.get("SNAPPY_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else \
        int(os.environ.get("SNAPPY_PROCESS_ID", "0"))
    if backend is None:
        import torch

        typ = torch.device(device).type if device is not None else (
            "cuda" if torch.cuda.is_available() else "cpu")
        backend = "nccl" if typ == "cuda" else "gloo"
    timeout = float(os.environ.get("SNAPPY_DIST_TIMEOUT_S", "120"))
    _dist().init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    _initialized = True
    return True


def shutdown() -> None:
    """Leave the world (`destroy_process_group`); a no-op when none."""
    global _initialized
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_count() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def process_index() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def local_device_indices(device=None) -> list:
    """Indices (into the GLOBAL slot list) of THIS process's slots on
    devices of `device`'s type — what a per-host ServerNode passes as
    `mesh_devices` so its submesh covers exactly the slots it hosts."""
    from snappydata_tpu_torch.parallel import mesh

    return [s.index for s in mesh.local_slots(device)]
