"""Where the port's mesh puts its slots and their plates, on the CPU:

- a CPU session's mesh stays on the CPU where cards are visible (its
  slots, a resize, a server's submesh, the per-slot ledger), and the
  multi-host world picks its backend from the device asked for;
- a slot on another card than the mesh's home device reads a copy of its
  block made once at the bind, not one per query, and the per-slot
  ledger counts each block where it resides (the other card stands in as
  torch's `meta` device, which holds shapes but no data);
- a mesh bind that shares the single-device entry's plates is charged
  once under the device cache budget, and so is its migrated entry."""

import contextlib
import types

import numpy as np
import pytest
import torch

from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.parallel import mesh as pm
from snappydata_tpu_torch.parallel import multihost
from snappydata_tpu_torch.storage import device as sd

_REAL_DEFAULT = pm._default_device


@contextlib.contextmanager
def mesh_slots(n):
    """`n` shard slots a process, on the CPU for a mesh that names no
    device (torch_parity's helper, kept here so this file imports nothing
    of the reference and runs on a machine with a card as well)."""
    props = config.global_properties()
    old = props.mesh_slots
    props.mesh_slots = n
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pm, "_default_device", lambda: torch.device("cpu"))
            yield
    finally:
        props.mesh_slots = old


def _table(s, name, batches):
    s.sql(f"CREATE TABLE {name} (g BIGINT, v DOUBLE) USING column")
    data = s.catalog.describe(name).data
    n = 0
    for _ in range(batches):
        k = data.capacity
        s.insert_arrays(name, [np.arange(n, n + k) % 5,
                               np.arange(n, n + k, dtype=np.float64)])
        data.force_rollover()
        n += k
    return data, n


def test_cpu_session_mesh_stays_on_the_cpu_with_cards_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with mesh_slots(4):
        monkeypatch.setattr(pm, "_default_device", _REAL_DEFAULT)
        # a mesh that names no device takes the (visible) cards ...
        assert [str(sl.device) for sl in pm.data_mesh(2).slots] == \
            ["cuda:0", "cuda:1"]
        s = SnappySession(catalog=Catalog(), device="cpu")
        # ... and the CPU session re-homes it onto the CPU
        s.default_mesh = pm.data_mesh(2)
        assert [sl.index for sl in s.default_mesh.slots] == [0, 1]
        assert {sl.device for sl in s.default_mesh.slots} == \
            {torch.device("cpu")}
        data, n = _table(s, "dv", 2)
        assert s.sql("SELECT count(*), sum(v) FROM dv").rows() == \
            [(n, float(n * (n - 1) // 2))]
        keys = set(sd.device_cache_bytes_by_device([("dv", data)]))
        assert keys == {"slot0:cpu", "slot1:cpu"}, keys
        s.resize_mesh(4)
        assert {sl.device for sl in s.default_mesh.slots} == \
            {torch.device("cpu")}
        assert s.sql("SELECT count(*) FROM dv").rows() == [(n,)]
        keys = set(sd.device_cache_bytes_by_device([("dv", data)]))
        assert keys == {f"slot{i}:cpu" for i in range(4)}, keys
        # an explicit context of cards does not move a CPU statement there
        with pytest.raises(ValueError, match="slots sit on cuda"):
            with pm.MeshContext(pm.data_mesh(2)):
                s.sql("SELECT count(*), sum(v) FROM dv").rows()
        s.stop()

        from snappydata_tpu_torch.cluster import ServerNode

        srv = SnappySession(catalog=Catalog(), device="cpu")
        ServerNode("127.0.0.1:1", srv, mesh_devices=[2, 3])
        assert [str(sl) for sl in srv.default_mesh.slots] == \
            ["slot2:cpu", "slot3:cpu"]
        assert multihost.local_device_indices("cpu") == [0, 1, 2, 3]

    seen = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: seen.append(kw["backend"]))
    for dev, backend in (("cpu", "gloo"), ("cuda", "nccl"),
                         (None, "nccl")):
        monkeypatch.setattr(multihost, "_initialized", False)
        assert multihost.initialize_multihost("127.0.0.1:1", 1, 0,
                                              device=dev)
        assert seen[-1] == backend
    monkeypatch.setattr(multihost, "_initialized", False)


def test_remote_slot_reads_its_bind_time_block_copy():
    cpu, card = torch.device("cpu"), torch.device("meta")
    mesh = pm.Mesh([pm.Slot(0, cpu), pm.Slot(1, card)])
    ctx = pm.MeshContext(mesh)
    plate = torch.arange(8, dtype=torch.int64).reshape(4, 2)
    assert pm.place_remote_blocks(plate, mesh) == 2 * 2 * 8
    # a second placement finds the copy already there
    assert pm.place_remote_blocks(plate, mesh) == 0
    copies = pm.block_copies()
    home_block = ctx.block(plate, 0)
    assert home_block.data_ptr() == plate.data_ptr()
    remote = ctx.block(plate, 1)
    assert remote.device == card and tuple(remote.shape) == (2, 2)
    assert ctx.block(plate, 1) is remote
    assert pm.block_copies() == copies

    # the ledger: the home slot's block, the remote slot's copy, and the
    # remote block's bytes the home card keeps in the whole plate
    data = types.SimpleNamespace(_device_cache={
        (1, ctx.token, None): {"valid": plate, "mesh": ctx}})
    assert sd.device_cache_bytes_by_device([("t", data)]) == {
        "slot0:cpu": 32, "slot1:meta": 32, "cpu": 32}
    assert sd._entry_bytes(data._device_cache[(1, ctx.token, None)]) \
        == 64 + 32

    # a plate the bind never placed crosses per query, counted
    other = torch.zeros(4, 2)
    assert ctx.block(other, 1).device == card
    assert pm.block_copies() == copies + 1

    # a resize drops the copies of the old block ranges
    mesh3 = pm.Mesh([pm.Slot(0, cpu), pm.Slot(1, card), pm.Slot(2, card)])
    wide = torch.zeros(6, 2)
    pm.place_remote_blocks(wide, mesh)
    assert len(pm.remote_blocks_of(wide)) == 1
    pm.place_remote_blocks(wide, mesh3)
    assert sorted(tuple(c.shape) for c in pm.remote_blocks_of(wide)) == \
        [(2, 2), (2, 2)]
    # the copies go with their plate
    del plate, data, home_block
    assert len(pm._remote_blocks) == 2


def test_mesh_bind_shares_plates_charged_once():
    props = config.global_properties()
    saved = props.device_cache_bytes
    props.device_cache_bytes = 1 << 40
    try:
        with mesh_slots(2):
            s = SnappySession(catalog=Catalog(), device="cpu")
            data, n = _table(s, "bud", 2)
            q = "SELECT g, count(*), sum(v) FROM bud GROUP BY g ORDER BY g"
            single = s.sql(q).rows()
            charged = sd._cache_budget.charged_bytes(data._device_cache)
            assert charged > 0
            held = sd.device_cache_bytes_by_table([("bud", data)])["bud"]
            assert held > 0
            s.default_mesh = pm.data_mesh(2)
            execs = global_registry().counter("mesh_shard_execs")
            assert s.sql(q).rows() == single
            assert global_registry().counter("mesh_shard_execs") == \
                execs + 1
            # the mesh entry's plates are the single-device entry's: the
            # table holds and is charged the same bytes as before
            assert sd.device_cache_bytes_by_table([("bud", data)])[
                "bud"] == held
            assert sd._cache_budget.charged_bytes(data._device_cache) \
                == charged
            # a resize re-keys the mesh entry: still charged once
            assert s.resize_mesh(1)["cache_entries_moved"] >= 1
            assert sd._cache_budget.charged_bytes(data._device_cache) \
                == charged
            assert s.sql(q).rows() == single
            s.stop()
    finally:
        props.device_cache_bytes = saved


@pytest.fixture(autouse=True)
def _no_leftover_blocks():
    yield
    pm._remote_blocks.clear()
