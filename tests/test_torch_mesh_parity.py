"""Cross-package parity of multi-slot execution: the same seeded rows
through a reference session on an 8-device mesh (its 8 XLA host
devices) and a port session on 8 CPU shard slots, under both plate
policies, with small column batches so every table spans the slots.
Q1, Q6, the min / max / avg / HAVING shape, NULL group keys, a table with
fewer batches than slots and Q3C under broadcast and under shuffle agree
at the parity bar (`torch_parity.assert_rows_equal`), take the same lane
(equal `mesh_shard_execs`, `mesh_join_*` deltas) and fall back nowhere;
then again after `resize_mesh(8 -> 4 -> 8)` on both sessions, with equal
moved-bucket counts.  The padding ladder, the shard placement and the
bucket map, the device-side murmur3 buckets and the shuffle's exchange
plan are held equal across the packages on their own."""

import numpy as np
import pytest
import torch

from snappydata_tpu import config as ref_config
from snappydata_tpu.engine import mesh_exec as ref_mesh_exec
from snappydata_tpu.parallel.hashing import bucket_of_np as ref_bucket_of
from snappydata_tpu.parallel import data_mesh as ref_data_mesh
from snappydata_tpu.parallel import mesh as ref_mesh
from snappydata_tpu.parallel import placement as ref_placement
from snappydata_tpu.parallel.buckets import BucketMap as RefBucketMap
from snappydata_tpu_torch import config
from snappydata_tpu_torch.engine import mesh_exec
from snappydata_tpu_torch.parallel import data_mesh
from snappydata_tpu_torch.parallel import mesh
from snappydata_tpu_torch.parallel import placement
from snappydata_tpu_torch.parallel.buckets import BucketMap
from snappydata_tpu_torch.parallel.hashing import bucket_of_torch
from snappydata_tpu_torch.utils import tpch
from torch_parity import (POLICIES, Pair, _ledger_per_test,  # noqa: F401
                          front_door_env, mesh_slots, policy)

ROUTED = ("host_fallbacks", "mesh_shard_execs", "mesh_psum_merges",
          "mesh_join_broadcast", "mesh_join_shuffle")

QUERIES = {
    "q1": tpch.Q1,
    "q6": tpch.Q6,
    "shapes": ("SELECT l_returnflag, min(l_quantity), max(l_extendedprice), "
               "avg(l_discount), count(*) FROM lineitem "
               "WHERE l_shipdate > DATE '1994-01-01' "
               "GROUP BY l_returnflag HAVING count(*) > 10 "
               "ORDER BY l_returnflag"),
    "null_keys": ("SELECT grp, count(*), sum(v), min(v) FROM nk "
                  "GROUP BY grp ORDER BY grp"),
    "null_bigint_keys": ("SELECT g, grp, count(*), sum(v) FROM nk "
                         "GROUP BY g, grp ORDER BY g, grp"),
    "tiny": "SELECT k % 3, sum(v), count(*) FROM tiny GROUP BY k % 3 "
            "ORDER BY 1",
    "tiny_global": "SELECT sum(v), count(*), max(k) FROM tiny",
}


@pytest.fixture(scope="module", params=POLICIES)
def pair(request):
    """A reference and a port session with the same rows in 2,048-row
    batches (TPC-H lineitem / orders at SF 0.01 over 30 / 8 batches, the
    NULL-keyed `nk`, the one-batch `tiny`), each with an 8-slot
    `default_mesh`."""
    props = (ref_config.global_properties(), config.global_properties())
    saved = [p.column_batch_rows for p in props]
    with mesh_slots(8):
        for p in props:
            p.column_batch_rows = 2048
        try:
            pr = Pair(request.param, routed=ROUTED)
            with policy(request.param):
                for s in (pr.ref, pr.port):
                    tpch.load_tpch(s, sf=0.01, seed=17)
            pr.sql("CREATE TABLE nk (g BIGINT, grp STRING, v DOUBLE) "
                   "USING column")
            rng = np.random.default_rng(5)
            g = rng.integers(0, 4, 6000)
            gnull = rng.random(6000) < 0.1
            grp = np.array(["a", "b", "c"], dtype=object)[
                rng.integers(0, 3, 6000)]
            v = rng.normal(size=6000)
            pr.insert_arrays("nk", [g.astype(np.int64), grp, v],
                             nulls=[gnull, None, None])
            pr.sql("CREATE TABLE tiny (k BIGINT, v DOUBLE) USING column")
            pr.insert_arrays("tiny", [np.arange(50, dtype=np.int64),
                                      np.arange(50, dtype=np.float64)])
            for s in (pr.ref, pr.port):
                for t in ("lineitem", "orders", "nk", "tiny"):
                    s.catalog.describe(t).data.force_rollover()
        finally:
            for p, old in zip(props, saved):
                p.column_batch_rows = old
        pr.ref.default_mesh = ref_data_mesh(8)
        pr.port.default_mesh = data_mesh(8)
        yield pr
        pr.ref.stop()
        pr.port.stop()


def _join_strategy(name):
    for p in (ref_config.global_properties(), config.global_properties()):
        p.mesh_join_strategy = name


def _check_all(pr):
    """Every query through both meshes: equal rows, equal lane deltas."""
    for name, q in QUERIES.items():
        pr.run(q)
    moved = {}
    try:
        for strategy in ("broadcast", "shuffle"):
            _join_strategy(strategy)
            _rows, moved[strategy] = pr.run(tpch.Q3C)
            assert moved[strategy]["mesh_join_" + strategy] == 1, moved
    finally:
        _join_strategy("auto")
    return moved


def test_queries_on_eight_slots(pair):
    with mesh_slots(8):
        _rows, moved = pair.run(tpch.Q1)
        assert moved["mesh_shard_execs"] == 1
        _check_all(pair)


def test_queries_after_resize(pair):
    with mesh_slots(8):
        for n in (4, 8):
            got = [s.resize_mesh(n) for s in (pair.ref, pair.port)]
            assert got[1]["num_devices"] == got[0]["num_devices"] == n
            assert got[1]["buckets_moved"] == got[0]["buckets_moved"] > 0
            _check_all(pair)


def test_padding_placement_and_bucket_map_equal_the_references():
    for s in range(1, 9):
        assert [mesh.shard_bucket(n, s) for n in range(1, 4097)] == \
            [ref_mesh.shard_bucket(n, s) for n in range(1, 4097)], s
    assert [mesh._ladder(n) for n in range(1, 4097)] == \
        [ref_mesh._ladder(n) for n in range(1, 4097)]
    for nb in (0, 32, 48):
        p = placement.ShardPlacement.balanced(8, nb)
        r = ref_placement.ShardPlacement.balanced(8, nb)
        assert (p.num_buckets, p.assignment) == (r.num_buckets, r.assignment)
        p4, r4 = p.rebalance(4), r.rebalance(4)
        assert (p4.assignment, p4.moved_from_previous) == \
            (r4.assignment, r4.moved_from_previous)
        assert p4.bucket_map() == r4.bucket_map()
        assert [p.bucket_of_batch(b, 24) for b in range(24)] == \
            [r.bucket_of_batch(b, 24) for b in range(24)]
    keys = np.random.default_rng(3).integers(-10**12, 10**12, 5000)
    for nb, nm, red in ((16, 4, 1), (113, 3, 2), (64, 5, 0)):
        bm, rm = BucketMap(nb, nm, red), RefBucketMap(nb, nm, red)
        assert [bm.members_of(b) for b in range(nb)] == \
            [rm.members_of(b) for b in range(nb)]
        assert (bm.member_for_rows(keys) == rm.member_for_rows(keys)).all()
        assert (bm.bucket_for_rows(keys) == rm.bucket_for_rows(keys)).all()


def test_device_buckets_and_exchange_plan_equal_the_references():
    """murmur3 buckets computed on the keys' device equal the reference's
    numpy buckets bit for bit (edge values included), and the shuffle's
    exchange plan (perm, live mask, padded batches, moved rows) equals
    the reference's host plan for the same keys and validity."""
    rng = np.random.default_rng(9)
    keys = np.concatenate([
        rng.integers(-2 ** 63, 2 ** 63 - 1, 50_000, dtype=np.int64),
        np.array([0, -1, 1, 2 ** 63 - 1, -2 ** 63, 2 ** 31, -2 ** 31,
                  2 ** 32, 7 - 2 ** 63], dtype=np.int64)])
    for n in (1, 2, 3, 4, 8):
        assert (bucket_of_torch(torch.from_numpy(keys), n).numpy()
                == ref_bucket_of(keys, n)).all(), n
    cap = 256
    for nd, b, frac in ((8, 24, 0.9), (4, 16, 0.3), (3, 9, 1.0)):
        k = rng.integers(0, 5000, b * cap).astype(np.int64)
        valid = rng.random(b * cap) < frac
        want = ref_mesh_exec._bucket_layout(k, valid, cap, nd, b)
        got = mesh_exec._bucket_layout(torch.from_numpy(k),
                                       torch.from_numpy(valid), cap, nd, b)
        assert (got[0].numpy() == want[0]).all()
        assert (got[1].numpy() == want[1]).all()
        assert got[2:] == want[2:]


def test_resize_with_a_bound_row_table_repairs_the_references_fault():
    """A row table bound under an 8-slot mesh, then `resize_mesh(4)`: the
    reference raises AttributeError (its `migrate_mesh_cache` reads the
    row table's cached DeviceTable as a dict of plates,
    snappydata_tpu/storage/device.py:1009); the port re-keys the
    replicated row table onto the new mesh and answers as before."""
    from snappydata_tpu import SnappySession as RefSession
    from snappydata_tpu.catalog import Catalog as RefCatalog
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog

    with mesh_slots(8):
        ref = RefSession(catalog=RefCatalog())
        port = SnappySession(catalog=Catalog(), device="cpu")
        rows = []
        for s, mesh_of in ((ref, ref_data_mesh), (port, data_mesh)):
            s.sql("CREATE TABLE r (id INT PRIMARY KEY, v DOUBLE) USING row")
            s.sql("INSERT INTO r VALUES (1, 2.0), (2, 3.0), (3, 4.5)")
            s.default_mesh = mesh_of(8)
            rows.append(s.sql("SELECT count(*), sum(v) FROM r").rows())
        assert rows[0] == rows[1] == [(3, 9.5)]
        with pytest.raises(AttributeError):
            ref.resize_mesh(4)
        moved = port.resize_mesh(4)
        assert moved["num_devices"] == 4 and moved["cache_entries_moved"] == 1
        assert port.sql("SELECT count(*), sum(v) FROM r").rows() == rows[1]
        ref.stop()
        port.stop()
