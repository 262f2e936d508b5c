"""The distributed session across the packages: the same seeded rows go
through a reference `DistributedSession` over three reference
`ServerNode`s and a port one over three port `ServerNode`s (device
`cpu`), under both plate policies.  Routing must be the reference's
bucket for bucket (equal per-server row counts); every scatter shape
(Q1, Q6, a filtered GROUP BY, a scan concat, a replicated join, a
collocated join, a broadcast and a shuffle exchange) gives the
reference's rows at the parity bar, makes the reference's exchange
temps and downgrades nothing, before and after fanned-out UPDATEs and
DELETEs.  Then the lead's float64 merge under the float32 policy."""

import contextlib

import numpy as np
import pytest

from torch_parity import (REL, _ledger_per_test, assert_rows_equal,  # noqa
                          clusters, front_door_env, policy)

N_ROWS = 24_000


def _data(seed=5):
    """Seeded numpy rows of every table, as both packages take them."""
    from snappydata_tpu_torch.utils import tpch

    li = tpch.gen_lineitem(N_ROWS, seed)
    orders = tpch.gen_orders(N_ROWS // 4, seed + 1)
    li["l_orderkey"] = np.minimum(li["l_orderkey"], N_ROWS // 4)
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 5000, N_ROWS).astype(np.int64)
    region = np.array(["e", "w", "n"], dtype=object)[
        rng.integers(0, 3, N_ROWS)]
    amt = np.round(rng.random(N_ROWS) * 100, 2)
    parts = np.arange(1, 4001, dtype=np.int64)
    return {"lineitem": li, "orders": orders,
            "tx": {"k": k, "region": region, "amt": amt},
            "part_w": {"p_partkey": parts, "p_grp": parts % 13,
                       "p_weight": np.round(parts * 0.25 % 17, 2)}}


def _load(ds, tpch, data):
    ds.sql(tpch.LINEITEM_DDL)
    ds.sql(tpch.ORDERS_DDL)
    ds.sql("CREATE TABLE tx (k BIGINT, region STRING, amt DOUBLE) "
           "USING column OPTIONS (partition_by 'k')")
    ds.sql("CREATE TABLE dim (code STRING, label STRING) USING column")
    ds.sql("CREATE TABLE part_w (p_partkey BIGINT, p_grp BIGINT, "
           "p_weight DOUBLE) USING column OPTIONS (partition_by 'p_grp')")
    for name in ("lineitem", "orders", "tx", "part_w"):
        ds.insert_arrays(name, [np.array(a, copy=True)
                                for a in data[name].values()])
    ds.sql("INSERT INTO dim VALUES ('e', 'east'), ('w', 'west'), "
           "('n', 'north')")


QUERIES = {
    "q1": None, "q6": None,
    "filtered_group_by": "SELECT region, count(*) AS c, sum(amt) AS t "
                         "FROM tx WHERE amt > 50 GROUP BY region "
                         "ORDER BY region",
    "scan_concat": "SELECT k, region, amt FROM tx WHERE amt > 90.0 "
                   "ORDER BY k, amt, region",
    "replicated_join": "SELECT d.label, count(*), sum(t.amt) FROM tx t "
                       "JOIN dim d ON t.region = d.code GROUP BY d.label "
                       "ORDER BY d.label",
    "collocated_join": "SELECT o.o_orderpriority, count(*), "
                       "sum(l.l_extendedprice) FROM lineitem l JOIN orders "
                       "o ON l.l_orderkey = o.o_orderkey GROUP BY "
                       "o.o_orderpriority ORDER BY o.o_orderpriority",
    # neither side is partitioned on its join column: the small side is
    # broadcast within hash_join_size, and below it both sides are
    # shuffled onto the join keys
    "broadcast_exchange": "SELECT l.l_returnflag, count(*), sum(p.p_weight) "
                          "FROM lineitem l JOIN part_w p ON l.l_partkey = "
                          "p.p_partkey GROUP BY l.l_returnflag "
                          "ORDER BY l.l_returnflag",
    "shuffle_exchange": "SELECT l.l_returnflag, count(*), sum(p.p_weight) "
                        "FROM lineitem l JOIN part_w p ON l.l_partkey = "
                        "p.p_partkey GROUP BY l.l_returnflag "
                        "ORDER BY l.l_returnflag",
}


@contextlib.contextmanager
def _join_budget(nbytes):
    from snappydata_tpu import config as ref_config
    from snappydata_tpu_torch import config

    props = (ref_config.global_properties(), config.global_properties())
    saved = [p.hash_join_size for p in props]
    for p in props:
        p.hash_join_size = nbytes
    try:
        yield
    finally:
        for p, old in zip(props, saved):
            p.hash_join_size = old


def _run_all(ref, port, name, tag):
    """Every query through both leads: rows at the parity bar, and the
    same exchange temps made."""
    for q, sql in QUERIES.items():
        sql = sql or getattr(port.tpch, q.upper())
        budget = 0 if q == "shuffle_exchange" else 100 * 1024 * 1024
        rows = {}
        with _join_budget(budget):
            for c in (ref, port):
                rows[c] = [tuple(r) for r in c.ds.sql(sql).rows()]
        assert rows[port], (tag, q)
        assert_rows_equal(rows[port], rows[ref], REL[name])
    for attr in ("_bcast_cache", "_shuf_cache"):
        assert sorted(getattr(port.ds, attr, {})) == \
            sorted(getattr(ref.ds, attr, {})), (tag, attr)
    assert getattr(port.ds, "_bcast_cache", {}), tag
    assert getattr(port.ds, "_shuf_cache", {}), tag
    assert port.ds.last_downgrades == [] == ref.ds.last_downgrades, tag


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_scatter_shapes_equal_the_references(name):
    data = _data()
    with policy(name), clusters() as (ref, port):
        for c in (ref, port):
            _load(c.ds, c.tpch, data)
        for table in ("lineitem", "orders", "tx", "part_w", "dim"):
            got, want = port.counts(table), ref.counts(table)
            assert got == want, (table, got, want)
            if table == "dim":
                assert got == [3, 3, 3]
            else:
                assert sum(got) == len(next(iter(data[table].values())))
        _run_all(ref, port, name, "loaded")
        for stmt in ("UPDATE tx SET amt = amt + 1.5 WHERE region = 'e'",
                     "DELETE FROM tx WHERE amt > 95",
                     "UPDATE lineitem SET l_discount = 0.06 "
                     "WHERE l_quantity < 10",
                     "DELETE FROM lineitem WHERE l_orderkey % 7 = 0"):
            got = [c.ds.sql(stmt).rows() for c in (ref, port)]
            assert got[1] == got[0], stmt
        assert port.counts("tx") == ref.counts("tx")
        assert port.counts("lineitem") == ref.counts("lineitem")
        _run_all(ref, port, name, "mutated")


def test_merge_keeps_float64_partials_under_f32():
    """Under the float32 plate policy each server's float64 partial sums
    reach the lead's merge unrounded: a partial of 2^24 + 1 (exact in
    float64, not in float32) survives the merge, where the reference's
    float32 scratch plates round it to 2^24; a scattered Q1 / Q6 equal
    the port's single session within the compensated kernels' bar."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.utils import tpch

    li = tpch.gen_lineitem(N_ROWS, 13)
    with policy("f32"), clusters(n=2) as (ref, port):
        one = SnappySession(catalog=Catalog(), device="cpu")
        for s in (port.ds, one):
            s.sql(tpch.LINEITEM_DDL)
            s.insert_arrays("lineitem", [np.array(a, copy=True)
                                         for a in li.values()])
            s.sql("CREATE TABLE big (k BIGINT, v DOUBLE) USING column "
                  "OPTIONS (partition_by 'k')")
            s.insert_arrays("big", [np.array([1, 1], dtype=np.int64),
                                    np.array([16777216.0, 1.0])])
        for q in (tpch.Q1, tpch.Q6, "SELECT sum(v), count(*) FROM big"):
            got = [tuple(r) for r in port.ds.sql(q).rows()]
            want = [tuple(r) for r in one.sql(q).rows()]
            assert_rows_equal(got, want, 1e-6)
        assert port.ds.sql("SELECT sum(v) FROM big").rows()[0][0] == \
            16777217.0
        ref.ds.sql("CREATE TABLE big (k BIGINT, v DOUBLE) USING column "
                   "OPTIONS (partition_by 'k')")
        ref.ds.insert_arrays("big", [np.array([1, 1], dtype=np.int64),
                                     np.array([16777216.0, 1.0])])
        assert ref.ds.sql("SELECT sum(v) FROM big").rows()[0][0] == \
            16777216.0
        one.stop()
