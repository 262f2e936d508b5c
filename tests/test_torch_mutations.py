"""UPDATE / DELETE / PUT INTO / ALTER TABLE through both packages.

The same seeded TPC-H lineitem and orders load into the reference and
the port (on the CPU) with small batches, so lineitem spans several
column batches and a row-buffer tail.  Each case applies one mutation
through `session.sql` in both, then runs Q1, Q6 and a lineitem-orders
join: the rows, the `host_fallbacks` and join routing deltas and every
`compressed_fallback_*` delta must equal the reference's, under both
plate policies (tolerances: ROADMAP "Port rules"; float sums rel 1e-9
under float64 plates, 1e-6 under float32).  An updated encoded column
binds decoded with its delta (`compressed_fallback_deltas`); deletes
ride the validity plate.
"""

import numpy as np
import pytest

from torch_parity import (POLICIES, REL, Pair, assert_rows_equal, counters,
                          policy)

from snappydata_tpu import config as ref_config
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.utils import tpch

JOIN = ("SELECT o_orderpriority, count(*), sum(l_extendedprice) "
        "FROM orders JOIN lineitem ON o_orderkey = l_orderkey "
        "WHERE l_quantity < 30 GROUP BY o_orderpriority "
        "ORDER BY o_orderpriority")
QUERIES = (tpch.Q1, tpch.Q6, JOIN)
N_LINEITEM = 3000
N_TAIL = 100


@pytest.fixture(autouse=True)
def small_batches():
    """Small batches in both packages, and the reference's background
    compactor off: it folds deltas and row-buffer rows on its own clock,
    which would change the reference's plates between two queries."""
    ref_props = ref_config.global_properties()
    props = (ref_props, config.global_properties())
    saved = [(p.column_batch_rows, p.column_max_delta_rows) for p in props]
    saved_compaction = ref_props.compaction_enabled
    ref_props.compaction_enabled = False
    for p in props:
        p.column_batch_rows = 512
        p.column_max_delta_rows = 256
    yield
    ref_props.compaction_enabled = saved_compaction
    for p, (rows, delta) in zip(props, saved):
        p.column_batch_rows = rows
        p.column_max_delta_rows = delta


def _load(name, seed=5):
    """lineitem as batches plus a row-buffer tail, and orders."""
    pair = Pair(name)
    li = tpch.gen_lineitem(N_LINEITEM + N_TAIL, seed)
    n_o = int(li["l_orderkey"].max())
    pair.sql(tpch.LINEITEM_DDL)
    pair.sql(tpch.ORDERS_DDL)
    cols = list(li.values())
    pair.insert_arrays("lineitem", [c[:N_LINEITEM] for c in cols])
    pair.insert_arrays("lineitem", [c[N_LINEITEM:] for c in cols])
    pair.insert_arrays("orders",
                       list(tpch.gen_orders(n_o, 100, seed + 1).values()))
    return pair


def _deltas(before, after, names=None):
    keys = set(before) | set(after)
    if names is None:
        keys = {k for k in keys if k.startswith("compressed_fallback_")}
    else:
        keys = set(names)
    return {k: after.get(k, 0) - before.get(k, 0) for k in keys
            if after.get(k, 0) != before.get(k, 0) or names is not None}


def _check_queries(pair):
    """Q1, Q6 and the join: rows, routing and compressed-fallback deltas
    equal the reference's."""
    for q in QUERIES:
        out = []
        with policy(pair.policy):
            for s, reg in ((pair.port, global_registry()),
                           (pair.ref, ref_registry())):
                # every query binds from a cold plate cache in both
                # packages, so each counts its own compressed-domain
                # decisions (the reference's cache can also drop entries
                # under process-wide memory pressure)
                for info in s.catalog.list_tables():
                    info.data._device_cache.clear()
                b = counters(reg)
                rows = [tuple(r) for r in s.sql(q).rows()]
                a = counters(reg)
                out.append((rows, _deltas(b, a),
                            _deltas(b, a, ("host_fallbacks",
                                           "join_device_joins",
                                           "join_host_fallbacks"))))
        (prows, pcf, proute), (rrows, rcf, rroute) = out
        assert_rows_equal(prows, rrows, REL[pair.policy])
        assert proute == rroute, (q, proute, rroute)
        assert pcf == rcf, (q, pcf, rcf)
        assert proute["host_fallbacks"] == 0, q


def _mutate(pair, stmt, params=None):
    port, ref = pair.sql(stmt, params)
    assert port == ref, (stmt, port, ref)
    return port[0][0] if port else None


# one mutation per case: (statements, expected touched-row count or None)
STEPS = {
    "update_batches_and_row_buffer": (
        ["UPDATE lineitem SET l_discount = l_discount + 0.01 "
         "WHERE l_shipdate >= DATE '1994-06-01' AND l_discount < 0.06"],
        None),
    "update_matching_no_row": (
        ["UPDATE lineitem SET l_quantity = 1 WHERE l_orderkey > 0 AND "
         "l_linenumber = 1 AND l_partkey < 0"], 0),
    "delete_batches_and_row_buffer": (
        ["DELETE FROM lineitem WHERE l_quantity >= 45"], None),
    "delete_then_update_same_rows": (
        ["DELETE FROM lineitem WHERE l_discount = 0.05",
         "UPDATE lineitem SET l_tax = 0.5 WHERE l_discount <= 0.05"], None),
    "null_assignment_then_cleared": (
        ["UPDATE lineitem SET l_discount = NULL WHERE l_quantity < 10",
         "UPDATE lineitem SET l_discount = 0.02 WHERE l_quantity < 5"],
        None),
    "string_assignment_new_to_dictionary": (
        ["UPDATE lineitem SET l_returnflag = 'Z' WHERE l_quantity > 40",
         "UPDATE lineitem SET l_linestatus = 'Q', l_returnflag = 'Y' "
         "WHERE l_tax < 0.02"], None),
    "update_with_where_subquery": (
        ["UPDATE lineitem SET l_extendedprice = l_extendedprice * 2 "
         "WHERE l_orderkey IN (SELECT o_orderkey FROM orders "
         "WHERE o_orderpriority = '1-URGENT')"], None),
    "delete_with_scalar_subquery": (
        ["DELETE FROM lineitem WHERE l_extendedprice > "
         "(SELECT avg(l_extendedprice) * 1.5 FROM lineitem)"], None),
    "update_all_rows": (
        ["UPDATE lineitem SET l_tax = l_tax + 0.01"], N_LINEITEM + N_TAIL),
}


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("step", sorted(STEPS))
def test_mutation_then_q1_q6_join_match_reference(name, step):
    pair = _load(name)
    stmts, touched = STEPS[step]
    counts = [_mutate(pair, q) for q in stmts]
    if touched is not None:
        assert counts[-1] == touched
    _check_queries(pair)


@pytest.mark.parametrize("name", POLICIES)
def test_update_moves_q6_and_counts_the_deltas_fallback(name):
    """Q6 after an UPDATE of l_discount: the column binds decoded with
    its delta merged, counted `compressed_fallback_deltas` in both
    packages, and the revenue moves."""
    pair = _load(name)
    with policy(name):
        before = pair.port.sql(tpch.Q6).rows()[0][0]
    _mutate(pair, "UPDATE lineitem SET l_discount = l_discount + 0.01 "
                  "WHERE l_shipdate >= DATE '1994-01-01' "
                  "AND l_discount < 0.10")
    c0 = global_registry().counter("compressed_fallback_deltas")
    _check_queries(pair)
    assert global_registry().counter("compressed_fallback_deltas") > c0
    with policy(name):
        after = pair.port.sql(tpch.Q6).rows()[0][0]
    assert after != before


@pytest.mark.parametrize("name", POLICIES)
def test_two_markers_in_set_and_where(name):
    """'?' positions follow the SQL text: SET first, then WHERE."""
    pair = _load(name)
    n = _mutate(pair, "UPDATE lineitem SET l_tax = ? WHERE l_quantity = ?",
                (0.33, 7))
    assert n > 0
    _check_queries(pair)
    rows, _ = pair.run("SELECT count(*), min(l_tax), max(l_tax) "
                       "FROM lineitem WHERE l_quantity = 7")
    assert rows[0][1] == pytest.approx(0.33, rel=REL[name])
    n = _mutate(pair, "DELETE FROM lineitem WHERE l_quantity = ? "
                      "OR l_quantity = ?", (3, 4))
    assert n > 0
    _check_queries(pair)


@pytest.mark.parametrize("name", POLICIES)
def test_put_into_keyed_and_unkeyed_column_tables(name):
    pair = Pair(name)
    pair.sql("CREATE TABLE kc (k INT, s STRING, v DOUBLE) USING column "
             "OPTIONS (key_columns 'k')")
    pair.sql("CREATE TABLE uc (k INT, s STRING, v DOUBLE) USING column")
    rng = np.random.default_rng(3)
    rows = ", ".join(f"({i}, 's{i % 4}', {float(rng.integers(0, 100))})"
                     for i in range(40))
    for t in ("kc", "uc"):
        pair.sql(f"INSERT INTO {t} VALUES {rows}")
        _mutate(pair, f"PUT INTO {t} VALUES (3, 'new', 1.5), "
                      f"(39, 's0', 2.5), (100, 'fresh', 3.5)")
        pair.run(f"SELECT k, s, v FROM {t} ORDER BY k, s, v")
        pair.device(f"SELECT s, count(*), sum(v) FROM {t} GROUP BY s "
                    f"ORDER BY s")
    rows_k, _ = pair.run("SELECT count(*) FROM kc")
    rows_u, _ = pair.run("SELECT count(*) FROM uc")
    assert rows_k == [(41,)] and rows_u == [(43,)]


@pytest.mark.parametrize("name", POLICIES)
def test_alter_add_and_drop_column(name):
    pair = _load(name)
    _mutate(pair, "ALTER TABLE lineitem ADD COLUMN l_note STRING")
    _mutate(pair, "ALTER TABLE lineitem ADD COLUMN l_score DOUBLE")
    _mutate(pair, "UPDATE lineitem SET l_score = l_quantity * 2, "
                  "l_note = 'checked' WHERE l_quantity > 30")
    _check_queries(pair)
    pair.device("SELECT l_note, count(*), count(l_score), sum(l_score) "
                "FROM lineitem GROUP BY l_note ORDER BY l_note")
    _mutate(pair, "ALTER TABLE lineitem DROP COLUMN l_shipmode")
    _mutate(pair, "ALTER TABLE lineitem DROP COLUMN l_note")
    _check_queries(pair)
    pair.device("SELECT count(l_score), sum(l_score) FROM lineitem")
    pair.sql("INSERT INTO orders SELECT * FROM orders WHERE o_orderkey < 5")
    _check_queries(pair)


@pytest.mark.parametrize("name", POLICIES)
def test_decimal_update_delete_stay_exact(name):
    """tests/test_decimal_exact.py::test_nulls_update_delete through both
    packages: an exact DECIMAL(10,2) column after UPDATE and DELETE sums
    digit for digit (the delta holds the host float64 value, the bind
    scales it to int64)."""
    from decimal import Decimal

    pair = Pair(name)
    pair.sql("CREATE TABLE u (k BIGINT, v DECIMAL(10,2)) USING column")
    pair.sql("INSERT INTO u VALUES (1, 1.10), (2, NULL), (3, 3.30), "
             "(4, 4.40)")
    assert pair.device("SELECT sum(v) FROM u") == [(Decimal("8.80"),)]
    _mutate(pair, "UPDATE u SET v = 9.99 WHERE k = 3")
    assert pair.device("SELECT sum(v) FROM u") == [(Decimal("15.49"),)]
    _mutate(pair, "DELETE FROM u WHERE k = 4")
    assert pair.device("SELECT sum(v) FROM u") == [(Decimal("11.09"),)]
    assert pair.device("SELECT k, v FROM u ORDER BY k") == \
        [(1, Decimal("1.10")), (2, None), (3, Decimal("9.99"))]
