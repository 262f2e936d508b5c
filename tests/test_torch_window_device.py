"""OVER clauses on the port's device lane, against the reference.

The port lowers the window shapes the reference lowers
(`Compiler._emit_window`: row_number, rank, dense_rank, sum, count, avg,
min, max, lag, lead) and sends the rest to `hosteval.eval_window`, as the
reference does.  Every case runs the same statements through both
packages (the port on the CPU) under both plate policies and asserts the
reference's rows and its `host_fallbacks` delta:

- each case of tests/test_window.py, statement for statement;
- ties, DESC, NULLS FIRST / LAST over order keys with NULLs, NULL
  partition keys, lag and lead at partition edges, filters that empty
  partitions, over seeded random tables;
- shapes that both packages route to the host.

Tolerances: ranks, counts, keys, MIN / MAX exact; sums rel 1e-9 under
float64 plates and 1e-6 under float32 plates (the port accumulates
running sums in float64, the reference's f32 lane in float32).
"""

import numpy as np
import pytest

from torch_parity import POLICIES, Pair, policy

from snappydata_tpu_torch.observability.metrics import global_registry


@pytest.fixture(scope="module", params=POLICIES)
def sal(request):
    """tests/test_window.py's `sal` table (500 rows, seed 5)."""
    pair = Pair(request.param)
    pair.sql("CREATE TABLE sal (dept STRING, emp INT, pay DOUBLE) "
             "USING column")
    rng = np.random.default_rng(5)
    n = 500
    pair.insert_arrays("sal", [
        np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)],
        np.arange(n, dtype=np.int32),
        np.round(rng.uniform(1000, 9000, n), 2)])
    return pair


# (setup statements, query, params, expected host fallbacks) — each case
# of tests/test_window.py in its own tables
WINDOW_CASES = {
    "row_number": (
        (), "SELECT emp, row_number() OVER (PARTITION BY dept ORDER BY pay "
            "DESC) AS rn FROM sal ORDER BY emp", None, 0),
    "rank_and_dense_rank": (
        ("CREATE TABLE t (g STRING, v INT) USING column",
         "INSERT INTO t VALUES ('x', 10), ('x', 10), ('x', 20), ('y', 5), "
         "('y', 7), ('y', 7)"),
        "SELECT g, v, rank() OVER (PARTITION BY g ORDER BY v) AS r, "
        "dense_rank() OVER (PARTITION BY g ORDER BY v) AS dr "
        "FROM t ORDER BY g, v", None, 0),
    "partition_aggregate_whole_frame": (
        (), "SELECT emp, pay, sum(pay) OVER (PARTITION BY dept) AS total, "
            "avg(pay) OVER (PARTITION BY dept) AS ap FROM sal ORDER BY emp",
        None, 0),
    "running_sum": (
        ("CREATE TABLE rs (g STRING, ord INT, v INT) USING column",
         "INSERT INTO rs VALUES ('a', 1, 10), ('a', 2, 20), ('a', 3, 30), "
         "('b', 1, 5), ('b', 2, 5)"),
        "SELECT g, ord, sum(v) OVER (PARTITION BY g ORDER BY ord) "
        "AS running FROM rs ORDER BY g, ord", None, 0),
    "lag_lead": (
        ("CREATE TABLE ll (ord INT, v INT) USING column",
         "INSERT INTO ll VALUES (1, 100), (2, 200), (3, 300)"),
        "SELECT ord, lag(v) OVER (ORDER BY ord) AS prev, "
        "lead(v) OVER (ORDER BY ord) AS nxt FROM ll ORDER BY ord", None, 0),
    "window_in_expression": (
        ("CREATE TABLE we (g STRING, v DOUBLE) USING column",
         "INSERT INTO we VALUES ('a', 10.0), ('a', 30.0), ('b', 50.0)"),
        "SELECT g, v, v / sum(v) OVER (PARTITION BY g) AS share "
        "FROM we ORDER BY g, v", None, 0),
    "window_with_prepared_params": (
        ("CREATE TABLE wp (id INT, age INT) USING column",
         "INSERT INTO wp VALUES (1, 30), (2, 60), (3, 40)"),
        "SELECT id, row_number() OVER (ORDER BY id) FROM wp "
        "WHERE age > ? AND id < ?", (35, 3), 0),
    "window_aggregates_skip_nulls": (
        ("CREATE TABLE wn (b INT) USING column",
         "INSERT INTO wn VALUES (NULL), (2), (4)"),
        "SELECT count(b) OVER () AS c, avg(b) OVER () AS a, "
        "min(b) OVER () AS m FROM wn LIMIT 1", None, 0),
    "running_frame_range_semantics_on_ties": (
        ("CREATE TABLE wt (k INT, v INT) USING column",
         "INSERT INTO wt VALUES (1, 10), (1, 20), (2, 5)"),
        "SELECT k, sum(v) OVER (ORDER BY k) AS rs FROM wt ORDER BY k, v",
        None, 0),
    "null_join_keys_never_match": (
        ("CREATE TABLE njc (ck INT) USING column",
         "CREATE TABLE njo (ok INT) USING column",
         "INSERT INTO njc VALUES (1), (NULL)",
         "INSERT INTO njo VALUES (NULL), (2)"),
        "SELECT count(*) FROM njc JOIN njo ON ck = ok", None, 0),
    "null_join_keys_not_exists": (
        ("CREATE TABLE njc (ck INT) USING column",
         "CREATE TABLE njo (ok INT) USING column",
         "INSERT INTO njc VALUES (1), (NULL)",
         "INSERT INTO njo VALUES (NULL), (2)"),
        "SELECT count(*) FROM njc WHERE NOT EXISTS "
        "(SELECT 1 FROM njo WHERE ok = ck)", None, None),
    "mixed_dtype_join_keys": (
        ("CREATE TABLE mji (k INT) USING column",
         "CREATE TABLE mjd (k2 DOUBLE) USING column",
         "INSERT INTO mji VALUES (3), (4)",
         "INSERT INTO mjd VALUES (3.0), (5.0)"),
        "SELECT count(*) FROM mji JOIN mjd ON k = k2", None, None),
    "count_star_window": (
        ("CREATE TABLE cw (g STRING) USING column",
         "INSERT INTO cw VALUES ('a'), ('a'), ('b')"),
        "SELECT g, count(*) OVER (PARTITION BY g) AS c FROM cw ORDER BY g",
        None, 0),
    "device_window_null_handling": (
        ("CREATE TABLE dwn (g BIGINT, t BIGINT, v DOUBLE) USING column",
         "INSERT INTO dwn VALUES (1, 1, 10.0), (1, 2, NULL), "
         "(1, 3, 30.0), (2, 1, NULL), (2, 2, NULL)"),
        "SELECT g, t, sum(v) OVER (PARTITION BY g ORDER BY t) AS rs,"
        " count(v) OVER (PARTITION BY g ORDER BY t) AS cv "
        "FROM dwn ORDER BY g, t", None, 0),
}

NULL_PLACEMENT = (
    "ORDER BY v", "ORDER BY v NULLS LAST", "ORDER BY v DESC",
    "ORDER BY v DESC NULLS FIRST")


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_case_matches_reference(sal, case):
    setup, q, params, fallbacks = WINDOW_CASES[case]
    pair = Pair(sal.policy) if setup else sal
    for stmt in setup:
        pair.sql(stmt)
    _rows, moved = pair.run(q, params)
    if fallbacks is not None:
        assert moved["host_fallbacks"] == fallbacks


def test_device_window_no_host_fallback(sal):
    """tests/test_window.py's 5,000-row mixed query, on the device in
    both packages."""
    pair = Pair(sal.policy)
    pair.sql("CREATE TABLE dw (g BIGINT, t BIGINT, v DOUBLE) USING column")
    rng = np.random.default_rng(9)
    n = 5000
    pair.insert_arrays("dw", [rng.integers(0, 40, n).astype(np.int64),
                              rng.permutation(n).astype(np.int64),
                              np.round(rng.random(n) * 10, 3)])
    pair.device(
        "SELECT g, t, row_number() OVER (PARTITION BY g ORDER BY t) AS rn,"
        " dense_rank() OVER (PARTITION BY g ORDER BY t DESC) AS dr,"
        " count(*) OVER (PARTITION BY g) AS c,"
        " min(v) OVER (PARTITION BY g ORDER BY t) AS mn,"
        " max(v) OVER (PARTITION BY g) AS mx,"
        " lead(t) OVER (PARTITION BY g ORDER BY t) AS ld "
        "FROM dw ORDER BY g, t")


@pytest.mark.parametrize("order", NULL_PLACEMENT)
def test_window_order_null_placement_spark_defaults(sal, order):
    pair = Pair(sal.policy)
    pair.sql("CREATE TABLE wnp (g VARCHAR, v DOUBLE) USING column")
    pair.sql("INSERT INTO wnp VALUES ('a', 2.0), ('a', NULL), ('a', 1.0)")
    pair.device(f"SELECT v, row_number() OVER (PARTITION BY g {order}) "
                f"FROM wnp ORDER BY 2")


@pytest.mark.parametrize("order", NULL_PLACEMENT)
def test_top_level_order_by_nulls_first_last(sal, order):
    pair = Pair(sal.policy)
    pair.sql("CREATE TABLE onp (v DOUBLE) USING column")
    pair.sql("INSERT INTO onp VALUES (2.0), (NULL), (1.0)")
    pair.device(f"SELECT v FROM onp {order}")


def test_distinct_in_window_rejected_in_both(sal):
    for s in (sal.port, sal.ref):
        with policy(sal.policy), pytest.raises(Exception, match="DISTINCT"):
            s.sql("SELECT count(DISTINCT dept) OVER () FROM sal")


# --- seeded random tables ---------------------------------------------------

def _random_pair(name, n=300, seed=11, uniform_fillers=True):
    """g: INT partition key with NULLs; s: STRING key with NULLs; o: INT
    order key with ties and NULLs; d: DOUBLE order key with ties and
    NULLs; v: DOUBLE values with NULLs (multiples of 1/4, exact sums)."""
    rng = np.random.default_rng(seed)
    pair = Pair(name)
    pair.sql("CREATE TABLE r (id INT, g INT, s STRING, o INT, d DOUBLE, "
             "v DOUBLE) USING column")
    masks = [rng.random(n) < p for p in (0.1, 0.1, 0.15, 0.15, 0.1)]
    cols = [
        np.arange(n, dtype=np.int32),
        rng.integers(0, 7, n).astype(np.int32),
        np.array(["pq", "rs", "tu"], dtype=object)[rng.integers(0, 3, n)],
        rng.integers(0, 20, n).astype(np.int32),
        rng.integers(0, 12, n) / 2.0,
        rng.integers(-40, 40, n) / 4.0]
    if uniform_fillers:
        # NULL slots hold one filler per column, as SQL inserts leave them
        for c, m in zip(cols[1:], masks):
            c[m] = c[0] if c.dtype == object else 0
    pair.insert_arrays("r", cols, nulls=[None] + masks)
    return pair, cols, masks


@pytest.fixture(scope="module", params=POLICIES)
def rnd(request):
    return _random_pair(request.param)[0]


RANDOM_QUERIES = {
    "ties_rank": "SELECT id, rank() OVER (PARTITION BY g ORDER BY o), "
                 "dense_rank() OVER (PARTITION BY g ORDER BY o), "
                 "row_number() OVER (PARTITION BY g ORDER BY o, id) "
                 "FROM r ORDER BY id",
    "desc_nulls": "SELECT id, rank() OVER (PARTITION BY s ORDER BY d DESC), "
                  "rank() OVER (PARTITION BY s ORDER BY d DESC NULLS FIRST)"
                  ", rank() OVER (PARTITION BY s ORDER BY d NULLS LAST) "
                  "FROM r ORDER BY id",
    "two_keys": "SELECT id, rank() OVER (PARTITION BY g, s ORDER BY o DESC, "
                "d), sum(v) OVER (PARTITION BY g, s ORDER BY o DESC, d) "
                "FROM r ORDER BY id",
    "running_aggs": "SELECT id, sum(v) OVER (PARTITION BY g ORDER BY o), "
                    "count(v) OVER (PARTITION BY g ORDER BY o), "
                    "avg(v) OVER (PARTITION BY g ORDER BY o), "
                    "min(v) OVER (PARTITION BY g ORDER BY o), "
                    "max(v) OVER (PARTITION BY g ORDER BY o) "
                    "FROM r ORDER BY id",
    "whole_partition": "SELECT id, sum(v) OVER (PARTITION BY s), "
                       "min(o) OVER (PARTITION BY s), "
                       "max(d) OVER (PARTITION BY g), count(*) OVER () "
                       "FROM r ORDER BY id",
    "lag_lead_edges": "SELECT id, lag(v) OVER (PARTITION BY g ORDER BY id),"
                      " lead(v) OVER (PARTITION BY g ORDER BY id), "
                      "lag(o) OVER (PARTITION BY s ORDER BY d, id) "
                      "FROM r ORDER BY id",
    "filter_empties_partitions": "SELECT id, row_number() OVER (PARTITION "
                                 "BY g ORDER BY id), sum(v) OVER "
                                 "(PARTITION BY g) FROM r WHERE g = 3 "
                                 "OR o > 17 ORDER BY id",
    "filter_empties_all": "SELECT id, rank() OVER (PARTITION BY g ORDER BY "
                          "o) FROM r WHERE o > 100 ORDER BY id",
    "expression_args": "SELECT id, sum(v * 2 + o) OVER (PARTITION BY g "
                       "ORDER BY d), lag(o + 1) OVER (ORDER BY id) "
                       "FROM r ORDER BY id",
}


@pytest.mark.parametrize("name", sorted(RANDOM_QUERIES))
def test_random_window_shapes_on_device(rnd, name):
    rnd.device(RANDOM_QUERIES[name])


# partitioned by a key without NULLs: the reference's host evaluator
# still splits NULL partition keys by their fillers (ROADMAP C1)
HOST_SHAPES = {
    "ntile": "SELECT id, ntile(4) OVER (PARTITION BY id % 5 ORDER BY id) "
             "FROM r ORDER BY id",
    "string_order": "SELECT id, row_number() OVER (PARTITION BY id % 5 "
                    "ORDER BY s, id) FROM r ORDER BY id",
    "rank_without_order": "SELECT id, rank() OVER (PARTITION BY id % 5) "
                          "FROM r ORDER BY id",
    "lag_with_default": "SELECT id, lag(o, 1, 0) OVER (PARTITION BY id % 5 "
                        "ORDER BY id) FROM r ORDER BY id",
    # a literal offset is tokenized into a parameter: not a device shape
    "lead_offset": "SELECT id, lead(v, 2) OVER (PARTITION BY id % 5 "
                   "ORDER BY id) FROM r ORDER BY id",
}


@pytest.mark.parametrize("name", sorted(HOST_SHAPES))
def test_shapes_the_reference_sends_to_the_host(rnd, name):
    _rows, moved = rnd.run(HOST_SHAPES[name])
    assert moved["host_fallbacks"] == 1


def test_large_partitions_take_the_doubling_scan(rnd):
    """One partition of 2,000 rows: the scan runs 11 doubling passes and
    its running sums still equal the reference's."""
    pair = Pair(rnd.policy)
    pair.sql("CREATE TABLE big (k INT, v DOUBLE) USING column")
    rng = np.random.default_rng(3)
    pair.insert_arrays("big", [rng.permutation(2000).astype(np.int32),
                               rng.integers(-400, 400, 2000) / 8.0])
    pair.device("SELECT k, sum(v) OVER (ORDER BY k), "
                "max(v) OVER (ORDER BY k) FROM big ORDER BY k")


@pytest.mark.parametrize("name", POLICIES)
def test_multi_key_nulls_form_one_partition_whatever_the_filler(name):
    """Two PARTITION BY keys whose NULL slots hold varied fillers: the
    port blanks the value under each key's null mask, so all NULLs of a
    key are one partition (the reference's device lane hashes the filler
    too and splits them: ROADMAP C, faults of the reference).  Checked
    against a Python oracle, with no host fallback."""
    pair, cols, masks = _random_pair(name, n=120, seed=4,
                                     uniform_fillers=False)
    before = global_registry().counter("host_fallbacks")
    with policy(name):
        rows = pair.port.sql("SELECT id, count(*) OVER (PARTITION BY g, s),"
                             " row_number() OVER (PARTITION BY g, s ORDER "
                             "BY id) FROM r ORDER BY id").rows()
    assert global_registry().counter("host_fallbacks") == before
    key = [(None if masks[0][i] else int(cols[1][i]),
            None if masks[1][i] else cols[2][i]) for i in range(120)]
    sizes = {k: key.count(k) for k in key}
    seen = {}
    for i, (rid, cnt, rn) in enumerate(rows):
        seen[key[i]] = seen.get(key[i], 0) + 1
        assert (rid, cnt, rn) == (i, sizes[key[i]], seen[key[i]])
