"""Materialized aggregate views of the port (snappydata_tpu_torch/views/
matview.py) against the reference's.

Each case of tests/test_matviews.py that needs no streaming, REST,
Flight or bench.py runs as one script through the JAX package's session
and through the port's (on the CPU), under both plate policies.  The
script records what it reads (rows, counter deltas, view flags) at every
step; the two packages' records must be equal (floats within rel 1e-9 on
float64 plates, 1e-6 on float32 plates; everything else exactly), and the
reference test's own expected values are asserted as well.  Then the
cases the port adds: the broker's `matview_state_bytes` and the
view-state rung of the degradation ladder against the reference's
numbers, cross-package recovery, governed folds under a one-query memory
limit, and the device ledger after a DROP.
"""

import gc
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from torch_parity import POLICIES, REL, assert_rows_equal, policy

import snappydata_tpu.resource.broker as ref_broker_mod
import snappydata_tpu.views.matview as ref_mv
from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu import types as RT
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu.sql.analyzer import AnalysisError as RefAnalysisError
import snappydata_tpu_torch.resource.broker as port_broker_mod
import snappydata_tpu_torch.views.matview as port_mv
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch import types as PT
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.sql.analyzer import AnalysisError

pytestmark = pytest.mark.views

REF = SimpleNamespace(
    name="ref", registry=ref_registry, mv=ref_mv, T=RT,
    broker=ref_broker_mod.global_broker, AnalysisError=RefAnalysisError,
    props=ref_config.global_properties,
    new=lambda **kw: RefSession(**kw), Catalog=RefCatalog)
PORT = SimpleNamespace(
    name="port", registry=global_registry, mv=port_mv, T=PT,
    broker=port_broker_mod.global_broker, AnalysisError=AnalysisError,
    props=config.global_properties,
    new=lambda **kw: SnappySession(device="cpu", **kw), Catalog=Catalog)


class Rec:
    """One package's run of a case: a session factory and the list of
    observations the two packages must share."""

    def __init__(self, side):
        self.side = side
        self.out = []

    def session(self, **kw):
        if "data_dir" not in kw:
            kw.setdefault("catalog", self.side.Catalog())
        return self.side.new(**kw)

    def counter(self, name) -> int:
        return self.side.registry().counter(name)

    def rows(self, s, q):
        got = [tuple(r) for r in s.sql(q).rows()]
        self.out.append(("rows", q, got))
        return got

    def note(self, what, value):
        self.out.append((what, value))
        return value

    def matviews(self, s):
        return self.side.mv.matviews(s.catalog)


def _same_record(p, r, rel):
    assert p[0] == r[0], (p, r)
    if p[0] == "rows":
        assert_rows_equal(p[2], r[2], rel)
    elif isinstance(r[1], float):
        assert p[1] == pytest.approx(r[1], rel=rel), (p, r)
    else:
        assert p[1] == r[1], (p, r)


def run_both(case, policy_name, *args):
    """Run `case` through both packages; the records must agree."""
    recs = []
    with policy(policy_name):
        for side in (PORT, REF):
            rec = Rec(side)
            case(rec, *args)
            recs.append(rec)
    port, ref = recs
    assert len(port.out) == len(ref.out), (port.out, ref.out)
    for p, r in zip(port.out, ref.out):
        _same_record(p, r, REL[policy_name])
    return port, ref


@pytest.fixture(autouse=True)
def _no_compactor():
    old = config.global_properties().compaction_enabled
    config.global_properties().compaction_enabled = False
    yield
    config.global_properties().compaction_enabled = old


def _mk(rec, rows=True):
    s = rec.session()
    s.sql("CREATE TABLE base (k INT, name STRING, v DOUBLE, n BIGINT) "
          "USING column")
    if rows:
        s.insert("base", (1, "a", 1.5, 10), (1, "b", 2.5, 20),
                 (2, "a", 10.0, 30), (3, None, 4.0, 40))
    return s


def _approx_rows(got, want, rel=1e-6):
    assert_rows_equal(got, want, rel)


# -- the reference's cases -----------------------------------------------

def case_create_read_fold_basic(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv, "
          "count(*) AS c, sum(n) AS sn FROM base GROUP BY k")
    _approx_rows(rec.rows(s, "SELECT * FROM mv ORDER BY k"),
                 [(1, 4.0, 2, 30), (2, 10.0, 1, 30), (3, 4.0, 1, 40)])
    f0, r0 = rec.counter("view_delta_folds"), \
        rec.counter("view_full_refreshes")
    s.insert("base", (2, "z", 5.0, 5), (4, "q", 7.0, 7))
    _approx_rows(rec.rows(s, "SELECT * FROM mv ORDER BY k"),
                 [(1, 4.0, 2, 30), (2, 15.0, 2, 35), (3, 4.0, 1, 40),
                  (4, 7.0, 1, 7)])
    assert rec.note("folds", rec.counter("view_delta_folds") - f0) == 1
    assert rec.note("refreshes",
                    rec.counter("view_full_refreshes") - r0) == 0
    _approx_rows(rec.rows(s, "SELECT sum(sv) FROM mv WHERE k <= 2"),
                 [(19.0,)])


def case_create_over_empty_table_grouped_and_global(rec):
    s = _mk(rec, rows=False)
    s.sql("CREATE MATERIALIZED VIEW g AS SELECT k, count(*) AS c "
          "FROM base GROUP BY k")
    s.sql("CREATE MATERIALIZED VIEW tot AS SELECT count(*) AS c, "
          "sum(v) AS sv FROM base")
    assert rec.rows(s, "SELECT * FROM g") == []
    assert rec.rows(s, "SELECT * FROM tot") == \
        rec.rows(s, "SELECT count(*), sum(v) FROM base")
    s.insert("base", (1, "a", 2.0, 1), (1, "a", 3.0, 2))
    assert rec.rows(s, "SELECT * FROM g") == [(1, 2)]
    _approx_rows(rec.rows(s, "SELECT * FROM tot"), [(2, 5.0)])


def case_duplicate_name_and_if_not_exists(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, count(*) AS c "
          "FROM base GROUP BY k")
    with pytest.raises(ValueError, match="already exists"):
        s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, count(*) AS c "
              "FROM base GROUP BY k")
    s.sql("CREATE MATERIALIZED VIEW IF NOT EXISTS mv AS "
          "SELECT k, count(*) AS c FROM base GROUP BY k")
    with pytest.raises(ValueError, match="already exists"):
        s.sql("CREATE MATERIALIZED VIEW base AS SELECT k, count(*) AS c "
              "FROM base GROUP BY k")
    with pytest.raises(ValueError):
        s.sql("CREATE TABLE mv (x INT) USING column")
    rec.rows(s, "SELECT * FROM mv ORDER BY k")


def case_unsupported_definitions_raise(rec):
    s = _mk(rec)
    s.sql("CREATE TABLE other (k INT, w DOUBLE) USING column")
    for ddl in [
        "SELECT k FROM base",
        "SELECT k, count(*) c FROM base GROUP BY k ORDER BY k",
        "SELECT DISTINCT k FROM base",
        "SELECT k, count(DISTINCT name) c FROM base GROUP BY k",
        "SELECT b.k, count(*) c FROM base b JOIN other o ON b.k = o.k "
        "GROUP BY b.k",
        "SELECT k, min(name) m FROM base GROUP BY k",
    ]:
        with pytest.raises(ValueError) as ei:
            s.sql(f"CREATE MATERIALIZED VIEW bad AS {ddl}")
        rec.note("error", type(ei.value).__name__)
        assert "bad" not in rec.matviews(s)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, count(*) AS c "
          "FROM base GROUP BY k")
    with pytest.raises(rec.side.mv.MatViewError, match="materialized views"):
        s.sql("CREATE MATERIALIZED VIEW mv2 AS SELECT k, sum(c) AS s "
              "FROM mv GROUP BY k")


def case_view_writes_and_ddl_rejected(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, count(*) AS c "
          "FROM base GROUP BY k")
    for stmt, match in [
            ("INSERT INTO mv VALUES (9, 9)", "materialized view"),
            ("UPDATE mv SET c = 0 WHERE k = 1", "materialized view"),
            ("DELETE FROM mv WHERE k = 1", "materialized view"),
            ("TRUNCATE TABLE mv", "materialized view"),
            ("DROP TABLE mv", "MATERIALIZED"),
            ("ALTER TABLE mv ADD COLUMN x INT", "materialized view")]:
        with pytest.raises(ValueError, match=match):
            s.sql(stmt)
    with pytest.raises(ValueError, match="materialized view"):
        s.insert("mv", (9, 9))
    rec.rows(s, "SELECT * FROM mv ORDER BY k")


def case_fold_all_new_vs_all_existing_groups(rec):
    s = _mk(rec, rows=False)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(n) AS sn "
          "FROM base GROUP BY k")
    mv = rec.matviews(s)["mv"]
    s.insert_arrays("base", [
        np.arange(100, dtype=np.int32), np.array(["a"] * 100, dtype=object),
        np.ones(100), np.arange(100, dtype=np.int64)])
    s.sql("SELECT * FROM mv")
    assert rec.note("groups", mv.snapshot()["groups"]) == 100
    regrow1 = rec.counter("view_state_regrows")
    s.insert_arrays("base", [
        np.arange(100, dtype=np.int32), np.array(["b"] * 100, dtype=object),
        np.ones(100), np.full(100, 1000, dtype=np.int64)])
    assert rec.rows(s, "SELECT sum(sn) FROM mv") == \
        [(int(np.arange(100).sum()) + 100 * 1000,)]
    assert rec.note("groups", mv.snapshot()["groups"]) == 100
    assert rec.note("regrows",
                    rec.counter("view_state_regrows") - regrow1) == 0
    s.insert_arrays("base", [
        np.arange(100, 300, dtype=np.int32),
        np.array(["c"] * 200, dtype=object),
        np.ones(200), np.ones(200, dtype=np.int64)])
    assert rec.rows(s, "SELECT count(*) FROM mv") == [(300,)]
    snap = mv.snapshot()
    assert rec.note("groups", snap["groups"]) == 300
    assert rec.note("regrew", rec.counter("view_state_regrows") > regrow1)
    assert rec.note("capacity", snap["capacity"]) in (512, 384)
    rec.note("state_bytes", mv.state_nbytes())


def case_null_group_keys_and_null_values_fold(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT name, sum(v) AS sv, "
          "count(v) AS cv, count(*) AS c FROM base GROUP BY name")
    key = (lambda r: (r[0] is not None, r[0]))
    view = sorted(rec.rows(s, "SELECT * FROM mv"), key=key)
    base = sorted(rec.rows(s, "SELECT name, sum(v), count(v), count(*) "
                              "FROM base GROUP BY name"), key=key)
    _approx_rows(view, base)
    s.insert("base", (7, None, None, 1))
    got = {r[0]: r for r in rec.rows(s, "SELECT * FROM mv ORDER BY name")}
    assert got[None][2] == 1 and got[None][3] == 2
    assert got[None][1] == pytest.approx(4.0)


def case_avg_and_having_views(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, avg(v) AS av "
          "FROM base GROUP BY k HAVING count(*) > 1")
    _approx_rows(rec.rows(s, "SELECT * FROM mv ORDER BY k"), [(1, 2.0)])
    s.insert("base", (2, "x", 20.0, 0))
    _approx_rows(rec.rows(s, "SELECT * FROM mv ORDER BY k"),
                 [(1, 2.0), (2, 15.0)])


def case_delete_subtraction_exact_f64_int64(rec):
    s = _mk(rec, rows=False)
    rng = np.random.default_rng(5)
    k = (np.arange(4000, dtype=np.int32) % 16)
    v = rng.integers(0, 1 << 40, 4000).astype(np.float64)
    n = rng.integers(-(1 << 50), 1 << 50, 4000)
    s.insert_arrays("base", [k, np.array(["s"] * 4000, dtype=object), v, n])
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv, "
          "sum(n) AS sn, count(*) AS c, count(v) AS cv "
          "FROM base GROUP BY k")
    sub0, r0 = rec.counter("view_subtract_folds"), \
        rec.counter("view_full_refreshes")
    s.sql("DELETE FROM base WHERE k >= 8")
    assert rec.note("subtracts",
                    rec.counter("view_subtract_folds") - sub0) == 1
    keep = k < 8
    expect = [(g, float(v[keep & (k == g)].sum()),
               int(n[keep & (k == g)].sum()), int((keep & (k == g)).sum()),
               int((keep & (k == g)).sum())) for g in range(8)]
    got = rec.rows(s, "SELECT * FROM mv ORDER BY k")
    _approx_rows(got, expect)
    assert [r[2] for r in got] == [e[2] for e in expect]   # int64 exact
    assert rec.note("refreshes",
                    rec.counter("view_full_refreshes") - r0) == 0
    s.sql("DELETE FROM base WHERE k = 3")
    assert rec.rows(s, "SELECT count(*) FROM mv") == [(7,)]


def case_minmax_delete_marks_stale_then_recovers_by_rescan(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, max(v) AS mx, "
          "min(n) AS mn FROM base GROUP BY k")
    _approx_rows(rec.rows(s, "SELECT * FROM mv ORDER BY k"),
                 [(1, 2.5, 10), (2, 10.0, 30), (3, 4.0, 40)])
    f0 = rec.counter("view_delta_folds")
    s.insert("base", (1, "z", 9.0, 5))
    _approx_rows(rec.rows(s, "SELECT mx, mn FROM mv WHERE k = 1"),
                 [(9.0, 5)])
    assert rec.note("folds", rec.counter("view_delta_folds") - f0) == 1
    st0, r0 = rec.counter("view_stale_marks"), \
        rec.counter("view_full_refreshes")
    s.sql("DELETE FROM base WHERE v = 9.0")
    assert rec.note("stale_marks",
                    rec.counter("view_stale_marks") - st0) == 1
    assert rec.note("stale", rec.matviews(s)["mv"].stale)
    _approx_rows(rec.rows(s, "SELECT * FROM mv ORDER BY k"),
                 [(1, 2.5, 10), (2, 10.0, 30), (3, 4.0, 40)])
    assert rec.note("refreshes",
                    rec.counter("view_full_refreshes") - r0) == 1
    assert not rec.note("stale", rec.matviews(s)["mv"].stale)


def case_update_and_keyed_put_mark_stale(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv "
          "FROM base GROUP BY k")
    s.sql("SELECT * FROM mv")
    st0 = rec.counter("view_stale_marks")
    s.sql("UPDATE base SET v = v + 1 WHERE k = 1")
    assert rec.note("stale_marks",
                    rec.counter("view_stale_marks") - st0) == 1
    _approx_rows(rec.rows(s, "SELECT sv FROM mv WHERE k = 1"), [(6.0,)])
    # a keyed row-table PUT replaces rows whose old image is not seen
    s.sql("CREATE TABLE kr (id INT PRIMARY KEY, v DOUBLE) USING row")
    s.insert("kr", (1, 1.0), (2, 2.0))
    s.sql("CREATE MATERIALIZED VIEW kv AS SELECT count(*) AS c, "
          "sum(v) AS sv FROM kr")
    s.put("kr", (2, 5.0), (3, 3.0))
    assert rec.note("stale", rec.matviews(s)["kv"].stale)
    _approx_rows(rec.rows(s, "SELECT * FROM kv"), [(3, 9.0)])


def case_column_put_upsert_stays_fresh_and_exact(rec):
    T = rec.side.T
    s = rec.session()
    s.catalog.create_table(
        "kv", T.Schema([T.Field("id", T.LONG, False),
                        T.Field("v", T.DOUBLE, True)]),
        "column", {}, key_columns=("id",))
    s.put_arrays("kv", [np.arange(10, dtype=np.int64), np.ones(10)])
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT count(*) AS c, "
          "sum(v) AS sv FROM kv")
    _approx_rows(rec.rows(s, "SELECT * FROM mv"), [(10, 10.0)])
    r0 = rec.counter("view_full_refreshes")
    s.put_arrays("kv", [np.arange(5, 15, dtype=np.int64),
                        np.full(10, 3.0)])
    _approx_rows(rec.rows(s, "SELECT * FROM mv"),
                 [(15, 5 * 1.0 + 10 * 3.0)])
    assert rec.note("refreshes",
                    rec.counter("view_full_refreshes") - r0) == 0


def case_truncate_resets_view(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, count(*) AS c "
          "FROM base GROUP BY k")
    s.sql("SELECT * FROM mv")
    s.sql("TRUNCATE TABLE base")
    assert rec.rows(s, "SELECT * FROM mv") == []
    s.insert("base", (5, "a", 1.0, 1))
    assert rec.rows(s, "SELECT * FROM mv") == [(5, 1)]
    s.sql("INSERT OVERWRITE base VALUES (6, 'b', 2.0, 2)")
    assert rec.rows(s, "SELECT * FROM mv") == [(6, 1)]


def case_alter_base_marks_stale_and_rebinds(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv "
          "FROM base GROUP BY k")
    s.sql("SELECT * FROM mv")
    s.sql("ALTER TABLE base ADD COLUMN extra DOUBLE")
    assert rec.note("stale", rec.matviews(s)["mv"].stale)
    s.insert("base", (1, "n", 1.0, 1, 8.5))
    _approx_rows(rec.rows(s, "SELECT sv FROM mv WHERE k = 1"), [(5.0,)])
    assert not rec.note("stale", rec.matviews(s)["mv"].stale)


def case_drop_base_table_cascades(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, count(*) AS c "
          "FROM base GROUP BY k")
    s.sql("DROP TABLE base")
    assert "mv" not in rec.matviews(s)
    with pytest.raises(rec.side.AnalysisError, match="not found"):
        s.sql("SELECT * FROM mv")
    assert rec.note("table", s.catalog.lookup_table("mv")) is None


def case_refresh_statement_and_eviction(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv "
          "FROM base GROUP BY k")
    r0 = rec.counter("view_full_refreshes")
    s.sql("REFRESH MATERIALIZED VIEW mv")
    assert rec.note("refreshes",
                    rec.counter("view_full_refreshes") - r0) == 1
    with pytest.raises(ValueError, match="not found"):
        s.sql("REFRESH MATERIALIZED VIEW nope")
    assert rec.side.mv.evict_all_states() > 0
    assert rec.note("stale", rec.matviews(s)["mv"].stale)
    _approx_rows(rec.rows(s, "SELECT * FROM mv ORDER BY k"),
                 [(1, 4.0), (2, 10.0), (3, 4.0)])
    assert rec.note("refreshes",
                    rec.counter("view_full_refreshes") - r0) == 2


def case_repeated_delete_does_not_double_subtract(rec):
    s = rec.session()
    s.sql("CREATE TABLE t (k INT, v DOUBLE) USING column")
    s.insert("t", (1, 5.0), (1, 7.0), (2, 3.0))
    s.sql("CREATE MATERIALIZED VIEW dd AS SELECT k, sum(v) AS sv, "
          "count(*) AS c FROM t GROUP BY k")
    assert rec.rows(s, "DELETE FROM t WHERE v = 5.0") == [(1,)]
    assert rec.rows(s, "DELETE FROM t WHERE v = 5.0") == [(0,)]
    _approx_rows(rec.rows(s, "SELECT * FROM dd ORDER BY k"),
                 [(1, 7.0, 1), (2, 3.0, 1)])
    s.sql("CREATE TABLE r (k INT, v DOUBLE) USING row")
    s.insert("r", (1, 5.0), (1, 7.0))
    s.sql("CREATE MATERIALIZED VIEW ddr AS SELECT k, sum(v) AS sv, "
          "count(*) AS c FROM r GROUP BY k")
    s.sql("DELETE FROM r WHERE v = 5.0")
    s.sql("DELETE FROM r WHERE v = 5.0")
    _approx_rows(rec.rows(s, "SELECT * FROM ddr"), [(1, 7.0, 1)])


def case_refresh_accepts_schema_qualified_name(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW q AS SELECT k, count(*) AS c "
          "FROM base GROUP BY k")
    s.sql("REFRESH MATERIALIZED VIEW app.q")
    assert rec.rows(s, "SELECT count(*) FROM q") == [(3,)]


def case_ctas_and_mutation_subqueries_see_fresh_view(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW f AS SELECT k, sum(v) AS sv "
          "FROM base GROUP BY k")
    s.insert("base", (9, "z", 1.0, 1))
    s.sql("CREATE TABLE snap AS SELECT * FROM f")
    assert (9, 1.0) in rec.rows(s, "SELECT * FROM snap ORDER BY k")
    s.sql("CREATE TABLE pick (k INT) USING column")
    s.insert("pick", (9,), (50,))
    s.insert("base", (50, "y", 2.0, 2))
    assert rec.rows(s, "DELETE FROM pick WHERE k IN "
                       "(SELECT k FROM f)") == [(2,)]
    s.sql("CREATE TABLE copy (k INT, sv DOUBLE) USING column")
    s.insert("base", (60, "w", 3.0, 3))
    s.sql("INSERT INTO copy SELECT * FROM f")
    assert (60, 3.0) in rec.rows(s, "SELECT * FROM copy ORDER BY k")


def case_stale_view_read_races_concurrent_committers(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW race AS SELECT k, count(*) AS c "
          "FROM base GROUP BY k")
    mv = rec.matviews(s)["race"]
    stop = threading.Event()
    errs = []
    written = [0]

    def writer():
        try:
            while not stop.is_set():
                s.insert("base", (7, "w", 1.0, 1))
                written[0] += 1
        except Exception as e:  # pragma: no cover
            errs.append(e)

    def reader():
        try:
            for _ in range(10):
                mv.mark_stale("test")  # force the refresh_full path
                s.sql("SELECT count(*) FROM race")
        except Exception as e:  # pragma: no cover
            errs.append(e)

    w = threading.Thread(target=writer, daemon=True)
    r = threading.Thread(target=reader, daemon=True)
    w.start()
    r.start()
    r.join(timeout=120)
    alive = r.is_alive()
    stop.set()
    w.join(timeout=30)
    assert not alive and not w.is_alive(), "reader/writer deadlocked"
    assert not errs, errs
    # one consistent epoch: after the race the view equals the base
    view = s.sql("SELECT * FROM race ORDER BY k").rows()
    base = s.sql("SELECT k, count(*) FROM base GROUP BY k "
                 "ORDER BY k").rows()
    assert [tuple(r) for r in view] == [tuple(r) for r in base]
    assert view[-1][1] == written[0]


def case_unmanaged_direct_write_marks_stale_not_diverges(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW uw AS SELECT k, sum(v) AS sv "
          "FROM base GROUP BY k")
    u0 = rec.counter("view_unmanaged_writes")
    s.catalog.describe("base").data.insert_arrays(
        [np.array([9], dtype=np.int32), np.array(["x"], dtype=object),
         np.array([2.5]), np.array([1], dtype=np.int64)])
    assert rec.note("stale", rec.matviews(s)["uw"].stale)
    assert rec.note("unmanaged",
                    rec.counter("view_unmanaged_writes") - u0) == 1
    _approx_rows(rec.rows(s, "SELECT * FROM uw WHERE k = 9"), [(9, 2.5)])
    u1 = rec.counter("view_unmanaged_writes")
    s.insert("base", (9, "y", 1.0, 1))
    assert rec.note("unmanaged",
                    rec.counter("view_unmanaged_writes") - u1) == 0
    assert not rec.note("stale", rec.matviews(s)["uw"].stale)


def case_row_table_null_delete_capture_exact(rec):
    s = rec.session()
    s.sql("CREATE TABLE rt (g INT, id INT, v DOUBLE) USING row")
    s.sql("CREATE MATERIALIZED VIEW rn AS SELECT g, sum(v) AS sv, "
          "count(*) AS c FROM rt GROUP BY g")
    s.sql("INSERT INTO rt VALUES (1, 1, NULL)")
    s.sql("INSERT INTO rt VALUES (1, 2, 3.0)")
    s.sql("DELETE FROM rt WHERE id = 1")
    _approx_rows(rec.rows(s, "SELECT * FROM rn"), [(1, 3.0, 1)])
    s.sql("INSERT INTO rt VALUES (2, 3, NULL)")
    s.sql("INSERT INTO rt VALUES (2, 4, 7.0)")
    s.sql("DELETE FROM rt WHERE id = 4")
    cold = rec.rows(s, "SELECT g, sum(v), count(*) FROM rt GROUP BY g "
                       "ORDER BY g")
    assert rec.rows(s, "SELECT * FROM rn ORDER BY g") == cold


def case_create_failure_rolls_back_registration(rec):
    from unittest import mock

    s = _mk(rec)
    with mock.patch.object(rec.side.mv.MaterializedView, "refresh_full",
                           side_effect=RuntimeError("injected")):
        with pytest.raises(RuntimeError, match="injected"):
            s.sql("CREATE MATERIALIZED VIEW cf AS SELECT k, sum(v) AS sv "
                  "FROM base GROUP BY k")
    assert "cf" not in rec.matviews(s)
    assert s.catalog.lookup_table("cf") is None
    s.sql("CREATE MATERIALIZED VIEW cf AS SELECT k, sum(v) AS sv "
          "FROM base GROUP BY k")
    assert len(rec.rows(s, "SELECT * FROM cf ORDER BY k")) == 3


def case_view_snapshot(rec):
    s = _mk(rec)
    s.sql("CREATE MATERIALIZED VIEW vs AS SELECT k, sum(v) AS sv, "
          "min(v) AS mn FROM base GROUP BY k")
    s.insert("base", (4, "d", 1.0, 1))
    s.sql("SELECT * FROM vs")
    snap = rec.side.mv.view_snapshot(s.catalog)
    (v,) = snap["views"]
    for key in ("name", "base_table", "groups", "capacity", "slots",
                "subtractable", "stale", "dirty", "state_bytes",
                "delta_folds", "rows_folded", "full_refreshes"):
        rec.note(key, v[key])
    rec.note("view_state_bytes", snap["view_state_bytes"])


CASES = [
    case_create_read_fold_basic,
    case_create_over_empty_table_grouped_and_global,
    case_duplicate_name_and_if_not_exists,
    case_unsupported_definitions_raise,
    case_view_writes_and_ddl_rejected,
    case_fold_all_new_vs_all_existing_groups,
    case_null_group_keys_and_null_values_fold,
    case_avg_and_having_views,
    case_delete_subtraction_exact_f64_int64,
    case_minmax_delete_marks_stale_then_recovers_by_rescan,
    case_update_and_keyed_put_mark_stale,
    case_column_put_upsert_stays_fresh_and_exact,
    case_truncate_resets_view,
    case_alter_base_marks_stale_and_rebinds,
    case_drop_base_table_cascades,
    case_refresh_statement_and_eviction,
    case_repeated_delete_does_not_double_subtract,
    case_refresh_accepts_schema_qualified_name,
    case_ctas_and_mutation_subqueries_see_fresh_view,
    case_unmanaged_direct_write_marks_stale_not_diverges,
    case_row_table_null_delete_capture_exact,
    case_create_failure_rolls_back_registration,
    case_view_snapshot,
]


@pytest.mark.parametrize("policy_name", POLICIES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_case_matches_reference(case, policy_name):
    run_both(case, policy_name)


def test_stale_view_read_races_concurrent_committers():
    """Readers of a stale view (refresh under the view's own locks)
    against committers folding inserts: no deadlock in either package,
    and afterwards the view equals its base."""
    for side in (PORT, REF):
        case_stale_view_read_races_concurrent_committers(Rec(side))


# -- durability ------------------------------------------------------------

def case_recovery_replays_only_the_tail(rec, d):
    s = rec.session(catalog=rec.side.Catalog(), data_dir=d, recover=False)
    s.sql("CREATE TABLE t (k INT, v DOUBLE) USING column")
    s.insert("t", (1, 1.0), (2, 2.0))
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv, "
          "count(*) AS c FROM t GROUP BY k")
    s.checkpoint()
    s.insert("t", (1, 10.0), (3, 30.0))
    s.stop()
    s.disk_store.close()
    rp0, rf0 = rec.counter("view_replay_folds"), \
        rec.counter("view_full_refreshes")
    s2 = rec.session(data_dir=d)
    mv = rec.matviews(s2)["mv"]
    assert not rec.note("stale", mv.stale)
    assert rec.note("replay_folds",
                    rec.counter("view_replay_folds") - rp0) == 1
    _approx_rows(rec.rows(s2, "SELECT * FROM mv ORDER BY k"),
                 [(1, 11.0, 2), (2, 2.0, 1), (3, 30.0, 1)])
    assert rec.note("refreshes",
                    rec.counter("view_full_refreshes") - rf0) == 0
    s2.stop()
    s2.disk_store.close()
    s3 = rec.session(data_dir=d)
    _approx_rows(rec.rows(s3, "SELECT * FROM mv ORDER BY k"),
                 [(1, 11.0, 2), (2, 2.0, 1), (3, 30.0, 1)])
    s3.stop()
    s3.disk_store.close()


def case_drop_base_cascade_removes_persisted_state(rec, d):
    s = rec.session(catalog=rec.side.Catalog(), data_dir=d, recover=False)
    s.sql("CREATE TABLE t (k INT) USING column")
    s.insert("t", (1,))
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, count(*) AS c "
          "FROM t GROUP BY k")
    spath = os.path.join(d, "views", "mv.state")
    assert rec.note("state_file", os.path.exists(spath))
    s.sql("DROP TABLE t")
    assert not rec.note("state_file", os.path.exists(spath))
    assert "mv" not in getattr(s.catalog, "_matview_ddl", {})
    s.stop()
    s.disk_store.close()
    s2 = rec.session(data_dir=d)
    assert "mv" not in rec.matviews(s2)
    s2.disk_store.close()


def case_drop_removes_persisted_state(rec, d):
    s = rec.session(catalog=rec.side.Catalog(), data_dir=d, recover=False)
    s.sql("CREATE TABLE t (k INT) USING column")
    s.insert("t", (1,))
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, count(*) AS c "
          "FROM t GROUP BY k")
    spath = os.path.join(d, "views", "mv.state")
    assert rec.note("state_file", os.path.exists(spath))
    s.sql("DROP MATERIALIZED VIEW mv")
    assert not rec.note("state_file", os.path.exists(spath))
    s.stop()
    s.disk_store.close()
    s2 = rec.session(data_dir=d)
    assert "mv" not in rec.matviews(s2)
    assert s2.catalog.lookup_table("mv") is None
    s2.disk_store.close()


def case_recovery_base_rows_mismatch_degrades_to_stale(rec, d):
    s = rec.session(data_dir=d)
    s.sql("CREATE TABLE t (k INT, v DOUBLE) USING column")
    s.catalog.describe("t").data.insert_arrays(
        [np.arange(100, dtype=np.int32) % 4, np.ones(100)])  # no WAL
    s.sql("CREATE MATERIALIZED VIEW rm AS SELECT k, sum(v) AS sv, "
          "count(*) AS c FROM t GROUP BY k")
    s.insert("t", (0, 5.0))
    s2 = rec.session(data_dir=d)   # crash-shape reopen
    view = rec.rows(s2, "SELECT * FROM rm ORDER BY k")
    base = rec.rows(s2, "SELECT k, sum(v), count(*) FROM t GROUP BY k "
                        "ORDER BY k")
    assert view == base, (view, base)
    s2.stop()
    s.stop()


@pytest.mark.parametrize("case", [
    case_recovery_replays_only_the_tail,
    case_drop_base_cascade_removes_persisted_state,
    case_drop_removes_persisted_state,
    case_recovery_base_rows_mismatch_degrades_to_stale,
], ids=lambda c: c.__name__[5:])
def test_durable_case_matches_reference(tmp_path, case):
    recs = []
    for side in (PORT, REF):
        rec = Rec(side)
        case(rec, str(tmp_path / side.name))
        recs.append(rec)
    port, ref = recs
    assert len(port.out) == len(ref.out)
    for p, r in zip(port.out, ref.out):
        _same_record(p, r, 1e-9)


def _durable_script(s, with_tail=True):
    s.sql("CREATE TABLE t (k INT, name STRING, v DOUBLE) USING column")
    s.insert("t", (1, "a", 1.0), (2, "b", 2.0), (1, "c", 4.0))
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv, "
          "count(*) AS c FROM t GROUP BY k")
    s.sql("CREATE VIEW big AS SELECT k, v FROM t WHERE v > 1.5")
    s.sql("CREATE FUNCTION trip AS 'lambda x: x * 3' RETURNS DOUBLE")
    s.checkpoint()
    if with_tail:
        s.insert("t", (3, "d", 30.0))
        s.sql("DELETE FROM t WHERE name = 'a'")


DURABLE_QS = ("SELECT * FROM mv ORDER BY k",
              "SELECT k, sum(v) FROM big GROUP BY k ORDER BY k",
              "SELECT sum(trip(v)) FROM t")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_views_recover_across_packages(tmp_path, writer):
    """A data directory holding a materialized view (its checkpointed
    state), a plain view and a function, plus a WAL tail past the view's
    watermark, written by either package, recovers in the other: the
    state reloads, only the tail folds, and every read equals the
    writer's."""
    wside, rside = (REF, PORT) if writer == "ref" else (PORT, REF)
    d = str(tmp_path)
    w = Rec(wside).session(catalog=wside.Catalog(), data_dir=d,
                           recover=False)
    _durable_script(w)
    want = [[tuple(r) for r in w.sql(q).rows()] for q in DURABLE_QS]
    w.disk_store.close()
    rrec = Rec(rside)
    rp0, rf0 = rrec.counter("view_replay_folds"), \
        rrec.counter("view_full_refreshes")
    rs0 = rrec.counter("view_subtract_folds")
    r = rrec.session(data_dir=d)
    mv = rrec.matviews(r)["mv"]
    assert not mv.stale
    # the tail: the insert record folds, the journaled DELETE subtracts
    assert rrec.counter("view_replay_folds") - rp0 == 1
    assert rrec.counter("view_subtract_folds") - rs0 == 1
    got = [[tuple(x) for x in r.sql(q).rows()] for q in DURABLE_QS]
    for g, x in zip(got, want):
        assert_rows_equal(g, x, 1e-9)
    assert rrec.counter("view_full_refreshes") == rf0
    assert got[0] == [(1, 4.0, 1), (2, 2.0, 1), (3, 30.0, 1)]
    r.disk_store.close()


def test_function_and_view_ddl_survive_recovery(tmp_path):
    """ref tests/test_udf.py::test_udf_survives_recovery, with a plain
    view beside the function, in the port; DROPs persist too."""
    d = str(tmp_path / "store")
    s = SnappySession(data_dir=d, device="cpu")
    s.sql("CREATE TABLE rt (v DOUBLE) USING column")
    s.sql("INSERT INTO rt VALUES (2.0), (4.0)")
    s.sql("CREATE FUNCTION trip AS 'lambda x: x * 3' RETURNS DOUBLE")
    s.sql("CREATE VIEW rv AS SELECT v FROM rt WHERE v > 3")
    s.sql("CREATE VIEW gone AS SELECT v FROM rt")
    s.sql("DROP VIEW gone")
    s.checkpoint()
    s.disk_store.close()
    s2 = SnappySession(data_dir=d, device="cpu")
    assert s2.sql("SELECT sum(trip(v)) FROM rt").rows()[0][0] == \
        pytest.approx(18.0)
    assert s2.sql("SELECT * FROM rv").rows() == [(4.0,)]
    assert s2.catalog.lookup_view("gone") is None
    s2.sql("DROP FUNCTION trip")
    s2.disk_store.close()
    s3 = SnappySession(data_dir=d, device="cpu")
    with pytest.raises(Exception, match="unknown function|unsupported"):
        s3.sql("SELECT trip(v) FROM rt")
    s3.disk_store.close()


# -- the broker's ledger line and the view-state rung ----------------------

def _ledger_script(rec):
    gc.collect()
    led0 = rec.side.broker().ledger()["matview_state_bytes"]
    s = _mk(rec)
    s.insert_arrays("base", [
        np.arange(5000, dtype=np.int32) % 512,
        np.array(["x"] * 5000, dtype=object),
        np.ones(5000), np.ones(5000, dtype=np.int64)])
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv "
          "FROM base GROUP BY k")
    led1 = rec.side.broker().ledger()["matview_state_bytes"]
    mv = rec.matviews(s)["mv"]
    rec.note("grown", led1 - led0)
    assert led1 - led0 == mv.state_nbytes()
    assert rec.side.mv.view_snapshot(s.catalog)["view_state_bytes"] == \
        mv.state_nbytes()
    s.sql("DROP MATERIALIZED VIEW mv")
    led2 = rec.side.broker().ledger()["matview_state_bytes"]
    assert led2 <= led0, "DROP must free the ledgered bytes immediately"
    assert rec.rows(s, "SELECT count(*) FROM base") == [(5004,)]
    with pytest.raises(ValueError, match="not found"):
        s.sql("DROP MATERIALIZED VIEW mv")
    s.sql("DROP MATERIALIZED VIEW IF EXISTS mv")


def test_drop_frees_ledgered_state_bytes():
    """ref test_drop_frees_ledgered_state_bytes: the broker's
    `matview_state_bytes` grows by exactly the view's `state_nbytes()`
    in both packages, by the same number of bytes, and DROP frees it."""
    run_both(_ledger_script, "f64")


def _ladder_script(rec):
    s = _mk(rec)
    s.insert_arrays("base", [
        np.arange(4000, dtype=np.int32) % 300,
        np.array(["x"] * 4000, dtype=object),
        np.arange(4000, dtype=np.float64), np.ones(4000, dtype=np.int64)])
    s.sql("CREATE MATERIALIZED VIEW lv AS SELECT k, sum(v) AS sv, "
          "count(*) AS c FROM base GROUP BY k")
    mv = rec.matviews(s)["lv"]
    rec.note("state_bytes", mv.state_nbytes())
    broker = rec.side.broker()
    e0 = rec.counter("governor_degrade_view_evictions")
    # the ledger seen by the ladder is the view states plus one byte, so
    # no rung but the view-state one can meet the target of one byte (and
    # no other table of the process is demoted or spilled by this test)
    broker.measured_bytes = lambda max_age_s=0.0: (
        0, rec.side.mv.matview_state_nbytes() + 1)
    try:
        broker._degrade(1)
    finally:
        del broker.measured_bytes
    assert rec.note("evictions",
                    rec.counter("governor_degrade_view_evictions") - e0) == 1
    assert rec.note("stale", mv.stale)
    assert rec.note("bytes_after", mv.state_nbytes()) == 0
    rows = rec.rows(s, "SELECT count(*), sum(sv), sum(c) FROM lv")
    assert rows[0][0] == 300 and rows[0][2] == 4004
    assert not rec.note("stale", mv.stale)


def test_view_state_rung_of_the_ladder():
    """`evict_all_states` is a rung of `_degrade` in both packages, right
    after the plan caches: the view goes stale and refreshes in full at
    its next read."""
    run_both(_ladder_script, "f64")


# -- the port's own: device ledger, governed folds -------------------------

def test_drop_leaves_no_device_bind_in_the_ledger():
    from snappydata_tpu_torch.storage.device import \
        device_cache_bytes_by_table

    broker = port_broker_mod.global_broker()
    gc.collect()
    before = sum(device_cache_bytes_by_table(
        broker._iter_tables()).values())
    s = _mk(Rec(PORT))
    s.sql("CREATE MATERIALIZED VIEW dl AS SELECT k, sum(v) AS sv "
          "FROM base GROUP BY k")
    s.insert("base", (8, "h", 2.0, 2))
    s.sql("SELECT * FROM dl")
    s.sql("DROP MATERIALIZED VIEW dl")
    s.sql("DROP TABLE base")
    gc.collect()
    after = sum(device_cache_bytes_by_table(
        broker._iter_tables()).values())
    assert after <= before, (before, after)
    assert port_mv.matview_state_nbytes() >= 0


@pytest.fixture
def one_query_limit(monkeypatch):
    """A memory limit that admits exactly one query at a time: every
    statement's estimate is the whole limit."""
    from snappydata_tpu_torch import resource

    props = config.global_properties()
    old = (props.memory_limit_bytes, props.query_timeout_s)
    props.memory_limit_bytes = 1 << 20
    props.query_timeout_s = 20.0
    monkeypatch.setattr(resource, "estimate_statement_bytes",
                        lambda catalog, stmt: 1 << 20)
    yield props
    props.memory_limit_bytes, props.query_timeout_s = old


def test_fold_and_stale_refresh_under_one_query_limit(one_query_limit):
    """A fold under INSERT ... SELECT, and a stale view's refresh inside
    a query, run their scratch SQL under the statement's own query
    context (no re-admission: under a limit that admits one query they
    would queue behind their own statement); a fold under a bare insert
    is admitted on its own."""
    from snappydata_tpu_torch import resource

    s = _mk(Rec(PORT))
    s.sql("CREATE TABLE src (k INT, name STRING, v DOUBLE, n BIGINT) "
          "USING column")
    s.insert("src", (5, "s", 5.0, 5), (1, "s", 1.0, 1))
    s.sql("CREATE MATERIALIZED VIEW gv AS SELECT k, sum(v) AS sv, "
          "count(*) AS c FROM base GROUP BY k")
    broker = resource.global_broker()
    done = threading.Event()
    errs = []

    def work():
        try:
            s.sql("INSERT INTO base SELECT * FROM src")   # fold inside
            s.insert("base", (2, "b", 1.0, 1))            # bare fold
            s.catalog._matviews["gv"].mark_stale("test")
            rows = s.sql("SELECT * FROM gv ORDER BY k").rows()
            errs.append(rows)
        except Exception as e:  # pragma: no cover
            errs.append(e)
        finally:
            done.set()

    t = threading.Thread(target=work, daemon=True)
    t.start()
    assert done.wait(60), "a fold or refresh queued behind its statement"
    (rows,) = errs
    assert [tuple(r) for r in rows] == [
        (1, 5.0, 3), (2, 11.0, 2), (3, 4.0, 1), (5, 5.0, 1)]
    assert not broker.queries()


@pytest.mark.parametrize("policy_name", POLICIES)
def test_state_accumulates_in_wide_dtypes(policy_name):
    """The [G] state accumulates in float64 for float domains and in
    int64 otherwise under either plate policy, on the session's device,
    and every growth lands on the {2^k, 1.5 * 2^k} ladder."""
    import torch

    with policy(policy_name):
        s = _mk(Rec(PORT))
        s.sql("CREATE MATERIALIZED VIEW wd AS SELECT k, sum(v) AS sv, "
              "sum(n) AS sn, min(v) AS mn, count(*) AS c "
              "FROM base GROUP BY k")
        mv = s.catalog._matviews["wd"]
        assert [t.dtype for t in mv._vals] == [
            torch.float64, torch.int64, torch.float64, torch.int64]
        assert all(t.device.type == "cpu" for t in mv._vals)
        assert mv._rowcount.dtype == torch.int64
        for g in (5, 40, 200):
            s.insert_arrays("base", [
                np.arange(g, dtype=np.int32) + 10,
                np.array(["g"] * g, dtype=object), np.ones(g),
                np.ones(g, dtype=np.int64)])
            s.sql("SELECT count(*) FROM wd")
            cap = mv.snapshot()["capacity"]
            k = cap.bit_length() - 1
            assert cap in (1 << k, 3 << (k - 1)), cap
