"""Observability of the port against the reference: histogram timers and
the Prometheus exposition, the trace ring, the slow-query log, the span
layer with tracing off, EXPLAIN [ANALYZE], the serving trace annotations,
the trace id of a CancelException, the compressed-domain tally
(`code_domain_predicates`, `rle_run_predicates`), the large host-fallback
warning, the status snapshots of `observability/stats_service.py` and the
metrics-hygiene lint over the port's package.

The cases of tests/test_observability.py that need no cluster, run
through the port (and, where the same inputs go through both packages,
held against the reference: counts and keys bit-identical)."""

import threading
import time

import numpy as np
import pytest

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability import stats_service as ref_stats
from snappydata_tpu.observability import tracing as ref_tracing
from snappydata_tpu.observability.metrics import MetricsRegistry as RefReg
from snappydata_tpu.observability.metrics import Timer as RefTimer
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability import stats_service
from snappydata_tpu_torch.observability import tracing
from snappydata_tpu_torch.observability.metrics import (MetricsRegistry,
                                                       Timer,
                                                       global_registry)
from snappydata_tpu_torch.utils import tpch
from torch_parity import Pair, mesh_slots, policy

_KNOBS = ("tracing_enabled", "trace_ring_entries", "slow_query_ms",
          "gidx_cache_bytes", "scan_compressed_domain", "pallas_reduce",
          "pallas_group_reduce", "decimal_as_float64")


@pytest.fixture(autouse=True)
def _restore_knobs():
    props = (config.global_properties(), ref_config.global_properties())
    saved = [{k: p.get(k) for k in _KNOBS} for p in props]
    yield props[0]
    for p, old in zip(props, saved):
        for k, v in old.items():
            setattr(p, k, v)


def _mk_session(n: int = 1000) -> SnappySession:
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql("CREATE TABLE t (g BIGINT, v DOUBLE) USING column")
    s.insert_arrays("t", [np.arange(n, dtype=np.int64) % 4,
                          np.arange(n, dtype=np.float64)])
    return s


# ----------------------------------------------------------------------
# histogram timers and the Prometheus exposition
# ----------------------------------------------------------------------

def test_histogram_quantiles_uniform_distribution():
    t, r = Timer(), RefTimer()
    for i in range(1, 1001):            # 1 ms .. 1000 ms uniform
        t.record(i / 1000.0)
        r.record(i / 1000.0)
    d = t.to_dict()
    assert d == r.to_dict()
    assert d["count"] == 1000
    assert d["min_s"] == 0.001 and d["max_s"] == 1.0
    for key, exact in (("p50_s", 0.500), ("p99_s", 0.990),
                       ("p999_s", 0.999)):
        assert abs(d[key] - exact) / exact < 0.25, (key, d[key], exact)
    assert d["p50_s"] <= d["p99_s"] <= d["p999_s"]
    assert t.prometheus_buckets() == r.prometheus_buckets()


def test_histogram_quantiles_bimodal_tail():
    t = Timer()
    for _ in range(100):
        t.record(0.001)
    t.record(1.0)
    d = t.to_dict()
    assert d["p50_s"] < 0.002
    assert d["p999_s"] > 0.5            # the outlier is visible
    assert d["mean_s"] < 0.02           # ... and the mean hid it
    t2 = Timer()
    for _ in range(50):
        t2.record(0.25)
    d2 = t2.to_dict()
    assert d2["p50_s"] == d2["p99_s"] == d2["p999_s"] == 0.25


def test_query_timer_surfaces_quantiles_in_snapshot():
    s = _mk_session()
    for _ in range(3):
        s.sql("SELECT g, sum(v) FROM t GROUP BY g")
    snap = global_registry().snapshot()
    assert set(snap) == {"counters", "gauges", "timers", "ts"}
    q = snap["timers"]["query"]
    assert {"p50_s", "p99_s", "p999_s"} <= set(q)
    assert 0 < q["p50_s"] <= q["p99_s"] <= q["p999_s"] <= q["max_s"]
    assert global_registry().to_json().startswith("{")
    s.stop()


def test_snapshot_gauge_touching_registry_does_not_deadlock():
    r = MetricsRegistry()
    r.inc("x", 7)
    r.gauge("self_reader", lambda: float(r.counter("x")))
    out = {}

    def snap():
        out["snap"] = r.snapshot()

    th = threading.Thread(target=snap, daemon=True)
    th.start()
    th.join(timeout=5)
    assert not th.is_alive(), "snapshot() deadlocked on a registry gauge"
    assert out["snap"]["gauges"]["self_reader"] == 7.0


def test_prometheus_exposition_types_histograms_collisions():
    outs = []
    for reg in (MetricsRegistry(), RefReg()):
        reg.inc("a.b", 1)
        reg.inc("a_b", 2)
        reg.gauge("g1", lambda: 3.5)
        for ms in (1, 2, 5, 10, 500):
            reg.record_time("lat", ms / 1000.0)
        outs.append(reg.to_prometheus())
    out, ref_out = outs
    assert out == ref_out
    assert "# TYPE snappy_tpu_a_b_total counter" in out
    values = sorted(int(ln.rsplit(" ", 1)[1]) for ln in out.splitlines()
                    if ln.startswith("snappy_tpu_a_b") and
                    ln.split(" ")[0].endswith("_total"))
    assert values == [1, 2]
    assert "# TYPE snappy_tpu_lat_seconds histogram" in out
    assert 'snappy_tpu_lat_seconds_bucket{le="+Inf"} 5' in out
    assert "snappy_tpu_lat_seconds_count 5" in out
    cums = [int(ln.rsplit(" ", 1)[1]) for ln in out.splitlines()
            if ln.startswith("snappy_tpu_lat_seconds_bucket")]
    assert cums == sorted(cums)
    assert 'snappy_tpu_lat_seconds_q{quantile="0.999"}' in out


def test_governor_counters_in_the_prometheus_exposition():
    """The governor's counters and gauges ride the global exposition,
    with unique sanitized names."""
    s = _mk_session()
    s.sql("SELECT sum(v) FROM t")
    out = global_registry().to_prometheus()
    assert "snappy_tpu_governor_admitted_total" in out
    assert "# TYPE snappy_tpu_governor_inflight_bytes gauge" in out
    names = [ln.split(" ")[2] for ln in out.splitlines()
             if ln.startswith("# TYPE")]
    assert len(names) == len(set(names))
    s.stop()


# ----------------------------------------------------------------------
# trace ring / slow-query log / disabled overhead
# ----------------------------------------------------------------------

def test_trace_ring_bounded(_restore_knobs):
    _restore_knobs.trace_ring_entries = 5
    s = _mk_session()
    tracing.ring().clear()
    before = tracing.ring().recorded
    for i in range(12):
        s.sql(f"SELECT count(*) FROM t WHERE g = {i % 4}")
    assert tracing.ring().recorded - before >= 12
    assert len(tracing.ring().traces(100)) <= 5
    s.stop()


def test_slow_query_log_threshold(_restore_knobs):
    s = _mk_session()
    tracing.ring().clear()
    _restore_knobs.slow_query_ms = 1e-4   # everything is "slow"
    c0 = global_registry().counter("slow_queries")
    s.sql("SELECT sum(v) FROM t")
    slow = tracing.ring().slow()
    assert slow and slow[0]["sql"].startswith("SELECT sum(v)")
    assert "root" in slow[0] and slow[0]["root"]["children"]
    assert global_registry().counter("slow_queries") > c0
    _restore_knobs.slow_query_ms = 1e9    # nothing is slow
    n = len(tracing.ring().slow())
    s.sql("SELECT sum(v) FROM t")
    assert len(tracing.ring().slow()) == n
    s.stop()


def test_tracing_disabled_records_nothing_and_spans_are_cheap(
        _restore_knobs):
    _restore_knobs.tracing_enabled = False
    s = _mk_session()
    tracing.ring().clear()
    s.sql("SELECT sum(v) FROM t")
    assert tracing.ring().traces(100) == []
    assert tracing.current() is None
    t0 = time.perf_counter()
    for _ in range(20000):
        with tracing.span("x"):
            pass
    assert time.perf_counter() - t0 < 0.5
    s.stop()


def test_trace_span_children_capped():
    with tracing.request_scope("cap test", user="t", kind="session",
                               force=True) as tr:
        for _ in range(5000):
            with tracing.span("tick"):
                pass
    assert len(tr.root.children) <= 256
    assert tr.root.attrs["children_truncated"] > 0


def test_query_trace_has_the_reference_span_tree():
    """One query's trace: the reference's span names in both packages
    (the port's `jit_compile` marks a static key's first run)."""
    trees = []
    for mk, tr_mod in ((lambda: _mk_session(), tracing),
                       (lambda: _ref_session(), ref_tracing)):
        s = mk()
        tr_mod.ring().clear()
        s.sql("SELECT g, sum(v) FROM t WHERE g > 0 GROUP BY g")
        s.sql("SELECT g, sum(v) FROM t WHERE g > 0 GROUP BY g")
        first, second = reversed(tr_mod.ring().traces(2))
        names = []
        for t in (first, second):
            root = tr_mod.ring().get(t["trace_id"])[0]["root"]
            names.append([c["name"] for c in root["children"]])
        trees.append(names)
        s.stop()
    port, ref = trees
    assert port == ref, (port, ref)
    # a grouped query splits at the group-index cache: phase A ("pre")
    # and phase B ("main") each take a span; the second run is a hit
    assert port[0] == ["parse", "optimize", "analyze", "compile", "bind",
                       "jit_compile", "jit_compile", "transfer"]
    assert port[1] == ["parse", "optimize", "analyze", "bind",
                       "device_execute", "transfer"]


def _ref_session(n: int = 1000) -> RefSession:
    s = RefSession(catalog=RefCatalog())
    s.sql("CREATE TABLE t (g BIGINT, v DOUBLE) USING column")
    s.insert_arrays("t", [np.arange(n, dtype=np.int64) % 4,
                          np.arange(n, dtype=np.float64)])
    return s


# ----------------------------------------------------------------------
# EXPLAIN ANALYZE
# ----------------------------------------------------------------------

def _line(rows, needle):
    for r in rows:
        if needle in r[0]:
            return r[0]
    raise AssertionError(f"no line containing {needle!r} in "
                         f"{[r[0] for r in rows]}")


def _field(line, key) -> str:
    for tok in line.replace("]", " ").replace("[", " ").split():
        if tok.startswith(key + "="):
            return tok.split("=", 1)[1]
    raise AssertionError(f"{key}= not in {line!r}")


def test_explain_analyze_counts_match_engine_counters():
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql("CREATE TABLE big (k BIGINT, v DOUBLE) USING column")
    n = 262144   # exactly 2 full default batches, k ascending
    s.insert_arrays("big", [np.arange(n, dtype=np.int64),
                            np.arange(n, dtype=np.float64)])
    q = "SELECT count(*), sum(v) FROM big WHERE k >= 200000"
    expect = s.sql(q).rows()[0]
    c0 = global_registry().counters_snapshot()
    s.sql(q)
    c1 = global_registry().counters_snapshot()
    seen = c1.get("column_batches_seen", 0) - \
        c0.get("column_batches_seen", 0)
    skipped = c1.get("column_batches_skipped", 0) - \
        c0.get("column_batches_skipped", 0)
    assert seen == 2 and skipped == 1   # min/max stats prune batch 0
    rows = s.sql("EXPLAIN ANALYZE " + q).rows()
    scan = _line(rows, "Scan big")
    assert int(_field(scan, "batches_seen")) == seen
    assert int(_field(scan, "skipped_stats")) == skipped
    assert int(_field(scan, "rows")) == n
    footer = _line(rows, "trace_id=")
    assert int(_field(footer, "rows_out")) == 1
    assert expect[0] == n - 200000
    stats = _line(rows, "batches_seen=2")
    assert _field(stats, "skipped_stats") == "1"
    phases = _line(rows, "phases:")
    assert "bind=" in phases and "transfer=" in phases
    tid = _field(footer, "trace_id")
    assert tracing.ring().get(tid), "EXPLAIN ANALYZE trace not in ring"
    s.stop()


def test_explain_analyze_strategy_and_plain_explain():
    s = _mk_session()
    q = "SELECT g, count(*), sum(v) FROM t GROUP BY g"
    rows = s.sql("EXPLAIN ANALYZE " + q).rows()
    agg = _line(rows, "HashAggregate")
    assert "strategy=" in agg
    assert int(_field(agg, "rows_out")) == 4
    scan = _line(rows, "Scan t")
    assert "code_domain=" in scan
    plain = s.sql("EXPLAIN " + q).rows()
    assert not any("rows_out=" in r[0] for r in plain)
    assert not any("batches_seen=" in r[0] for r in plain)
    s.stop()


def test_explain_analyze_works_with_tracing_disabled(_restore_knobs):
    _restore_knobs.tracing_enabled = False
    s = _mk_session()
    rows = s.sql("EXPLAIN ANALYZE SELECT sum(v) FROM t").rows()
    footer = _line(rows, "rows_out=")
    assert int(_field(footer, "rows_out")) == 1
    assert "phases:" in _line(rows, "phases:")
    s.stop()


def test_explain_analyze_counts_kernel_launches(_restore_knobs,
                                               monkeypatch):
    """The footer's `kernels` line names the session's device, the plate
    bytes of the query's tables resident there, and for each CUDA kernel
    its launches in this pass over the wrapper's count: on the CPU the
    wrappers run their plain versions and count nothing."""
    from snappydata_tpu_torch.ops import group_reduce, kahan_reduce

    _restore_knobs.pallas_reduce = True
    _restore_knobs.pallas_group_reduce = True
    _restore_knobs.decimal_as_float64 = False
    monkeypatch.setattr(kahan_reduce.masked_kahan_sum, "launches", 5)
    monkeypatch.setattr(group_reduce.grouped_reduce, "launches", 3)
    monkeypatch.setattr(kahan_reduce.fused_code_filter_sum, "launches", 0)
    monkeypatch.setattr(group_reduce.grouped_code_reduce, "launches", 0)
    s = _mk_session()
    rows = s.sql("EXPLAIN ANALYZE SELECT g, sum(v) FROM t GROUP BY g").rows()
    line = _line(rows, "kernels ")
    assert line.split() == [
        "kernels", "device=cpu", line.split()[2], "masked_kahan_sum=0/5",
        "grouped_reduce=0/3", "fused_code_filter_sum=0/0",
        "grouped_code_reduce=0/0"]
    assert int(_field(line, "resident_bytes")) > 0
    assert not any(r[0].startswith("kernels ") for r in
                   s.sql("EXPLAIN SELECT sum(v) FROM t").rows())
    s.stop()


def test_explain_analyze_names_the_kernel_lanes(_restore_knobs):
    """With the kernel knobs on, the footer's strategies name the port's
    kernel lanes ("kahan" for a global sum, "grouped" for a grouped
    one): the reference's strategy tuple would drop both."""
    _restore_knobs.pallas_reduce = True
    _restore_knobs.pallas_group_reduce = True
    _restore_knobs.decimal_as_float64 = False   # the kernels' f32 plates
    s = _mk_session()
    agg = _line(s.sql("EXPLAIN ANALYZE SELECT sum(v) FROM t").rows(),
                "HashAggregate")
    assert "kahan" in _field(agg, "strategy").split(",")
    agg = _line(s.sql("EXPLAIN ANALYZE SELECT g, sum(v), count(*) FROM t "
                      "GROUP BY g").rows(), "HashAggregate")
    assert "grouped" in _field(agg, "strategy").split(",")
    s.stop()


# ----------------------------------------------------------------------
# EXPLAIN parity on TPC-H
# ----------------------------------------------------------------------

WINDOW_QUERY = ("SELECT o_orderkey, o_totalprice, rank() OVER "
                "(PARTITION BY o_orderpriority ORDER BY o_totalprice) AS r "
                "FROM orders WHERE o_orderkey < 100")


@pytest.fixture(scope="module")
def tpch_pair():
    pair = Pair()
    sf, seed = 0.001, 4
    n_l = int(tpch.LINEITEM_ROWS_PER_SF * sf)
    n_o = int(tpch.ORDERS_ROWS_PER_SF * sf)
    n_c = int(tpch.CUSTOMER_ROWS_PER_SF * sf)
    li = tpch.gen_lineitem(n_l, seed)
    li["l_orderkey"] = np.minimum(li["l_orderkey"], n_o)
    for ddl, name, cols in (
            (tpch.LINEITEM_DDL, "lineitem", li),
            (tpch.ORDERS_DDL, "orders", tpch.gen_orders(n_o, n_c, seed + 1)),
            (tpch.CUSTOMER_DDL, "customer",
             tpch.gen_customer(n_c, seed + 2))):
        pair.sql(ddl)
        pair.insert_arrays(name, list(cols.values()))
    yield pair


EXPLAINED = {"q1": tpch.Q1, "q6": tpch.Q6, "q3c": tpch.Q3C, "q4": tpch.Q4,
             "window": WINDOW_QUERY}


@pytest.mark.parametrize("name", sorted(EXPLAINED))
def test_plain_explain_text_equals_the_reference(tpch_pair, name):
    port, ref = tpch_pair.sql("EXPLAIN " + EXPLAINED[name])
    assert port == ref
    assert len(port) > 1


_FOOTER_KEYS = ("rows_out", "plan_cache", "host_fallbacks", "batches_seen",
                "skipped_stats", "skipped_dict")


def _analyze(session, q):
    rows = session.sql("EXPLAIN ANALYZE " + q).rows()
    footer = _line(rows, "plan_cache=") + " " + _line(rows, "rows_out=")
    out = {k: _field(footer, k) for k in _FOOTER_KEYS}
    tree = [r[0] for r in rows
            if not r[0].startswith(("== runtime", "rows_out=",
                                    "plan_cache=", "phases:"))]
    agg = [ln for ln in tree if "HashAggregate" in ln and "strategy=" in ln]
    if agg:
        out["strategy"] = _field(agg[0], "strategy")
    join = [ln for ln in tree if "path=" in ln]
    if join:
        out["join_path"] = _field(join[0], "path")
    reasons = [r[0] for r in rows if r[0].startswith("host_fallback_reason")]
    out["host_fallback_reasons"] = len(reasons)
    return out


@pytest.mark.parametrize("name", sorted(EXPLAINED))
def test_explain_analyze_footer_equals_the_reference(tpch_pair, name):
    """Knobs off, both packages take the same lanes on the CPU: equal
    rows out, batches, plan-cache verdict, host fallbacks, join verdicts
    and strategies (the port's strategies restricted to the reference's
    families)."""
    q = EXPLAINED[name]
    with policy("f64"):
        port = _analyze(tpch_pair.port, q)
        ref = _analyze(tpch_pair.ref, q)
    assert port == ref, (name, port, ref)


# ----------------------------------------------------------------------
# serving and errors
# ----------------------------------------------------------------------

def test_serving_trace_annotations():
    s = _mk_session()
    h = s.prepare("SELECT count(*) FROM t WHERE g = ?")
    tracing.ring().clear()
    h.execute((1,))
    h.execute((2,))
    traces = tracing.ring().traces(10)
    kinds = [t["kind"] for t in traces]
    assert kinds.count("serving") >= 2
    tid = [t for t in traces if t["kind"] == "serving"][0]["trace_id"]
    detail = tracing.ring().get(tid)[0]
    assert detail["root"]["attrs"]["serving_registry"] == "hit"
    # the prepared execute lands in the query log like session.sql
    assert [q["sql"] for q in s.recent_queries()[-2:]] == \
        ["SELECT count(*) FROM t WHERE g = ?"] * 2
    s.stop()


def test_cancel_exception_carries_the_trace_id():
    """The trace id of a CancelException, in both packages (the
    reference's DistributedError waits on the front doors)."""
    from snappydata_tpu.resource.context import \
        CancelException as RefCancel
    from snappydata_tpu_torch.resource.context import CancelException

    for exc, tr_mod in ((CancelException, tracing),
                        (RefCancel, ref_tracing)):
        with tr_mod.request_scope("SELECT 1", user="t", kind="session",
                                  force=True) as tr:
            ce = exc("deadline")
        assert ce.trace_id == tr.trace_id
        assert f"[trace {tr.trace_id}]" in str(ce)
        ce2 = exc("deadline")
        assert ce2.trace_id is None and "[trace" not in str(ce2)


def test_cancelled_query_error_joins_its_trace(_restore_knobs):
    """A query cancelled by its statement timeout raises XCL52 with its
    own trace id, and that trace sits in the ring with status error."""
    from snappydata_tpu_torch import resource
    from snappydata_tpu_torch.resource.context import CancelException

    s = _mk_session()
    tracing.ring().clear()
    ctx = resource.new_query("SELECT sum(v) FROM t", "admin")
    ctx.cancel("cancelled by the test")
    with pytest.raises(CancelException) as ei:
        s.sql("SELECT sum(v) FROM t", query_ctx=ctx)
    tid = ei.value.trace_id
    assert tid and f"[trace {tid}]" in str(ei.value)
    got = tracing.ring().get(tid)
    assert got and got[0]["status"] == "error"
    s.stop()


# ----------------------------------------------------------------------
# the compressed-domain tally
# ----------------------------------------------------------------------

def _mixed(make, n=60_000):
    """The mixed-encoding table of tests/test_compressed_domain.py."""
    s = make()
    s.sql("CREATE TABLE mx (k BIGINT, qty DOUBLE, wide DOUBLE, "
          "grp BIGINT, flag BOOLEAN, name STRING, v DOUBLE) USING column")
    rng = np.random.default_rng(17)
    k = np.arange(n, dtype=np.int64)
    qty = np.floor(rng.random(n) * 50) + 1.0
    wide = rng.integers(0, 5000, n).astype(np.float64) * 0.5
    grp = np.sort(rng.integers(0, 6, n)).astype(np.int64)
    flag = (k % 3 == 0)
    name = np.array([f"n{i % 7}" for i in range(n)], dtype=object)
    v = rng.random(n) * 1000
    s.insert_arrays("mx", [k, qty, wide, grp, flag, name, v])
    s.catalog.describe("mx").data.force_rollover()
    return s


COMPRESSED_QUERIES = [
    "SELECT count(*), sum(v) FROM mx WHERE qty = 24",
    "SELECT count(*), sum(v) FROM mx WHERE qty < 24.5",
    "SELECT count(*) FROM mx WHERE wide >= 1250.0",
    "SELECT count(*) FROM mx WHERE grp <= 3",
    "SELECT count(*), sum(v) FROM mx WHERE qty BETWEEN 10 AND 20",
    "SELECT count(*) FROM mx WHERE qty = 10 AND grp >= 2",
    "SELECT count(*) FROM mx WHERE flag",
    "SELECT count(*) FROM mx WHERE name = 'n3'",
    "SELECT grp, count(*), sum(qty), min(wide), max(qty) FROM mx "
    "GROUP BY grp ORDER BY grp",
    "SELECT sum(qty * v), avg(wide) FROM mx WHERE grp <= 4",
    # a grouped query with a code-plate filter, run twice: the second
    # run is a group-index cache hit, which skips phase A's predicates
    "SELECT name, sum(v) FROM mx WHERE qty < 30 GROUP BY name "
    "ORDER BY name",
    "SELECT name, sum(v) FROM mx WHERE qty < 30 GROUP BY name "
    "ORDER BY name",
]


def test_compressed_domain_tally_equals_the_reference():
    names = ("code_domain_predicates", "rle_run_predicates",
             "gidx_cache_hits", "gidx_cache_misses")
    deltas = []
    for make, reg in (
            (lambda: SnappySession(catalog=Catalog(), device="cpu"),
             global_registry()),
            (lambda: RefSession(catalog=RefCatalog()), ref_registry())):
        s = _mixed(make)
        per = []
        for q in COMPRESSED_QUERIES:
            c0 = reg.counters_snapshot()
            rows = s.sql(q).rows()
            c1 = reg.counters_snapshot()
            per.append((rows, {k: c1.get(k, 0) - c0.get(k, 0)
                               for k in names}))
        h = s.prepare("SELECT count(*), sum(v) FROM mx WHERE qty = ?")
        for lit in (10.0, 24.5, 50.0):
            c0 = reg.counters_snapshot()
            rows = h.execute((lit,)).rows()
            c1 = reg.counters_snapshot()
            per.append((rows, {k: c1.get(k, 0) - c0.get(k, 0)
                               for k in names}))
        deltas.append(per)
        s.stop()
    port, ref = deltas
    for q, (prow, pd), (rrow, rd) in zip(
            COMPRESSED_QUERIES + ["prepared"] * 3, port, ref):
        assert pd == rd, (q, pd, rd)
        assert len(prow) == len(rrow)
        for a, b in zip(prow, rrow):
            assert a == pytest.approx(b, rel=1e-9), (q, a, b)
    assert sum(d["code_domain_predicates"] for _, d in port) > 0
    assert sum(d["rle_run_predicates"] for _, d in port) > 0
    # the reference counts phase A's filter twice on a miss (its phase B
    # re-lowers it as dead code) and once on a hit; the port gives the
    # same totals
    miss, hit = port[-5][1], port[-4][1]
    assert (miss["gidx_cache_misses"], hit["gidx_cache_hits"]) == (1, 1)
    assert hit["code_domain_predicates"] * 2 == \
        miss["code_domain_predicates"] > 0


def test_large_host_fallback_warns_once(capsys):
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.conf.set("host_fallback_warn_rows", 100)
    try:
        s.sql("CREATE TABLE w (k BIGINT, x DOUBLE) USING column")
        s.insert_arrays("w", [np.arange(500, dtype=np.int64),
                              np.arange(500, dtype=np.float64)])
        # lag() with a default takes the host window lane: a counted
        # host fallback over 500 rows
        q = "SELECT k, lag(x, 1, 0.0) OVER (ORDER BY k) FROM w"
        c0 = global_registry().counter("host_fallbacks")
        for _ in range(3):
            s.sql(q)
        assert global_registry().counter("host_fallbacks") > c0
        err = capsys.readouterr().err
        assert err.count("running on the HOST path") == 1
        assert "~500 rows" in err
    finally:
        s.conf.extra.pop("host_fallback_warn_rows", None)
        s.stop()


# ----------------------------------------------------------------------
# the stats service and the metrics lint
# ----------------------------------------------------------------------

def _stats_pair():
    out = []
    for s in (SnappySession(catalog=Catalog(), device="cpu"),
              RefSession(catalog=RefCatalog())):
        s.sql("CREATE TABLE st (k BIGINT, q DOUBLE, name STRING) "
              "USING column")
        n = 5000
        s.insert_arrays("st", [np.arange(n, dtype=np.int64),
                               np.floor(np.arange(n) % 50) + 1.0,
                               np.array([f"n{i % 7}" for i in range(n)],
                                        dtype=object)])
        s.catalog.describe("st").data.force_rollover()
        s.sql("CREATE TABLE kv (id BIGINT PRIMARY KEY, v DOUBLE) "
              "USING row")
        s.sql("INSERT INTO kv VALUES (1, 2.0), (2, 3.0)")
        s.sql("SELECT count(*), sum(q) FROM st WHERE q < 10")
        out.append(s)
    return out


def test_stats_snapshots_equal_the_reference():
    port, ref = _stats_pair()
    a = stats_service.TableStatsService(port.catalog).collect_once()
    b = ref_stats.TableStatsService(ref.catalog).collect_once()
    drop = ("data_id", "in_memory_bytes")
    assert {t: {k: v for k, v in d.items() if k not in drop}
            for t, d in a.items()} == \
        {t: {k: v for k, v in d.items() if k not in drop}
         for t, d in b.items()}
    ma = stats_service.encoding_mix(port.catalog)["st"]
    mb = ref_stats.encoding_mix(ref.catalog)["st"]
    for k in ("rows", "batches", "encoding_mix", "at_rest_bytes",
              "decoded_bytes"):
        assert ma[k] == mb[k], (k, ma[k], mb[k])
    # every status snapshot answers with the reference's keys
    for fn in ("durability_snapshot", "join_snapshot", "storage_snapshot"):
        assert set(getattr(stats_service, fn)()) == \
            set(getattr(ref_stats, fn)()), fn
    for fn in ("scan_snapshot", "mvcc_snapshot", "ha_snapshot"):
        pa = getattr(stats_service, fn)(port.catalog)
        pb = getattr(ref_stats, fn)(ref.catalog)
        assert set(pa) == set(pb), fn
    ms = stats_service.mesh_snapshot(port.catalog)
    assert set(ms) == set(ref_stats.mesh_snapshot(ref.catalog))
    assert ms["active"] is False
    assert ms["mesh_shard_execs"] == \
        global_registry().counter("mesh_shard_execs")
    # an active 2-slot mesh: the port reports it under the reference's
    # keys, with the same bucket map and per-slot resident bytes
    from snappydata_tpu.parallel import MeshContext as RefMeshContext
    from snappydata_tpu.parallel import data_mesh as ref_data_mesh
    from snappydata_tpu_torch.parallel import MeshContext, data_mesh

    with mesh_slots(2), MeshContext(data_mesh(2)) as pctx, \
            RefMeshContext(ref_data_mesh(2)):
        execs = global_registry().counter("mesh_shard_execs")
        port.sql("SELECT count(*), sum(q) FROM st WHERE q < 10")
        ms = stats_service.mesh_snapshot(port.catalog)
        mr = ref_stats.mesh_snapshot(ref.catalog)
    assert set(ms) == set(mr)
    assert ms["active"] and ms["num_devices"] == 2
    assert ms["token"] == pctx.token
    assert ms["mesh_shard_execs"] == execs + 1
    assert ms["placement"]["bucket_map"] == mr["placement"]["bucket_map"]
    slots = {k: v for k, v in ms["resident_bytes_by_device"].items()
             if k.startswith("slot")}
    assert sorted(slots) == ["slot0:cpu", "slot1:cpu"]
    assert all(v > 0 for v in slots.values())
    mv_a = stats_service.mvcc_snapshot(port.catalog)["tables"]["st"]
    mv_b = ref_stats.mvcc_snapshot(ref.catalog)["tables"]["st"]
    assert mv_a["version"] == mv_b["version"]
    assert stats_service.tracing_snapshot()["tracing_enabled"] is \
        ref_stats.tracing_snapshot()["tracing_enabled"]
    port.stop()
    ref.stop()


def test_stats_service_thread_and_device_bytes():
    port, ref = _stats_pair()
    svc = stats_service.TableStatsService(port.catalog,
                                          interval_s=0.01).start()
    try:
        time.sleep(0.05)
        assert svc.current()["st"]["row_count"] == 5000
        gauges = global_registry().gauges()
        assert gauges["tables_total"] == 2.0
    finally:
        svc.stop()
    from snappydata_tpu_torch.storage.device import \
        device_cache_bytes_by_table

    mix = stats_service.encoding_mix(port.catalog)
    dev = device_cache_bytes_by_table(
        [(i.name, i.data) for i in port.catalog.list_tables()])
    assert mix["st"]["device_resident_bytes"] == dev["st"] > 0
    port.stop()
    ref.stop()


def test_metrics_lint_over_the_port():
    """Every metric name the port uses is declared in its own
    metric_names.py, and no two collide after sanitization."""
    from tools.locklint import metrics_lint

    findings = metrics_lint.run(
        ["snappydata_tpu_torch"],
        "snappydata_tpu_torch/observability/metric_names.py")
    assert findings == [], findings
    declared = metrics_lint.load_declared(
        "snappydata_tpu_torch/observability/metric_names.py")
    for s in ("kahan", "grouped"):
        assert f"agg_strategy_{s}" in declared["counter"]
