"""AQP of the port against the reference's: stratified sample tables,
the approximate rewrite, the sketches, TopK, and the HAC error surface
(ports the cases of tests/test_aqp.py and tests/test_aqp_error.py).

Each case runs the same seeded rows through the JAX package's session
and the port's (on the CPU).  The reservoirs draw from the same seeded
generator, so the samples are the same rows and every estimate, error
and bound must agree within the f64 parity bar; the reference tests'
own checks (against the exact answers) hold on the port's results too.
The estimator's distributed entry waits for the cluster front doors.
"""

import numpy as np
import pytest

from torch_parity import Pair, assert_rows_equal

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu.aqp import error_estimation as ref_ee
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.sql import parser as ref_parser
from snappydata_tpu_torch import SnappySession
from snappydata_tpu_torch.aqp import (CountMinSketch, StratifiedReservoir,
                                      TopKSummary)
from snappydata_tpu_torch.aqp import error_estimation as ee
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.sql import parser

REL = 1e-9


def _pair():
    return Pair("f64", routed=("host_fallbacks",))


def _rows(r):
    return [tuple(x) for x in r.rows()]


def _both(pair, fn):
    """fn(session) in the port and the reference: (port, ref) results,
    asserted equal where they are row lists."""
    got = fn(pair.port)
    want = fn(pair.ref)
    return got, want


def _sql_both(pair, q, approx=False):
    """Rows of `q` (or of approx_sql(q)) in both packages, asserted equal
    within the parity bar; returns the port's."""
    def run(s):
        return _rows(s.approx_sql(q) if approx else s.sql(q))

    got, want = _both(pair, run)
    assert_rows_equal(got, want, REL)
    return got


def _err_both(pair, q, port_exc, ref_exc):
    with pytest.raises(port_exc):
        pair.port.sql(q)
    with pytest.raises(ref_exc):
        pair.ref.sql(q)


# ------------------------------------------------------------------
# tests/test_aqp.py
# ------------------------------------------------------------------

def _load_base(pair, n=20000, seed=4):
    pair.sql("CREATE TABLE tx (region STRING, amount DOUBLE) USING column")
    rng = np.random.default_rng(seed)
    regions = np.array(["east", "west", "north", "rare"], dtype=object)
    probs = np.array([0.5, 0.3, 0.198, 0.002])
    reg = regions[rng.choice(4, n, p=probs)]
    amt = np.round(rng.random(n) * 100, 2)
    pair.insert_arrays("tx", [reg, amt])
    return reg, amt


def test_stratified_reservoir_keeps_rare_strata():
    from snappydata_tpu.aqp import StratifiedReservoir as RefReservoir

    stats = []
    for cls in (StratifiedReservoir, RefReservoir):
        r = cls([0], 2, reservoir_size=20)
        rng = np.random.default_rng(0)
        keys = np.array(["common"] * 9990 + ["rare"] * 10, dtype=object)
        r.observe([keys, rng.random(10000)])
        stats.append(r.stats())
    assert stats[0] == stats[1]
    assert stats[0][("rare",)][0] == 10      # all rare rows kept
    assert stats[0][("common",)] == (20, 9990)


def test_create_sample_table_and_weighted_estimates():
    p = _pair()
    _load_base(p)
    p.sql("CREATE SAMPLE TABLE tx_sample ON tx OPTIONS "
          "(qcs 'region', reservoir_size '200')")
    exact = _sql_both(p, "SELECT count(*), sum(amount) FROM tx")[0]
    approx = _sql_both(p, "SELECT count(*), sum(amount) FROM tx",
                       approx=True)[0]
    assert approx[0] == pytest.approx(exact[0], rel=0.05)
    assert approx[1] == pytest.approx(exact[1], rel=0.1)
    grouped = dict(_sql_both(p, "SELECT region, count(*) FROM tx "
                                "GROUP BY region ORDER BY region",
                             approx=True))
    exact_g = dict(_sql_both(p, "SELECT region, count(*) FROM tx "
                                "GROUP BY region ORDER BY region"))
    assert set(grouped) == set(exact_g)
    assert grouped["rare"] == exact_g["rare"]  # a fully kept stratum


def test_sample_table_direct_query_and_avg_rewrite():
    p = _pair()
    _load_base(p)
    p.sql("CREATE SAMPLE TABLE tx_sample ON tx OPTIONS "
          "(qcs 'region', reservoir_size '100')")
    direct = _sql_both(p, "SELECT count(*) FROM tx_sample")[0][0]
    assert 0 < direct <= 500
    exact_avg = _sql_both(p, "SELECT avg(amount) FROM tx")[0][0]
    approx_avg = _sql_both(p, "SELECT avg(amount) FROM tx",
                           approx=True)[0][0]
    assert approx_avg == pytest.approx(exact_avg, rel=0.15)


def test_sample_follows_new_inserts():
    p = _pair()
    _load_base(p, n=5000)
    p.sql("CREATE SAMPLE TABLE tx_sample ON tx OPTIONS (qcs 'region')")
    before = _sql_both(p, "SELECT count(*) FROM tx", approx=True)[0][0]
    for s in (p.port, p.ref):
        s.insert_arrays("tx", [np.array(["south"] * 5000, dtype=object),
                               np.ones(5000)])
    after = _sql_both(p, "SELECT count(*) FROM tx", approx=True)[0][0]
    assert after == pytest.approx(10000, rel=0.05)
    assert after > before


def test_count_min_sketch():
    from collections import Counter

    from snappydata_tpu.aqp import CountMinSketch as RefCMS

    rng = np.random.default_rng(1)
    keys = rng.zipf(1.5, 50000).astype(np.int64)
    keys = keys[keys < 1000]
    truth = Counter(keys.tolist())
    probes = np.array(list(truth)[:50], dtype=np.int64)
    ests = []
    for cls in (CountMinSketch, RefCMS):
        cms = cls(depth=5, width=4096)
        cms.add(keys)
        ests.append((cms.estimate(probes), cms.merge(cms).estimate(probes),
                     cms.total))
    (est, merged, total), (rest, rmerged, rtotal) = ests
    assert np.array_equal(est, rest) and np.array_equal(merged, rmerged)
    assert total == rtotal
    for k, e in zip(probes, est):
        assert e >= truth[int(k)]                 # never undercounts
        assert e <= truth[int(k)] + 0.02 * total
    assert merged[0] >= 2 * truth[int(probes[0])]


def test_topk_summary_and_session_api():
    from collections import Counter

    p = _pair()
    p.sql("CREATE TABLE clicks (page STRING, n INT) USING column")
    rng = np.random.default_rng(2)
    pages = np.array([f"page{i}" for i in range(100)], dtype=object)
    weights = 1.0 / np.arange(1, 101)
    weights /= weights.sum()
    data = pages[rng.choice(100, 30000, p=weights)]
    tops = []
    for s in (p.port, p.ref):
        s.create_topk("hot_pages", "clicks", "page", k=10)
        s.insert_arrays("clicks", [data.copy(),
                                   np.ones(len(data), dtype=np.int32)])
        tops.append(_rows(s.query_topk("hot_pages", 5)))
    assert tops[0] == tops[1]
    assert len(tops[0]) == 5
    truth = [k for k, _ in Counter(data.tolist()).most_common(5)]
    assert set(r[0] for r in tops[0][:3]) <= set(truth[:6])
    # the standalone summary agrees too
    from snappydata_tpu.aqp import TopKSummary as RefTopK

    a, b = TopKSummary(k=10), RefTopK(k=10)
    a.observe(data)
    b.observe(data)
    assert a.top(5) == b.top(5)


# ------------------------------------------------------------------
# tests/test_aqp_error.py — parsing
# ------------------------------------------------------------------

def _parse_both(q):
    return parser.parse(q), ref_parser.parse(q)


def test_with_error_clause_parses():
    for stmt in _parse_both("SELECT sum(x) FROM t WITH ERROR 0.1 "
                            "CONFIDENCE 0.9 BEHAVIOR 'local_omit'"):
        assert stmt.with_error.error == pytest.approx(0.1)
        assert stmt.with_error.confidence == pytest.approx(0.9)
        assert stmt.with_error.behavior == "local_omit"


def test_with_error_defaults():
    for stmt in _parse_both("SELECT sum(x) FROM t WITH ERROR 0.2"):
        assert stmt.with_error.confidence == pytest.approx(0.95)
        assert stmt.with_error.behavior == "do_nothing"


@pytest.mark.parametrize("q", [
    "SELECT sum(x) FROM t WITH ERROR 0.1 BEHAVIOR 'explode'",
    "SELECT sum(x) FROM t WITH ERROR 1.5"], ids=["behavior", "fraction"])
def test_with_error_rejects_bad_clauses(q):
    with pytest.raises(parser.SQLSyntaxError):
        parser.parse(q)
    with pytest.raises(ref_parser.SQLSyntaxError):
        ref_parser.parse(q)


def test_plain_with_cte_still_parses():
    for stmt in _parse_both("WITH c AS (SELECT 1 AS a) SELECT a FROM c"):
        assert stmt.with_error is None


# ------------------------------------------------------------------
# error functions + estimates
# ------------------------------------------------------------------

def _make_base(pair, n=20000, seed=0):
    pair.sql("CREATE TABLE airline (carrier STRING, delay DOUBLE, "
             "month_ INT) USING column")
    rng = np.random.default_rng(seed)
    carriers = np.array(["AA", "UA", "DL", "WN"],
                        dtype=object)[rng.integers(0, 4, n)]
    delay = rng.normal(10, 5, n)
    month = rng.integers(1, 13, n).astype(np.int32)
    pair.insert_arrays("airline", [carriers, delay, month])
    return carriers, delay, month


@pytest.fixture(scope="module")
def sess():
    p = _pair()
    carriers, delay, month = _make_base(p)
    p.sql("CREATE SAMPLE TABLE airline_sample ON airline OPTIONS "
          "(baseTable 'airline', qcs 'carrier', reservoir_size '200')")
    return p, carriers, delay, month


def test_error_functions_shape_and_consistency(sess):
    p, _c, _d, _m = sess
    rows = _sql_both(
        p, "SELECT carrier, avg(delay) AS ad, absolute_error(ad) AS ae, "
           "relative_error(ad) AS re, lower_bound(ad) AS lb, "
           "upper_bound(ad) AS ub FROM airline GROUP BY carrier "
           "ORDER BY carrier WITH ERROR 0.5 CONFIDENCE 0.95")
    assert [r[0] for r in rows] == ["AA", "DL", "UA", "WN"]
    for _, ad, ae, re, lb, ub in rows:
        assert ae > 0
        assert re == pytest.approx(ae / abs(ad))
        assert lb == pytest.approx(ad - ae)
        assert ub == pytest.approx(ad + ae)
        assert lb < ad < ub


def test_count_star_no_filter_is_exact(sess):
    p, carriers, _d, _m = sess
    c, ae, lb, ub = _sql_both(
        p, "SELECT count(*) AS c, absolute_error(c) AS ae, "
           "lower_bound(c) AS lb, upper_bound(c) AS ub "
           "FROM airline WITH ERROR 0.5")[0]
    assert c == len(carriers)
    assert ae == pytest.approx(0.0)
    assert lb == pytest.approx(c) and ub == pytest.approx(c)


def test_filtered_estimates_near_exact(sess):
    p, _c, delay, month = sess
    c, sd, clb, cub, slb, sub = _sql_both(
        p, "SELECT count(*) AS c, sum(delay) AS sd, "
           "lower_bound(c) AS clb, upper_bound(c) AS cub, "
           "lower_bound(sd) AS slb, upper_bound(sd) AS sub "
           "FROM airline WHERE month_ <= 6 WITH ERROR 0.5")[0]
    m = month <= 6
    assert clb < cub and slb < sub
    width_c, width_s = (cub - clb) / 2, (sub - slb) / 2
    assert abs(c - m.sum()) < 4 * max(width_c, 1)
    assert abs(sd - delay[m].sum()) < 4 * max(width_s, 1)


def test_sample_alias_returns_true_sample_answer(sess):
    p, carriers, _d, _m = sess
    c, sample_c = _sql_both(p, "SELECT count(*) AS c, count(*) AS "
                               "sample_c FROM airline WITH ERROR 0.5")[0]
    n_sample = _sql_both(p, "SELECT count(*) FROM airline_sample")[0][0]
    assert sample_c == n_sample
    assert c == len(carriers)
    assert sample_c < c


def test_unsampled_table_runs_exact_with_zero_errors(sess):
    p, _c, _d, _m = sess
    p.sql("DROP TABLE IF EXISTS plain_t")
    p.sql("CREATE TABLE plain_t (v DOUBLE) USING column")
    p.sql("INSERT INTO plain_t VALUES (1.0), (2.0), (3.0)")
    sv, ae, re, lb = _sql_both(
        p, "SELECT sum(v) AS sv, absolute_error(sv) AS ae, "
           "relative_error(sv) AS re, lower_bound(sv) AS lb "
           "FROM plain_t WITH ERROR 0.1")[0]
    assert sv == pytest.approx(6.0)
    assert ae == 0.0 and re == 0.0
    assert lb is None   # bounds are NULL on base-table execution


@pytest.mark.parametrize("q", [
    "SELECT count(DISTINCT month_) FROM airline WITH ERROR 0.1",
    "SELECT absolute_error(nope) FROM airline WITH ERROR 0.1",
    "SELECT carrier, sum(delay) AS sd FROM airline GROUP BY carrier "
    "HAVING length(carrier) > 1 WITH ERROR 0.1"],
    ids=["distinct", "unknown_alias", "having_function"])
def test_unsupported_shapes_raise(sess, q):
    p, _c, _d, _m = sess
    _err_both(p, q, ee.AQPUnsupported, ref_ee.AQPUnsupported)


def test_having_filters_on_estimates(sess):
    p, _c, _d, _m = sess
    all_rows = _sql_both(p, "SELECT carrier, sum(delay) AS sd FROM airline "
                            "GROUP BY carrier WITH ERROR 0.5")
    assert len(all_rows) >= 2
    # between two estimates, not at one: the port's and the reference's
    # sums may differ in the last bits
    ests = sorted(r[1] for r in all_rows)
    mid = len(ests) // 2
    cutoff = (ests[mid - 1] + ests[mid]) / 2
    kept = _sql_both(p, f"SELECT carrier, sum(delay) AS sd FROM airline "
                        f"GROUP BY carrier HAVING sum(delay) > {cutoff} "
                        f"WITH ERROR 0.5")
    assert {r[0] for r in kept} == \
        {r[0] for r in all_rows if r[1] > cutoff}
    kept2 = _sql_both(p, f"SELECT carrier, sum(delay) AS sd FROM airline "
                         f"GROUP BY carrier HAVING sd > {cutoff} "
                         f"WITH ERROR 0.5")
    assert {r[0] for r in kept2} == {r[0] for r in kept}


def test_rollup_with_error(sess):
    p, _c, _d, _m = sess
    rows = _sql_both(
        p, "SELECT carrier, sum(delay) AS sd, absolute_error(sd) AS ae "
           "FROM airline GROUP BY ROLLUP(carrier) WITH ERROR 0.5")
    per_carrier = [r for r in rows if r[0] is not None]
    grand = [r for r in rows if r[0] is None]
    assert len(per_carrier) == 4 and len(grand) == 1
    assert all(r[2] is not None and r[2] >= 0 for r in rows)
    assert grand[0][1] == pytest.approx(
        sum(r[1] for r in per_carrier), rel=0.2)
    plain = _sql_both(p, "SELECT month_, count(*) FROM airline "
                         "GROUP BY ROLLUP(month_) ORDER BY month_")
    assert len(plain) == 13


# ------------------------------------------------------------------
# behaviors
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def behavior_sess():
    """One noisy group (mean near 0: a huge relative error) among stable
    ones."""
    p = _pair()
    p.sql("CREATE TABLE m (g STRING, v DOUBLE) USING column")
    rng = np.random.default_rng(5)
    n = 8000
    g = np.array(["a", "b", "c", "noisy"], dtype=object)[
        rng.integers(0, 4, n)]
    v = np.where(g == "noisy", rng.normal(0.02, 50, n),
                 rng.normal(100, 1, n))
    p.insert_arrays("m", [g, v])
    p.sql("CREATE SAMPLE TABLE m_sample ON m OPTIONS (baseTable 'm', "
          "qcs 'g', reservoir_size '150')")
    return p, {"g": g, "v": v}


def test_behavior_do_nothing_returns_estimates(behavior_sess):
    p, _ = behavior_sess
    rows = _sql_both(p, "SELECT g, avg(v) AS av FROM m GROUP BY g "
                        "ORDER BY g WITH ERROR 0.05 BEHAVIOR 'do_nothing'")
    assert len(rows) == 4
    assert all(row[1] is not None for row in rows)


def test_behavior_strict_raises(behavior_sess):
    p, _ = behavior_sess
    _err_both(p, "SELECT g, avg(v) AS av FROM m GROUP BY g "
                 "WITH ERROR 0.05 BEHAVIOR 'strict'",
              ee.HACViolation, ref_ee.HACViolation)


def test_behavior_local_omit_nulls_violators(behavior_sess):
    p, _ = behavior_sess
    got = dict(_sql_both(p, "SELECT g, avg(v) AS av FROM m GROUP BY g "
                            "ORDER BY g WITH ERROR 0.05 "
                            "BEHAVIOR 'local_omit'"))
    assert got["noisy"] is None
    for k in ("a", "b", "c"):
        assert got[k] == pytest.approx(100, rel=0.1)


def test_behavior_run_on_full_table_gives_exact(behavior_sess):
    p, df = behavior_sess
    rows = _sql_both(p, "SELECT g, avg(v) AS av, absolute_error(av) AS ae, "
                        "lower_bound(av) AS lb FROM m GROUP BY g ORDER BY g "
                        "WITH ERROR 0.05 BEHAVIOR 'run_on_full_table'")
    for g_, av, ae, lb in rows:
        assert av == pytest.approx(df["v"][df["g"] == g_].mean())
        assert ae == 0.0
        assert lb is None


def test_behavior_partial_run_replaces_only_violators(behavior_sess):
    p, df = behavior_sess
    got = {r[0]: (r[1], r[2]) for r in _sql_both(
        p, "SELECT g, avg(v) AS av, absolute_error(av) AS ae FROM m "
           "GROUP BY g ORDER BY g "
           "WITH ERROR 0.05 BEHAVIOR 'partial_run_on_base_table'")}
    exact_noisy = df["v"][df["g"] == "noisy"].mean()
    assert got["noisy"][0] == pytest.approx(exact_noisy)
    assert got["noisy"][1] == 0.0
    assert any(got[k][1] > 0 for k in ("a", "b", "c"))


# ------------------------------------------------------------------
# calibration and scale
# ------------------------------------------------------------------

def test_monte_carlo_interval_coverage():
    """Across K independently seeded samples the 90% interval of a
    FILTERED sum covers the exact answer at about the stated confidence
    (Binomial(30, 0.9): P(X < 22) < 0.004).  The port runs all K seeds;
    the first PARITY_SEEDS of them also run through the reference, whose
    estimate and bounds must be the port's."""
    p = _pair()
    _c, delay, month = _make_base(p, n=12000, seed=42)
    m = month <= 4
    exact_sum = float(delay[m].sum())
    exact_cnt = int(m.sum())
    q = ("SELECT sum(delay) AS sd, lower_bound(sd) AS slb, "
         "upper_bound(sd) AS sub, count(*) AS c, "
         "lower_bound(c) AS clb, upper_bound(c) AS cub "
         "FROM airline WHERE month_ <= 4 WITH ERROR 0.9 CONFIDENCE 0.9")
    K, cover_sum, cover_cnt, ests = 30, 0, 0, []
    for i in range(K):
        ddl = ["DROP TABLE IF EXISTS airline_sample",
               "CREATE SAMPLE TABLE airline_sample ON airline OPTIONS "
               f"(baseTable 'airline', qcs 'carrier', "
               f"reservoir_size '250', seed '{i}')"]
        if i < PARITY_SEEDS:
            for d in ddl:
                p.sql(d)
            row = _sql_both(p, q)[0]
        else:
            for d in ddl:
                p.port.sql(d)
            row = _rows(p.port.sql(q))[0]
        sd, slb, sub, c, clb, cub = row
        ests.append(sd)
        cover_sum += slb <= exact_sum <= sub
        cover_cnt += clb <= exact_cnt <= cub
    assert cover_sum >= 22, f"sum coverage {cover_sum}/{K}"
    assert cover_cnt >= 22, f"count coverage {cover_cnt}/{K}"
    assert np.mean(ests) == pytest.approx(exact_sum, rel=0.05)


PARITY_SEEDS = 3


def test_group_order_differs_from_select_order():
    """SELECT lists the groups in another order than GROUP BY; the
    exact re-run path must not swap the group columns."""
    p = _pair()
    p.sql("CREATE TABLE g2 (a STRING, b STRING, x DOUBLE) USING column")
    rng = np.random.default_rng(2)
    n = 4000
    a = np.array(["a1", "a2"], dtype=object)[rng.integers(0, 2, n)]
    b = np.array(["b1", "b2"], dtype=object)[rng.integers(0, 2, n)]
    x = rng.normal(50, 2, n)
    p.insert_arrays("g2", [a, b, x])
    p.sql("CREATE SAMPLE TABLE g2_s ON g2 OPTIONS (baseTable 'g2', "
          "qcs 'a', reservoir_size '100')")
    rows = _sql_both(p, "SELECT b, a, avg(x) AS ax FROM g2 GROUP BY a, b "
                        "ORDER BY a, b WITH ERROR 0.00001 "
                        "BEHAVIOR 'run_on_full_table'")
    for bv, av, ax in rows:
        assert av.startswith("a") and bv.startswith("b")
        assert ax == pytest.approx(x[(a == av) & (b == bv)].mean())


def test_empty_sample_global_aggregate_contract():
    """SUM over an empty sample answers NULL, COUNT answers 0."""
    p = _pair()
    p.sql("CREATE TABLE empt (x DOUBLE) USING column")
    p.sql("CREATE SAMPLE TABLE empt_s ON empt OPTIONS (baseTable 'empt', "
          "reservoir_size '50')")
    assert _sql_both(p, "SELECT sum(x) AS sx, count(*) AS c FROM empt "
                        "WITH ERROR 0.5") == [(None, 0)]


def test_base_table_underscore_spelling():
    p = _pair()
    p.sql("CREATE TABLE bt (x DOUBLE) USING column")
    p.insert_arrays("bt", [np.arange(1000, dtype=np.float64)])
    p.sql("CREATE SAMPLE TABLE bt_s ON bt OPTIONS (base_table 'bt', "
          "reservoir_size '100')")
    _sx, ae = _sql_both(p, "SELECT sum(x) AS sx, absolute_error(sx) AS ae "
                           "FROM bt WITH ERROR 0.9")[0]
    assert ae is not None and ae > 0   # estimated, not the exact path


def test_best_qcs_sample_selection():
    """Several samples on one base: the estimator picks the sample whose
    QCS best matches the query's columns — exact match > superset >
    largest-overlap subset, the largest sample on ties."""
    p = _pair()
    p.sql("CREATE TABLE ms (a STRING, b STRING, v DOUBLE) USING column")
    rng = np.random.default_rng(4)
    n = 3000
    p.insert_arrays("ms", [
        rng.choice(np.array(["x", "y", "z"], dtype=object), n),
        rng.choice(np.array(["p", "q"], dtype=object), n),
        rng.random(n)])
    for name, qcs in (("ms_a", "a"), ("ms_ab", "a,b"), ("ms_b", "b")):
        p.sql(f"CREATE SAMPLE TABLE {name} ON ms OPTIONS (baseTable 'ms', "
              f"qcs '{qcs}', reservoir_size '60')")
    cands = ["ms_a", "ms_ab", "ms_b"]
    ctx = ee._ExecCtx(catalog=p.port.catalog, run_phases=None,
                      run_exact=None, refresh=lambda: None)
    rctx = ref_ee._ExecCtx(catalog=p.ref.catalog, run_phases=None,
                           run_exact=None, refresh=lambda: None)

    def pick(sql_text):
        out = []
        for mod, prs, c in ((ee, parser, ctx), (ref_ee, ref_parser, rctx)):
            node = prs.parse(sql_text).plan
            while type(node).__name__ != "Aggregate":
                node = node.children()[0]
            out.append(mod._select_sample(c, node, None, cands))
        assert out[0] == out[1], sql_text
        return out[0]

    assert pick("SELECT a, sum(v) FROM ms GROUP BY a") == "ms_a"
    assert pick("SELECT b, sum(v) FROM ms GROUP BY b") == "ms_b"
    assert pick("SELECT a, b, sum(v) FROM ms GROUP BY a, b") == "ms_ab"
    assert pick("SELECT b, sum(v) FROM ms WHERE a = 'x' GROUP BY b") \
        == "ms_ab"
    assert len(_sql_both(p, "SELECT a, sum(v) AS sv, absolute_error(sv) "
                            "FROM ms GROUP BY a ORDER BY a "
                            "WITH ERROR 0.9")) == 3


def test_100k_group_with_error_completes():
    """The vectorized strata combine at scale: a 100k-group WITH ERROR
    query completes, and its estimates are the per-stratum exact sums (a
    2-row stratum keeps every row: weight 1, variance 0).  The port is
    held against numpy here; the reference takes half a minute on this
    shape (it is a slow-marked test there), and the same estimator runs
    through both packages in the cases above."""
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql("CREATE TABLE wide (g BIGINT, v DOUBLE) USING column")
    n = 200_000
    rng = np.random.default_rng(5)
    g = np.arange(n, dtype=np.int64) % 100_000
    v = rng.random(n)
    s.insert_arrays("wide", [g, v])
    s.sql("CREATE SAMPLE TABLE wide_s ON wide OPTIONS (baseTable "
          "'wide', qcs 'g', reservoir_size '2')")
    rows = _rows(s.sql("SELECT g, sum(v) AS sv, absolute_error(sv) "
                       "FROM wide GROUP BY g WITH ERROR 0.99"))
    assert len(rows) == 100_000
    exact = np.bincount(g, weights=v)
    for gi, sv, ae in rows[:1000]:
        assert sv == pytest.approx(exact[gi], rel=1e-9), gi
        assert ae == 0.0
    s.stop()


def test_distributed_estimation_waits_for_the_front_doors():
    """WITH ERROR over a cluster of each package (the phase aggregates fan
    to every server, the lead merges the strata): the estimates, their
    errors and bounds, the exact count's zero error and the exact re-run
    of BEHAVIOR 'run_on_full_table' equal the reference's.  (The name is
    kept from the slice before the distributed session, when the
    estimator raised.)"""
    from torch_parity import clusters, ledger_guard

    rng = np.random.default_rng(31)
    n = 12_000
    k = rng.integers(0, 50_000, n).astype(np.int64)
    g = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)]
    v = rng.normal(50, 8, n)
    queries = (
        "SELECT g, avg(v) AS av, absolute_error(av) AS ae, "
        "lower_bound(av) AS lb, upper_bound(av) AS ub FROM we_t "
        "GROUP BY g ORDER BY g WITH ERROR 0.5 CONFIDENCE 0.95",
        "SELECT count(*) AS c, absolute_error(c) FROM we_t WITH ERROR 0.5",
        "SELECT g, avg(v) AS av, absolute_error(av) AS ae FROM we_t "
        "GROUP BY g ORDER BY g WITH ERROR 0.00001 "
        "BEHAVIOR 'run_on_full_table'")
    with ledger_guard(), clusters(n=2) as (ref, port):
        got = []
        for c in (ref, port):
            c.ds.sql("CREATE TABLE we_t (k BIGINT, g STRING, v DOUBLE) "
                     "USING column OPTIONS (partition_by 'k')")
            c.ds.insert_arrays("we_t", [k.copy(), g.copy(), v.copy()])
            c.ds.sql("CREATE SAMPLE TABLE we_s ON we_t OPTIONS "
                     "(baseTable 'we_t', qcs 'g', reservoir_size '250')")
            got.append([_rows(c.ds.sql(q)) for q in queries])
        for p_rows, r_rows in zip(got[1], got[0]):
            assert_rows_equal(p_rows, r_rows, REL)
        assert got[1][1][0][0] == n and got[1][1][0][1] == 0.0
        assert len(got[1][0]) == 3 and all(r[2] > 0 for r in got[1][0])


def test_sample_tables_and_topk_recover(tmp_path):
    """A durable session's sample table and TopK come back after a
    restart (maintainer re-seeded from the base, TopK re-registered),
    and the estimates equal the reference's on its own directory."""
    d = {n: str(tmp_path / n) for n in ("port", "ref")}
    got = {}
    for name, cls, cat, kw in (
            ("port", SnappySession, Catalog, {"device": "cpu"}),
            ("ref", RefSession, RefCatalog, {})):
        s = cls(catalog=cat(), data_dir=d[name], recover=False, **kw)
        s.sql("CREATE TABLE tx (region STRING, amount DOUBLE) USING column")
        rng = np.random.default_rng(3)
        s.insert_arrays("tx", [np.array(["e", "w", "n"], dtype=object)[
            rng.integers(0, 3, 3000)], np.round(rng.random(3000), 2)])
        s.sql("CREATE SAMPLE TABLE tx_s ON tx OPTIONS (qcs 'region', "
              "reservoir_size '40')")
        s.create_topk("top_r", "tx", "region", k=3)
        s.checkpoint()
        s.disk_store.close()
        s2 = cls(data_dir=d[name], **kw)
        got[name] = (_rows(s2.sql(
            "SELECT region, sum(amount) AS sa, absolute_error(sa) FROM tx "
            "GROUP BY region ORDER BY region WITH ERROR 0.9")),
            _rows(s2.query_topk("top_r")))
        s2.disk_store.close()
    assert_rows_equal(got["port"][0], got["ref"][0], REL)
    assert got["port"][1] == got["ref"][1]
    assert len(got["port"][0]) == 3
