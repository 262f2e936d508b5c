"""Exact DECIMAL(p<=18) through both packages: scaled-int64 device plates,
integer aggregation with the int64 overflow guard, scale tracking through
+, -, *, % and comparisons, Decimal results at the user boundary.

Each case loads the same seeded numpy inputs into the JAX package's
session and the port's (on the CPU), under both float plate policies
(`decimal_as_float64` True and False: decimal plates are int64 either
way), and requires the port to return the reference's rows: exact slots
byte-identical `Decimal`s (and equal to a Python-decimal oracle), float
slots within the reference test's own tolerance.  Where the reference
answers on its device (its `host_fallbacks` did not move), the port's
`host_fallbacks` must not move either.

The cases of tests/test_decimal_exact.py that wait on UPDATE/DELETE,
persistence, row tables, subqueries, scalar functions, the mesh or the
cluster are listed in ROADMAP.md, not here.
"""

from decimal import Decimal

import numpy as np
import pytest

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.engine import exprs
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.storage.device import (current_scan_scale,
                                                 scan_window)

_PROPS = (ref_config.global_properties(), config.global_properties())


class Pair:
    """One reference session and one port session fed identically."""

    def __init__(self):
        self.ref = RefSession(catalog=RefCatalog())
        self.port = SnappySession(catalog=Catalog(), device="cpu")

    def sql(self, q):
        for s in (self.ref, self.port):
            s.sql(q)

    def insert_arrays(self, table, arrays):
        for s in (self.ref, self.port):
            s.insert_arrays(table, arrays)

    def rows(self, q):
        """(port rows, reference rows); the port stays on its device
        wherever the reference does."""
        rfb = ref_registry().counter("host_fallbacks")
        want = self.ref.sql(q).rows()
        ref_on_device = ref_registry().counter("host_fallbacks") == rfb
        pfb = global_registry().counter("host_fallbacks")
        got = self.port.sql(q).rows()
        if ref_on_device:
            assert global_registry().counter("host_fallbacks") == pfb, q
        return got, want

    def same(self, q):
        got, want = self.rows(q)
        assert got == want, (q, got, want)
        return got


@pytest.fixture(params=[False, True], ids=["f64-plates", "f32-plates"])
def pair(request):
    saved = [(p.decimal_as_float64, p.scan_tile_bytes) for p in _PROPS]
    for p in _PROPS:
        p.decimal_as_float64 = not request.param
    yield Pair()
    for p, (dec, tile) in zip(_PROPS, saved):
        p.decimal_as_float64 = dec
        p.scan_tile_bytes = tile


def _tile_bytes(n: int) -> None:
    for p in _PROPS:
        p.scan_tile_bytes = n


def _money(n, seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.integers(-10_000_000, 10_000_000, n)  # +/- 100k.00
    return cents, cents.astype(np.float64) / 100.0


def test_sum_byte_identical_to_decimal_oracle(pair):
    n = 200_000
    cents, vals = _money(n, seed=1)
    pair.sql("CREATE TABLE m (k BIGINT, price DECIMAL(12,2)) USING column")
    pair.insert_arrays("m", [np.arange(n, dtype=np.int64), vals])
    got = pair.same("SELECT sum(price), min(price), max(price), "
                    "count(price) FROM m")[0]
    oracle = sum(Decimal(int(c)) for c in cents) / Decimal(100)
    assert isinstance(got[0], Decimal)
    assert got[0] == oracle
    assert str(got[0]) == str(oracle)             # byte-identical
    assert got[1] == Decimal(int(cents.min())) / Decimal(100)
    assert got[2] == Decimal(int(cents.max())) / Decimal(100)
    assert got[3] == n


def test_grouped_sum_and_avg_exact(pair):
    n = 120_000
    cents, vals = _money(n, seed=2)
    g = (np.arange(n) % 7).astype(np.int64)
    pair.sql("CREATE TABLE gm (g BIGINT, price DECIMAL(12,2)) USING column")
    pair.insert_arrays("gm", [g, vals])
    got, want = pair.rows("SELECT g, sum(price), avg(price), count(*) "
                          "FROM gm GROUP BY g ORDER BY g")
    assert len(got) == len(want) == 7
    for (gi, sv, av, cnt), (wg, ws, wa, wc) in zip(got, want):
        sel = g == gi
        oracle = sum(Decimal(int(c)) for c in cents[sel]) / Decimal(100)
        assert (gi, sv, cnt) == (wg, ws, wc)
        assert sv == oracle and cnt == int(sel.sum())
        # avg = exact sum / exact count, computed (and typed) as DOUBLE
        assert av == pytest.approx(wa, rel=1e-12)
        assert av == pytest.approx(float(oracle) / cnt, rel=1e-12)


def test_arithmetic_scale_tracking(pair):
    pair.sql("CREATE TABLE a (x DECIMAL(6,2), y DECIMAL(6,3)) USING column")
    pair.sql("INSERT INTO a VALUES (1.25, 2.125), (10.50, 0.375),"
             " (-3.75, 1.005)")
    got, want = pair.rows(
        "SELECT x + y, x - y, x * y, x / y FROM a ORDER BY x")
    oracle = [(Decimal("-3.75"), Decimal("1.005")),
              (Decimal("1.25"), Decimal("2.125")),
              (Decimal("10.50"), Decimal("0.375"))]
    for (ax, sx, mx, dx), w, (x, y) in zip(got, want, oracle):
        assert (ax, sx, mx) == w[:3]
        assert ax == x + y            # exact: scale 3
        assert sx == x - y
        assert mx == x * y            # exact: scale 5
        assert dx == pytest.approx(w[3], rel=1e-12)
        assert dx == pytest.approx(float(x) / float(y), rel=1e-12)


def test_comparison_boundaries_exact(pair):
    pair.sql("CREATE TABLE c (v DECIMAL(10,2)) USING column")
    pair.sql("INSERT INTO c VALUES (24.04), (24.05), (24.06)")
    assert pair.same("SELECT count(*) FROM c WHERE v < 24.05")[0][0] == 1
    assert pair.same("SELECT count(*) FROM c WHERE v <= 24.05")[0][0] == 2
    assert pair.same("SELECT count(*) FROM c WHERE v = 24.05")[0][0] == 1
    # a literal finer than the column scale: v <= 24.056 is v <= 24.05
    assert pair.same("SELECT count(*) FROM c WHERE v <= 24.056")[0][0] == 2
    assert pair.same("SELECT count(*) FROM c WHERE v > 24.041")[0][0] == 2
    # decimal vs integer literal
    pair.sql("INSERT INTO c VALUES (25.00)")
    assert pair.same("SELECT count(*) FROM c WHERE v = 25")[0][0] == 1


def test_casts(pair):
    pair.sql("CREATE TABLE t (d DOUBLE, x DECIMAL(10,3)) USING column")
    pair.sql("INSERT INTO t VALUES (1.2345, 12.3456), (-1.2355, -0.9)")
    r = pair.same("SELECT CAST(d AS DECIMAL(8,3)), CAST(x AS INT), "
                  "CAST(x AS DECIMAL(8,1)), CAST(x AS DOUBLE) "
                  "FROM t ORDER BY d")
    assert r[1][0] == Decimal("1.234") or r[1][0] == Decimal("1.235")
    assert r[0][0] == Decimal("-1.236") or r[0][0] == Decimal("-1.235")
    assert r[1][1] == 12 and r[0][1] == 0          # truncation toward 0
    assert r[1][2] == Decimal("12.3")              # HALF_UP at scale 1
    assert r[1][3] == pytest.approx(12.3456, abs=5e-4)


def test_order_by_having_group_key(pair):
    n = 50_000
    cents, vals = _money(n, seed=3)
    g = (np.arange(n) % 5).astype(np.int64)
    pair.sql("CREATE TABLE oh (g BIGINT, v DECIMAL(12,2)) USING column")
    pair.insert_arrays("oh", [g, vals])
    rows = pair.same(
        "SELECT g, sum(v) AS s FROM oh GROUP BY g "
        "HAVING sum(v) > -100000000 ORDER BY s DESC LIMIT 3")
    oracle = sorted(
        (sum(Decimal(int(c)) for c in cents[g == gi]) / Decimal(100)
         for gi in range(5)), reverse=True)[:3]
    assert [r[1] for r in rows] == oracle
    # GROUP BY a decimal column (exact int64 grouping keys)
    pair.sql("CREATE TABLE gk (v DECIMAL(6,2)) USING column")
    pair.sql("INSERT INTO gk VALUES (1.10), (1.10), (2.20)")
    rows = pair.same("SELECT v, count(*) FROM gk GROUP BY v ORDER BY v")
    assert rows == [(Decimal("1.10"), 2), (Decimal("2.20"), 1)]


def test_sum_overflow_falls_back_not_wraps(pair):
    # DECIMAL(18,0) near int64: the bound check must reroute to the host
    # path (approximate f64) instead of wrapping silently — in both
    # packages, each counting one host fallback
    n = 64
    pair.sql("CREATE TABLE big (v DECIMAL(18,0)) USING column")
    pair.insert_arrays("big", [np.full(n, 9.0e17, dtype=np.float64)])
    rfb = ref_registry().counter("host_fallbacks")
    pfb = global_registry().counter("host_fallbacks")
    got, want = pair.rows("SELECT sum(v) FROM big")
    assert ref_registry().counter("host_fallbacks") == rfb + 1
    assert global_registry().counter("host_fallbacks") == pfb + 1
    exact = 9.0e17 * n          # 5.76e19: far beyond int64
    assert float(got[0][0]) == pytest.approx(exact, rel=1e-9)
    assert got[0][0] == want[0][0]


def test_sum_overflow_guard_covers_merged_total_across_tiles(pair):
    """Each 4-row tile passes the per-tile bound (3.6e18 < 2^62) while
    the merged total (1.8e19) wraps int64: the guard scales its bound by
    the tile count, so the pass reroutes to the host instead."""
    pair.sql("CREATE TABLE tile_big (v DECIMAL(18,0)) USING column "
             "OPTIONS (column_batch_rows '4', column_max_delta_rows '4')")
    pair.insert_arrays("tile_big", [np.full(20, 9.0e17, dtype=np.float64)])
    _tile_bytes(60)   # one 4-row batch per tile
    tiles = global_registry().counter("scan_tiles")
    got, want = pair.rows("SELECT sum(v) FROM tile_big")
    assert global_registry().counter("scan_tiles") > tiles
    exact = 9.0e17 * 20
    # rel covers f32-plate rounding of the approximate fallback (~2e-8);
    # a silent int64 wrap would be negative or off by more than 2x
    assert float(got[0][0]) == pytest.approx(exact, rel=1e-6)
    assert float(got[0][0]) > 0
    assert float(got[0][0]) == pytest.approx(float(want[0][0]), rel=1e-6)


def test_tile_host_fallback_reads_only_its_tile(pair):
    """When a tile reroutes to the host path (here every 8-row tile: 8 x
    9e17 >= 2^62), the host evaluation honors the scan window: reading
    the whole table inside a tile would double-count every other tile."""
    pair.sql("CREATE TABLE tile_hf (v DECIMAL(18,0)) USING column "
             "OPTIONS (column_batch_rows '8', column_max_delta_rows '8')")
    pair.insert_arrays("tile_hf", [np.full(20, 9.0e17, dtype=np.float64)])
    _tile_bytes(100)
    got, want = pair.rows("SELECT sum(v) FROM tile_hf")
    assert float(got[0][0]) == pytest.approx(9.0e17 * 20, rel=1e-6)
    assert float(got[0][0]) == pytest.approx(float(want[0][0]), rel=1e-6)


def test_scan_scale_uses_nominal_tile_width(pair):
    """The guard's tile scale comes from the pass's NOMINAL window width:
    the last window may be truncated (10 units in tiles of 4 -> (8, 10))
    and a width of 2 would claim 5 tiles where 3 exist."""
    pair.sql("CREATE TABLE ts_w (v BIGINT) USING column OPTIONS "
             "(column_batch_rows '4', column_max_delta_rows '4')")
    pair.insert_arrays("ts_w", [np.arange(40, dtype=np.int64)])
    data = pair.port.catalog.describe("ts_w").data
    m = data.snapshot()
    assert len(m.views) == 10
    with scan_window(data, 8, 10, m, tile_units=4):
        assert current_scan_scale(data) == 3.0
    with scan_window(data, 0, 4, m, tile_units=4):
        assert current_scan_scale(data) == 3.0
    assert current_scan_scale(data) == 1.0   # outside any pass


def test_wide_precision_keeps_float_path(pair):
    pair.sql("CREATE TABLE wp (v DECIMAL(28,2)) USING column")
    pair.sql("INSERT INTO wp VALUES (1.25), (2.50)")
    got = pair.same("SELECT sum(v) FROM wp")[0][0]
    assert got == Decimal("3.75")   # float path, still Decimal-decoded


def test_tiled_scan_sum_exact(pair):
    """scan_tile_bytes forces a multi-tile pass: the per-tile int64
    partials re-combine exactly.  Both packages merge through DOUBLE
    partial columns (partial_agg.ddl_type), so the tiled sum comes back
    as a float whose value quantizes to the exact Decimal.  The port keeps
    its scratch partials at float64 under either plate policy; the
    reference stores them at plate width, float32 under the f32 policy,
    so its tiled sum is within float32 rounding of the port's there."""
    n = 20_000
    cents, vals = _money(n, seed=7)
    pair.sql("CREATE TABLE ts (k BIGINT, v DECIMAL(12,2)) USING column "
             "OPTIONS (column_batch_rows '2000', "
             "column_max_delta_rows '2000')")
    pair.insert_arrays("ts", [np.arange(n, dtype=np.int64), vals])
    oracle = sum(Decimal(int(c)) for c in cents) / Decimal(100)
    untiled = pair.same("SELECT sum(v), count(*) FROM ts")[0]
    assert untiled == (oracle, n)
    _tile_bytes(64 * 1024)
    tiles = global_registry().counter("scan_tiles")
    got, want = pair.rows("SELECT sum(v), count(*) FROM ts")
    assert global_registry().counter("scan_tiles") > tiles
    got, want = got[0], want[0]
    assert got[1] == want[1] == n
    assert Decimal(repr(got[0])).quantize(Decimal("0.01")) == oracle
    assert got[0] == pytest.approx(want[0], rel=2.0 ** -23)


def test_union_and_intersect_mixed_scales(pair):
    pair.sql("CREATE TABLE ua (v DECIMAL(10,2)) USING column")
    pair.sql("CREATE TABLE ub (v DECIMAL(10,3)) USING column")
    pair.sql("INSERT INTO ua VALUES (24.05), (1.10)")
    pair.sql("INSERT INTO ub VALUES (24.050), (2.200), (1.005)")
    got, want = pair.rows("SELECT v FROM ua UNION ALL SELECT v FROM ub")
    assert sorted(str(r[0]) for r in got) == sorted(str(r[0]) for r in want)
    assert "1.005" in {str(r[0]) for r in got}
    got, want = pair.rows("SELECT v FROM ua INTERSECT SELECT v FROM ub")
    assert [float(r[0]) for r in got] == pytest.approx([24.05])
    assert [float(r[0]) for r in got] == [float(r[0]) for r in want]


def test_ctas_and_insert_select_keep_values(pair):
    """CTAS / INSERT..SELECT from an exact-decimal column store the VALUE,
    not the scaled representation."""
    pair.sql("CREATE TABLE src (k BIGINT, v DECIMAL(10,2)) USING column")
    pair.sql("INSERT INTO src VALUES (1, 24.05), (2, 1.10)")
    pair.sql("CREATE TABLE ct AS SELECT k, v FROM src")
    assert pair.same("SELECT sum(v) FROM ct")[0][0] == Decimal("25.15")
    pair.sql("CREATE TABLE tgt (k BIGINT, v DECIMAL(10,2)) USING column")
    pair.sql("INSERT INTO tgt SELECT k, v FROM src")
    assert pair.same("SELECT v FROM tgt WHERE k = 1") \
        == [(Decimal("24.05"),)]


def test_half_up_rounding_ties(pair):
    # 0.125 at scale 2: HALF_UP -> 0.13 (half-even would give 0.12)
    pair.sql("CREATE TABLE hu (v DECIMAL(6,2)) USING column")
    pair.insert_arrays("hu", [np.array([0.125, -0.125])])
    rows = pair.same("SELECT v FROM hu ORDER BY v")
    assert rows == [(Decimal("-0.13"),), (Decimal("0.13"),)]


@pytest.mark.parametrize("value,frm,to", [
    (125, 2, 1), (-125, 2, 1), (124, 2, 1), (-124, 2, 1), (-5, 1, 0),
    (5, 1, 0), (-15, 1, 0), (1234567, 4, 2), (-1234567, 4, 2), (7, 0, 3)])
def test_rescale_rounds_half_away_from_zero(value, frm, to):
    """Downscale of scaled int64 rounds HALF_UP on negatives too (torch's
    integer division floors; the rescale divides |v| only)."""
    import torch

    got = int(exprs._dec_rescale_int(
        torch.tensor([value], dtype=torch.int64), frm, to)[0])
    want = int((Decimal(value).scaleb(-frm)).quantize(
        Decimal(1).scaleb(-to), rounding="ROUND_HALF_UP").scaleb(to))
    assert got == want
