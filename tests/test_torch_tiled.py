"""Tiled scans through both packages.

An aggregate over a column table whose decoded bind exceeds
`scan_tile_bytes` streams the scan units through one compiled partial
program tile by tile and merges the partials.  Each case loads the same
seeded numpy inputs into the JAX package's session and the port's (on
the CPU), sets the same tiny `scan_tile_bytes` (and 256-row batches) in
both packages, and requires the port to count tiles and to return the
reference's rows: keys and counts exactly, sums within the reference
test's own rel 1e-9 (1e-6 for the moments).  The port's
`host_fallbacks` must not move where the reference's did not.

Ports the cases of tests/test_tiled_scan.py and
tests/test_agg_strategy.py::test_tile_merges_stay_on_device.
"""

import numpy as np
import pytest

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry

_PROPS = (ref_config.global_properties(), config.global_properties())


@pytest.fixture
def small_batches():
    """Tiny batch capacity in both packages, so a few thousand rows span
    many scan units."""
    saved = [(p.column_batch_rows, p.scan_tile_bytes) for p in _PROPS]
    for p in _PROPS:
        p.column_batch_rows = 256
    yield
    for p, (rows, tile) in zip(_PROPS, saved):
        p.column_batch_rows = rows
        p.scan_tile_bytes = tile


def _tile_bytes(n: int) -> None:
    for p in _PROPS:
        p.scan_tile_bytes = n


def _sessions():
    return (RefSession(catalog=RefCatalog()),
            SnappySession(catalog=Catalog(), device="cpu"))


def _load(sessions, n=4000, seed=7):
    rng = np.random.default_rng(seed)
    k = rng.choice(np.array(["a", "b", "c", "d"], dtype=object), n)
    v = rng.normal(100.0, 10.0, n)
    w = rng.integers(0, 1000, n, dtype=np.int64)
    for s in sessions:
        s.sql("CREATE TABLE big (k STRING, v DOUBLE, w BIGINT) USING column")
        s.catalog.describe("big").data.insert_arrays([k, v, w])
    return k, v, w


def _rows(sessions, q):
    """(port rows, reference rows); the port's scan_tiles delta rides
    along as the third value."""
    ref, port = sessions
    rfb = ref_registry().counter("host_fallbacks")
    want = ref.sql(q).rows()
    ref_on_device = ref_registry().counter("host_fallbacks") == rfb
    reg = global_registry()
    pfb, t0 = reg.counter("host_fallbacks"), reg.counter("scan_tiles")
    got = port.sql(q).rows()
    if ref_on_device:
        assert reg.counter("host_fallbacks") == pfb, q
    return got, want, reg.counter("scan_tiles") - t0


def _approx_rows(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=rel)
            else:
                assert a == b


def test_tiled_matches_untiled(small_batches):
    ss = _sessions()
    _load(ss)
    q = ("SELECT k, count(*), sum(v), avg(v), min(w), max(w) "
         "FROM big GROUP BY k ORDER BY k")
    expected, _, tiles = _rows(ss, q)
    assert tiles == 0
    _tile_bytes(3 * 256 * 32)  # ~3 units per tile
    got, want, tiles = _rows(ss, q)
    assert tiles > 1, "expected the tiled path to run"
    assert len(got) == len(expected) == 4
    _approx_rows(got, want, 1e-9)
    _approx_rows(got, expected, 1e-9)


def test_tiled_global_aggregate_and_filter(small_batches):
    ss = _sessions()
    _, v, w = _load(ss)
    q = "SELECT count(*), sum(v), avg(w) FROM big WHERE w >= 500"
    expected = _rows(ss, q)[0][0]
    _tile_bytes(2 * 256 * 32)
    got, want, tiles = _rows(ss, q)
    assert tiles > 1
    _approx_rows(got, want, 1e-9)
    got = got[0]
    assert got[0] == expected[0]
    assert got[1] == pytest.approx(expected[1], rel=1e-9)
    assert got[2] == pytest.approx(expected[2], rel=1e-9)
    sel = w >= 500
    assert got[0] == int(sel.sum())
    assert got[1] == pytest.approx(float(v[sel].sum()), rel=1e-9)


def test_tiled_having_and_limit(small_batches):
    ss = _sessions()
    _load(ss)
    q = ("SELECT k, count(*) AS n FROM big GROUP BY k "
         "HAVING count(*) > 0 ORDER BY n DESC, k LIMIT 2")
    expected = _rows(ss, q)[0]
    _tile_bytes(2 * 256 * 32)
    got, want, tiles = _rows(ss, q)
    assert tiles > 1
    assert got == want == expected and len(got) == 2


def test_tiled_stddev_variance(small_batches):
    ss = _sessions()
    _load(ss)
    q = "SELECT stddev(v), variance(v) FROM big"
    expected = _rows(ss, q)[0][0]
    _tile_bytes(2 * 256 * 32)
    got, want, tiles = _rows(ss, q)
    assert tiles > 1
    _approx_rows(got, want, 1e-6)
    assert got[0][0] == pytest.approx(expected[0], rel=1e-6)
    assert got[0][1] == pytest.approx(expected[1], rel=1e-6)


def test_tiled_with_nulls(small_batches):
    ss = _sessions()
    n = 2000
    rng = np.random.default_rng(3)
    g = rng.choice(np.array(["p", "q"], dtype=object), n)
    x = rng.normal(0, 1, n)
    nulls = rng.random(n) < 0.2
    for s in ss:
        s.sql("CREATE TABLE nt (g STRING, x DOUBLE) USING column")
        s.catalog.describe("nt").data.insert_arrays([g, x],
                                                    nulls=[None, nulls])
    q = "SELECT g, count(x), sum(x) FROM nt GROUP BY g ORDER BY g"
    expected = _rows(ss, q)[0]
    _tile_bytes(2 * 256 * 32)
    got, want, tiles = _rows(ss, q)
    assert tiles > 1
    _approx_rows(got, want, 1e-9)
    _approx_rows(got, expected, 1e-9)
    # count excludes NULLs: against the oracle too
    for gg, gc, _gs in got:
        assert gc == int(((g == gg) & ~nulls).sum())


def test_tiling_leaves_joins_alone(small_batches):
    """Join shapes tile on the probe side only, and answer exactly."""
    ss = _sessions()
    _load(ss)
    for s in ss:
        s.sql("CREATE TABLE d (k STRING, label STRING) USING column")
        s.sql("INSERT INTO d VALUES ('a','A'),('b','B'),('c','C'),"
              "('d','D')")
    _tile_bytes(2 * 256 * 32)
    got, want, _tiles = _rows(
        ss, "SELECT d.label, count(*) FROM big JOIN d ON big.k = d.k "
            "GROUP BY d.label ORDER BY d.label")
    assert got == want
    assert [x[0] for x in got] == ["A", "B", "C", "D"]
    assert sum(x[1] for x in got) == 4000


def test_tiled_snapshot_consistency(small_batches):
    """Tiles pin ONE manifest; a mutation between passes is visible to
    the next pass."""
    ss = _sessions()
    _load(ss, n=3000)
    _tile_bytes(2 * 256 * 32)
    got, want, _ = _rows(ss, "SELECT count(*) FROM big")
    assert got == want == [(3000,)]
    q = "SELECT count(*), sum(w) FROM big"
    before, want, tiles = _rows(ss, q)
    assert tiles > 1 and before == want
    for s in ss:
        s.sql("INSERT INTO big VALUES ('a', 1.0, 1)")
    got, want, _ = _rows(ss, "SELECT count(*) FROM big")
    assert got == want == [(3001,)]
    got, want, tiles = _rows(ss, q)
    assert tiles > 1 and got == want
    assert got == [(3001, before[0][1] + 1)]


def test_tiles_do_not_accumulate_on_device(small_batches):
    """A tile pass keeps at most ONE windowed cache entry resident once it
    ends (the table is oversized by definition)."""
    ss = _sessions()
    _load(ss)
    _tile_bytes(2 * 256 * 32)
    got, want, tiles = _rows(ss, "SELECT k, count(*) FROM big GROUP BY k")
    assert tiles > 1 and sorted(got) == sorted(want)
    data = ss[1].catalog.describe("big").data
    windowed = [k for k in data._device_cache if k[2] is not None]
    assert len(windowed) <= 1, windowed


def test_tile_merges_stay_on_device(small_batches):
    """A tile-aligned grouped aggregate merges its [G] partials on the
    device (no per-tile host round trip); a direct numeric key groups
    through its table-global domain and merges on the device too; an
    expression key takes the generic lane and the host merge, once."""
    ss = _sessions()
    rng = np.random.default_rng(9)
    n = 4096
    k = rng.choice(np.array(["a", "b", "c"], dtype=object), n)
    v = rng.integers(0, 1000, n).astype(np.float64)
    for s in ss:
        s.sql("CREATE TABLE big (k STRING, v DOUBLE) USING column")
        s.catalog.describe("big").data.insert_arrays([k, v])
    reg = global_registry()

    def counters():
        return (reg.counter("scan_tile_device_merges"),
                reg.counter("scan_tile_host_merges"))

    q = "SELECT k, count(*), sum(v), min(v) FROM big GROUP BY k ORDER BY k"
    untiled = _rows(ss, q)[0]
    _tile_bytes(4 * 256 * 16)
    d0, h0 = counters()
    got, want, tiles = _rows(ss, q)
    assert tiles > 1, "expected a multi-tile pass"
    assert counters() == (d0 + tiles - 1, h0)
    assert got == want == untiled

    q2 = "SELECT v, count(*) FROM big GROUP BY v ORDER BY v LIMIT 3"
    _tile_bytes(0)
    flat2 = _rows(ss, q2)[0]
    _tile_bytes(4 * 256 * 16)
    h1 = counters()[1]
    got, want, _ = _rows(ss, q2)
    assert got == want == flat2
    assert counters()[1] == h1

    q3 = "SELECT v + 0.5, count(*) FROM big GROUP BY v + 0.5 LIMIT 3"
    d2, h2 = counters()
    got, want, _ = _rows(ss, q3)
    assert counters() == (d2, h2 + 1)


def test_prefetcher_warms_windows_without_deaths(small_batches):
    """The host-to-device tile prefetcher warms look-ahead windows on a
    multi-tile pass, and its worker never dies on the way."""
    ss = _sessions()
    _load(ss)
    _tile_bytes(2 * 256 * 32)
    reg = global_registry()
    w0 = reg.counter("prefetch_windows_warmed")
    d0 = reg.counter("prefetch_worker_deaths")
    got, want, tiles = _rows(
        ss, "SELECT k, sum(w) FROM big GROUP BY k ORDER BY k")
    assert got == want
    assert tiles > 2
    assert reg.counter("prefetch_windows_warmed") - w0 == tiles - 1
    assert reg.counter("prefetch_worker_deaths") == d0
