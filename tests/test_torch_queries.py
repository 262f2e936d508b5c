"""The port's device lowering across the SQL shapes of its slice.

One small table with NULLs, string and numeric keys loads into both
packages from the same numpy arrays; each query must return the same rows
through the JAX package's session and the port's (CPU), in float64
(knobs off) and in float32 with both kernel lanes on.  Counts, keys and
MIN/MAX must be equal; sums within rel 1e-7 (float64) or 1e-6 * sum(|v|)
(float32 lanes, mixed-sign data).
"""

import numpy as np
import pytest

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry

N = 20_000
DDL = ("CREATE TABLE t (k STRING, g INT, x DOUBLE, y DOUBLE, b BIGINT, "
       "d DATE) USING column OPTIONS (column_batch_rows '4096')")

# (query, runs on the device path)
QUERIES = [
    ("SELECT count(*), sum(x), min(x), max(x), avg(y) FROM t", True),
    ("SELECT k, count(*), count(x), sum(x), min(y), max(y) FROM t "
     "GROUP BY k ORDER BY k", True),
    ("SELECT g, sum(x * y), avg(x) FROM t GROUP BY g ORDER BY g", True),
    ("SELECT k, g, sum(b), count(*) FROM t WHERE x > 0 GROUP BY k, g "
     "ORDER BY k, g", True),
    ("SELECT sum(x) FROM t WHERE k IN ('a', 'c') AND y BETWEEN -1 AND 1",
     True),
    ("SELECT count(*) FROM t WHERE NOT (x < 0 OR y < 0)", True),
    ("SELECT count(*), sum(y) FROM t WHERE k = 'zz'", True),
    ("SELECT sum(x / y), count(*) FROM t WHERE g < 3", True),
    ("SELECT k, sum(b) FROM t WHERE d >= DATE '1995-01-01' GROUP BY k "
     "ORDER BY k", True),
    ("SELECT k, max(b) - min(b) AS spread FROM t GROUP BY k "
     "HAVING count(*) > 10 ORDER BY spread DESC LIMIT 3", True),
    ("SELECT x, y FROM t WHERE g = 2 AND x > 1.5 ORDER BY x LIMIT 20", True),
    ("SELECT count(*) FROM t WHERE x IS NULL", True),
    # a derived key: the generic hash-key lane
    ("SELECT g % 2 AS p, count(*) FROM t GROUP BY g % 2 ORDER BY p", True),
    # count(DISTINCT): the sort-based device lane
    ("SELECT k, count(DISTINCT g) FROM t GROUP BY k ORDER BY k", True),
    # CASE WHEN with and without ELSE, over a nullable operand
    ("SELECT k, sum(CASE WHEN x > 0 THEN x ELSE 0 END), "
     "count(CASE WHEN g = 2 THEN 1 END), sum(CASE WHEN y > 0 THEN x END) "
     "FROM t GROUP BY k ORDER BY k", True),
    ("SELECT count(*), sum(y) FROM t WHERE k LIKE '%c' OR k NOT LIKE 'b'",
     True),
]

_KNOBS = ("decimal_as_float64", "pallas_reduce", "pallas_group_reduce")


def _arrays(seed=3):
    rng = np.random.default_rng(seed)
    k = rng.choice(np.array(["a", "b", "c", "d", None], dtype=object), N)
    x = np.round(rng.normal(0, 2, N), 3)
    x[rng.random(N) < 0.05] = np.nan   # NULL marker for the insert below
    return {
        "k": k,
        "g": rng.integers(0, 6, N).astype(np.int32),
        "x": x,
        "y": np.round(rng.normal(0, 1, N), 3),
        "b": rng.integers(-1000, 1000, N).astype(np.int64),
        "d": rng.integers(8000, 11000, N).astype(np.int32),
    }


@pytest.fixture(scope="module", params=["off", "on"])
def sessions(request):
    props = (ref_config.global_properties(), config.global_properties())
    saved = [{k: getattr(p, k) for k in _KNOBS} for p in props]
    if request.param == "on":
        for p in props:
            p.decimal_as_float64 = False
            p.pallas_reduce = True
            p.pallas_group_reduce = True
    cols = _arrays()
    xnull = np.isnan(cols["x"])
    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    for s in (ref, port):
        s.sql(DDL)
        info = s.catalog.describe("t")
        arrays = [cols[f.name] for f in info.schema.fields]
        arrays[2] = np.where(xnull, 0.0, cols["x"])
        nulls = [None, None, xnull, None, None, None]
        info.data.insert_arrays(arrays, nulls=nulls)
    yield request.param, ref, port
    for p, old in zip(props, saved):
        for k, v in old.items():
            setattr(p, k, v)


def _close(a, b, f32):
    if isinstance(b, (float, np.floating)) and not isinstance(b, bool):
        if np.isnan(b):
            return a is None or np.isnan(a)
        return a == pytest.approx(b, rel=1e-6 if f32 else 1e-7,
                                  abs=1e-3 if f32 else 1e-9)
    return a == b


@pytest.mark.parametrize("query,on_device", QUERIES,
                         ids=[f"q{i}" for i in range(len(QUERIES))])
def test_query_matches_reference(sessions, query, on_device):
    mode, ref, port = sessions
    reg = global_registry()
    fb = reg.counter("host_fallbacks")
    got = port.sql(query).rows()
    want = ref.sql(query).rows()
    assert (reg.counter("host_fallbacks") == fb) == on_device
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert all(_close(a, b, mode == "on") for a, b in zip(g, w)), (g, w)


# --- fault C6: the bare LIMIT early stop (executeTake) ----------------------

def test_bare_limit_over_string_compare_matches_reference():
    """ROADMAP C6: `WHERE k = 1 LIMIT 3` over a STRING k takes the
    executeTake lane in both packages and returns the reference's []
    (the port raised numpy's UFuncTypeError before); without LIMIT both
    packages raise."""
    from torch_parity import Pair as PolicyPair

    p = PolicyPair("f64")
    p.sql("CREATE TABLE z (id INT, k STRING) USING column "
          "OPTIONS (column_batch_rows '4', column_max_delta_rows '4')")
    p.insert_arrays("z", [np.arange(10, dtype=np.int32),
                          np.array(list("abcdefghij"), dtype=object)])
    rows, _ = p.run("SELECT id FROM z WHERE k = 1 LIMIT 3")
    assert rows == []
    for s in (p.port, p.ref):
        with pytest.raises(Exception):
            s.sql("SELECT id FROM z WHERE k = 1")


def test_limit_decodes_only_the_batches_it_needs(monkeypatch):
    """A LIMIT over a multi-batch column table returns after decoding its
    first batch (a spy counts the decodes), with the reference's rows and
    its `take_*` counters; a LIMIT over an aggregate does not take the
    early stop."""
    from torch_parity import Pair as PolicyPair, counters
    from snappydata_tpu.observability.metrics import \
        global_registry as ref_registry
    from snappydata_tpu_torch.storage.table_store import ColumnTableData

    p = PolicyPair("f64")
    p.sql("CREATE TABLE big (id BIGINT, x DOUBLE, s STRING) USING column "
          "OPTIONS (column_batch_rows '256', column_max_delta_rows '256')")
    n = 2048
    p.insert_arrays("big", [np.arange(n, dtype=np.int64),
                            np.arange(n, dtype=np.float64) * 0.5,
                            np.array([f"s{i % 9}" for i in range(n)],
                                     dtype=object)])
    data = p.port.catalog.describe("big").data
    assert len(data.snapshot().views) == n // 256
    decodes = []
    real = ColumnTableData._decode_all

    def spy(self, view):
        decodes.append(view.batch.batch_id)
        return real(self, view)

    monkeypatch.setattr(ColumnTableData, "_decode_all", spy)
    keys = ("take_early_stops", "take_batches_decoded", "host_fallbacks")
    moved = []
    for s, reg in ((p.port, global_registry()), (p.ref, ref_registry())):
        before = counters(reg)
        rows = [tuple(r) for r in s.sql(
            "SELECT id, s FROM big WHERE x >= 10 LIMIT 5").rows()]
        after = counters(reg)
        moved.append(({k: after.get(k, 0) - before.get(k, 0)
                       for k in keys}, rows))
    (pm, prows), (rm, rrows) = moved
    assert prows == rrows == [(i, f"s{i % 9}") for i in range(20, 25)]
    assert pm == rm == {"take_early_stops": 1, "take_batches_decoded": 1,
                        "host_fallbacks": 0}, (pm, rm)
    assert len(decodes) == 1
    decodes.clear()
    rows, moved2 = p.run("SELECT count(*), sum(x) FROM big LIMIT 1")
    assert rows == [(n, float(np.arange(n).sum() * 0.5))]
    assert decodes == []   # the aggregate ran on the device, no take
