"""TPC-H Q1/Q6 and the README Quick start through both SnappySessions.

The same numpy inputs, made from a seed, load into the JAX package's
session and into the PyTorch port's (on the CPU), and every query must
return the same rows: group keys and counts exactly, sums and averages
within rel 1e-7 (all these sums are same-sign).  Each runs twice:

- knobs off: the defaults of both packages — float64 plates on the CPU,
  the packed reduction families;
- knobs on: `decimal_as_float64 = False` (float32 plates, the
  accelerator's dtype policy) with `pallas_reduce` and
  `pallas_group_reduce` set on both packages, so the reference runs its
  Pallas kernels in interpret mode and the port runs its kernels' plain
  versions through the same executor lanes.

`import_batches` carries the reference table's encoded batches into the
port unchanged, so the two scan byte-identical storage.
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
from snappydata_tpu_torch.storage.encoding import Encoding
from snappydata_tpu_torch.storage.transfer import import_batches
from snappydata_tpu_torch.utils import tpch

SF001_ROWS = 60_000   # lineitem at TPC-H scale factor 0.01
REL = 1e-7
# four batches at SF 0.01, so bucketing and batch stacking are exercised
DDL = tpch.LINEITEM_DDL.replace("OPTIONS (",
                                "OPTIONS (column_batch_rows '16384', ")
QUICK_DDL = ("CREATE TABLE sales (sym STRING, qty INT, price DOUBLE) "
             "USING column")
QUICK_INSERT = ("INSERT INTO sales VALUES ('AAPL', 10, 171.5), "
                "('GOOG', 5, 2831.0), ('AAPL', 3, 170.25), "
                "('MSFT', NULL, 410.0)")
QUICK_QUERY = "SELECT sym, sum(qty * price) FROM sales GROUP BY sym ORDER BY sym"

_KNOBS = ("decimal_as_float64", "pallas_reduce", "pallas_group_reduce")


@pytest.fixture(params=["off", "on"])
def knobs(request):
    props = (ref_config.global_properties(), config.global_properties())
    saved = [{k: getattr(p, k) for k in _KNOBS} for p in props]
    if request.param == "on":
        for p in props:
            p.decimal_as_float64 = False
            p.pallas_reduce = True
            p.pallas_group_reduce = True
    yield request.param
    for p, old in zip(props, saved):
        for k, v in old.items():
            setattr(p, k, v)


@pytest.fixture(scope="module")
def lineitem():
    return tpch.gen_lineitem(SF001_ROWS, seed=11)


def _sessions(lineitem):
    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    for s in (ref, port):
        s.sql(DDL)
        s.insert_arrays("lineitem", list(lineitem.values()))
    return ref, port


def _assert_rows_equal(got, want, rel=REL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, (float, np.floating)):
                assert a == pytest.approx(b, rel=rel, abs=1e-9)
            else:
                assert a == b


def _oracle_q6(li):
    ship = li["l_shipdate"]
    lo, hi = tpch._days("1994-01-01"), tpch._days("1995-01-01")
    m = (ship >= lo) & (ship < hi) & (li["l_discount"] >= 0.05) \
        & (li["l_discount"] <= 0.07) & (li["l_quantity"] < 24)
    return float((li["l_extendedprice"][m] * li["l_discount"][m]).sum())


def test_q1_q6_match_reference(lineitem, knobs):
    ref, port = _sessions(lineitem)
    reg = global_registry()
    before = reg.snapshot()
    for q in (tpch.Q1, tpch.Q6):
        _assert_rows_equal(port.sql(q).rows(), ref.sql(q).rows())
    after = reg.snapshot()

    def moved(name):
        return after.get(name, 0) - before.get(name, 0)

    # the port's lanes: the Kahan lane carried Q6's global sum and the
    # fused grouped lane Q1's slots exactly when the knobs are on
    expect = 1 if knobs == "on" else 0
    assert moved("agg_strategy_kahan") == expect
    assert moved("agg_strategy_grouped") == expect
    assert moved("host_fallbacks") == 0
    # and Q6 holds against a float64 oracle straight from the arrays
    (rev,), = port.sql(tpch.Q6).rows()
    assert rev == pytest.approx(_oracle_q6(lineitem), rel=1e-6)


def test_q1_rows_against_numpy_oracle(lineitem, knobs):
    _ref, port = _sessions(lineitem)
    rows = port.sql(tpch.Q1).rows()
    li = lineitem
    cut = tpch._days("1998-12-01") - 90
    m = li["l_shipdate"] <= cut
    keys = sorted(set(zip(li["l_returnflag"][m], li["l_linestatus"][m])))
    assert [r[:2] for r in rows] == keys
    for row in rows:
        sel = m & (li["l_returnflag"] == row[0]) \
            & (li["l_linestatus"] == row[1])
        price = li["l_extendedprice"][sel]
        disc = li["l_discount"][sel]
        assert row[2] == pytest.approx(li["l_quantity"][sel].sum(), rel=1e-6)
        assert row[4] == pytest.approx((price * (1 - disc)).sum(), rel=1e-6)
        assert row[-1] == int(sel.sum())


def test_quick_start_matches_reference(knobs):
    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    for s in (ref, port):
        s.sql(QUICK_DDL)
        s.sql(QUICK_INSERT)
    got = port.sql(QUICK_QUERY).rows()
    _assert_rows_equal(got, ref.sql(QUICK_QUERY).rows())
    assert got[0] == ("AAPL", pytest.approx(10 * 171.5 + 3 * 170.25))


def _export_batches(ref_data):
    """A reference table's encoded batches as plain numpy."""
    out = []
    for view in ref_data.snapshot().views:
        assert view.delete_mask is None and not view.deltas
        b = view.batch
        out.append({"num_rows": b.num_rows, "capacity": b.capacity,
                    "columns": [{
                        "encoding": int(c.encoding), "data": c.data,
                        "dictionary": c.dictionary, "runs": c.runs,
                        "validity": c.validity,
                        "stats": None if c.stats is None else (
                            c.stats.min, c.stats.max, c.stats.null_count,
                            c.stats.count)} for c in b.columns]})
    return out


def test_import_batches_round_trip(lineitem, knobs):
    ref = RefSession(catalog=RefCatalog())
    ref.sql(DDL)
    ref.insert_arrays("lineitem", list(lineitem.values()))
    exported = _export_batches(ref.catalog.describe("lineitem").data)
    assert len(exported) == 4
    port = SnappySession(catalog=Catalog(), device="cpu")
    port.sql(DDL)
    assert import_batches(port, "lineitem", exported) == SF001_ROWS
    views = port.catalog.describe("lineitem").data.snapshot().views
    kinds = set()
    for got, want in zip(views, exported):
        for c, w in zip(got.batch.columns, want["columns"]):
            kinds.add(c.encoding)
            assert int(c.encoding) == w["encoding"]
            assert c.data.dtype == w["data"].dtype
            assert np.array_equal(c.data, w["data"])
            if w["dictionary"] is not None:
                assert list(c.dictionary) == list(w["dictionary"])
    # the cut makes VALUE_DICT codes (quantity, discount, tax) and
    # DICTIONARY strings: the scan reads them as they were encoded
    assert {Encoding.VALUE_DICT, Encoding.DICTIONARY} <= kinds
    for q in (tpch.Q1, tpch.Q6):
        _assert_rows_equal(port.sql(q).rows(), ref.sql(q).rows())


def test_import_rejects_foreign_dictionary(lineitem):
    ref = RefSession(catalog=RefCatalog())
    ref.sql(DDL)
    ref.insert_arrays("lineitem", list(lineitem.values()))
    exported = _export_batches(ref.catalog.describe("lineitem").data)
    port = SnappySession(catalog=Catalog(), device="cpu")
    port.sql(DDL)
    port.sql("INSERT INTO lineitem (l_returnflag) VALUES ('Z')")
    with pytest.raises(ValueError):
        import_batches(port, "lineitem", exported)


def test_plan_cache_reuses_plans_across_literals(lineitem):
    _ref, port = _sessions(lineitem)
    reg = global_registry()
    q = "SELECT count(*) FROM lineitem WHERE l_quantity < {}"
    port.sql(q.format(10))
    hits = reg.counter("plan_cache_hits")
    (n,), = port.sql(q.format(20)).rows()
    assert reg.counter("plan_cache_hits") == hits + 1
    assert n == int((lineitem["l_quantity"] < 20).sum())


def test_host_fallback_for_unported_shapes(lineitem):
    ref, port = _sessions(lineitem)
    reg = global_registry()
    before = reg.counter("host_fallbacks")
    # ntile has no device lowering in either package (the shapes this
    # test used before — count(DISTINCT), abs, then a windowed sum — run
    # on the device now)
    q = ("SELECT l_orderkey, l_linenumber, ntile(3) OVER "
         "(PARTITION BY l_returnflag ORDER BY l_orderkey, l_linenumber) "
         "FROM lineitem WHERE l_orderkey < 200 "
         "ORDER BY l_orderkey, l_linenumber")
    _assert_rows_equal(port.sql(q).rows(), ref.sql(q).rows())
    assert reg.counter("host_fallbacks") == before + 1


def test_reference_lanes_fire_with_knobs_on(lineitem, knobs):
    """The comparison above is between like lanes: with the knobs on the
    reference's Pallas lanes carry Q1 and Q6 too."""
    ref, _port = _sessions(lineitem)
    reg = ref_registry()
    before = reg.counter("agg_strategy_pallas")
    ref.sql(tpch.Q1)
    ref.sql(tpch.Q6)
    assert reg.counter("agg_strategy_pallas") - before == \
        (2 if knobs == "on" else 0)
