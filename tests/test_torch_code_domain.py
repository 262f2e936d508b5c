"""The compressed-domain scan through both packages.

1. TPC-H Q6 / Q1 over code plates: the same small TPC-H load (sf 0.02,
   seed 11, 16,384-row batches, the row-buffer tail rolled into batches,
   float32 plates on both packages) goes through the port's
   `code_domain_q6` / `code_domain_q1` on a CPU session and through the
   JAX package's Pallas kernels (interpret mode) on the reference's own
   bind of the same table: counts exact, sums rel 1e-7; and against the
   port session's own Q6 / Q1 rows: counts exact, sums rel 5e-5 (the
   engine sums decoded values, the kernels sum code-plate products).
2. RLE and bitset plates: the run arithmetic of both packages' building
   blocks, the reference bench's run-space probe, and a filtered BOOLEAN
   count — identical answers, the run-space lane firing in both, and no
   column rerouted as `compressed_fallback_not_ported`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu.ops.pallas_group import grouped_code_reduce as jax_gcr
from snappydata_tpu.ops.pallas_reduce import fused_code_filter_sum as jax_fcs
from snappydata_tpu.storage import device as ref_device
from snappydata_tpu.storage import device_decode as ref_dd
from snappydata_tpu.utils import tpch as ref_tpch
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.storage import device_decode as dd
from snappydata_tpu_torch.storage.device import build_device_table
from snappydata_tpu_torch.utils import tpch
from snappydata_tpu_torch.utils import tpch_code_domain as tcd

QTY, PRICE, DISC, TAX, RF, LS, SHIP = 4, 5, 6, 7, 8, 9, 10
Q6_COUNT = ("SELECT count(*) FROM lineitem "
            "WHERE l_shipdate >= DATE '1994-01-01' "
            "AND l_shipdate < DATE '1995-01-01' "
            "AND l_discount BETWEEN 0.05 AND 0.07 "
            "AND l_quantity < 24")


@pytest.fixture(scope="module")
def loaded():
    """(reference session, its device table, port session), both loaded
    with float32 plates and 16,384-row batches."""
    props = (ref_config.global_properties(), config.global_properties())
    saved = [(p.column_batch_rows, p.decimal_as_float64) for p in props]
    for p in props:
        p.column_batch_rows = 1 << 14
        p.decimal_as_float64 = False
    try:
        ref = RefSession(catalog=RefCatalog())
        port = SnappySession(catalog=Catalog(), device="cpu")
        for s, load in ((ref, ref_tpch.load_tpch), (port, tpch.load_tpch)):
            load(s, sf=0.02, seed=11)
            s.catalog.lookup_table("lineitem").data.force_rollover()
        ref_dt = ref_device.build_device_table(
            ref.catalog.lookup_table("lineitem").data, None,
            [QTY, PRICE, DISC, TAX, RF, LS, SHIP])
        yield ref, ref_dt, port
    finally:
        for p, (rows, f64) in zip(props, saved):
            p.column_batch_rows = rows
            p.decimal_as_float64 = f64


def _ref_thresh(dt, ci, lit, side, round_literal=True):
    """The port's threshold rule on the reference's bind: dictionary
    domain and literal both at the engine's float32 compare width."""
    dom, sizes = dt.dict_domains[ci]
    if round_literal:
        lit = np.float32(lit)
        dom = dom.astype(np.float32)
    out = np.zeros(int(dt.valid.shape[0]), dtype=np.int32)
    for i in range(out.shape[0]):
        sz = int(sizes[i])
        out[i] = np.searchsorted(dom[i, :sz], lit, side) if sz else 0
    return out


def _ref_q6(dt, round_literal=True):
    qp, dp = dt.columns[QTY], dt.columns[DISC]
    total, count = jax_fcs(
        qp.codes, dp.codes, dt.columns[SHIP], dt.columns[PRICE], dt.valid,
        dp.dicts, _ref_thresh(dt, QTY, 24.0, "left", round_literal),
        _ref_thresh(dt, DISC, 0.05, "left", round_literal),
        _ref_thresh(dt, DISC, 0.07, "right", round_literal) - 1,
        tpch._days("1994-01-01"), tpch._days("1995-01-01"))
    return float(total), int(count)


def test_code_domain_q6_matches_reference_kernel_and_engine(loaded):
    ref, ref_dt, port = loaded
    revenue, count = tcd.code_domain_q6(port)
    ref_rev, ref_cnt = _ref_q6(ref_dt)
    assert count == ref_cnt == port.sql(Q6_COUNT).rows()[0][0] \
        == ref.sql(Q6_COUNT).rows()[0][0]
    assert revenue == pytest.approx(ref_rev, rel=1e-7)
    assert revenue == pytest.approx(port.sql(tpch.Q6).rows()[0][0],
                                    rel=5e-5)
    # the float32 dictionaries hold 0.07 as 0.0700000003: searching the
    # unrounded float64 literal (the reference bench's translation) drops
    # those rows, which the engines keep
    assert _ref_q6(ref_dt, round_literal=False)[1] < count


def test_code_domain_q1_matches_reference_kernel_and_engine(loaded):
    ref, ref_dt, port = loaded
    rows = tcd.code_domain_q1(port)
    qp, dp, tp = (ref_dt.columns[c] for c in (QTY, DISC, TAX))
    rfd, lsd = ref_dt.dictionaries[RF], ref_dt.dictionaries[LS]
    nls = len(lsd)
    G = len(rfd) * nls
    price = ref_dt.columns[PRICE]
    one_minus_disc = 1.0 - ref_dt.dict_domains[DISC][0]
    ref_outs = jax.block_until_ready(jax_gcr(
        ref_dt.columns[RF] * nls + ref_dt.columns[LS],
        ref_dt.valid & (ref_dt.columns[SHIP]
                        <= tpch._days("1998-12-01") - 90),
        [("count",),
         ("sum", None, [(qp.codes, ref_dt.dict_domains[QTY][0])]),
         ("sum", price, []),
         ("sum", price, [(dp.codes, one_minus_disc)]),
         ("sum", price, [(dp.codes, one_minus_disc),
                         (tp.codes, 1.0 + ref_dt.dict_domains[TAX][0])])],
        G))
    by_key = {(str(rfd[g // nls]), str(lsd[g % nls])): g for g in range(G)}
    assert [r[:2] for r in rows] == sorted(by_key)
    engine = {(r[0], r[1]): r for r in port.sql(tpch.Q1).rows()}
    assert set(engine) == {(r[0], r[1]) for r in ref.sql(tpch.Q1).rows()}
    matched = 0
    for r in rows:
        g = by_key[r[:2]]
        assert r[2] == int(ref_outs[0][g])
        for k in range(1, 5):
            assert r[2 + k] == pytest.approx(float(ref_outs[k][g]),
                                             rel=1e-7)
        if r[:2] not in engine:
            assert r[2] == 0
            continue
        matched += 1
        e = engine[r[:2]]
        assert r[2] == e[9]
        for got, want in zip(r[3:], e[2:6]):
            assert got == pytest.approx(want, rel=5e-5)
    assert matched == len(engine)


def test_code_domain_q6_with_dictionaries_wider_than_plates():
    """Batches encoded at float64 (dictionaries hold exact 0.05 / 0.07)
    bound as float32 plates: the thresholds follow the engine's float32
    compare, so no 0.05 or 0.07 row is lost."""
    props = config.global_properties()
    saved = props.decimal_as_float64
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql(tpch.LINEITEM_DDL)
    li = tpch.gen_lineitem(40_000, 5)
    props.decimal_as_float64 = True
    try:
        s.insert_arrays("lineitem", list(li.values()))
        s.catalog.lookup_table("lineitem").data.force_rollover()
        props.decimal_as_float64 = False
        revenue, count = tcd.code_domain_q6(s)
        assert count == s.sql(Q6_COUNT).rows()[0][0]
        assert revenue == pytest.approx(s.sql(tpch.Q6).rows()[0][0],
                                        rel=5e-5)
    finally:
        props.decimal_as_float64 = saved


def test_code_domain_raises_without_code_plates():
    props = config.global_properties()
    saved = props.scan_compressed_domain
    props.scan_compressed_domain = "off"
    try:
        s = SnappySession(catalog=Catalog(), device="cpu")
        s.sql(tpch.LINEITEM_DDL)
        s.insert_arrays("lineitem", list(tpch.gen_lineitem(2000, 3).values()))
        with pytest.raises(RuntimeError, match="code-bound"):
            tcd.code_domain_q6(s)
    finally:
        props.scan_compressed_domain = saved


# --- RLE and bitset plates ---------------------------------------------------

def test_rle_run_arithmetic_matches_reference():
    """O(runs) filter / count / sum arithmetic of both packages equals
    the expanded O(rows) answer (the reference test's case)."""
    vals = np.array([[5.0, 2.0, 9.0, 9.0], [1.0, 1.0, 1.0, 1.0]])
    ends = np.array([[10, 25, 40, 40], [7, 7, 7, 7]])   # padded runs
    cap = 64
    port = dd.RlePlate(torch.from_numpy(vals), torch.from_numpy(ends))
    ref = ref_dd.RlePlate(jnp.asarray(vals), jnp.asarray(ends))
    expanded = dd.rle_values(port, cap).numpy()
    assert (expanded == np.asarray(ref_dd.rle_values(ref, cap))).all()
    lens = dd.rle_run_lengths(port.ends)
    assert lens.tolist() == [[10, 15, 15, 0], [7, 0, 0, 0]] \
        == np.asarray(ref_dd.rle_run_lengths(ref.ends)).tolist()
    run_mask = vals >= 5.0
    total, count = dd.rle_masked_sum_count(port, torch.from_numpy(run_mask))
    r_total, r_count = ref_dd.rle_masked_sum_count(ref,
                                                   jnp.asarray(run_mask))
    exp_cnt, exp_sum = 0, 0.0
    for b in range(2):
        rowvals = expanded[b, :int(ends[b, -1])]
        exp_cnt += int((rowvals >= 5.0).sum())
        exp_sum += float(rowvals[rowvals >= 5.0].sum())
    assert int(count) == int(r_count) == exp_cnt
    assert float(total) == float(r_total) == pytest.approx(exp_sum)
    mask_rows = dd.rle_cmp_mask(lambda v, lit: v >= lit, port,
                                torch.tensor(5.0), cap).numpy()
    assert (mask_rows == (expanded >= 5.0)).all()
    assert (mask_rows == np.asarray(ref_dd.rle_cmp_mask(
        lambda v, lit: v >= lit, ref, jnp.asarray(5.0), cap))).all()


def _counter_deltas(reg, snap, before, names):
    after = snap(reg)
    return {k: after.get(k, 0) - before.get(k, 0) for k in names}


def test_rle_and_bitset_queries_match_reference():
    """The reference bench's run-space probe (a sorted DOUBLE column of 5
    distinct values, 65,536 rows) and a filtered BOOLEAN count answer
    alike in both packages; the run-space lane fires in both, and no
    column is rerouted as not ported."""
    rng = np.random.default_rng(7)
    rvals = np.sort(rng.choice(np.array([1.0, 2.0, 5.0, 9.0, 12.0]),
                               1 << 16))
    flags = rng.random(40_000) < 0.3
    ids = np.arange(40_000, dtype=np.int32)
    queries = ["SELECT sum(r), count(r) FROM code_agg_rle WHERE r < 9.0",
               "SELECT sum(r), count(*) FROM code_agg_rle "
               "WHERE r >= 2.0 AND r < 12.0",
               "SELECT count(*) FROM flags WHERE b",
               "SELECT count(*), sum(id) FROM flags "
               "WHERE b = true AND id < 1000"]
    names = ("agg_rle_runs", "compressed_fallback_not_ported",
             "compressed_fallback_rle_agg")
    answers = []
    lanes = []
    for make, reg, snap in (
            (lambda: RefSession(catalog=RefCatalog()), ref_registry(),
             lambda r: dict(r.snapshot()["counters"])),
            (lambda: SnappySession(catalog=Catalog(), device="cpu"),
             global_registry(), lambda r: r.counters_snapshot())):
        s = make()
        s.sql("CREATE TABLE code_agg_rle (r DOUBLE) USING column")
        s.insert_arrays("code_agg_rle", [rvals])
        s.catalog.describe("code_agg_rle").data.force_rollover()
        s.sql("CREATE TABLE flags (id INT, b BOOLEAN) USING column")
        s.insert_arrays("flags", [ids, flags])
        s.catalog.describe("flags").data.force_rollover()
        before = snap(reg)
        answers.append([s.sql(q).rows() for q in queries])
        lanes.append(_counter_deltas(reg, snap, before, names))
    ref_rows, port_rows = answers
    assert port_rows == ref_rows
    keep = rvals < 9.0
    assert port_rows[0] == [(float(rvals[keep].sum()), int(keep.sum()))]
    assert port_rows[2] == [(int(flags.sum()),)]
    for d in lanes:
        assert d["agg_rle_runs"] == 2
        assert d["compressed_fallback_not_ported"] == 0
        assert d["compressed_fallback_rle_agg"] == 0


def test_rle_and_bitset_columns_bind_resident():
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql("CREATE TABLE t (r DOUBLE, b BOOLEAN) USING column")
    r = np.repeat(np.array([3.0, 4.0, 8.0]), 2000)
    s.insert_arrays("t", [r, np.arange(r.size) % 3 == 0])
    data = s.catalog.describe("t").data
    data.force_rollover()
    dt = build_device_table(data, [0, 1], torch.device("cpu"))
    assert isinstance(dt.columns[0], dd.RlePlate)
    assert isinstance(dt.columns[1], dd.BitPlate)
    assert (dd.rle_values(dt.columns[0], dt.capacity)[0, :r.size].numpy()
            == r).all()
    bits = dd.bit_values(dt.columns[1], dt.capacity)[0, :r.size].numpy()
    assert (bits == (np.arange(r.size) % 3 == 0)).all()


def test_filter_leaving_run_space_is_a_counted_fallback():
    """A conjunct the run lane cannot carry (arithmetic over the column)
    takes the row-space path, counted as compressed_fallback_rle_agg,
    with the same answer."""
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql("CREATE TABLE t (r DOUBLE) USING column")
    r = np.repeat(np.array([1.0, 2.0, 5.0, 9.0]), 5000)
    s.insert_arrays("t", [r])
    s.catalog.describe("t").data.force_rollover()
    reg = global_registry()
    before = reg.counters_snapshot()
    rows = s.sql("SELECT sum(r), count(r) FROM t "
                 "WHERE r < 9.0 OR r * 2.0 > 17.0").rows()
    after = reg.counters_snapshot()
    assert rows == [(float(r.sum()), r.size)]
    assert after.get("compressed_fallback_rle_agg", 0) \
        - before.get("compressed_fallback_rle_agg", 0) == 2
    assert after.get("agg_rle_runs", 0) == before.get("agg_rle_runs", 0)
