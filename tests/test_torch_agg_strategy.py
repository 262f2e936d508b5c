"""The rest of the aggregate engine through both packages: count(DISTINCT)
and the reduction strategy table with the one-hot matmul strategy.

- count(DISTINCT): the same seeded rows, with NULLs, NaN and -0.0, load
  into the JAX package's session and the port's (on the CPU); the counts
  must be equal and exact against numpy, with no host fallback in either.
- `resolve_strategy` for the CPU backend must return the reference's
  choice for every request, segment count, row count and family.
- unroll / scatter / matmul return bit-identical group sums on
  integer-valued inputs (summation order cannot matter there), through
  the packed kernels and through the engine.

Ports tests/test_agg_strategy.py:47, :72, :139, :176, :199 and :231.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu.ops import reduction as ref_reduction
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.ops import reduction

_PROPS = (ref_config.global_properties(), config.global_properties())


@pytest.fixture
def props():
    saved = [(p.agg_reduce_strategy, p.decimal_as_float64) for p in _PROPS]
    yield _PROPS
    for p, (strat, dec) in zip(_PROPS, saved):
        p.agg_reduce_strategy = strat
        p.decimal_as_float64 = dec


def _set(name, value):
    for p in _PROPS:
        setattr(p, name, value)


def _rows(ref, port, q):
    """(port rows, reference rows), both answered on their devices."""
    rfb = ref_registry().counter("host_fallbacks")
    pfb = global_registry().counter("host_fallbacks")
    want = ref.sql(q).rows()
    got = port.sql(q).rows()
    assert ref_registry().counter("host_fallbacks") == rfb, q
    assert global_registry().counter("host_fallbacks") == pfb, q
    return got, want


# ---------------------------------------------------------------------
# count(DISTINCT)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_count_distinct_matches_reference(props, f32):
    _set("decimal_as_float64", not f32)
    rng = np.random.default_rng(21)
    n = 6000
    k = rng.choice(np.array(["a", "b", "c", None], dtype=object), n)
    g = rng.integers(0, 4, n).astype(np.int32)
    i = rng.integers(0, 50, n).astype(np.int64)
    x = rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.nan, 7.0]), n)
    xnull = rng.random(n) < 0.1
    inull = rng.random(n) < 0.1
    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    for s in (ref, port):
        s.sql("CREATE TABLE cd (k STRING, g INT, i BIGINT, x DOUBLE) "
              "USING column OPTIONS (column_batch_rows '1024')")
        s.catalog.describe("cd").data.insert_arrays(
            [k, g, i, x], nulls=[None, None, inull, xnull])
    got, want = _rows(ref, port,
                      "SELECT g, count(DISTINCT i), count(DISTINCT x), "
                      "count(DISTINCT k), count(*) FROM cd GROUP BY g "
                      "ORDER BY g")
    assert got == want
    for gi, ci, cx, ck, cnt in got:
        sel = g == gi
        assert ci == len(np.unique(i[sel & ~inull]))
        # -0.0 and 0.0 are one value; NaN is one value (one bit pattern)
        xv = x[sel & ~xnull]
        assert cx == len({0.0 if v == 0 else ("nan" if np.isnan(v) else v)
                          for v in xv})
        assert ck == len({v for v in k[sel] if v is not None})
        assert cnt == int(sel.sum())
    got, want = _rows(ref, port, "SELECT count(DISTINCT i), "
                      "count(DISTINCT g) FROM cd WHERE x > 0")
    assert got == want
    sel = (x > 0) & ~xnull
    assert got[0] == (len(np.unique(i[sel & ~inull])),
                      len(np.unique(g[sel])))


def test_count_distinct_pairs_against_numpy():
    """The chip smoke test's shape: distinct keys per (flag, status)
    group against np.unique over the (group, key) pairs."""
    rng = np.random.default_rng(5)
    n = 20_000
    rf = rng.choice(np.array(["A", "N", "R"], dtype=object), n)
    ls = rng.choice(np.array(["F", "O"], dtype=object), n)
    sk = rng.integers(0, 3000, n).astype(np.int32)
    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    for s in (ref, port):
        s.sql("CREATE TABLE li (rf STRING, ls STRING, sk INT) USING column")
        s.insert_arrays("li", [rf, ls, sk])
    got, want = _rows(ref, port,
                      "SELECT rf, ls, count(DISTINCT sk) FROM li "
                      "GROUP BY rf, ls ORDER BY rf, ls")
    assert got == want
    pairs = np.unique(np.stack([np.unique(np.char.add(
        rf.astype(str), ls.astype(str)), return_inverse=True)[1], sk]),
        axis=1)
    assert sum(r[2] for r in got) == pairs.shape[1]


# ---------------------------------------------------------------------
# strategy table + packed kernels
# ---------------------------------------------------------------------

_FAMILIES = {"fsum": (torch.float64, jnp.float64),
             "isum": (torch.int64, jnp.int64),
             "minmax": (torch.float64, jnp.float64)}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_resolve_strategy_matches_reference_cpu_table(family):
    tdt, jdt = _FAMILIES[family]
    for req in reduction.STRATEGIES + ("bogus",):
        for nseg in (1, 2, 4, 5, 9, 63, 64, 65, 200, 100_000):
            for n in (1000, 100_000, 60_000_000,
                      reduction.MATMUL_ONEHOT_MAX_BYTES):
                got = reduction.resolve_strategy(req, "cpu", nseg, n,
                                                 family, tdt)
                want = ref_reduction.resolve_strategy(req, "cpu", nseg, n,
                                                      family, jdt)
                assert got == want, (req, nseg, n, family)
                # CUDA takes the same (non-TPU) rows
                assert reduction.resolve_strategy(
                    req, "cuda", nseg, n, family, tdt) == want


def test_resolve_strategy_degrades_invalid_requests():
    assert reduction.resolve_strategy(
        "matmul", "cpu", 8, 1000, "isum", torch.int64) != "matmul"
    assert reduction.resolve_strategy(
        "matmul", "cpu", 8, 1000, "minmax", torch.float64) != "matmul"
    huge_n = reduction.MATMUL_ONEHOT_MAX_BYTES
    assert reduction.resolve_strategy(
        "matmul", "cpu", 8, huge_n, "fsum", torch.float64) == "scatter"
    assert reduction.resolve_strategy(
        "unroll", "cpu", reduction.UNROLL_MAX_SEGMENTS + 1, 1000,
        "fsum", torch.float64) == "scatter"
    assert reduction.resolve_strategy(
        "auto", "cpu", 9, 100_000, "fsum", torch.float64) == "matmul"
    assert reduction.onehot_bytes(10, 9, torch.float64) == 720


@pytest.mark.parametrize("nseg", [1, 2, 63, 64, 65, 200])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_packed_strategies_bit_identical(nseg, dtype):
    """unroll / scatter / matmul give bit-identical group sums on
    integer-valued values across dtypes, null patterns, empty groups and
    G around the 64-group unroll boundary, equal to the reference's."""
    rng = np.random.default_rng(nseg)
    n = 4096
    lo = 1 if nseg > 2 else 0
    gidx = rng.integers(lo, max(1, nseg - 1), n)
    vals = rng.integers(-50, 50, (n, 3)).astype(dtype)
    mask = rng.random(n) < 0.8
    masked = np.where(mask[:, None], vals, 0).astype(dtype)
    cols = [torch.from_numpy(masked[:, j].copy()) for j in range(3)]
    jcols = [jnp.asarray(masked[:, j]) for j in range(3)]
    tg = torch.from_numpy(gidx)
    family = "isum" if dtype == np.int64 else "fsum"
    outs = {}
    for strat in ("unroll", "scatter", "matmul"):
        eff = reduction.resolve_strategy(strat, "cpu", nseg, n, family,
                                         torch.from_numpy(vals).dtype)
        outs[strat] = reduction.packed_sum(cols, tg, nseg, eff).numpy()
        ref_eff = ref_reduction.resolve_strategy(
            strat, "cpu", nseg, n, family, jnp.dtype(dtype))
        assert eff == ref_eff
        want = np.asarray(ref_reduction.packed_sum(
            jcols, jnp.asarray(gidx), nseg, ref_eff))
        np.testing.assert_array_equal(outs[strat], want)
    assert (outs["unroll"] == outs["scatter"]).all()
    assert (outs["unroll"] == outs["matmul"]).all()
    for g in range(nseg):
        sel = (gidx == g) & mask
        np.testing.assert_array_equal(
            outs["scatter"][g], vals[sel].sum(axis=0).astype(dtype)
            if sel.any() else np.zeros(3, dtype))


def test_matmul_onehot_and_nonfinite_isolation():
    """The one-hot drops the overflow segment, and a NaN/Inf value poisons
    only its own group (the finite check takes the isolating scatter)."""
    g = torch.tensor([0, 1, 2, 1, 3])
    oh = reduction.make_onehot(g, 3, torch.float64)
    assert oh.shape == (5, 3) and oh[4].sum() == 0 and oh.sum() == 4
    v = torch.tensor([1.0, float("nan"), 2.0, 3.0, 5.0])
    out = reduction.packed_sum([v], g, 3, "matmul")[:, 0]
    assert out[0] == 1.0 and out[2] == 2.0 and torch.isnan(out[1])


def test_matmul_nonfinite_values_stay_group_isolated(props):
    _set("agg_reduce_strategy", "matmul")
    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    for s in (ref, port):
        s.sql("CREATE TABLE nf (k STRING, v DOUBLE) USING column")
        s.insert_arrays("nf", [np.array(["a", "a", "b", "b"], dtype=object),
                               np.array([1.0, np.nan, 2.0, 3.0])])
    got, want = _rows(ref, port,
                      "SELECT k, sum(v) FROM nf GROUP BY k ORDER BY k")
    assert got[0][0] == "a" and np.isnan(got[0][1]) and np.isnan(want[0][1])
    assert got[1] == want[1] == ("b", 5.0)


ENGINE_Q = ("SELECT k, b, count(*), count(v), sum(v), avg(v), min(v), "
            "max(v), sum(i), stddev(v) FROM t GROUP BY k, b "
            "ORDER BY k, b")


def test_engine_strategies_identical(props):
    """Every strategy returns the reference's rows through the engine,
    and the knob re-specializes without a plan-cache flush."""
    rng = np.random.default_rng(11)
    n = 20_000
    k = rng.choice(np.array(["a", "b", "c", "d", "e"], dtype=object), n)
    b = rng.random(n) < 0.5
    v = rng.integers(0, 10_000, n).astype(np.float64)  # exactly summable
    i = rng.integers(-100, 100, n, dtype=np.int64)
    nulls = rng.random(n) < 0.2
    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    for s in (ref, port):
        s.sql("CREATE TABLE t (k STRING, b BOOLEAN, v DOUBLE, i BIGINT) "
              "USING column")
        s.catalog.describe("t").data.insert_arrays(
            [k, b, v, i], nulls=[None, None, nulls, None])
    _set("agg_reduce_strategy", "auto")
    base, _ = _rows(ref, port, ENGINE_Q)
    assert len(base) == 10
    for strat in ("unroll", "scatter", "matmul"):
        _set("agg_reduce_strategy", strat)
        before = global_registry().counter(f"agg_strategy_{strat}")
        got, want = _rows(ref, port, ENGINE_Q)
        for a, w, c in zip(got, want, base):
            assert a[:9] == w[:9] == c[:9], (strat, a, w)
            assert a[9] == pytest.approx(w[9], rel=1e-12)
        assert global_registry().counter(f"agg_strategy_{strat}") > before


def test_reduce_passes_constant_in_slot_count(props):
    """Fused reduction dispatches are O(1) in the number of aggregate
    slots, in both packages alike: a wide aggregate packs into the same
    per-family passes as a narrow one."""
    _set("agg_reduce_strategy", "auto")
    rng = np.random.default_rng(5)
    n = 5000
    arrays = [rng.choice(np.array(["x", "y", "z"], dtype=object), n)] \
        + [np.round(rng.random(n) * 100, 2) for _ in range(8)]
    decls = ", ".join(f"c{j} DOUBLE" for j in range(8))
    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    for s in (ref, port):
        s.sql(f"CREATE TABLE w (k STRING, {decls}) USING column")
        s.insert_arrays("w", arrays)

    def passes_of(q):
        out = []
        for s, reg in ((ref, ref_registry()), (port, global_registry())):
            s.sql(q)
            c0 = reg.counter("agg_reduce_passes")
            s.sql(q)
            out.append(reg.counter("agg_reduce_passes") - c0)
        return out

    narrow = passes_of(
        "SELECT k, sum(c0), min(c0), count(*) FROM w GROUP BY k")
    sums = ", ".join(f"sum(c{j})" for j in range(8))
    avgs = ", ".join(f"avg(c{j})" for j in range(8))
    mins = ", ".join(f"min(c{j})" for j in range(4))
    wide = passes_of(
        f"SELECT k, {sums}, {avgs}, {mins}, count(*) FROM w GROUP BY k")
    assert narrow[1] > 0
    assert wide[1] == narrow[1]
    assert wide == narrow, (wide, narrow)


def test_count_accumulator_widens_past_int32(monkeypatch):
    """The packed count dtype widens past the int32 row bound; at a
    shrunken bound the count stays exact in int64."""
    assert reduction.count_pack_dtype(2 ** 31 - 1) == torch.int32
    assert reduction.count_pack_dtype(2 ** 31) == torch.int64
    monkeypatch.setattr(reduction, "COUNT_I32_MAX_ROWS", 100)
    assert reduction.count_pack_dtype(101) == torch.int64
    gidx = torch.zeros(500, dtype=torch.int64)
    ones = torch.ones(500, dtype=reduction.count_pack_dtype(500))
    out = reduction.packed_sum([ones], gidx, 2, "scatter")
    assert out.dtype == torch.int64 and int(out[0, 0]) == 500
