"""The device join engine and the generic group-key lane, port vs reference.

Three layers, each against the JAX package on the CPU:

- the `ops/join` primitives on the same seeded numpy inputs: the key
  encodings (`key_bits`, `combine_key_arrays`, `encode_*_keys`) and
  `translate_codes` bit-identical, the match ranges, k-th match lookups
  and the expansion exact, and the build artifact's stable sort order
  equal to the reference's argsort;
- the reference's join-engine tests (tests/test_join_engine.py), each
  running BOTH packages with the same rows: the port's device rows must
  equal the reference's and the host oracle's (the pandas join reached
  through the `device_join` knob), with equal `join_*` counter deltas —
  the port leaves the device exactly where the reference does.  Where
  the reference mutates with DELETE, which the port lacks, the tests use
  TRUNCATE or INSERT;
- the slice as a whole: TPC-H at sf 0.002 loaded into both packages from
  the same arrays, every query of `utils/tpch.py` with a join and no
  subquery, and the generic hash-key lane with its max_groups overflow
  reroute.

Float results compare within rel 1e-9 (float64 plates on the CPU);
counts, keys and integer sums exactly.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu.ops import join as ref_join
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.ops import join as pj
from snappydata_tpu_torch.utils import tpch

REL = 1e-9
_KNOBS = ("device_join", "join_expand_max_bytes", "join_build_cache_bytes",
          "max_groups")


# --- primitives ------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _keycols(rng, n):
    """Key columns of every dtype the encoders see, with +/-0.0, NaN-free
    floats, large int64 values and a NULL mask."""
    f64 = rng.normal(0, 1e6, n)
    f64[::7] = 0.0
    f64[3::7] = -0.0
    f32 = rng.normal(0, 100, n).astype(np.float32)
    f32[::5] = -0.0
    i64 = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    nulls = rng.random(n) < 0.2
    return {"f64": f64, "f32": f32, "i64": i64, "i32": i32}, nulls


@pytest.mark.parametrize("kind", ["f64", "f32", "i64", "i32"])
def test_key_bits_bit_identical(kind):
    cols, _ = _keycols(np.random.default_rng(1), 257)
    got = pj.key_bits(_t(cols[kind])).numpy()
    want = np.asarray(ref_join.key_bits(jnp.asarray(cols[kind])))
    assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("names", [("i64",), ("f64",), ("f32", "i32"),
                                   ("i64", "f64", "i32"),
                                   ("f32", "f64", "i64", "i32")])
@pytest.mark.parametrize("with_nulls", [False, True])
def test_combine_and_encode_keys_bit_identical(names, with_nulls):
    rng = np.random.default_rng(zlib.crc32(repr((names, with_nulls))
                                           .encode()))
    n = 301
    cols, nulls = _keycols(rng, n)
    nm = [nulls if with_nulls and i % 2 == 0 else None
          for i in range(len(names))]
    ppairs = [(_t(cols[k]), _t(m) if m is not None else None)
              for k, m in zip(names, nm)]
    rpairs = [(jnp.asarray(cols[k]), jnp.asarray(m) if m is not None
               else None) for k, m in zip(names, nm)]
    got = pj.combine_key_arrays(ppairs).numpy()
    want = np.asarray(ref_join.combine_key_arrays(rpairs))
    assert np.array_equal(got, want)
    valid = rng.random(n) < 0.9
    anynull = nulls if with_nulls else None
    assert np.array_equal(
        pj.encode_probe_keys(ppairs, _t(anynull) if with_nulls else None)
        .numpy(),
        np.asarray(ref_join.encode_probe_keys(
            rpairs, jnp.asarray(anynull) if with_nulls else None)))
    assert np.array_equal(
        pj.encode_build_keys(ppairs, _t(valid),
                             _t(anynull) if with_nulls else None).numpy(),
        np.asarray(ref_join.encode_build_keys(
            rpairs, jnp.asarray(valid),
            jnp.asarray(anynull) if with_nulls else None)))


def test_translate_codes_bit_identical():
    rng = np.random.default_rng(5)
    pool = np.array([f"v{i}" for i in range(40)] + [None], dtype=object)
    ld = rng.choice(pool, 23, replace=False)
    rd = rng.choice(pool, 31, replace=False)
    for a, b in ((ld, rd), (ld, rd[:0]), (ld[:0], rd), (ld[:1], rd)):
        got = pj.translate_codes(a, b)
        want = ref_join.translate_codes(a, b)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _build_side(rng, n, filtered):
    """Sorted build keys with duplicates, sentinels and a pass mask."""
    keys = rng.integers(0, 40, n).astype(np.int64)
    valid = rng.random(n) < 0.85
    bkeys = np.where(valid, keys, pj.BUILD_NULL_SENTINEL)
    order = np.argsort(bkeys, kind="stable").astype(np.int64)
    skeys = bkeys[order]
    passing = valid & ((rng.random(n) < 0.6) if filtered else True)
    return skeys, order, passing


@pytest.mark.parametrize("filtered", [False, True])
def test_match_ranges_nth_match_and_expand_exact(filtered):
    rng = np.random.default_rng(11 + filtered)
    skeys, order, passing = _build_side(rng, 500, filtered)
    pkeys = rng.integers(-5, 45, 120).astype(np.int64)
    pkeys[::9] = pj.PROBE_NULL_SENTINEL
    pvalid = rng.random(120) < 0.9
    if filtered:
        got = pj.match_ranges(_t(skeys), _t(order), _t(passing), _t(pkeys))
        want = ref_join.match_ranges(jnp.asarray(skeys), jnp.asarray(order),
                                     jnp.asarray(passing),
                                     jnp.asarray(pkeys))
    else:
        got = pj.match_ranges_dense(_t(skeys), _t(pkeys))
        want = ref_join.match_ranges_dense(jnp.asarray(skeys),
                                           jnp.asarray(pkeys))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    counts, base = got[0], got[1]
    counts_f = torch.where(_t(pvalid), counts, 0)
    for eff in (counts_f, torch.where(_t(pvalid), counts_f.clamp(min=1), 0)):
        bucket = pj.expand_bucket(max(1, int(eff.sum())))
        pe = pj.expand(counts_f, eff, bucket)
        re = ref_join.expand(jnp.asarray(counts_f.numpy()),
                             jnp.asarray(eff.numpy()), bucket)
        for g, w in zip(pe, re):
            assert np.array_equal(g.numpy(), np.asarray(w))
        probe_of, rank = pe[0], pe[1]
        if filtered:
            gpos = pj.nth_match(base[probe_of], rank, got[2], _t(order))
            wpos = ref_join.nth_match(jnp.asarray(base[probe_of].numpy()),
                                      jnp.asarray(rank.numpy()),
                                      jnp.asarray(got[2].numpy()),
                                      jnp.asarray(order))
        else:
            gpos = pj.nth_match_dense(base[probe_of], rank, _t(order))
            wpos = ref_join.nth_match_dense(
                jnp.asarray(base[probe_of].numpy()),
                jnp.asarray(rank.numpy()), jnp.asarray(order))
        assert np.array_equal(gpos.numpy(), np.asarray(wpos))


def test_build_artifact_order_matches_reference_argsort():
    """The artifact's sort is stable, as jnp.argsort is: equal keys keep
    their flat order, so the k-th match and the summation order along the
    expanded axis agree with the reference."""
    rng = np.random.default_rng(3)
    bkeys = rng.integers(0, 30, 2000).astype(np.int64)
    bkeys[rng.random(2000) < 0.1] = pj.BUILD_NULL_SENTINEL
    ident = torch.zeros(1)
    art = pj.build_artifact(ident, ("test",), lambda: _t(bkeys))
    want = np.asarray(jnp.argsort(jnp.asarray(bkeys)))
    assert np.array_equal(art["order"].numpy(), want)
    assert art["unique"] is False
    uniq = pj.build_artifact(torch.zeros(1), ("test",),
                             lambda: _t(np.arange(9, dtype=np.int64)))
    assert uniq["unique"] is True


# --- session parity: the reference's join-engine tests ---------------------

class Pair:
    """A reference session and a port session (CPU) fed the same rows."""

    def __init__(self):
        self.ref = RefSession(catalog=RefCatalog())
        self.port = SnappySession(catalog=Catalog(), device="cpu")

    def sql(self, q):
        self.ref.sql(q)
        self.port.sql(q)

    def insert(self, table, *rows):
        self.ref.insert(table, *rows)
        self.port.insert(table, *rows)

    def insert_arrays(self, table, arrays):
        self.ref.insert_arrays(table, arrays)
        self.port.insert_arrays(table, arrays)

    def set(self, key, value):
        for p in (ref_config.global_properties(),
                  config.global_properties()):
            p.set(key, value)

    def run(self, q):
        """(port rows, reference rows, port join_* deltas, reference
        join_* deltas, host_fallbacks delta of each)."""
        out = []
        for sess, reg in ((self.port, global_registry()),
                          (self.ref, ref_registry())):
            before = _counters(reg)
            rows = sess.sql(q).rows()
            after = _counters(reg)
            moved = {k: after.get(k, 0) - before.get(k, 0)
                     for k in set(after) | set(before)
                     if k.startswith("join_") or k in (
                         "host_fallbacks", "compressed_fallback_join_key")}
            out.append((rows, {k: v for k, v in moved.items() if v}))
        return out[0][0], out[1][0], out[0][1], out[1][1]

    def both_paths(self, q):
        """Host oracle first (device_join off), then the device run: the
        port's device rows equal the reference's and the oracle's, and the
        two packages moved the same join_* counters.  Returns the port's
        rows and the port's join_host_fallbacks delta."""
        self.set("device_join", False)
        try:
            host, ref_host, pmoved, rmoved = self.run(q)
        finally:
            self.set("device_join", True)
        _assert_rows_equal(host, ref_host)
        assert pmoved == rmoved
        dev, ref_dev, pmoved, rmoved = self.run(q)
        _assert_rows_equal(dev, ref_dev)
        _assert_rows_equal(dev, host)
        assert pmoved == rmoved, (pmoved, rmoved)
        return dev, pmoved.get("join_host_fallbacks", 0)


def _counters(reg):
    snap = reg.snapshot()
    return dict(snap["counters"]) if "counters" in snap else dict(snap)


def _assert_rows_equal(got, want, rel=REL):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, (float, np.floating)) and b is not None:
                assert a == pytest.approx(b, rel=rel, abs=1e-9), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture()
def pair():
    props = (ref_config.global_properties(), config.global_properties())
    saved = [{k: p.get(k) for k in _KNOBS} for p in props]
    yield Pair()
    for p, old in zip(props, saved):
        for k, v in old.items():
            p.set(k, v)


def _load_pair(pair, key_sql_type, keys_l, keys_r):
    pair.sql(f"CREATE TABLE tl (k {key_sql_type}, lv INT) USING column")
    pair.sql(f"CREATE TABLE tr (k {key_sql_type}, rv INT) USING column")
    for i, k in enumerate(keys_l):
        pair.insert("tl", (k, i))
    for i, k in enumerate(keys_r):
        pair.insert("tr", (k, 1000 + i))


def _keyset(rng, dtype, n):
    """Keys with duplicates on BOTH sides, misses, and ~15% NULLs."""
    if dtype == "BIGINT":
        pool = [int(v) for v in rng.integers(0, 8, 64)]
    elif dtype == "DOUBLE":
        pool = [float(v) * 0.5 for v in rng.integers(0, 8, 64)]
    else:  # VARCHAR
        pool = [f"k{v}" for v in rng.integers(0, 8, 64)]
    return [None if rng.random() < 0.15 else pool[i % len(pool)]
            for i in range(n)]


HOWS = ["JOIN", "LEFT JOIN", "RIGHT JOIN", "FULL JOIN"]


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("dtype", ["BIGINT", "DOUBLE", "VARCHAR"])
def test_join_device_matches_host(pair, how, dtype):
    rng = np.random.default_rng(zlib.crc32(f"{how}/{dtype}".encode()))
    _load_pair(pair, dtype, _keyset(rng, dtype, 37), _keyset(rng, dtype, 23))
    q = (f"SELECT a.lv, b.rv FROM tl a {how} tr b ON a.k = b.k "
         f"ORDER BY a.lv NULLS LAST, b.rv NULLS LAST")
    _dev, fallbacks = pair.both_paths(q)
    assert fallbacks == 0, "expected the device join path"


@pytest.mark.parametrize("how", HOWS)
def test_join_empty_sides(pair, how):
    _load_pair(pair, "BIGINT", [1, 2, 2, None], [])
    q = (f"SELECT a.lv, b.rv FROM tl a {how} tr b ON a.k = b.k "
         f"ORDER BY a.lv NULLS LAST, b.rv NULLS LAST")
    assert pair.both_paths(q)[1] == 0
    # empty probe, non-empty build
    pair.sql("TRUNCATE TABLE tl")
    pair.insert("tr", (2, 1001))
    assert pair.both_paths(q)[1] == 0


def test_mixed_int_float_keys_small_values_stay_device(pair):
    pair.sql("CREATE TABLE fi (k DOUBLE, lv INT) USING column")
    pair.sql("CREATE TABLE ii (k BIGINT, rv INT) USING column")
    pair.sql("INSERT INTO fi VALUES (1.0, 1), (2.5, 2), (3.0, 3), (NULL, 4)")
    pair.sql("INSERT INTO ii VALUES (1, 10), (3, 30), (3, 31), (4, 40)")
    assert pair.both_paths(
        "SELECT a.lv, b.rv FROM fi a LEFT JOIN ii b ON a.k = b.k "
        "ORDER BY a.lv, b.rv NULLS LAST")[1] == 0


def test_mixed_int_float_key_2p53_routes_to_host(pair):
    big = 1 << 53
    pair.sql("CREATE TABLE fk (k DOUBLE, lv INT) USING column")
    pair.sql("CREATE TABLE ik (k BIGINT, rv INT) USING column")
    pair.sql(f"INSERT INTO fk VALUES ({float(big)}, 1), (2.0, 2)")
    # big+1 is NOT representable in float64
    pair.sql(f"INSERT INTO ik VALUES ({big + 1}, 10), (2, 20)")
    r0 = global_registry().counter("join_fallback_int_float_key_2p53")
    _dev, fallbacks = pair.both_paths(
        "SELECT a.lv, b.rv FROM fk a JOIN ik b ON a.k = b.k ORDER BY a.lv")
    assert fallbacks > 0
    assert global_registry().counter("join_fallback_int_float_key_2p53") \
        > r0


def test_mixed_int_float_below_2p53_exact_on_device(pair):
    v = (1 << 53) - 1
    pair.sql("CREATE TABLE fk2 (k DOUBLE, lv INT) USING column")
    pair.sql("CREATE TABLE ik2 (k BIGINT, rv INT) USING column")
    pair.sql(f"INSERT INTO fk2 VALUES ({float(v)}, 1)")
    pair.sql(f"INSERT INTO ik2 VALUES ({v}, 10), ({v - 2}, 20)")
    dev, fallbacks = pair.both_paths(
        "SELECT a.lv, b.rv FROM fk2 a JOIN ik2 b ON a.k = b.k")
    assert fallbacks == 0 and dev == [(1, 10)]


def test_residual_on_inner_expansion(pair):
    _load_pair(pair, "BIGINT", [1, 2, 2, 3], [2, 2, 3, 3])
    assert pair.both_paths(
        "SELECT a.lv, b.rv FROM tl a JOIN tr b "
        "ON a.k = b.k AND b.rv > 1001 ORDER BY a.lv, b.rv")[1] == 0


def test_residual_on_outer_falls_back_reasoned(pair):
    _load_pair(pair, "BIGINT", [1, 2], [2, 2])
    r0 = global_registry().counter("join_fallback_residual_outer")
    pair.both_paths("SELECT a.lv, b.rv FROM tl a LEFT JOIN tr b "
                    "ON a.k = b.k AND b.rv > 1000 "
                    "ORDER BY a.lv, b.rv NULLS LAST")
    assert global_registry().counter("join_fallback_residual_outer") > r0


def test_expansion_bucket_grows_with_duplicates(pair):
    """Growing build duplication crosses {2^k, 1.5*2^k} bucket edges:
    each growth step stays correct and on the device."""
    pair.sql("CREATE TABLE gp (k BIGINT, lv INT) USING column")
    pair.sql("CREATE TABLE gb (k BIGINT, rv INT) USING column")
    for i in range(8):
        pair.insert("gp", (i % 4, i))
    out0 = global_registry().counter("join_expand_out_rows")
    total = 0
    for step in range(4):
        for i in range(6 * (step + 1)):
            pair.insert("gb", (i % 4, total + i))
        total += 6 * (step + 1)
        assert pair.both_paths(
            "SELECT a.lv, b.rv FROM gp a JOIN gb b ON a.k = b.k "
            "ORDER BY a.lv, b.rv")[1] == 0
    assert global_registry().counter("join_expand_out_rows") > out0


def test_build_cache_hits_and_invalidation_on_insert(pair):
    reg = global_registry()
    pair.sql("CREATE TABLE cp (k BIGINT, lv INT) USING column")
    pair.sql("CREATE TABLE cb (k BIGINT, rv INT) USING column")
    for i in range(10):
        pair.insert("cp", (i % 5, i))
    for i in range(12):
        pair.insert("cb", (i % 5, i))
    q = ("SELECT a.lv, b.rv FROM cp a JOIN cb b ON a.k = b.k "
         "ORDER BY a.lv, b.rv")
    pair.run(q)  # the first run pays the ONE build sort
    s0 = reg.counter("join_build_sorts")
    h0 = reg.counter("join_build_cache_hits")
    for _ in range(3):
        pair.run(q)
    assert reg.counter("join_build_sorts") == s0, \
        "repeated executions must reuse the cached build artifact"
    assert reg.counter("join_build_cache_hits") > h0
    # a build-side insert rotates the bind identity -> a fresh sort
    pair.insert("cb", (1, 99))
    before, ref_before, pmoved, rmoved = pair.run(q)
    _assert_rows_equal(before, ref_before)
    assert pmoved == rmoved
    assert reg.counter("join_build_sorts") == s0 + 1
    dev, _ = pair.both_paths(q)
    assert before == dev


def test_expand_bound_not_shared_across_probe_key_columns(pair):
    """Two queries probing the SAME build snapshot on DIFFERENT probe key
    columns must not share a memoized expansion bound: a stale too-small
    bound would trip the overflow reroute on every execution."""
    pair.sql("CREATE TABLE pb (few BIGINT, many BIGINT, lv INT) "
             "USING column")
    pair.sql("CREATE TABLE bb (k BIGINT, rv INT) USING column")
    for i in range(8):
        pair.insert("pb", (100 + i, i % 2, i))   # `few` matches NOTHING
        pair.insert("bb", (i % 2, 10 + i))       # hot keys 0/1: 4 dups each
    g0 = global_registry().counter("host_fallbacks")
    for col in ("few", "many"):
        q = (f"SELECT a.lv, b.rv FROM pb a JOIN bb b ON a.{col} = b.k "
             f"ORDER BY a.lv, b.rv")
        dev, ref, _pm, _rm = pair.run(q)
        _assert_rows_equal(dev, ref)
    assert global_registry().counter("host_fallbacks") == g0, \
        "a stale shared expansion bound tripped the overflow reroute"
    assert len(dev) == 32


def test_build_cache_disabled_still_joins_on_device(pair):
    pair.set("join_build_cache_bytes", 0)
    pair.sql("CREATE TABLE dp (k BIGINT, lv INT) USING column")
    pair.sql("CREATE TABLE db (k BIGINT, rv INT) USING column")
    for i in range(6):
        pair.insert("dp", (i % 3, i))
        pair.insert("db", (i % 3, 10 + i))
    q = ("SELECT a.lv, b.rv FROM dp a JOIN db b ON a.k = b.k "
         "ORDER BY a.lv, b.rv")
    s0 = global_registry().counter("join_build_sorts")
    assert pair.both_paths(q)[1] == 0
    pair.port.sql(q)
    # no cache: ONE re-sort per bind (the aux builder shares its artifact
    # with the mode provider within a bind)
    assert global_registry().counter("join_build_sorts") == s0 + 2


def test_expand_cap_falls_back_loud_and_correct(pair, capsys):
    pair.set("join_expand_max_bytes", 64)  # absurdly small: force the cap
    pair.sql("CREATE TABLE xp (k BIGINT, lv INT) USING column")
    pair.sql("CREATE TABLE xb (k BIGINT, rv INT) USING column")
    for i in range(8):
        pair.insert("xp", (i % 2, i))
        pair.insert("xb", (i % 2, 10 + i))
    r0 = global_registry().counter("join_fallback_expand_bytes")
    _dev, fallbacks = pair.both_paths(
        "SELECT a.lv, b.rv FROM xp a JOIN xb b ON a.k = b.k "
        "ORDER BY a.lv, b.rv")
    assert fallbacks > 0
    assert global_registry().counter("join_fallback_expand_bytes") > r0


def test_expand_cap_covers_right_outer_build_extension(pair):
    """Right/full outer appends one output slot per build flat row; those
    extension slots count against join_expand_max_bytes even on a UNIQUE
    build."""
    pair.set("join_expand_max_bytes", 64)
    pair.sql("CREATE TABLE yp (k BIGINT, lv INT) USING column")
    pair.sql("CREATE TABLE yb (k BIGINT, rv INT) USING column")
    for i in range(8):
        pair.insert("yp", (i, i))
        pair.insert("yb", (i, 10 + i))   # unique build keys
    r0 = global_registry().counter("join_fallback_expand_bytes")
    _dev, fallbacks = pair.both_paths(
        "SELECT a.lv, b.rv FROM yp a RIGHT JOIN yb b ON a.k = b.k "
        "ORDER BY b.rv")
    assert fallbacks > 0
    assert global_registry().counter("join_fallback_expand_bytes") > r0


def test_string_translation_lut_cached_and_vectorized(pair):
    pair.sql("CREATE TABLE sl (k VARCHAR, lv INT) USING column")
    pair.sql("CREATE TABLE sr (k VARCHAR, rv INT) USING column")
    for i in range(20):
        pair.insert("sl", (f"s{i % 6}", i))
    for i in range(15):
        pair.insert("sr", (f"s{i % 9}", 100 + i))
    q = ("SELECT a.lv, b.rv FROM sl a JOIN sr b ON a.k = b.k "
         "ORDER BY a.lv, b.rv")
    assert pair.both_paths(q)[1] == 0
    t0 = global_registry().counter("join_trans_cache_hits")
    pair.run(q)
    assert global_registry().counter("join_trans_cache_hits") > t0
    # dictionary growth (append-only: length is the version) must
    # invalidate the LUT, not serve a stale one
    pair.insert("sr", ("s5", 990))
    pair.both_paths(q)


def test_q3c_stays_on_device_with_one_build_sort(pair):
    """TPC-H Q3C (orders LEFT JOIN lineitem, a non-unique build) runs on
    the device join with exactly ONE build sort over repeated runs, and
    its rows equal the reference's and the host join's."""
    for s in (pair.ref, pair.port):
        (tpch if s is pair.port else _ref_tpch()).load_tpch(
            s, sf=0.002, seed=3)
    reg = global_registry()
    s0 = reg.counter("join_build_sorts")
    d0 = reg.counter("join_device_joins")
    first = None
    for _ in range(4):
        dev, ref, pmoved, rmoved = pair.run(tpch.Q3C)
        _assert_rows_equal(dev, ref)
        assert pmoved == rmoved
        if first is None:
            # the join binds lineitem decoded: its code-resident
            # l_discount is a counted decode, as in the reference
            assert pmoved["compressed_fallback_join_key"] == 1
        assert first is None or dev == first
        first = dev
    assert reg.counter("join_build_sorts") - s0 == 1
    assert reg.counter("join_device_joins") - d0 == 4
    assert pair.both_paths(tpch.Q3C)[1] == 0


def _ref_tpch():
    from snappydata_tpu.utils import tpch as ref_tpch

    return ref_tpch


# --- slice level: TPC-H join queries, the generic key lane -----------------

JOIN_QUERIES = [3, 5, 7, 8, 9, 10, 12, 14, 19]


@pytest.fixture(scope="module")
def tpch_pair():
    """TPC-H at sf 0.002 in both packages from the same arrays, with the
    real DDL: nation and region are row tables."""
    props = (ref_config.global_properties(), config.global_properties())
    saved = [{k: p.get(k) for k in _KNOBS} for p in props]
    pair = Pair()
    sf, seed = 0.002, 5
    n_l = int(tpch.LINEITEM_ROWS_PER_SF * sf)
    n_o = int(tpch.ORDERS_ROWS_PER_SF * sf)
    n_c = int(tpch.CUSTOMER_ROWS_PER_SF * sf)
    n_s, n_p = max(10, int(10_000 * sf)), max(50, int(200_000 * sf))
    li = tpch.gen_lineitem(n_l, seed)
    li["l_orderkey"] = np.minimum(li["l_orderkey"], n_o)
    li["l_suppkey"] = (li["l_suppkey"] % n_s) + 1
    li["l_partkey"] = (li["l_partkey"] % n_p) + 1
    tables = [
        (tpch.LINEITEM_DDL, "lineitem", li),
        (tpch.ORDERS_DDL, "orders", tpch.gen_orders(n_o, n_c, seed + 1)),
        (tpch.CUSTOMER_DDL, "customer", tpch.gen_customer(n_c, seed + 2)),
        (tpch.SUPPLIER_DDL, "supplier", tpch.gen_supplier(n_s, seed + 3)),
        (tpch.PART_DDL, "part", tpch.gen_part(n_p, seed + 4)),
        (tpch.PARTSUPP_DDL, "partsupp",
         tpch.gen_partsupp(n_p, n_s, seed + 6)),
        (tpch.NATION_DDL, "nation", tpch.gen_nation()),
        (tpch.REGION_DDL, "region", tpch.gen_region()),
    ]
    for ddl, name, cols in tables:
        pair.sql(ddl)
        pair.insert_arrays(name, list(cols.values()))
    yield pair
    for p, old in zip(props, saved):
        for k, v in old.items():
            p.set(k, v)


@pytest.mark.parametrize("qnum", JOIN_QUERIES)
def test_tpch_join_query_matches_reference(tpch_pair, qnum):
    """Every TPC-H query with a join and no subquery: the same rows as the
    reference, with the same device/host routing (join_device_joins,
    join_host_fallbacks and host_fallbacks deltas)."""
    dev, ref, pmoved, rmoved = tpch_pair.run(tpch.ALL_QUERIES[qnum])
    _assert_rows_equal(dev, ref)
    for k in ("join_device_joins", "join_host_fallbacks", "host_fallbacks"):
        assert pmoved.get(k, 0) == rmoved.get(k, 0), (k, pmoved, rmoved)


def test_tpch_q3c_matches_reference(tpch_pair):
    dev, ref, pmoved, rmoved = tpch_pair.run(tpch.Q3C)
    _assert_rows_equal(dev, ref)
    assert pmoved.get("join_device_joins", 0) == 1
    assert pmoved.get("host_fallbacks", 0) == 0
    assert pmoved == rmoved


GENERIC_QUERIES = [
    # a numeric key above a join: the o_orderdate query of the chip run
    "SELECT o_orderdate, count(*), sum(l_extendedprice) FROM orders "
    "JOIN lineitem ON o_orderkey = l_orderkey GROUP BY o_orderdate "
    "ORDER BY o_orderdate",
    # multi-key hash over a join, a string key among them
    "SELECT o_orderpriority, o_shippriority, l_linenumber, count(*), "
    "min(l_discount), max(l_quantity) FROM orders JOIN lineitem "
    "ON o_orderkey = l_orderkey GROUP BY o_orderpriority, o_shippriority, "
    "l_linenumber ORDER BY 1, 2, 3",
    # derived keys over one table
    "SELECT l_linenumber % 3 AS k, l_quantity * 2 AS q2, count(*), "
    "sum(l_tax) FROM lineitem GROUP BY l_linenumber % 3, l_quantity * 2 "
    "ORDER BY k, q2",
]


@pytest.mark.parametrize("q", GENERIC_QUERIES,
                         ids=["orderdate", "multikey", "derived"])
def test_generic_keys_match_reference_on_device(tpch_pair, q):
    dev, ref, pmoved, rmoved = tpch_pair.run(q)
    _assert_rows_equal(dev, ref)
    assert pmoved.get("host_fallbacks", 0) == 0
    assert pmoved == rmoved


def test_generic_keys_with_nulls_match_reference(pair):
    rng = np.random.default_rng(9)
    n = 3000
    pair.sql("CREATE TABLE gn (a DOUBLE, b INT, x DOUBLE) USING column")
    a = rng.integers(0, 6, n) * 0.5
    b = rng.integers(-3, 3, n).astype(np.int32)
    x = np.round(rng.normal(0, 10, n), 3)
    anull = rng.random(n) < 0.1
    for s in (pair.ref, pair.port):
        s.catalog.describe("gn").data.insert_arrays(
            [a, b, x], nulls=[anull, None, None])
    for q in ("SELECT a * 2 AS a2, count(*), sum(x) FROM gn "
              "GROUP BY a * 2 ORDER BY a2 NULLS FIRST",
              "SELECT a + 0, b % 2, count(*), min(x) FROM gn "
              "GROUP BY a + 0, b % 2 ORDER BY 1 NULLS LAST, 2"):
        dev, ref, pmoved, rmoved = pair.run(q)
        _assert_rows_equal(dev, ref)
        assert pmoved.get("host_fallbacks", 0) == 0
        assert pmoved == rmoved


def test_generic_key_overflow_reroutes_to_host_exactly(pair):
    """Past max_groups the generic lane raises the overflow flag: the
    executor reruns the plan on the exact host path, in both packages."""
    pair.set("max_groups", 4)
    pair.sql("CREATE TABLE ov (k BIGINT, v DOUBLE) USING column")
    rows = [(i % 7, float(i)) for i in range(50)]
    pair.insert("ov", *rows)
    q = ("SELECT k * 10 AS kk, count(*), sum(v) FROM ov "
         "GROUP BY k * 10 ORDER BY kk")
    dev, ref, pmoved, rmoved = pair.run(q)
    _assert_rows_equal(dev, ref)
    assert pmoved.get("host_fallbacks", 0) == 1 == rmoved["host_fallbacks"]
    assert [r[0] for r in dev] == [10 * k for k in range(7)]
    assert [r[1] for r in dev] == [8] + [7] * 6
