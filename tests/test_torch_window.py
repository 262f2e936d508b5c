"""OVER clauses through both SnappySessions, with NULL partition keys.

The port evaluates every window function on the host
(`engine/hosteval._window_values`); the reference answers them on its
device lane (`Compiler._emit_window`), which keeps all NULLs of a
PARTITION BY key in one partition.  The same rows, made from a seed with
numpy, load into both sessions on the CPU, by SQL INSERT and by
`insert_arrays` with a null mask whose filler values collide with real
keys; each query's rows must agree with the reference's and with an
independent Python oracle.  Tolerances: row numbers, ranks and keys
exact; the f64 sums rel 1e-12 (the values are multiples of 1/4, so every
sum is exact in float32 and float64 and only reassociation could move
it).  Each runs under both `decimal_as_float64` settings.
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

REL = 1e-12
DDL = ("CREATE TABLE w (id INT, gi INT, gd DOUBLE, gs STRING, v DOUBLE) "
       "USING column")
KEYS = ("gi", "gd", "gs")
N_ROWS = 48


@pytest.fixture(params=[True, False], ids=["f64", "f32"])
def knobs(request):
    props = (ref_config.global_properties(), config.global_properties())
    saved = [p.decimal_as_float64 for p in props]
    for p in props:
        p.decimal_as_float64 = request.param
    yield request.param
    for p, old in zip(props, saved):
        p.decimal_as_float64 = old


def _data(seed=5):
    """Columns and null masks; NULL slots hold fillers equal to real keys
    (0, 0.5, 'a'), so a partition that ignores the mask mixes them."""
    rng = np.random.default_rng(seed)
    ids = np.arange(N_ROWS, dtype=np.int32)
    gi = rng.integers(0, 3, N_ROWS).astype(np.int32)
    gd = rng.integers(0, 3, N_ROWS).astype(np.float64) / 2
    gs = np.array(["abc"[k] for k in rng.integers(0, 3, N_ROWS)],
                  dtype=object)
    # distinct values, so ORDER BY v has no ties and row_number is defined
    v = rng.permutation(N_ROWS).astype(np.float64) / 4 + 1
    masks = [rng.random(N_ROWS) < 0.3 for _ in KEYS]
    gi[masks[0]] = 0
    gd[masks[1]] = 0.5
    gs[masks[2]] = "a"
    return [ids, gi, gd, gs, v], masks


def _sql_literal(x, null):
    if null:
        return "NULL"
    if isinstance(x, str):
        return f"'{x}'"
    return repr(x.item() if hasattr(x, "item") else x)


def _load(session, how, arrays, masks):
    session.sql(DDL)
    if how == "sql":
        nulls = [np.zeros(N_ROWS, bool)] + masks + [np.zeros(N_ROWS, bool)]
        rows = ", ".join(
            "(" + ", ".join(_sql_literal(a[i], m[i])
                            for a, m in zip(arrays, nulls)) + ")"
            for i in range(N_ROWS))
        session.sql(f"INSERT INTO w VALUES {rows}")
    else:
        session.catalog.describe("w").data.insert_arrays(
            [a.copy() for a in arrays], nulls=[None] + masks + [None])


def _sessions(how, arrays, masks):
    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    for s in (ref, port):
        _load(s, how, arrays, masks)
    return ref, port


def _oracle(arrays, masks, keys):
    """Per id: (row_number, rank, partition sum, running sum) over the
    partitions of `keys` with every NULL of a key one partition, ORDER
    BY v (no ties)."""
    ids, v = arrays[0], arrays[4]
    col = dict(zip(KEYS, zip(arrays[1:4], masks)))

    def part(i):
        return tuple((bool(col[k][1][i]),
                      None if col[k][1][i] else col[k][0][i]) for k in keys)

    out = {}
    parts = {}
    for i in range(N_ROWS):
        parts.setdefault(part(i), []).append(i)
    for rows in parts.values():
        rows.sort(key=lambda i: v[i])
        total = float(sum(v[i] for i in rows))
        run = 0.0
        for pos, i in enumerate(rows):
            run += float(v[i])
            out[int(ids[i])] = (pos + 1, pos + 1, total, run)
    return out


def _query(keys):
    pk = ", ".join(keys)
    return (f"SELECT id, row_number() OVER (PARTITION BY {pk} ORDER BY v), "
            f"rank() OVER (PARTITION BY {pk} ORDER BY v), "
            f"sum(v) OVER (PARTITION BY {pk}), "
            f"sum(v) OVER (PARTITION BY {pk} ORDER BY v) "
            f"FROM w ORDER BY id")


def _assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=REL, abs=0)
            else:
                assert a == b


@pytest.mark.parametrize("how", ["sql", "arrays"])
@pytest.mark.parametrize("keys", [("gi",), ("gd",), ("gs",), ("gi", "gs")],
                         ids=["int", "double", "string", "int-string"])
def test_null_partition_keys_match_reference(knobs, how, keys):
    arrays, masks = _data()
    ref, port = _sessions(how, arrays, masks)
    q = _query(keys)
    fallbacks = ref_registry().counter("host_fallbacks")
    want = ref.sql(q).rows()
    # the reference answered on its device lane, not through its host
    # evaluator (which shares the fault the port had)
    assert ref_registry().counter("host_fallbacks") == fallbacks
    got = port.sql(q).rows()
    _assert_rows(got, want)
    oracle = _oracle(arrays, masks, keys)
    _assert_rows(got, [(i,) + oracle[i] for i in range(N_ROWS)])


def test_motivating_queries(knobs):
    """The smallest input of the fault: NULL keys stored as 0 by SQL."""
    want_sum = [18.0, 18.0, 5.0, 5.0, 8.0]
    want_rank = [1, 2, 1, 2, 1]
    for s in (RefSession(catalog=RefCatalog()),
              SnappySession(catalog=Catalog(), device="cpu")):
        s.sql("CREATE TABLE t (g INT, v DOUBLE) USING column")
        s.sql("INSERT INTO t VALUES (0, 1.0), (NULL, 2.0), (0, 4.0), "
              "(1, 8.0), (NULL, 16.0)")
        rows = s.sql("SELECT g, v, sum(v) OVER (PARTITION BY g) FROM t "
                     "ORDER BY 1, 2").rows()
        assert [r[2] for r in rows] == want_sum
        rows = s.sql("SELECT g, v, rank() OVER (PARTITION BY g ORDER BY v) "
                     "FROM t ORDER BY 1, 2").rows()
        assert [r[2] for r in rows] == want_rank
