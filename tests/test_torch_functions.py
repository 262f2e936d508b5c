"""Scalar and string functions on the device, port vs reference.

Every case runs the same SQL over the same rows through the JAX
package's session and the port's (on the CPU), under both
`decimal_as_float64` settings, and checks three things: the port's rows
equal the reference's, the port's `host_fallbacks` moved exactly as the
reference's did (the port stays on its device wherever the reference
does), and the reference tests' own expected values.  The cases are
those of tests/test_scalar_functions.py, of the date and string
sections of tests/test_sql_surface.py, and
tests/test_decimal_exact.py::test_decimal_in_scalar_functions_unscales,
plus the civil-calendar helpers over a column of random dates against
Python's `datetime`, and the string CAST the port lowers through a
dictionary LUT, against the reference's host evaluator.

Floats compare within rel 1e-12 (float64 plates) or 1e-6 (float32
plates); everything else exactly.  Shapes that hit a fault of the
reference (ROADMAP §C: string and BOOLEAN MIN / MAX, a boolean key
beside a generic key, CAST of a string on the reference's device) are
not compared with the reference.
"""

import datetime

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


class Pair:
    """One reference session and one port session on the CPU."""

    def __init__(self, rel):
        self.ref = RefSession(catalog=RefCatalog())
        self.port = SnappySession(catalog=Catalog(), device="cpu")
        self.rel = rel

    def sql(self, q):
        self.ref.sql(q)
        self.port.sql(q)

    def insert_arrays(self, table, arrays, nulls=None):
        for s in (self.ref, self.port):
            s.catalog.describe(table).data.insert_arrays(
                [np.asarray(a) for a in arrays], nulls=nulls)

    def run(self, q):
        """(port rows, port host_fallbacks delta) after asserting the
        rows and the delta equal the reference's."""
        got = []
        for s, reg in ((self.port, global_registry()),
                       (self.ref, ref_registry())):
            before = reg.counter("host_fallbacks")
            rows = [tuple(r) for r in s.sql(q).rows()]
            got.append((rows, reg.counter("host_fallbacks") - before))
        (prows, pfb), (rrows, rfb) = got
        assert_rows_equal(prows, rrows, self.rel)
        assert pfb == rfb, (q, pfb, rfb)
        return prows, pfb

    def device(self, q, expect=None):
        """Rows of q, which must stay on the device in both packages."""
        rows, fb = self.run(q)
        assert fb == 0, f"{q} left the device"
        if expect is not None:
            assert_rows_equal(rows, expect, self.rel)
        return rows

    def one(self, q):
        return self.run(q)[0][0]


def assert_rows_equal(got, want, rel):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, (float, np.floating)):
                assert a == pytest.approx(b, rel=rel, abs=1e-12), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(params=["f64", "f32"])
def pair(request):
    props = (ref_config.global_properties(), config.global_properties())
    saved = [p.decimal_as_float64 for p in props]
    for p in props:
        p.decimal_as_float64 = request.param == "f64"
    yield Pair(1e-12 if request.param == "f64" else 1e-6)
    for p, old in zip(props, saved):
        p.decimal_as_float64 = old


def _days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso)
            - datetime.date(1970, 1, 1)).days


# --- tests/test_scalar_functions.py ----------------------------------------

@pytest.fixture
def sf(pair):
    pair.sql("CREATE TABLE sf (a INT, b DOUBLE, s VARCHAR, t VARCHAR) "
             "USING column")
    pair.sql("INSERT INTO sf VALUES "
             "(1, 2.5, 'abcdef', 'u'), (2, 3.5, 'XYZ', 'v'), "
             "(3, -1.25, NULL, 'w'), (4, NULL, 'abcdef', NULL)")
    return pair


def test_numeric_functions_on_device(sf):
    sf.device("SELECT floor(b), ceil(b) FROM sf WHERE a = 1", [(2, 3)])
    sf.device("SELECT floor(b), ceil(b) FROM sf WHERE a = 3", [(-2, -1)])
    sf.device("SELECT mod(a, 2) FROM sf ORDER BY a",
              [(1,), (0,), (1,), (0,)])
    sf.device("SELECT sign(b) FROM sf ORDER BY a",
              [(1.0,), (1.0,), (-1.0,), (None,)])
    sf.device("SELECT nullif(a, 2) FROM sf ORDER BY a",
              [(1,), (None,), (3,), (4,)])
    # greatest / least SKIP NULLs (NULL only when every argument is NULL)
    sf.device("SELECT greatest(b, 0.0) FROM sf ORDER BY a",
              [(2.5,), (3.5,), (0.0,), (0.0,)])
    sf.device("SELECT least(b, 3.0) FROM sf ORDER BY a",
              [(2.5,), (3.0,), (-1.25,), (3.0,)])
    # the rest of the numeric surface, against the reference's rows
    sf.device("SELECT abs(b), round(b), round(b, 1), exp(a), ln(a), "
              "sqrt(a), pow(a, 2), coalesce(b, 7.5), pmod(a - 3, 2) "
              "FROM sf ORDER BY a")


def test_mod_sign_conventions(sf):
    # mod keeps the dividend's sign (Spark %); pmod is non-negative
    assert sf.one("SELECT mod(-3, 2)")[0] == -1
    assert sf.one("SELECT pmod(-3, 2)")[0] == 1
    # division / mod by zero is NULL, not an error
    sf.device("SELECT mod(a, 0) FROM sf WHERE a = 1", [(None,)])


def test_string_functions_via_derived_dictionaries(sf):
    sf.device("SELECT concat(s, '_x') FROM sf ORDER BY a",
              [("abcdef_x",), ("XYZ_x",), (None,), ("abcdef_x",)])
    sf.device("SELECT 'p_' || s || '_q' FROM sf WHERE a = 2",
              [("p_XYZ_q",)])
    sf.device("SELECT replace(s, 'a', 'z') FROM sf WHERE a = 1",
              [("zbcdef",)])
    sf.device("SELECT instr(s, 'c') FROM sf ORDER BY a",
              [(3,), (0,), (None,), (3,)])
    # substr literals are STRUCTURAL: rebinding the same query shape with
    # other offsets must not reuse the old derived dictionary
    sf.device("SELECT substr(s, 2) FROM sf WHERE a = 1", [("bcdef",)])
    sf.device("SELECT substr(s, 3) FROM sf WHERE a = 1", [("cdef",)])
    sf.device("SELECT substr(s, 2, 3) FROM sf WHERE a = 1", [("bcd",)])


def test_composed_string_transforms_on_device(sf):
    sf.device("SELECT upper(concat(s, '_t')) FROM sf WHERE a = 1",
              [("ABCDEF_T",)])
    sf.device("SELECT a FROM sf WHERE upper(s) = 'XYZ'", [(2,)])
    sf.device("SELECT a FROM sf WHERE lower(s) LIKE 'abc%' ORDER BY a",
              [(1,), (4,)])
    sf.device("SELECT count(*) FROM sf WHERE instr(lower(s), 'x') > 0",
              [(1,)])
    sf.device("SELECT a FROM sf WHERE substr(s, 1, 3) = 'abc' "
              "ORDER BY a", [(1,), (4,)])
    sf.device("SELECT length(trim(concat('  ', s))) FROM sf WHERE a = 2",
              [(3,)])


def test_functions_in_aggregation_context(sf):
    sf.device("SELECT sum(a) FROM sf WHERE mod(a, 2) = 1", [(4,)])
    # Spark default ordering: ASC -> NULLS FIRST
    sf.device("SELECT concat(s, '!'), count(*) FROM sf "
              "GROUP BY concat(s, '!') ORDER BY 1",
              [(None, 1), ("XYZ!", 1), ("abcdef!", 2)])
    sf.device("SELECT concat(s, '!'), count(*) FROM sf "
              "GROUP BY concat(s, '!') ORDER BY 1 NULLS LAST",
              [("XYZ!", 1), ("abcdef!", 2), (None, 1)])


def test_host_oracle_agrees_for_two_column_concat(sf):
    # two DIFFERENT string columns: the host path in both, still correct
    rows, fb = sf.run("SELECT concat(s, t) FROM sf WHERE a = 1")
    assert rows == [("abcdefu",)] and fb == 1


# --- tests/test_sql_surface.py: date and string functions ------------------

@pytest.fixture
def dt(pair):
    pair.sql("CREATE TABLE t (k STRING, v BIGINT, d DATE) USING column")
    pair.sql("INSERT INTO t VALUES ('a', 1, DATE '2020-01-15'), "
             "('b', 2, DATE '2020-06-30'), ('a', 3, DATE '2021-02-28')")
    return pair


def test_date_functions_scalar(dt):
    one = dt.one
    assert one("SELECT date_add(DATE '2020-01-01', 31)") == \
        (_days("2020-02-01"),)
    assert one("SELECT date_sub(DATE '2020-01-01', 1)") == \
        (_days("2019-12-31"),)
    assert one("SELECT datediff(DATE '2020-03-01', DATE '2020-02-01')") \
        == (29,)
    assert one("SELECT add_months(DATE '2020-01-31', 1)") == \
        (_days("2020-02-29"),)  # leap-year clamp
    assert one("SELECT last_day(DATE '2021-02-03')") == \
        (_days("2021-02-28"),)
    assert one("SELECT trunc(DATE '2020-02-15', 'MM')") == \
        (_days("2020-02-01"),)
    assert one("SELECT trunc(DATE '2020-02-15', 'YEAR')") == \
        (_days("2020-01-01"),)
    assert one("SELECT months_between(DATE '2020-03-15', "
               "DATE '2020-01-15')") == (2.0,)
    assert one("SELECT to_date('2020-07-04')") == (_days("2020-07-04"),)
    assert one("SELECT unix_timestamp(TIMESTAMP '1970-01-02 00:00:00')") \
        == (86400,)
    assert one("SELECT extract(year FROM DATE '2020-01-02')") == (2020,)
    assert one("SELECT quarter(DATE '2020-05-15')") == (2,)
    assert one("SELECT dayofweek(DATE '2020-02-15')") == (7,)  # Saturday
    assert one("SELECT dayofyear(DATE '2020-03-01')") == (61,)  # leap
    assert one("SELECT weekofyear(DATE '2021-01-01')") == (53,)  # ISO
    assert one("SELECT hour(TIMESTAMP '2020-01-01 10:30:05')") == (10,)
    assert one("SELECT minute(TIMESTAMP '2020-01-01 10:30:05')") == (30,)
    assert one("SELECT second(TIMESTAMP '2020-01-01 10:30:05')") == (5,)
    assert one("SELECT current_date() IS NOT NULL")[0]
    assert one("SELECT current_timestamp() IS NOT NULL")[0]


def test_date_functions_on_columns_device(dt):
    """Columnar date math runs on the device (civil-calendar integer
    arithmetic): checked against Python's datetime per row."""
    r = dt.device("SELECT k, year(d), month(d), day(d), quarter(d), "
                  "dayofweek(d), date_add(d, 10) FROM t ORDER BY k, d")
    got = set()
    for k, y, m, dd, q, dow, plus10 in r:
        date = datetime.date(y, m, dd)
        got.add((k, date.isoformat()))
        assert q == (m + 2) // 3
        assert dow == date.isoweekday() % 7 + 1
        assert plus10 == _days(date.isoformat()) + 10
    assert got == {("a", "2020-01-15"), ("a", "2021-02-28"),
                   ("b", "2020-06-30")}


def test_group_by_date_part(dt):
    dt.device("SELECT year(d), count(*) FROM t GROUP BY year(d) "
              "ORDER BY year(d)", [(2020, 2), (2021, 1)])


def test_string_functions_scalar(dt):
    one = dt.one
    assert one("SELECT lpad('x', 3, '0'), rpad('x', 3, '0')") == \
        ("00x", "x00")
    assert one("SELECT lpad('abcdef', 3, '0')") == ("abc",)  # truncates
    assert one("SELECT initcap('hello wORLD')") == ("Hello World",)
    assert one("SELECT repeat('ab', 3), reverse('abc')") == \
        ("ababab", "cba")
    assert one("SELECT split_part('a,b,c', ',', 2)") == ("b",)
    assert one("SELECT split_part('a,b,c', ',', -1)") == ("c",)
    assert one("SELECT split_part('a,b,c', ',', 9)") == ("",)
    assert one("SELECT translate('abcba', 'ab', 'x')") == ("xcx",)
    assert one("SELECT position('b' IN 'abc')") == (2,)
    assert one("SELECT ascii('A')") == (65,)


def test_string_functions_on_columns(dt):
    """String column transforms ride derived dictionaries: the codes
    never leave the device."""
    dt.device("SELECT DISTINCT initcap(repeat(k, 2)) FROM t ORDER BY 1",
              [("Aa",), ("Bb",)])
    dt.device("SELECT count(*) FROM t WHERE ascii(k) = 97", [(2,)])
    dt.device("SELECT lpad(k, 3, '*'), rpad(k, 2, '-'), reverse(k), "
              "translate(k, 'a', 'z'), split_part(k, 'b', 1), "
              "ltrim(k), rtrim(k), lower(upper(k)), length(k) "
              "FROM t ORDER BY v")


def test_to_date_string_column_device(pair):
    pair.sql("CREATE TABLE logs (ts STRING) USING column")
    pair.sql("INSERT INTO logs VALUES ('2020-01-01'), ('2020-01-01'), "
             "('2021-12-31'), ('not a date')")
    pair.device("SELECT to_date(ts), count(*) FROM logs "
                "GROUP BY to_date(ts) ORDER BY 1",
                [(None, 1), (_days("2020-01-01"), 2),
                 (_days("2021-12-31"), 1)])


def test_current_date_not_baked_into_plan_cache(dt):
    """current_date folds per EXECUTION: the cached plan rebinds, never
    baking a stale clock."""
    r1 = dt.device("SELECT count(*) FROM t WHERE d < current_date()")
    r2 = dt.device("SELECT count(*) FROM t WHERE d < current_date()")
    assert r1 == r2 == [(3,)]
    hits = global_registry().counter("plan_cache_hits")
    dt.port.sql("SELECT count(*) FROM t WHERE d < current_date()")
    assert global_registry().counter("plan_cache_hits") == hits + 1


# --- tests/test_decimal_exact.py -------------------------------------------

def test_decimal_in_scalar_functions_unscales(pair):
    pair.sql("CREATE TABLE sfd (v DECIMAL(8,2)) USING column")
    pair.sql("INSERT INTO sfd VALUES (2.25), (-3.50)")
    rows = pair.device("SELECT round(v), abs(v), sqrt(abs(v)) FROM sfd "
                       "ORDER BY v")
    assert rows[0][0] == pytest.approx(-4.0)   # half to even: -3.5 -> -4
    assert rows[0][1] == pytest.approx(3.5)
    assert rows[1][2] == pytest.approx(1.5)


# --- the civil-calendar helpers over many dates ----------------------------

def test_civil_calendar_over_random_dates(pair):
    """Every date part, trunc, add_months, last_day, datediff and
    months_between over 4,000 dates from 1600 to 2400 (leap centuries,
    negative days) equal the reference's rows and Python's datetime."""
    rng = np.random.default_rng(3)
    lo, hi = _days("1600-01-01"), _days("2400-12-31")
    days = rng.integers(lo, hi, 4000).astype(np.int32)
    days[:4] = [_days("2000-02-29"), _days("1900-03-01"),
                _days("1969-12-31"), 0]
    pair.sql("CREATE TABLE cal (id BIGINT, d DATE) USING column")
    pair.insert_arrays("cal", [np.arange(4000, dtype=np.int64), days])
    rows = pair.device(
        "SELECT id, year(d), month(d), day(d), quarter(d), dayofyear(d), "
        "dayofweek(d), weekofyear(d), trunc(d, 'YEAR'), trunc(d, 'Q'), "
        "trunc(d, 'MM'), trunc(d, 'WEEK'), add_months(d, 13), "
        "add_months(d, -1), last_day(d), datediff(d, DATE '2000-01-01'), "
        "months_between(d, DATE '2000-01-31'), unix_timestamp(d) "
        "FROM cal ORDER BY id")
    epoch = datetime.date(1970, 1, 1)
    for r in rows[:400]:
        date = epoch + datetime.timedelta(days=int(days[r[0]]))
        iso = date.isocalendar()
        assert r[1:4] == (date.year, date.month, date.day)
        assert r[4] == (date.month + 2) // 3
        assert r[5] == date.timetuple().tm_yday
        assert r[6] == date.isoweekday() % 7 + 1
        assert r[7] == iso[1]
        assert r[8] == (date.replace(month=1, day=1) - epoch).days
        assert r[10] == (date.replace(day=1) - epoch).days
        assert r[11] == (date - epoch).days - (iso[2] - 1)
        nxt = date.replace(day=28) + datetime.timedelta(days=4)
        assert r[14] == (nxt - datetime.timedelta(days=nxt.day)
                         - epoch).days
        assert r[15] == (date - datetime.date(2000, 1, 1)).days
        assert r[17] == (date - epoch).days * 86400


# --- CAST ------------------------------------------------------------------

def test_numeric_and_date_casts_on_device(pair):
    pair.sql("CREATE TABLE c (i INT, x DOUBLE, d DATE) USING column")
    pair.sql("INSERT INTO c VALUES (1, 2.75, DATE '2020-01-15'), "
             "(-2, -3.5, DATE '1969-12-31'), (NULL, NULL, NULL)")
    pair.device("SELECT CAST(x AS INT), CAST(i AS DOUBLE), "
                "CAST(d AS BIGINT), CAST(i AS DATE), CAST(x AS BOOLEAN) "
                "FROM c ORDER BY i NULLS LAST")


def test_cast_to_string_takes_the_host_path_as_in_the_reference(pair):
    pair.sql("CREATE TABLE c (k STRING, v BIGINT) USING column")
    pair.sql("INSERT INTO c VALUES ('a', 1), ('b', 2)")
    rows, fb = pair.run("SELECT k FROM c WHERE CAST(v AS STRING) = '2'")
    assert rows == [("b",)] and fb == 1


def _ref_host_cast(values, to):
    """CAST of a string column by the reference's host evaluator
    (`snappydata_tpu.engine.hosteval.eval_expr`), the rule the port's
    dictionary LUT copies: (values, NULL mask)."""
    from snappydata_tpu import types as RT
    from snappydata_tpu.engine import hosteval as ref_hosteval
    from snappydata_tpu.sql import ast as ref_ast

    null = np.array([v is None for v in values])
    col = np.array(["0" if v is None else v for v in values], dtype=object)
    cast = ref_ast.Cast(ref_ast.Col("s", index=0, dtype=RT.STRING),
                        getattr(RT, to))
    v, _ = ref_hosteval.eval_expr(cast, [col], [None], (), len(values))
    return v, null


def test_string_cast_lowers_through_the_dictionary():
    """CAST(string column AS number) converts each dictionary value once
    on the host, by the host evaluator's rule, into a LUT the codes
    gather.  The reference's device lane casts the CODES (ROADMAP §C), so
    the port is held against the reference's host evaluator on the same
    rows, and stays on its device."""
    port = SnappySession(catalog=Catalog(), device="cpu")
    port.sql("CREATE TABLE n (s STRING, k INT) USING column")
    strings = ["12", "7", "40", "7", None, "-3", "12"]
    port.sql("INSERT INTO n VALUES " + ", ".join(
        f"({'NULL' if v is None else repr(v)}, {k})"
        for k, v in enumerate(strings)))
    as_int, null = _ref_host_cast(strings, "INT")
    as_long, _ = _ref_host_cast(strings, "LONG")
    as_double, _ = _ref_host_cast(strings, "DOUBLE")
    reg = global_registry()
    before = reg.counter("host_fallbacks")
    rows = port.sql("SELECT CAST(s AS INT), CAST(s AS DOUBLE) + 1 FROM n "
                    "ORDER BY k").rows()
    assert rows == [(None, None) if null[k]
                    else (int(as_int[k]), float(as_double[k]) + 1)
                    for k in range(len(strings))]
    hit = ~null & (as_int > 8)
    assert port.sql("SELECT sum(CAST(s AS BIGINT)) FROM n WHERE "
                    "CAST(s AS INT) > 8").rows() == [(int(as_long[hit].sum()),)]
    assert reg.counter("host_fallbacks") == before
    # a value that does not convert reroutes to the host, which raises as
    # the reference's host evaluator does
    port.sql("CREATE TABLE bad (s STRING) USING column")
    port.sql("INSERT INTO bad VALUES ('3'), ('x')")
    with pytest.raises(ValueError):
        _ref_host_cast(["3", "x"], "INT")
    with pytest.raises(ValueError):
        port.sql("SELECT CAST(s AS INT) FROM bad").rows()
    assert reg.counter("host_fallbacks") == before + 1


# --- routing of derived group keys -----------------------------------------

def test_non_injective_derived_group_key_takes_the_host_path(pair):
    """Grouping runs on dictionary codes, so a derived key whose values
    repeat (substr(m, 1, 1) folds 'RAIL' and 'REG AIR') reroutes to the
    host in both packages; an injective one stays on the device."""
    pair.sql("CREATE TABLE sm (m STRING, q DOUBLE, d DATE) USING column")
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK"], dtype=object)
    rng = np.random.default_rng(4)
    n = 500
    pair.insert_arrays("sm", [modes[rng.integers(0, 7, n)],
                              rng.integers(1, 51, n).astype(np.float64),
                              rng.integers(8000, 10500, n)
                              .astype(np.int32)])
    q = ("SELECT year(d), substr(m, 1, {}), sum(abs(q - 25)), count(*) "
         "FROM sm GROUP BY 1, 2 ORDER BY 1, 2")
    rows1, fb1 = pair.run(q.format(1))
    assert fb1 == 1
    rows2 = pair.device(q.format(2))
    assert sum(r[3] for r in rows1) == sum(r[3] for r in rows2) == n
    assert {r[1] for r in rows2} == {"AI", "FO", "MA", "RA", "RE", "SH",
                                     "TR"}


# --- fault C3: `%` with a zero divisor ---------------------------------------

MOD_QUERIES = [
    ("SELECT b % g FROM z ORDER BY g", [(0,), (1,), (None,)]),
    ("SELECT b % 0 FROM z ORDER BY g", [(0,), (0,), (None,)]),
    ("SELECT m % m FROM z ORDER BY g", None),
    ("SELECT sum(b % g) FROM z", [(1,)]),
    ("SELECT b % g AS r, count(*) FROM z GROUP BY b % g ORDER BY r", None),
    ("SELECT b FROM z WHERE b % g = 1", [(-7,)]),
]


@pytest.mark.parametrize("policy_name", ["f64", "f32"])
@pytest.mark.parametrize("q,want", MOD_QUERIES)
def test_modulo_by_zero_gives_the_references_zero(policy_name, q, want):
    """ROADMAP C3: an integer (BIGINT, INT, exact DECIMAL) zero divisor
    gives 0 as the reference's jnp `%` does, on the device, never a
    raise; NULL stays NULL; the routing equals the reference's (no host
    fallback)."""
    from torch_parity import Pair as PolicyPair

    p = PolicyPair(policy_name)
    p.sql("CREATE TABLE z (b BIGINT, g INT, m DECIMAL(10,2)) USING column")
    p.sql("INSERT INTO z VALUES (7, 0, 2.50), (-7, 2, 0.00), "
          "(NULL, 3, NULL)")
    rows = p.device(q)
    if want is not None:
        assert rows == want


# --- fault C7: `round` under the float32 plate policy ------------------------

def _round_pair(policy_name):
    from torch_parity import Pair as PolicyPair

    p = PolicyPair(policy_name)
    p.sql("CREATE TABLE rt (id BIGINT, x DOUBLE) USING column")
    p.sql("INSERT INTO rt VALUES (0, 3.35), (4, -2.35)")
    return p


def _bit_equal(p, q):
    """The port's rows of q equal the reference's bit for bit, and stay on
    the device in both packages."""
    rows = p.device(q)
    port, ref = p.sql(q)
    assert port == ref, (q, port, ref)
    return rows


@pytest.mark.parametrize("policy_name", ["f64", "f32"])
def test_round_projects_the_references_values(policy_name):
    """round(x, 1) with its digits tokenized rounds in float64 as the
    reference does: a float32 plate's 3.35 is 3.3499999..., so the f32
    policy gives 3.3 / -2.3 where float64 plates give 3.4 / -2.4."""
    p = _round_pair(policy_name)
    want = {"f64": [(0, 3.4), (4, -2.4)], "f32": [(0, 3.3), (4, -2.3)]}
    assert _bit_equal(p, "SELECT id, round(x, 1) FROM rt ORDER BY id") \
        == want[policy_name]


@pytest.mark.parametrize("policy_name", ["f64", "f32"])
def test_round_in_a_filter_counts_as_the_reference(policy_name):
    p = _round_pair(policy_name)
    assert _bit_equal(
        p, "SELECT count(*) FROM rt WHERE round(x, 1) = 3.4") == \
        [(1 if policy_name == "f64" else 0,)]


@pytest.mark.parametrize("policy_name", ["f64", "f32"])
def test_round_group_keys_equal_the_references(policy_name):
    p = _round_pair(policy_name)
    p.sql("INSERT INTO rt VALUES (5, 3.3), (6, -2.3), (7, 3.44)")
    rows = _bit_equal(p, "SELECT round(x, 1) AS r, count(*) FROM rt "
                         "GROUP BY round(x, 1) ORDER BY r")
    assert sum(r[1] for r in rows) == 5


@pytest.mark.parametrize("policy_name", ["f64", "f32"])
def test_round_over_seeded_normal_rows(policy_name):
    """400 seeded normal rows (sd 5, 3 decimals): round(x, 2), round(x, 1)
    and round(x, -1) bit for bit, and round of an integer column, whose
    static (no digits) and tokenized forms both round in float64."""
    from torch_parity import Pair as PolicyPair

    rng = np.random.default_rng(16)
    n = 400
    p = PolicyPair(policy_name)
    p.sql("CREATE TABLE rn (id BIGINT, x DOUBLE, k BIGINT) USING column")
    p.insert_arrays("rn", [np.arange(n, dtype=np.int64),
                           np.round(rng.normal(0.0, 5.0, n), 3),
                           rng.integers(10 ** 8, 10 ** 9, n)],
                    nulls=[None, None, None])
    rows = _bit_equal(p, "SELECT id, round(x, 2), round(x, 1), "
                         "round(x, -1), round(k), round(k, 1) FROM rn "
                         "ORDER BY id")
    assert len(rows) == n
    assert all(r[4] == r[5] for r in rows)
