"""SQL functions (CREATE FUNCTION) of the port against the reference's.

The cases of tests/test_udf.py run through the JAX package's session and
the port's (on the CPU) under both plate policies: the rows must agree,
and so must the routing (`host_fallbacks`): a body the reference lowers
into its device program the port runs on the plates' tensors, a STRING
argument takes the host lane in both.  Then the port's own: the body
namespace (`jnp` is the port's small elementwise namespace; a name
outside it sends the device lane to the host), the result's plate dtype
under the dtype policy, and the TPC-H Q6 revenue written through a
function.
"""

import numpy as np
import pytest
import torch

from torch_parity import POLICIES, Pair

from snappydata_tpu_torch import SnappySession
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.sql import udf
from snappydata_tpu_torch.utils import tpch

ROUTED = ("host_fallbacks",)


def _pair(name):
    p = Pair(name, routed=ROUTED)
    p.sql("CREATE TABLE tf (k BIGINT, price DOUBLE, rate DOUBLE, "
          "name STRING) USING column")
    rng = np.random.default_rng(4)
    n = 5000
    p.insert_arrays("tf", [
        np.arange(n, dtype=np.int64), np.round(rng.random(n) * 100, 2),
        np.round(rng.random(n) * 0.2, 3),
        np.array([f"s{i % 5}" for i in range(n)], dtype=object)])
    p.sql("CREATE TABLE tn (v DOUBLE) USING column")
    p.sql("INSERT INTO tn VALUES (1.0), (NULL), (3.0)")
    return p


@pytest.fixture(scope="module", params=POLICIES)
def pair(request):
    p = _pair(request.param)
    p.sql("CREATE FUNCTION taxed AS "
          "'lambda price, rate: price * (1 + rate)' RETURNS DOUBLE")
    p.sql("CREATE FUNCTION clipped AS 'lambda x: jnp.clip(x, 10, 90)' "
          "RETURNS DOUBLE")
    p.sql("CREATE FUNCTION dbl AS 'lambda x: x * 2' RETURNS DOUBLE")
    p.sql("CREATE FUNCTION bucket2 AS 'lambda k: k % 3' RETURNS LONG")
    p.sql("CREATE FUNCTION shout AS 'lambda s: s' RETURNS STRING")
    p.sql("CREATE FUNCTION wild AS "
          "'lambda x: jnp.where(jnp.isnan(x), 0.0, jnp.sqrt(jnp.abs(x)))'")
    p.sql("CREATE FUNCTION mix AS 'lambda a, b: jnp.maximum(a, b) + "
          "jnp.power(jnp.minimum(a, b), 2) - jnp.floor(a) + jnp.ceil(b) "
          "+ jnp.round(a) + jnp.sign(b - 50) + jnp.log1p(jnp.exp(-a))' "
          "RETURNS DOUBLE")
    return p


DEVICE_QUERIES = [
    "SELECT sum(taxed(price, rate)) FROM tf",
    "SELECT count(*) FROM tf WHERE taxed(price, rate) > 60",
    "SELECT avg(clipped(price)) FROM tf",
    "SELECT dbl(v) FROM tn ORDER BY v NULLS FIRST",
    "SELECT bucket2(k) AS b, count(*) FROM tf GROUP BY bucket2(k) "
    "ORDER BY b",
    "SELECT name, sum(taxed(price, rate)), max(clipped(price)) FROM tf "
    "GROUP BY name ORDER BY name",
    "SELECT sum(wild(price - 50)) FROM tf",
    "SELECT sum(mix(price, rate * 100)) FROM tf WHERE k < 100",
]


@pytest.mark.parametrize("q", DEVICE_QUERIES)
def test_udf_on_the_device_matches_reference(pair, q):
    rows = pair.device(q)
    assert rows


def test_udf_oracles(pair):
    """tests/test_udf.py's own expected values, through the port."""
    s = pair.port
    r = s.sql("SELECT sum(taxed(price, rate)) FROM tf").rows()[0][0]
    assert r == pytest.approx(
        s.sql("SELECT sum(price * (1 + rate)) FROM tf").rows()[0][0])
    prices = np.asarray(s.sql("SELECT price FROM tf").columns[0])
    got = s.sql("SELECT avg(clipped(price)) FROM tf").rows()[0][0]
    assert got == pytest.approx(float(np.clip(prices, 10, 90).mean()),
                                rel=1e-6)
    vals = [row[0] for row in s.sql("SELECT dbl(v) FROM tn").rows()]
    assert None in vals and sorted(v for v in vals if v is not None) == \
        [2.0, 6.0]
    r = s.sql("SELECT bucket2(k) AS b, count(*) FROM tf "
              "GROUP BY bucket2(k) ORDER BY b").rows()
    assert [row[0] for row in r] == [0, 1, 2]
    assert sum(row[1] for row in r) == 5000


def test_string_argument_takes_the_host_in_both(pair):
    rows, moved = pair.run("SELECT shout(name) FROM tf WHERE k < 3 "
                           "ORDER BY k")
    assert moved["host_fallbacks"] == 1
    assert rows == [("s0",), ("s1",), ("s2",)]


@pytest.mark.parametrize("policy_name", POLICIES)
def test_or_replace_and_drop(policy_name):
    p = _pair(policy_name)
    p.sql("CREATE FUNCTION f1 AS 'lambda x: x + 1' RETURNS DOUBLE")
    p.run("SELECT f1(price) FROM tf ORDER BY k LIMIT 3")
    for s in (p.port, p.ref):
        with pytest.raises(Exception, match="already exists"):
            s.sql("CREATE FUNCTION f1 AS 'lambda x: x + 2'")
    p.sql("CREATE OR REPLACE FUNCTION f1 AS 'lambda x: x + 100' "
          "RETURNS DOUBLE")
    rows, _ = p.run("SELECT f1(price) - price FROM tf ORDER BY k LIMIT 1")
    assert rows[0][0] == pytest.approx(100.0)
    p.sql("DROP FUNCTION f1")
    for s in (p.port, p.ref):
        with pytest.raises(Exception, match="unknown function|unsupported"):
            s.sql("SELECT f1(price) FROM tf")
    p.sql("DROP FUNCTION IF EXISTS f1")
    for s in (p.port, p.ref):
        with pytest.raises(ValueError, match="not found"):
            s.sql("DROP FUNCTION f1")


def test_invalid_body_and_aggregate_names_rejected():
    s = SnappySession(catalog=Catalog(), device="cpu")
    with pytest.raises(Exception, match="does not evaluate|callable"):
        s.sql("CREATE FUNCTION bad AS 'this is not python'")
    with pytest.raises(Exception, match="callable"):
        s.sql("CREATE FUNCTION bad2 AS '42'")
    with pytest.raises(ValueError, match="aggregate"):
        s.sql("CREATE FUNCTION sum AS 'lambda x: x'")


def test_create_function_gated_on_unauthenticated_network_session():
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.remote, s.authenticated = True, False
    with pytest.raises(PermissionError, match="CREATE FUNCTION"):
        s.sql("CREATE FUNCTION evil AS 'lambda x: x'")
    s.authenticated = True   # the admin principal, authenticated
    s.sql("CREATE FUNCTION fine AS 'lambda x: x'")


def test_registering_bumps_the_plan_cache_generation():
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql("CREATE TABLE g (x DOUBLE) USING column")
    s.sql("INSERT INTO g VALUES (1.0), (2.0)")
    s.sql("CREATE FUNCTION h AS 'lambda x: x + 1' RETURNS DOUBLE")
    assert s.sql("SELECT sum(h(x)) FROM g").rows() == [(5.0,)]
    gen = s.catalog.generation
    s.sql("CREATE OR REPLACE FUNCTION h AS 'lambda x: x * 10' "
          "RETURNS DOUBLE")
    assert s.catalog.generation == gen + 1
    assert s.sql("SELECT sum(h(x)) FROM g").rows() == [(30.0,)]


# -- the port's body namespace ---------------------------------------------

def test_namespace_dispatches_on_tensor_or_array():
    x = np.array([-4.0, 1.0, 9.0])
    t = torch.tensor(x)
    for name in ("abs", "sqrt", "exp", "log", "log1p", "floor", "ceil",
                 "round", "sign", "isnan"):
        fn = getattr(udf.JNP, name)
        arg_np = np.abs(x) if name in ("sqrt", "log", "log1p") else x
        want = getattr(np, name)(arg_np)
        arg_t = torch.tensor(arg_np)
        got_t = fn(arg_t)
        assert isinstance(got_t, torch.Tensor)
        np.testing.assert_allclose(got_t.numpy(), want)
        np.testing.assert_allclose(fn(arg_np), want)
    assert isinstance(udf.JNP.clip(t, 0, 5), torch.Tensor)
    np.testing.assert_allclose(udf.JNP.clip(t, 0, 5).numpy(),
                               np.clip(x, 0, 5))
    np.testing.assert_allclose(udf.JNP.where(t > 0, t, 0.0).numpy(),
                               np.where(x > 0, x, 0.0))
    np.testing.assert_allclose(udf.JNP.maximum(t, 2.0).numpy(),
                               np.maximum(x, 2.0))
    np.testing.assert_allclose(udf.JNP.minimum(3.0, t).numpy(),
                               np.minimum(3.0, x))
    np.testing.assert_allclose(udf.JNP.power(t, 2).numpy(), x ** 2)
    assert sorted(udf.NAMES) == sorted(
        n for n in dir(udf.JNP) if not n.startswith("_"))


def test_name_outside_the_namespace():
    """Device lane: an AttributeError naming it (the lowering's
    CompileError, so the host takes over); host lane: numpy's."""
    with udf.device_lane(torch.device("cpu")):
        with pytest.raises(AttributeError, match="jnp.tanh"):
            udf.JNP.tanh
    assert udf.JNP.tanh is np.tanh
    with pytest.raises(AttributeError, match="jnp.no_such"):
        udf.JNP.no_such


@pytest.mark.parametrize("policy_name", POLICIES)
def test_body_outside_the_namespace_runs_on_the_host(policy_name):
    """jnp.tanh is not in the device namespace: the query takes the host
    lane once, counted in host_fallbacks, with the right answer."""
    from torch_parity import policy

    with policy(policy_name):
        s = SnappySession(catalog=Catalog(), device="cpu")
        s.sql("CREATE TABLE g (x DOUBLE) USING column")
        s.sql("INSERT INTO g VALUES (0.5), (1.5), (NULL)")
        s.sql("CREATE FUNCTION th AS 'lambda x: jnp.tanh(x)' "
              "RETURNS DOUBLE")
        reg = global_registry()
        h0 = reg.counter("host_fallbacks")
        got = s.sql("SELECT sum(th(x)) FROM g").rows()[0][0]
        assert reg.counter("host_fallbacks") == h0 + 1
        assert got == pytest.approx(np.tanh(0.5) + np.tanh(1.5), rel=1e-6)
        s.sql("CREATE FUNCTION tt AS 'lambda x: torch.tanh(x)' "
              "RETURNS DOUBLE")
        h1 = reg.counter("host_fallbacks")
        assert s.sql("SELECT sum(tt(x)) FROM g").rows()[0][0] == \
            pytest.approx(got, rel=1e-6)
        assert reg.counter("host_fallbacks") == h1   # torch: device lane


@pytest.mark.parametrize("policy_name", POLICIES)
def test_result_cast_to_the_declared_plate_dtype(policy_name):
    """The body's result follows torch promotion; the lowering casts it
    to the RETURNS type's plate dtype under the dtype policy."""
    from snappydata_tpu_torch import types as T
    from snappydata_tpu_torch.engine.exprs import _udf_plate
    from torch_parity import policy

    with policy(policy_name):
        f = torch.float64 if policy_name == "f64" else torch.float32
        v = torch.tensor([1, 2], dtype=torch.int64) * 1.5
        assert _udf_plate(v, T.DOUBLE).dtype == f
        assert _udf_plate(v, T.LONG).dtype == torch.int64
        assert _udf_plate(v, T.INT).dtype == torch.int32


@pytest.mark.parametrize("policy_name", POLICIES)
def test_q6_revenue_through_a_function(policy_name):
    """TPC-H Q6 with its revenue written as `rev(price, discount)`: the
    reference's rows and routing, and Q6's own rows."""
    p = Pair(policy_name, routed=ROUTED)
    p.sql(tpch.LINEITEM_DDL)
    p.insert_arrays("lineitem", list(tpch.gen_lineitem(6000, 7).values()))
    p.sql("CREATE FUNCTION rev AS 'lambda p, d: p * d' RETURNS DOUBLE")
    q6f = tpch.Q6.replace("sum(l_extendedprice * l_discount)",
                          "sum(rev(l_extendedprice, l_discount))")
    assert q6f != tpch.Q6
    rows = p.device(q6f)
    want, _ = p.run(tpch.Q6)
    assert rows[0][0] == pytest.approx(want[0][0], rel=1e-9)
