"""Prepared-statement serving of the port against the reference's.

The cases of tests/test_serving.py that need no front door run through
the JAX package's session and the port's (on the CPU) on the same seeded
rows: session.prepare / SQL PREPARE-EXECUTE-DEALLOCATE, the compile-once
counters, the point lane's zero device work, one bulk host copy per
fused dispatch, re-prepare on DDL, racing threads and distinct
principals sharing a dispatch, cancel and timeout inside a fused batch,
an overflowing batch, a failed re-prepare, batched values equal to
unbatched, warm_batches, the plan-cache LRU and the registry LRU with its
ledger line.  Each case returns what it observed (rows, counter deltas,
error class names) from both packages and the two must agree; the
`serving_batch_fallbacks` and `serving_vmap_compiles` deltas are part of
every deterministic case's observation.

Left for the front doors: the REST serving endpoint, the Flight SQL
prepared statement and the FlightInfo peek, and bench.py's qps guard;
the grant checks of a prepared handle wait for the security module.
"""

import threading
import time

import numpy as np
import pytest

from torch_parity import assert_rows_equal

SERVING = ("serving_batch_fallbacks", "serving_vmap_compiles")
JOIN_S = 60.0     # every thread join and barrier wait is bounded


class Kit:
    """One package's session and serving surface."""

    def __init__(self, name):
        self.name = name
        if name == "ref":
            from snappydata_tpu import SnappySession, config, resource
            from snappydata_tpu import types as T
            from snappydata_tpu.catalog import Catalog
            from snappydata_tpu.observability.metrics import global_registry
            from snappydata_tpu.resource.context import CancelException
            from snappydata_tpu.serving import (ServingError, batcher,
                                                serving_snapshot)
            from snappydata_tpu.sql.analyzer import AnalysisError
            from snappydata_tpu.sql.lexer import SQLSyntaxError

            self.new = lambda **kw: SnappySession(catalog=Catalog(), **kw)
        else:
            from snappydata_tpu_torch import SnappySession, config, resource
            from snappydata_tpu_torch import types as T
            from snappydata_tpu_torch.catalog import Catalog
            from snappydata_tpu_torch.observability.metrics import \
                global_registry
            from snappydata_tpu_torch.resource.context import \
                CancelException
            from snappydata_tpu_torch.serving import (ServingError, batcher,
                                                      serving_snapshot)
            from snappydata_tpu_torch.sql.analyzer import AnalysisError
            from snappydata_tpu_torch.sql.lexer import SQLSyntaxError

            config.global_properties().compaction_enabled = False
            self.new = lambda **kw: SnappySession(catalog=Catalog(),
                                                  device="cpu", **kw)
        self.SnappySession = SnappySession
        self.Catalog = Catalog
        self.config = config
        self.resource = resource
        self.T = T
        self.reg = global_registry
        self.CancelException = CancelException
        self.ServingError = ServingError
        self.batcher = batcher
        self.serving_snapshot = serving_snapshot
        self.AnalysisError = AnalysisError
        self.SQLSyntaxError = SQLSyntaxError

    @property
    def props(self):
        return self.config.global_properties()

    def counter(self, name):
        return self.reg().counter(name)

    def counters(self, names):
        return {n: self.counter(n) for n in names}

    def compile_count(self):
        if self.name == "ref":
            return self.reg().snapshot()["timers"].get(
                "plan_compile", {}).get("count", 0)
        return self.reg().timer("plan_compile")[0]

    def batched(self, compiled, params, session):
        if self.name == "ref":
            return compiled.execute_batched(params)
        return compiled.execute_batched(params, session.device)

    def user_session(self, s, user):
        """A session of `user` over the same catalog, granted SELECT on
        txns."""
        s.sql(f"GRANT SELECT ON txns TO {user}")
        return s.for_user(user)

    def serving_session(self):
        s = self.new()
        T = self.T
        rng = np.random.default_rng(7)
        s.create_table("accounts", [("id", T.LONG), ("balance", T.DOUBLE),
                                    ("name", T.STRING)],
                       provider="row", key_columns=("id",))
        n = 5000
        s.insert_arrays("accounts", [
            np.arange(n, dtype=np.int64), rng.random(n) * 100.0,
            np.array([f"u{i}" for i in range(n)], dtype=object)])
        region = rng.integers(0, 16, 20000).astype(np.int64)
        amount = rng.random(20000)
        s.create_table("txns", [("region_id", T.LONG),
                                ("amount", T.DOUBLE)], provider="column")
        s.insert_arrays("txns", [region, amount])
        s._region = region
        s._amount = amount
        return s


@pytest.fixture(scope="module")
def kits():
    return [Kit("port"), Kit("ref")]


@pytest.fixture()
def sessions(kits):
    out = [(k, k.serving_session()) for k in kits]
    yield out
    for _k, s in out:
        s.stop()


AGG_SQL = "SELECT count(*), sum(amount) FROM txns WHERE region_id = ?"


def _agg_expect(s, r):
    m = s._region == r
    return int(m.sum()), float(s._amount[m].sum())


def _check_agg(s, r, row):
    cnt, sm = _agg_expect(s, r)
    assert row[0] == cnt, (r, row)
    assert abs(row[1] - sm) <= 1e-9 * max(sm, 1.0), (r, row)


def _same(obs_port, obs_ref):
    """Two observations agree: equal keys; rows within the f64 parity
    bar, everything else equal."""
    assert obs_port.keys() == obs_ref.keys()
    for key in obs_port:
        a, b = obs_port[key], obs_ref[key]
        if key.startswith("rows"):
            if a and isinstance(a[0], list):
                assert len(a) == len(b), key
                for x, y in zip(a, b):
                    assert_rows_equal(x, y, 1e-9)
            else:
                assert_rows_equal(a, b, 1e-9)
        else:
            assert a == b, (key, a, b)


def both(sessions, body, counters=SERVING):
    """Run `body(kit, session)` in both packages; the observations and
    the deltas of `counters` must agree.  Returns the port's."""
    obs = {}
    for k, s in sessions:
        before = k.counters(counters)
        o = body(k, s)
        after = k.counters(counters)
        o.update({f"delta_{n}": after[n] - before[n] for n in counters})
        obs[k.name] = o
    _same(obs["port"], obs["ref"])
    return obs["port"]


def _err(fn):
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - the class is the observation
        return type(e).__name__
    return None


# ---------------------------------------------------------------------
# basics: handle API + SQL grammar
# ---------------------------------------------------------------------

def test_prepare_execute_point_and_agg(sessions):
    def body(k, s):
        ph = s.prepare("SELECT balance, name FROM accounts WHERE id = ?")
        row = ph.execute((17,)).rows()
        naive = s.sql(
            "SELECT balance, name FROM accounts WHERE id = 17").rows()
        assert row == naive
        ah = s.prepare(AGG_SQL)
        aggs = []
        for r in (0, 3, 15):
            got = ah.execute((r,)).rows()[0]
            _check_agg(s, r, got)
            aggs.append(tuple(got))
        return {"rows_point": row, "rows_agg": aggs}

    both(sessions, body)


def test_prepare_arity_and_non_query_errors(sessions):
    def body(k, s):
        h = s.prepare(AGG_SQL)
        errs = [_err(lambda: h.execute(())),
                _err(lambda: h.execute((1, 2))),
                _err(lambda: s.prepare("INSERT INTO txns VALUES (1, 2.0)"))]
        assert errs == ["ServingError"] * 3
        return {"errs": errs}

    both(sessions, body)


def test_sql_prepare_execute_deallocate(sessions):
    def body(k, s):
        s.sql("PREPARE get_bal AS SELECT balance FROM accounts "
              "WHERE id = ?")
        got = s.sql("EXECUTE get_bal (23)").rows()
        assert got == s.sql(
            "SELECT balance FROM accounts WHERE id = 23").rows()
        s.sql("PREPARE by_name AS SELECT id FROM accounts WHERE name = ?")
        by_name = s.sql("EXECUTE by_name ('u7')").rows()
        assert by_name == [(7,)]
        s.sql("DEALLOCATE get_bal")
        errs = [_err(lambda: s.sql("EXECUTE get_bal (23)")),
                _err(lambda: s.sql("EXECUTE never_prepared (1)")),
                _err(lambda: s.sql("DEALLOCATE PREPARE get_bal"))]
        assert errs == ["ServingError"] * 3
        return {"rows": got, "rows_name": by_name, "errs": errs}

    both(sessions, body)


def test_prepared_with_order_by_limit(sessions):
    q = ("SELECT region_id, sum(amount) AS sa FROM txns "
         "WHERE region_id < {} GROUP BY region_id ORDER BY sa DESC LIMIT 3")

    def body(k, s):
        got = s.prepare(q.format("?")).execute((9,)).rows()
        naive = s.sql(q.format(9)).rows()
        assert [(g[0], round(g[1], 9)) for g in got] == \
            [(x[0], round(x[1], 9)) for x in naive]
        return {"rows": got}

    both(sessions, body)


def test_prepared_passthrough_subquery(sessions):
    q = ("SELECT count(*) FROM txns WHERE region_id = "
         "(SELECT min(region_id) FROM txns)")

    def body(k, s):
        h = s.prepare(q)
        before = k.counter("serving_passthrough")
        got = h.execute(()).rows()
        moved = k.counter("serving_passthrough") - before
        assert moved > 0
        assert got == s.sql(q).rows()
        return {"rows": got, "passthrough": moved}

    both(sessions, body)


def test_round_digits_bind(sessions):
    """round(col, ?) honours the bind value."""
    def body(k, s):
        h = s.prepare("SELECT sum(round(amount, ?)) FROM txns "
                      "WHERE region_id = 0")
        rows = []
        for d in (0, 2, 3):
            exp = s.sql(f"SELECT sum(round(amount, {d})) FROM txns "
                        f"WHERE region_id = 0").rows()
            got = h.execute((d,)).rows()
            assert abs(got[0][0] - exp[0][0]) <= 1e-9, (d, got, exp)
            rows.append(got[0])
        return {"rows": rows}

    both(sessions, body)


def test_passthrough_arity_checked(sessions):
    q = ("SELECT count(*) FROM txns WHERE region_id = {} AND "
         "amount < (SELECT max(amount) FROM txns)")

    def body(k, s):
        h = s.prepare(q.format("?"))
        assert h._entry.passthrough == "subquery"
        assert h.param_count == 1
        errs = [_err(lambda: h.execute(())), _err(lambda: h.execute((1, 2)))]
        got = h.execute((3,)).rows()
        assert got == s.sql(q.format(3)).rows()
        return {"rows": got, "errs": errs,
                "passthrough": h._entry.passthrough}

    both(sessions, body)


def test_execute_sign_on_non_numeric_rejected(sessions):
    def body(k, s):
        s.sql("PREPARE sgn AS SELECT count(*) FROM accounts WHERE name = ?")
        with pytest.raises(k.SQLSyntaxError):
            s.sql("EXECUTE sgn (-'u1')")
        return {}

    both(sessions, body)


# ---------------------------------------------------------------------
# compile-once: zero recompiles / re-tokenizations per execute
# ---------------------------------------------------------------------

def test_compile_once_counters(sessions):
    def body(k, s):
        ph = s.prepare("SELECT balance FROM accounts WHERE id = ?")
        ah = s.prepare(AGG_SQL)
        ph.execute((1,))
        ah.execute((1,))
        compiles0 = k.compile_count()
        names = ("plan_key_builds", "plan_cache_misses",
                 "serving_prepared_hits")
        c0 = k.counters(names)
        for i in range(20):
            ph.execute((i,))
            ah.execute((i % 16,))
        c1 = k.counters(names)
        moved = {n: c1[n] - c0[n] for n in names}
        # no plan compiles, no plan-repr walks, no plan-cache misses
        assert k.compile_count() == compiles0
        assert moved["plan_key_builds"] == 0
        assert moved["plan_cache_misses"] == 0
        assert moved["serving_prepared_hits"] >= 40
        return {"moved": moved}

    both(sessions, body)


def test_point_lookup_zero_transfers(sessions, monkeypatch):
    """A prepared point lookup answers from the key index: no device
    work and no transfer in either package (the reference under
    jax.transfer_guard; the port with every device entry of a compiled
    plan made to raise)."""
    import jax

    from snappydata_tpu_torch.engine import executor as port_exec

    def refuse(*_a, **_k):
        raise AssertionError("the point lane reached the device")

    def body(k, s):
        ph = s.prepare("SELECT balance FROM accounts WHERE id = ?")
        ph.execute((0,))
        p0 = k.counter("point_lookups")
        if k.name == "ref":
            with jax.transfer_guard("disallow"):
                rows = [ph.execute((i,)).rows() for i in range(10)]
        else:
            with monkeypatch.context() as m:
                for fn in ("_bind", "execute_batched", "run"):
                    m.setattr(port_exec.CompiledPlan, fn, refuse)
                rows = [ph.execute((i,)).rows() for i in range(10)]
        assert all(len(r) == 1 for r in rows)
        return {"rows": [r[0] for r in rows],
                "lookups": k.counter("point_lookups") - p0}

    obs = both(sessions, body)
    assert obs["lookups"] == 10


def test_one_bulk_transfer_per_fused_dispatch(sessions):
    def body(k, s):
        entry = s.prepare(AGG_SQL)._entry
        compiled = entry.compiled_for(s)
        t0 = k.counter("serving_bulk_transfers")
        params = [entry.lit_params + (r,) for r in range(4)]
        tables, outs = k.batched(compiled, params, s)
        moved = k.counter("serving_bulk_transfers") - t0
        rows = []
        for i, p in enumerate(params):
            res = entry.assemble_batched(s, outs, tables, i, p)
            _check_agg(s, i, res.rows()[0])
            rows.append(res.rows()[0])
        return {"rows": rows, "transfers": moved}

    obs = both(sessions, body)
    assert obs["transfers"] == 1


def test_reprepare_on_ddl(sessions):
    def body(k, s):
        h = s.prepare(AGG_SQL)
        h.execute((1,))
        r0 = k.counter("serving_reprepares")
        s.sql("ALTER TABLE txns ADD COLUMN note STRING")
        got = h.execute((1,)).rows()[0]
        _check_agg(s, 1, got)
        return {"rows": [got], "reprepares": k.counter(
            "serving_reprepares") - r0}

    obs = both(sessions, body)
    assert obs["reprepares"] > 0


# ---------------------------------------------------------------------
# micro-batched dispatch under racing threads
# ---------------------------------------------------------------------

def _race(k, calls, wait_us=30000.0):
    """Run each (callable, params) on its own thread near-simultaneously
    with a wide coalescing window; [(result | None, error | None)]."""
    props = k.props
    saved = props.serving_batch_wait_us
    props.serving_batch_wait_us = wait_us
    out = [(None, None)] * len(calls)
    barrier = threading.Barrier(len(calls))

    def run(i, fn, params):
        try:
            barrier.wait(timeout=JOIN_S)
            out[i] = (fn(params), None)
        except Exception as e:  # noqa: BLE001
            out[i] = (None, e)

    try:
        ts = [threading.Thread(target=run, args=(i, fn, p), daemon=True)
              for i, (fn, p) in enumerate(calls)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in ts), "a request hung"
    finally:
        props.serving_batch_wait_us = saved
    return out


def test_batched_racing_threads_each_get_own_rows(sessions):
    binds = [0, 3, 3, 7, 11, 15]

    def body(k, s):
        ah = s.prepare(AGG_SQL)
        d0 = k.counter("serving_batched_dispatches")
        results = _race(k, [(ah.execute, (r,)) for r in binds])
        rows = []
        for r, (res, err) in zip(binds, results):
            assert err is None, err
            _check_agg(s, r, res.rows()[0])
            rows.append(res.rows()[0])
        return {"rows": rows,
                "fused": k.counter("serving_batched_dispatches") > d0}

    # how the racing requests split into batches is the scheduler's
    # choice: only the fallback count is compared
    obs = both(sessions, body, counters=("serving_batch_fallbacks",))
    assert obs["fused"]


def test_batched_distinct_principals_share_a_dispatch(sessions):
    def body(k, s):
        s1 = k.user_session(s, "u1")
        s2 = k.user_session(s, "u2")
        h1 = s1.prepare(AGG_SQL)
        h2 = s2.prepare(AGG_SQL)
        # one shared registry entry: the second principal's prepare hits
        assert h1._entry is h2._entry
        d0 = k.counter("serving_batched_dispatches")
        binds = (2, 5, 9, 13)
        results = _race(k, [(h1.execute, (2,)), (h2.execute, (5,)),
                            (h1.execute, (9,)), (h2.execute, (13,))])
        rows = []
        for r, (res, err) in zip(binds, results):
            assert err is None, err
            _check_agg(s, r, res.rows()[0])
            rows.append(res.rows()[0])
        return {"rows": rows,
                "fused": k.counter("serving_batched_dispatches") > d0}

    obs = both(sessions, body, counters=("serving_batch_fallbacks",))
    assert obs["fused"]


def test_cancel_inside_fused_batch_spares_batchmates(sessions):
    """Three requests collected into one batch, the middle one's context
    cancelled: the dispatch gate drops it with its own CancelException,
    and its batchmates still share one fused dispatch."""
    def body(k, s):
        entry = s.prepare(AGG_SQL)._entry
        assert entry.batchable(s)
        reqs = [k.batcher._Request(s, entry.lit_params + (r,),
                                   k.resource.new_query(AGG_SQL, "admin"))
                for r in (1, 4, 8)]
        reqs[1].ctx.cancel("test cancel")
        names = ("serving_batched_dispatches", "serving_batch_requests")
        c0 = k.counters(names)
        k.batcher.MicroBatcher()._dispatch(entry, reqs)
        assert isinstance(reqs[1].error, k.CancelException)
        assert reqs[1].result is None
        rows = []
        for i, r in ((0, 1), (2, 8)):
            assert reqs[i].error is None
            _check_agg(s, r, reqs[i].result.rows()[0])
            rows.append(reqs[i].result.rows()[0])
        c1 = k.counters(names)
        return {"rows": rows, "moved": {n: c1[n] - c0[n] for n in names}}

    obs = both(sessions, body)
    assert obs["moved"] == {"serving_batched_dispatches": 1,
                            "serving_batch_requests": 2}


def test_timeout_inside_fused_batch(sessions):
    """A request whose statement deadline passed before dispatch raises
    its own timeout; its batchmate is unaffected."""
    def body(k, s):
        entry = s.prepare(AGG_SQL)._entry
        late = k.resource.new_query(AGG_SQL, "admin")
        late.deadline = time.monotonic() - 1.0
        reqs = [k.batcher._Request(s, entry.lit_params + (2,), late),
                k.batcher._Request(s, entry.lit_params + (6,),
                                   k.resource.new_query(AGG_SQL, "admin"))]
        k.batcher.MicroBatcher()._dispatch(entry, reqs)
        assert isinstance(reqs[0].error, k.CancelException)
        assert "timeout" in str(reqs[0].error)
        _check_agg(s, 6, reqs[1].result.rows()[0])
        return {"rows": [reqs[1].result.rows()[0]]}

    both(sessions, body)


def test_overflowing_batch_serves_every_request(sessions):
    """More compatible waiters than serving_batch_max: the leader rides
    its own batch and the rest are served by follow-up batches."""
    binds = [1, 2, 3, 4, 5, 6, 7]

    def body(k, s):
        ah = s.prepare(AGG_SQL)
        saved = k.props.serving_batch_max
        k.props.serving_batch_max = 2
        try:
            results = _race(k, [(ah.execute, (r,)) for r in binds])
        finally:
            k.props.serving_batch_max = saved
        rows = []
        for r, (res, err) in zip(binds, results):
            assert err is None, err
            assert res is not None, r
            _check_agg(s, r, res.rows()[0])
            rows.append(res.rows()[0])
        return {"rows": rows}

    both(sessions, body, counters=("serving_batch_fallbacks",))


def test_failed_reprepare_surfaces_real_error_every_time(sessions):
    """A DROP TABLE under a prepared statement gives the real analysis
    error on every later execute: a failed rebuild publishes nothing."""
    def body(k, s):
        T = k.T
        s.create_table("tmp_serve", [("k", T.LONG), ("v", T.DOUBLE)],
                       provider="column")
        s.insert_arrays("tmp_serve", [np.arange(10, dtype=np.int64),
                                      np.ones(10)])
        h = s.prepare("SELECT sum(v) FROM tmp_serve WHERE k = ?")
        first = h.execute((3,)).rows()
        assert first == [(1.0,)]
        s.sql("DROP TABLE tmp_serve")
        errs = [_err(lambda: h.execute((3,))) for _ in range(2)]
        assert all(e in ("AnalysisError", "ValueError") for e in errs), errs
        return {"rows": first, "errs": errs}

    both(sessions, body)


def test_batched_values_match_unbatched(sessions):
    """A direct fused dispatch of all 16 regions against the unbatched
    engine path: equal values."""
    def body(k, s):
        entry = s.prepare(AGG_SQL)._entry
        compiled = entry.compiled_for(s)
        params = [entry.lit_params + (r,) for r in range(16)]
        tables, outs = k.batched(compiled, params, s)
        rows = []
        for i, p in enumerate(params):
            res = entry.assemble_batched(s, outs, tables, i, p)
            ref = s.executor.execute(entry.tokenized, p)
            assert res.rows() == ref.rows(), i
            rows.append(res.rows()[0])
        return {"rows": rows}

    both(sessions, body)


def test_grouped_batch_pads_data_sized_groups(sessions):
    """A GROUP BY over the generic key lane, whose group count the port
    takes from the data: requests with different group counts share one
    fused dispatch (the shorter outputs padded, mask False) and each gets
    its unbatched rows."""
    q = ("SELECT region_id % 5 AS m, count(*), sum(amount) FROM txns "
         "WHERE region_id < ? GROUP BY region_id % 5 ORDER BY m")

    def body(k, s):
        entry = s.prepare(q)._entry
        compiled = entry.compiled_for(s)
        params = [entry.lit_params + (b,) for b in (16, 4, 2)]
        tables, outs = k.batched(compiled, params, s)
        rows = []
        for i, p in enumerate(params):
            res = entry.assemble_batched(s, outs, tables, i, p)
            assert res is not None
            assert res.rows() == s.executor.execute(
                entry.tokenized, p).rows(), i
            rows.append(res.rows())
        return {"rows": rows}

    both(sessions, body)


def test_warm_batches_primes_vmap_variants(sessions):
    def body(k, s):
        h = s.prepare("SELECT sum(amount) FROM txns WHERE region_id = ?")
        v0 = k.counter("serving_vmap_compiles")
        n = h.warm_batches((0,))
        assert n > 0
        assert k.counter("serving_vmap_compiles") >= v0 + n
        v1 = k.counter("serving_vmap_compiles")
        h.warm_batches((5,))        # warmed: nothing new
        return {"n": n, "rewarm": k.counter("serving_vmap_compiles") - v1}

    obs = both(sessions, body)
    assert obs["rewarm"] == 0


# ---------------------------------------------------------------------
# plan-cache LRU + registry LRU + ledger
# ---------------------------------------------------------------------

def test_plan_cache_lru_keeps_hot_entries(kits):
    queries = ["SELECT sum(v) FROM t GROUP BY k",
               "SELECT min(v) FROM t GROUP BY k",
               "SELECT count(*) FROM t GROUP BY k"]
    obs = {}
    for k in kits:
        s = k.new(conf=k.config.Properties(plan_cache_size=3))
        T = k.T
        s.create_table("t", [("k", T.LONG), ("v", T.DOUBLE)],
                       provider="column")
        s.insert_arrays("t", [np.arange(100, dtype=np.int64),
                              np.ones(100)])
        for q in queries:
            s.sql(q)
        ev0 = k.counter("plan_cache_evictions")
        s.sql(queries[0])               # touch: q0 is now the hottest
        s.sql("SELECT max(v) FROM t GROUP BY k")   # evicts the coldest
        evicted = k.counter("plan_cache_evictions") - ev0
        size = len(s.executor._plan_cache)
        h0 = k.counter("plan_cache_hits")
        s.sql(queries[0])               # the hot entry survived the miss
        obs[k.name] = (evicted, size, k.counter("plan_cache_hits") - h0)
        s.stop()
    assert obs["port"] == obs["ref"]
    evicted, size, hits = obs["port"]
    assert evicted > 0 and size <= 3 and hits > 0


def test_registry_lru_and_ledger(sessions):
    def body(k, s):
        saved = k.props.serving_max_handles
        k.props.serving_max_handles = 2
        try:
            e0 = k.counter("serving_handle_evictions")
            for i in (1, 2, 3):
                s.prepare(f"SELECT count(*) FROM txns WHERE region_id < {i}")
            evicted = k.counter("serving_handle_evictions") - e0
            entries = len(s.catalog._serving_registry._entries)
            led = k.resource.global_broker().ledger()
            assert led["serving_registry_bytes"] > 0
            snap = k.serving_snapshot(s.catalog)
        finally:
            k.props.serving_max_handles = saved
        return {"evicted": evicted, "entries": entries,
                "handles": [(h["sql"], h["params"], h["passthrough"])
                            for h in snap["handles"]],
                "keys": sorted(snap)}

    obs = both(sessions, body)
    assert obs["evicted"] > 0 and obs["entries"] <= 2


def test_degradation_first_rung_drops_prepared_plans(sessions, monkeypatch):
    """The broker's first rung drops the plan caches, the group-index
    cache and the prepared-plan registries (a dropped statement
    re-prepares on its next execute)."""
    def body(k, s):
        from importlib import import_module

        ex = import_module(k.SnappySession.__module__.split(".")[0]
                           + ".engine.executor")
        h = s.prepare(AGG_SQL)
        h.execute((1,))
        s.sql("SELECT region_id, count(*) FROM txns GROUP BY region_id")
        assert len(s.catalog._serving_registry._entries) == 1
        assert ex.gidx_cache_nbytes() > 0
        broker = k.resource.global_broker()
        calls = iter([(1, 0)])
        monkeypatch.setattr(broker, "measured_bytes",
                            lambda *a, **kw: next(calls, (0, 0)))
        e0 = k.counter("governor_degrade_plan_evictions")
        broker._degrade(0)
        monkeypatch.undo()
        got = h.execute((1,)).rows()[0]
        _check_agg(s, 1, got)
        return {"entries": len(s.catalog._serving_registry._entries),
                "gidx": ex.gidx_cache_nbytes(),
                "rung": k.counter("governor_degrade_plan_evictions") - e0,
                "rows": [got]}

    obs = both(sessions, body)
    assert obs["entries"] == 0 and obs["gidx"] == 0 and obs["rung"] == 1


def test_batcher_stress_every_request_gets_its_own_rows(kits):
    """More client threads than cores, a shortened switch interval: every
    request of the port's micro-batcher comes back with its own bind's
    rows (a lost or crossed update would hand a request a batchmate's
    answer), and every request is accounted to a fused dispatch or a
    straight-through execute."""
    import sys

    k = kits[0]
    s = k.serving_session()
    h = s.prepare(AGG_SQL)
    names = ("serving_batch_requests", "serving_straight_through",
             "serving_batch_fallbacks")
    c0 = k.counters(names)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        calls = [(h.execute, ((t * 7 + i) % 16,))
                 for t in range(24) for i in range(3)]
        results = _race(k, calls, wait_us=2000.0)
    finally:
        sys.setswitchinterval(old)
    for (_fn, (r,)), (res, err) in zip(calls, results):
        assert err is None, err
        _check_agg(s, r, res.rows()[0])
    c1 = k.counters(names)
    moved = {n: c1[n] - c0[n] for n in names}
    assert moved["serving_batch_fallbacks"] == 0
    assert moved["serving_batch_requests"] + \
        moved["serving_straight_through"] == len(calls)
    s.stop()
