"""Shared harness of the port's parity tests: one reference session and
one port session on the CPU, the same statements through both, rows and
routing counters compared (parity bar: ROADMAP "Port rules")."""

import contextlib
import decimal

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

POLICIES = ("f64", "f32")
REL = {"f64": 1e-9, "f32": 1e-6}
ROUTED = ("host_fallbacks", "join_device_joins", "join_host_fallbacks")


@contextlib.contextmanager
def policy(name):
    """Both packages' plate policy: float64 plates or float32 plates."""
    props = (ref_config.global_properties(), config.global_properties())
    saved = [p.decimal_as_float64 for p in props]
    for p in props:
        p.decimal_as_float64 = name == "f64"
    try:
        yield
    finally:
        for p, old in zip(props, saved):
            p.decimal_as_float64 = old


def counters(reg) -> dict:
    snap = reg.snapshot()
    return dict(snap["counters"]) if "counters" in snap else dict(snap)


def _same(a, b, rel) -> bool:
    if isinstance(b, (float, np.floating)) and not isinstance(b, bool):
        if a is None:
            return False
        if np.isnan(b):
            return np.isnan(a)
        return a == pytest.approx(float(b), rel=rel, abs=1e-9)
    if isinstance(b, decimal.Decimal) and isinstance(a, float):
        return a == pytest.approx(float(b), rel=rel, abs=1e-9)
    return a == b


def assert_rows_equal(got, want, rel):
    got = [tuple(r) for r in got]
    want = [tuple(r) for r in want]
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            assert _same(a, b, rel), (g, w)


class Pair:
    """A reference and a port session loaded with the same rows under one
    plate policy; `run` asserts equal rows and equal routing deltas."""

    def __init__(self, name="f64", routed=ROUTED):
        self.policy = name
        self.routed = routed
        # the port's broker-kicked compactor would rewrite the port's
        # tables on its own clock between two compared queries; a test
        # of the scheduler turns it on explicitly
        config.global_properties().compaction_enabled = False
        self.ref = RefSession(catalog=RefCatalog())
        self.port = SnappySession(catalog=Catalog(), device="cpu")

    def sql(self, q, params=None):
        """Run a statement in both; return (port rows, ref rows) of its
        result (empty for DDL / DML without one)."""
        out = []
        with policy(self.policy):
            for s in (self.port, self.ref):
                r = s.sql(q, params=params) if params is not None \
                    else s.sql(q)
                out.append([tuple(x) for x in r.rows()]
                           if hasattr(r, "rows") else r)
        return out

    def insert_arrays(self, table, arrays, nulls=None):
        with policy(self.policy):
            for s in (self.port, self.ref):
                if nulls is None:   # row tables take no null masks
                    s.insert_arrays(table, [np.array(a, copy=True)
                                            for a in arrays])
                    continue
                s.catalog.describe(table).data.insert_arrays(
                    [np.array(a, copy=True) for a in arrays], nulls=nulls)

    def run(self, q, params=None):
        """(port rows, port counter deltas) after asserting the rows and
        the routing counters equal the reference's."""
        out = []
        with policy(self.policy):
            for s, reg in ((self.port, global_registry()),
                           (self.ref, ref_registry())):
                before = counters(reg)
                r = s.sql(q, params=params) if params is not None \
                    else s.sql(q)
                rows = [tuple(x) for x in r.rows()]
                after = counters(reg)
                out.append((rows, {k: after.get(k, 0) - before.get(k, 0)
                                   for k in self.routed}))
        (prows, pmoved), (rrows, rmoved) = out
        assert_rows_equal(prows, rrows, REL[self.policy])
        assert pmoved == rmoved, (q, pmoved, rmoved)
        return prows, pmoved

    def device(self, q, params=None):
        rows, moved = self.run(q, params)
        assert moved["host_fallbacks"] == 0, f"{q} left the device"
        return rows
