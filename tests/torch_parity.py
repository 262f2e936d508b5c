"""Shared harness of the port's parity tests: one reference session and
one port session on the CPU, the same statements through both, rows and
routing counters compared (parity bar: ROADMAP "Port rules")."""

import contextlib
import os
import decimal
import time

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


# -- reference test cases run against the port -------------------------

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def port_cases(ref_file, names, edits=(), rename=None):
    """The named test functions and fixtures of the reference test file
    `ref_file` (under tests/), compiled against the port: the source,
    after the `edits` (exact text, or a compiled pattern; each must
    occur), reads every
    `snappydata_tpu` module path as `snappydata_tpu_torch`, so each case
    asserts the reference's own rows, errors and counters of the port.
    Returns {name: object}, keyed by `rename[name]` where given; the
    caller puts them in its module namespace for pytest to collect.  The
    port's sessions default to the CPU inside `cpu_default()`."""
    import re
    import types

    path = os.path.join(TESTS_DIR, ref_file)
    with open(path) as fh:
        src = fh.read()
    for old, new in edits:
        if isinstance(old, re.Pattern):
            src, n = old.subn(new, src)
            assert n, (ref_file, old.pattern)
        else:
            assert old in src, (ref_file, old)
            src = src.replace(old, new)
    src = re.sub(r"\bsnappydata_tpu\b", "snappydata_tpu_torch", src)
    mod = types.ModuleType("ported_" + ref_file[:-3])
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    rename = rename or {}
    return {rename.get(n, n): getattr(mod, n) for n in names}



def case_names(ref_file):
    """Every case of the reference test file `ref_file` with what pytest
    needs to run it there: its top-level `test_*` functions, `Test*`
    classes and fixtures, for `port_cases(ref_file, case_names(...))`."""
    import ast

    with open(os.path.join(TESTS_DIR, ref_file)) as fh:
        tree = ast.parse(fh.read())
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            out.append(node.name)
        elif isinstance(node, ast.FunctionDef) and (
                node.name.startswith("test_")
                or any("fixture" in ast.unparse(d)
                       for d in node.decorator_list)):
            out.append(node.name)
    return out


def unslow(obj):
    """Take the reference's own `slow` mark off a ported case (a function
    or a class) that runs in seconds on the port."""
    obj.pytestmark = [m for m in getattr(obj, "pytestmark", [])
                      if m.name != "slow"]
    return obj

@contextlib.contextmanager
def mesh_slots(n):
    """The port's shard slot count (`mesh_slots`) set to `n`, on the CPU
    for a mesh that names no device (a card may be visible): the
    counterpart of the reference tests' 8 XLA host devices
    (tests/conftest.py)."""
    import torch

    from snappydata_tpu_torch.parallel import mesh as port_mesh

    props = config.global_properties()
    old = props.mesh_slots
    old_default = port_mesh._default_device
    props.mesh_slots = n
    port_mesh._default_device = lambda: torch.device("cpu")
    try:
        yield
    finally:
        props.mesh_slots = old
        port_mesh._default_device = old_default


@pytest.fixture(scope="module")
def eight_slots():
    """Module-wide: 8 shard slots on the CPU (a mesh test module lists it
    in an autouse fixture of its own), with torch's CPU ops on one thread:
    the slots run one after another, each over a block, and in the
    parallel suite every worker's default thread pool (one thread a core)
    oversubscribes the cores many times over for such small ops."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mesh_slots(8):
            yield
    finally:
        torch.set_num_threads(threads)


@contextlib.contextmanager
def cpu_default():
    """A port session that names no device runs on the CPU here (the
    reference's test cases construct `SnappySession()`); an explicit
    device is kept."""
    import snappydata_tpu_torch.session as port_session

    orig = port_session.resolve_device
    port_session.resolve_device = \
        lambda device=None: orig("cpu" if device is None else device)
    try:
        yield
    finally:
        port_session.resolve_device = orig


@contextlib.contextmanager
def ledger_guard():
    """Both brokers' ledgers as they were: a table a test (or a module
    fixture's server) keeps alive must not stay ledgered after it, where
    the tier ladder's pass would walk it for later tests (ROADMAP C4)."""
    from snappydata_tpu.resource.broker import global_broker as ref_broker
    from snappydata_tpu_torch.resource.broker import global_broker

    brokers = (ref_broker(), global_broker())
    before = []
    for b in brokers:
        with b._tables_lock:
            before.append(set(b._tables))
    try:
        yield
    finally:
        for b, keys in zip(brokers, before):
            with b._tables_lock:
                for k in [k for k in b._tables if k not in keys]:
                    b._tables.pop(k, None)


def stop_flight(srv):
    """Shut Flight server `srv` down.  The port's server then waits
    SHUTDOWN_GRACE_S itself (snappydata_tpu_torch/cluster/flight_server.py
    `shutdown`); after a reference server the test waits as long, so the
    server the next test creates keeps its listener."""
    from snappydata_tpu_torch.cluster import flight_server

    srv.shutdown()
    if not isinstance(srv, flight_server.SnappyFlightServer):
        time.sleep(flight_server.SHUTDOWN_GRACE_S)


def stop_member(node):
    """Stop member node `node` (a server or a lead of either package).
    A port node's Flight server waits SHUTDOWN_GRACE_S itself; after a
    reference node the test waits as long, as `stop_flight` does."""
    from snappydata_tpu_torch.cluster import flight_server

    node.stop()
    if node.flight is not None and not isinstance(
            node.flight, flight_server.SnappyFlightServer):
        time.sleep(flight_server.SHUTDOWN_GRACE_S)


@pytest.fixture(scope="module", autouse=True)
def front_door_env():
    """Module-wide: port sessions default to the CPU and both ledgers are
    restored at teardown (set up before, and torn down after, every
    module fixture of a front-door test module)."""
    with cpu_default(), ledger_guard():
        yield


@pytest.fixture(autouse=True)
def _ledger_per_test():
    with ledger_guard():
        yield


# -- clusters of either package ----------------------------------------------

def _cluster_pkg(name):
    if name == "ref":
        from snappydata_tpu import SnappySession as Session
        from snappydata_tpu.catalog import Catalog as Cat
        from snappydata_tpu.cluster import LocatorNode, ServerNode
        from snappydata_tpu.cluster import distributed
        from snappydata_tpu.utils import tpch

        def session():
            return Session(catalog=Cat())
    else:
        from snappydata_tpu_torch.cluster import LocatorNode, ServerNode
        from snappydata_tpu_torch.cluster import distributed
        from snappydata_tpu_torch.utils import tpch

        def session():
            return SnappySession(catalog=Catalog(), device="cpu")
    return LocatorNode, ServerNode, distributed, tpch, session


class Cluster:
    """A locator, `n` servers and a lead's DistributedSession of one
    package ("ref" or "port"; the port's on the CPU)."""

    def __init__(self, pkg, n=3):
        LocatorNode, ServerNode, distributed, self.tpch, session = \
            _cluster_pkg(pkg)
        self.locator = LocatorNode().start()
        self.servers = [ServerNode(self.locator.address, session()).start()
                        for _ in range(n)]
        kw = {} if pkg == "ref" else {"device": "cpu"}
        self.ds = distributed.DistributedSession(
            server_addresses=[s.flight_address for s in self.servers], **kw)

    def counts(self, table):
        """Each server's row count of `table`."""
        return [s.session.sql(f"SELECT count(*) FROM {table}").rows()[0][0]
                for s in self.servers]

    def close(self):
        self.ds.close()
        for s in self.servers:
            stop_member(s)
        self.locator.stop()


@contextlib.contextmanager
def clusters(n=3):
    """(reference cluster, port cluster) of `n` servers each."""
    made = []
    try:
        for pkg in ("ref", "port"):
            made.append(Cluster(pkg, n))
        yield made
    finally:
        for c in made:
            c.close()
