"""End-to-end request tracing: one trace id per request, one span tree
per trace.

Port of snappydata_tpu/observability/tracing.py, with the reference's
span names, child cap, ring and slow-query log.  A trace id is minted at
the front door a request enters (`SnappySession.sql`, a prepared
execute, EXPLAIN ANALYZE, REST `POST /sql` and jobs, `SnappyClient`, a
Flight ticket or action) and rides a contextvar locally and a `trace_id`
request-body / ticket field across the wire: a server receiving a traced
request opens its own trace under the same id (`origin` names the
server).  A `DistributedSession.sql` is one lead trace: one `member`
span per fan-out leg (hedge legs re-attach to it), and its
`DistributedError`s carry the trace id.

Span tree invariants:

- ``request_scope`` mints at most one trace per logical request: an
  ambient trace absorbs nested scopes (tile partials, matview-sync
  scratch queries, the serving path re-entering session.sql), so the
  whole request is ONE tree.
- ``span(name)`` is ~free when no trace is active (one contextvar read,
  no allocation).
- Spans cap their direct children (`_MAX_CHILDREN`) so a 10k-tile scan
  can't balloon a trace; truncation is visible (``children_truncated``
  on the parent).
- Worker threads do not inherit contextvars.  The engine opens spans on
  the calling thread only: a span reached on the tile prefetcher or on
  the micro-batcher's dispatch thread finds no trace and is a no-op, so
  a fused dispatch never records one request's spans under another's
  trace.  A thread acting for a traced request may re-enter it with
  ``attach(trace, span)``.
- No span waits on the device: a span's time is the host's, and device
  work shows in the first span that waits for it (``transfer``, the
  device-to-host copy).

Completed traces land in a bounded in-process ring
(``trace_ring_entries``); any trace slower than ``slow_query_ms`` is
ALSO kept in a separate slow-query ring so one burst of fast queries
can't wash an outlier out of the evidence.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
from snappydata_tpu_torch.utils import locks
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

from snappydata_tpu_torch import config

# children per span beyond which further same-level spans collapse into
# a truncation counter (a per-tile bind span tree must stay bounded)
_MAX_CHILDREN = 256

# trace ids: one random process prefix + a counter — uuid4 per trace
# costs ~4µs of urandom on every short serving request, and ids only
# need to be unique across the processes sharing a monitoring surface
_ID_PREFIX = uuid.uuid4().hex[:8]
_ID_COUNTER = itertools.count(1)


class Span:
    """One timed phase. `attrs` carries the phase's evidence (batch
    counts, cache verdicts, member addresses); children nest."""

    __slots__ = ("name", "attrs", "children", "_t0", "duration_s")

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.attrs: dict = attrs or {}
        self.children: List["Span"] = []
        self._t0 = time.perf_counter()
        self.duration_s: Optional[float] = None

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def add(self, key: str, value) -> None:
        self.attrs[key] = self.attrs.get(key, 0) + value

    def close(self) -> None:
        if self.duration_s is None:
            self.duration_s = time.perf_counter() - self._t0

    def to_dict(self) -> dict:
        out = {"name": self.name,
               "ms": round((self.duration_s or 0.0) * 1e3, 4)}
        if self.attrs:
            # defensive copy: a straggling worker (a losing hedge leg)
            # may still be inserting attrs while the ring serializes —
            # retry the copy through the resize, degrade rather than
            # let a RuntimeError escape into the REST handler
            for _ in range(4):
                try:
                    out["attrs"] = dict(self.attrs)
                    break
                except RuntimeError:
                    continue
            else:
                out["attrs"] = {"attrs_unstable": True}
        if self.children:
            out["children"] = [c.to_dict() for c in list(self.children)]
        return out


class Trace:
    """One request's span tree plus its identity (trace id, sql, user,
    kind, origin). `kind` names the front door that minted it —
    session | client | lead | server | rest | job | explain."""

    __slots__ = ("trace_id", "sql", "user", "kind", "origin", "ts",
                 "root", "status", "error", "duration_s")

    def __init__(self, sql: str, user: str, kind: str,
                 trace_id: Optional[str] = None,
                 origin: Optional[str] = None):
        self.trace_id = trace_id or \
            f"{_ID_PREFIX}{next(_ID_COUNTER):08x}"
        # truncate at construction: the ring retains up to
        # trace_ring_entries+SLOW_ENTRIES traces, and a bulk INSERT's
        # multi-MB literal list must not pin memory until eviction
        # (summaries cap at 200 chars anyway; 2000 keeps detail useful)
        self.sql = sql if len(sql) <= 2000 else sql[:2000] + "…"
        self.user = user
        self.kind = kind
        self.origin = origin
        self.ts = time.time()
        self.root = Span("request")
        self.status = "ok"
        self.error: Optional[str] = None
        self.duration_s: Optional[float] = None

    def finish(self) -> None:
        self.root.close()
        self.duration_s = self.root.duration_s

    def span_count(self) -> int:
        n = 0
        stack = [self.root]
        while stack:
            sp = stack.pop()
            n += 1
            stack.extend(sp.children)
        return n

    def phase_seconds(self) -> Dict[str, float]:
        """Total seconds per span NAME across the whole tree — the
        per-phase breakdown EXPLAIN ANALYZE and bench.py report.  Spans
        still open (crashed mid-phase) are skipped."""
        out: Dict[str, float] = {}
        stack = list(self.root.children)
        while stack:
            sp = stack.pop()
            if sp.duration_s is not None:
                out[sp.name] = out.get(sp.name, 0.0) + sp.duration_s
            stack.extend(sp.children)
        return out

    def summary(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "kind": self.kind,
            "origin": self.origin,
            "sql": (self.sql or "")[:200],
            "user": self.user,
            "ts": self.ts,
            "ms": round((self.duration_s or 0.0) * 1e3, 3),
            "status": self.status,
            "error": self.error,
            "spans": self.span_count() - 1,
        }

    def to_dict(self) -> dict:
        out = self.summary()
        out["root"] = self.root.to_dict()
        out["phases_ms"] = {k: round(v * 1e3, 4)
                            for k, v in sorted(self.phase_seconds().items())}
        return out


# -----------------------------------------------------------------------
# ambient trace/span (contextvars; threads re-enter via attach())
# -----------------------------------------------------------------------

_trace: contextvars.ContextVar = contextvars.ContextVar(
    "snappy_trace", default=None)
_span: contextvars.ContextVar = contextvars.ContextVar(
    "snappy_trace_span", default=None)


def enabled() -> bool:
    return bool(config.global_properties().tracing_enabled)


def current() -> Optional[Trace]:
    return _trace.get()


def current_span() -> Optional[Span]:
    return _span.get()


def current_trace_id() -> Optional[str]:
    tr = _trace.get()
    return tr.trace_id if tr is not None else None


def wire_id() -> Optional[str]:
    """The trace id to ship in a request body/ticket, or None (no
    active trace).  Kept as its own helper so call sites read as wire
    propagation, not introspection."""
    return current_trace_id()


class request_scope:
    """Mint (or join) the request's trace.  An ambient trace absorbs
    the scope (nested executions stay one tree); otherwise a new trace
    starts when tracing is enabled (or `force`, which EXPLAIN ANALYZE
    uses so it works with tracing off).  On exit the trace finalizes
    into the ring + slow-query log.  Enters to the active Trace or
    None.  Class-based CM: the @contextmanager generator machinery cost
    ~4µs per request on the serving point-lookup profile."""

    __slots__ = ("sql", "user", "kind", "trace_id", "origin", "force",
                 "_tr", "_tok_t", "_tok_s")

    def __init__(self, sql: str = "", user: str = "",
                 kind: str = "session", trace_id: Optional[str] = None,
                 origin: Optional[str] = None, force: bool = False):
        self.sql = sql
        self.user = user
        self.kind = kind
        self.trace_id = trace_id
        self.origin = origin
        self.force = force
        self._tr = None

    def __enter__(self):
        ambient = _trace.get()
        if ambient is not None:
            return ambient
        if not (self.force or enabled()):
            return None
        tr = Trace(self.sql, self.user, self.kind,
                   trace_id=self.trace_id, origin=self.origin)
        self._tr = tr
        self._tok_t = _trace.set(tr)
        self._tok_s = _span.set(tr.root)
        return tr

    def __exit__(self, et, ev, tb):
        tr = self._tr
        if tr is None:
            return False
        if et is not None:
            tr.status = "error"
            tr.error = f"{et.__name__}: {ev}"[:300]
        _span.reset(self._tok_s)
        _trace.reset(self._tok_t)
        tr.finish()
        _RING.record(tr)
        return False


class _NoopSpan:
    __slots__ = ()

    def set(self, key, value):
        pass

    def add(self, key, value):
        pass


_NOOP = _NoopSpan()


class span:
    """A timed child span of the current span — a no-op (one contextvar
    read, no allocation) when no trace is active.  Enters to the span
    so callers can `.set()` evidence on it."""

    __slots__ = ("name", "attrs", "_sp", "_tok")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._sp = None

    def __enter__(self):
        parent = _span.get()
        if parent is None:
            return _NOOP
        if len(parent.children) >= _MAX_CHILDREN:
            parent.attrs["children_truncated"] = \
                parent.attrs.get("children_truncated", 0) + 1
            return _NOOP
        sp = Span(self.name, self.attrs or None)
        parent.children.append(sp)
        self._sp = sp
        self._tok = _span.set(sp)
        return sp

    def __exit__(self, et, ev, tb):
        sp = self._sp
        if sp is not None:
            _span.reset(self._tok)
            sp.close()
        return False


def annotate(key: str, value) -> None:
    """Attach evidence to the CURRENT span (no-op untraced)."""
    sp = _span.get()
    if sp is not None:
        sp.attrs[key] = value


@contextlib.contextmanager
def attach(trace: Optional[Trace], at_span: Optional[Span] = None):
    """Re-enter a trace from a worker thread (contextvars do not cross
    threads).  Spans opened under it append to `at_span` (default: the
    trace root); list append is GIL-atomic, so concurrent workers may
    share a parent.  A trace that already FINISHED (the primary won and
    the request returned while this worker — a losing hedge leg — was
    still running) is not re-entered: its tree is published to the ring
    and must stop changing."""
    if trace is None or trace.duration_s is not None:
        yield
        return
    tok_t = _trace.set(trace)
    tok_s = _span.set(at_span or trace.root)
    try:
        yield
    finally:
        _span.reset(tok_s)
        _trace.reset(tok_t)


@contextlib.contextmanager
def attach_or_detach(trace: Optional[Trace], at_span: Optional[Span] = None):
    """Run the enclosed work for `trace`: re-enter it as `attach` does,
    or, when `trace` is None, with no trace at all (a thread serving
    another request's work must not record it under its own trace)."""
    if trace is not None:
        with attach(trace, at_span):
            yield
        return
    tok_t = _trace.set(None)
    tok_s = _span.set(None)
    try:
        yield
    finally:
        _span.reset(tok_s)
        _trace.reset(tok_t)


# -----------------------------------------------------------------------
# completed-trace ring + slow-query log
# -----------------------------------------------------------------------

class TraceRing:
    """Bounded ring of completed traces plus the separate slow-query
    ring (`slow_query_ms`) — a burst of fast queries can't evict the
    over-threshold outlier an operator is hunting."""

    SLOW_ENTRIES = 64

    def __init__(self):
        self._lock = locks.named_lock("tracing.rings")
        self._ring: "deque[Trace]" = deque()
        self._slow: "deque[Trace]" = deque(maxlen=self.SLOW_ENTRIES)
        self.recorded = 0
        self.slow_recorded = 0

    def record(self, trace: Trace) -> None:
        props = config.global_properties()
        cap = max(1, int(props.trace_ring_entries or 1))
        slow_ms = float(props.slow_query_ms or 0.0)
        is_slow = slow_ms > 0 and (trace.duration_s or 0.0) * 1e3 >= slow_ms
        with self._lock:
            self._ring.append(trace)
            while len(self._ring) > cap:
                self._ring.popleft()
            self.recorded += 1
            if is_slow:
                self._slow.append(trace)
                self.slow_recorded += 1
        if is_slow:
            from snappydata_tpu_torch.observability.metrics import global_registry

            global_registry().inc("slow_queries")

    def traces(self, limit: int = 50) -> List[dict]:
        with self._lock:
            items = list(self._ring)[-max(1, limit):]
        return [t.summary() for t in reversed(items)]

    def get(self, trace_id: str) -> List[dict]:
        """Every local trace carrying `trace_id` (a distributed query
        in one process — the test cluster — may record a lead trace AND
        per-server traces under one id), full span trees."""
        with self._lock:
            items = [t for t in self._ring if t.trace_id == trace_id]
        return [t.to_dict() for t in items]

    def slow(self) -> List[dict]:
        with self._lock:
            items = list(self._slow)
        return [t.to_dict() for t in reversed(items)]

    def last(self) -> Optional[Trace]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slow.clear()


_RING = TraceRing()


def ring() -> TraceRing:
    return _RING


def tracing_snapshot() -> dict:
    """Knobs + ring state for `GET /status/api/v1/traces` and the
    dashboard's Tracing section."""
    props = config.global_properties()
    r = _RING
    with r._lock:
        held = len(r._ring)
        slow_held = len(r._slow)
    return {
        "tracing_enabled": bool(props.tracing_enabled),
        "trace_ring_entries": int(props.trace_ring_entries),
        "slow_query_ms": float(props.slow_query_ms or 0.0),
        "traces_recorded": r.recorded,
        "traces_held": held,
        "slow_queries_recorded": r.slow_recorded,
        "slow_queries_held": slow_held,
    }
