"""Per-query execution context: id, deadline, budget, cancel flag.

Port of snappydata_tpu/resource/context.py.  SnappyData cancels running
statements mid-scan through `CancelException` checks inside its generated
scan loops, and rejects new work with `LowMemoryException` when
`critical-heap-percentage` is crossed (SnappyUnifiedMemoryManager.scala:
379-401).  The port threads a `QueryContext` through the session ->
executor -> host-eval layers; cooperative checks at plan, batch and tile
boundaries make `cancel(<id>)`, statement timeouts and broker kills take
effect within one tile of the signal.  One tile's launches are the atomic
unit of work, as one generated-code batch loop is in the reference.

A `CancelException` raised inside a traced request carries its trace id.
A remote caller's remaining budget becomes the context's deadline
(`set_deadline_in`): the Flight and REST front doors arm it before they
hand the context to `sql()` / `serving_sql()`.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import time
import uuid
from typing import Optional

# query ids: one random process prefix and a counter (unique across
# processes that share a monitoring surface, cheap per query)
_ID_PREFIX = uuid.uuid4().hex[:6]
_ID_COUNTER = itertools.count(1)


class LowMemoryException(MemoryError):
    """Admission rejected: the query's memory estimate does not fit the
    configured budget (ref: GemFireXD LowMemoryException, surfaced to
    clients as SQLSTATE XCL54 'query cancelled due to low memory')."""

    sqlstate = "XCL54"

    def __init__(self, msg: str):
        super().__init__(f"[{self.sqlstate}] {msg}")


class CancelException(RuntimeError):
    """Query stopped cooperatively: an explicit cancel, a statement
    timeout, or a broker kill under memory pressure (ref: Derby/GemFireXD
    SQLSTATE XCL52 'statement cancelled or timed out').  `trace_id` (when
    the request was traced) joins this failure to its trace in the
    ring."""

    sqlstate = "XCL52"

    def __init__(self, msg: str):
        from snappydata_tpu_torch.observability import tracing  # cold path

        self.trace_id = tracing.current_trace_id()
        suffix = f" [trace {self.trace_id}]" if self.trace_id else ""
        super().__init__(f"[{self.sqlstate}] {msg}{suffix}")


class QueryContext:
    """One query's governor state.  Created per top-level statement;
    nested executions (tile partials, subquery rewrites, the tiled-merge
    scratch session) inherit it through the contextvar below."""

    __slots__ = ("query_id", "sql", "user", "submitted_ts", "started_ts",
                 "deadline", "estimate_bytes", "state", "cancel_reason",
                 "_cancelled", "_timeout_counted")

    def __init__(self, sql: str = "", user: str = "admin"):
        self.query_id = f"{_ID_PREFIX}{next(_ID_COUNTER):06x}"
        self.sql = sql
        self.user = user
        self.submitted_ts = time.time()
        self.started_ts: Optional[float] = None
        self.deadline: Optional[float] = None   # time.monotonic() domain
        self.estimate_bytes = 0
        self.state = "created"   # created | queued | running | finished
        self.cancel_reason: Optional[str] = None
        # a plain bool: writes are GIL-atomic and nothing waits on it
        self._cancelled = False
        self._timeout_counted = False

    # -- cancellation ---------------------------------------------------

    def cancel(self, reason: str = "cancelled") -> None:
        if not self._cancelled:
            self.cancel_reason = reason
            self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def start(self, timeout_s: float = 0.0) -> None:
        self.started_ts = time.time()
        self.state = "running"
        # a deadline set at SUBMISSION (the timeout covers queue time) is
        # never extended here
        if self.deadline is None and timeout_s and timeout_s > 0:
            self.deadline = time.monotonic() + float(timeout_s)

    def set_deadline_in(self, budget_s: float) -> None:
        """Arm the deadline `budget_s` seconds from now: deadline
        propagation, so the cooperative checks stop server-side work when
        the remote caller has already given up."""
        if budget_s and budget_s > 0:
            self.deadline = time.monotonic() + float(budget_s)

    def remaining_s(self) -> Optional[float]:
        """Seconds left before the deadline (None = no deadline; negative
        when already expired)."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def check(self) -> None:
        """Cooperative checkpoint, called at plan, batch and tile
        boundaries: raises CancelException when this query was cancelled
        or ran past its deadline (a flag read and a clock read)."""
        if self._cancelled:
            raise CancelException(
                f"query {self.query_id} {self.cancel_reason or 'cancelled'}")
        if self.deadline is not None and time.monotonic() > self.deadline:
            self.cancel_reason = "timed out (query_timeout_s)"
            self._cancelled = True
            if not self._timeout_counted:
                self._timeout_counted = True
                from snappydata_tpu_torch.observability.metrics import \
                    global_registry

                global_registry().inc("governor_timeouts")
            raise CancelException(
                f"query {self.query_id} exceeded its statement timeout")

    def describe(self) -> dict:
        return {
            "id": self.query_id,
            "sql": self.sql,
            "user": self.user,
            "state": self.state,
            "estimate_bytes": int(self.estimate_bytes),
            "submitted_ts": self.submitted_ts,
            "elapsed_s": round(time.time() - self.submitted_ts, 3),
            "cancelled": self.cancelled,
            "cancel_reason": self.cancel_reason,
        }


_current_query: contextvars.ContextVar = contextvars.ContextVar(
    "snappy_query_context", default=None)


def current_query() -> Optional[QueryContext]:
    return _current_query.get()


def check_current() -> None:
    """Per-boundary checkpoint for code that may or may not run under a
    governed query: one contextvar read when ungoverned."""
    ctx = _current_query.get()
    if ctx is not None:
        ctx.check()


@contextlib.contextmanager
def query_scope(ctx: QueryContext):
    tok = _current_query.set(ctx)
    try:
        yield ctx
    finally:
        _current_query.reset(tok)


def new_query(sql: str = "", user: str = "admin") -> QueryContext:
    return QueryContext(sql, user)
