"""End-to-end request reliability primitives: deadlines + idempotent
mutation retry (port of snappydata_tpu/reliability/__init__.py), shared
by the client, the Flight server and WAL recovery, plus the typed retry
contract (`is_retryable`) the client's callers rely on.

Reference: the SnappyData thrift/JDBC layer carries a per-statement
query timeout that cancels server-side work (`queryTimeout` on
StatementAttrs, SnappyDataService.thrift) and its drivers retry
failover transparently against the locator's member view — but a
mutation whose ack was lost could not be blindly re-sent.  The two
pieces here close both gaps for this engine:

- ``deadline_scope`` / ``current_deadline`` / ``remaining``: one
  per-request ABSOLUTE deadline (``time.monotonic`` domain) riding a
  contextvar, so every layer sees the same budget shrink — the lead's
  fan-out loop checks it between failover attempts, ``SnappyClient``
  turns the remainder into a Flight call-option timeout (client-side
  enforcement: a hung member cannot hold the caller) AND ships it in
  the request body (server-side enforcement: the remote QueryContext
  stops work cooperatively when the caller has given up).

- ``MutationDedup``: a server-side at-most-once window keyed on
  client-stamped statement ids.  A mutation whose response is lost in
  flight is safe to re-send: the server remembers (id → result) and a
  retry returns the recorded result without re-applying.  The ids ride
  the WAL record headers (``stmt_scope`` threads them into
  ``wal_append``), so crash-recovery replay repopulates the window and
  a retry that races a server restart still dedups.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from snappydata_tpu_torch.utils import locks
import time
from collections import OrderedDict
from typing import Optional

# -----------------------------------------------------------------------
# per-request deadline (time.monotonic domain)
# -----------------------------------------------------------------------

_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "snappy_request_deadline", default=None)


def current_deadline() -> Optional[float]:
    """The ambient absolute deadline (monotonic seconds), or None."""
    return _deadline.get()


def remaining() -> Optional[float]:
    """Seconds left on the ambient deadline — None when no deadline is
    set; may be <= 0 when it already expired (callers decide whether to
    raise or clamp)."""
    d = _deadline.get()
    if d is None:
        return None
    return d - time.monotonic()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[float]):
    """Install `deadline` (absolute monotonic, or None) for the scope.
    Threads do NOT inherit contextvars — a worker acting on behalf of a
    deadlined request must re-enter the scope with the captured value
    (the hedged-read threads in cluster/distributed.py do)."""
    tok = _deadline.set(deadline)
    try:
        yield
    finally:
        _deadline.reset(tok)


# -----------------------------------------------------------------------
# client-stamped statement ids (the WAL threading seam)
# -----------------------------------------------------------------------

_stmt_id: contextvars.ContextVar = contextvars.ContextVar(
    "snappy_stmt_id", default=None)


def current_stmt_id() -> Optional[str]:
    return _stmt_id.get()


@contextlib.contextmanager
def stmt_scope(stmt_id: Optional[str]):
    """Carry the client's statement id down to ``wal_append`` so the
    journal record persists it (recovery replay re-seeds the dedup
    window from these headers)."""
    tok = _stmt_id.set(stmt_id)
    try:
        yield
    finally:
        _stmt_id.reset(tok)


# -----------------------------------------------------------------------
# server-side at-most-once mutation window
# -----------------------------------------------------------------------

class MutationDedup:
    """Bounded (id → recorded result) window with in-flight tracking.

    ``begin(sid)`` returns the recorded result for an id already seen
    (the retry path — caller must NOT re-apply), blocks briefly when the
    ORIGINAL request is still executing (a retry racing its own first
    attempt waits for the recorded result instead of double-applying),
    and returns None when the id is fresh — the caller executes and must
    then ``commit`` (success) or ``abort`` (failed before applying, so a
    retry may execute)."""

    def __init__(self, max_entries: int = 8192):
        self.max_entries = max(16, int(max_entries))
        self._done: "OrderedDict[str, dict]" = OrderedDict()
        self._pending: dict = {}       # sid -> threading.Event
        self._lock = locks.named_lock("reliability.dedup")

    def begin(self, sid: str, wait_s: float = 60.0) -> Optional[dict]:
        deadline = time.monotonic() + wait_s
        while True:
            with self._lock:
                if sid in self._done:
                    self._done.move_to_end(sid)
                    return self._done[sid]
                ev = self._pending.get(sid)
                if ev is None:
                    self._pending[sid] = threading.Event()
                    return None
            # the original attempt is mid-flight: wait it out, then
            # re-check (either its result landed, or its abort freed
            # the id for this retry to execute)
            ev.wait(timeout=max(0.0, deadline - time.monotonic()))
            if time.monotonic() >= deadline:
                # pathological wedge (original hung forever): fail the
                # retry loudly rather than risk a double-apply
                raise TimeoutError(
                    f"statement {sid} still executing after {wait_s}s; "
                    f"retry refused (double-apply guard)")

    def commit(self, sid: str, payload: dict) -> None:
        with self._lock:
            self._done[sid] = payload
            self._done.move_to_end(sid)
            while len(self._done) > self.max_entries:
                self._done.popitem(last=False)
            ev = self._pending.pop(sid, None)
        if ev is not None:
            ev.set()

    def abort(self, sid: str) -> None:
        """The attempt failed BEFORE applying — release the id so a
        retry may execute it for real."""
        with self._lock:
            ev = self._pending.pop(sid, None)
        if ev is not None:
            ev.set()

    def record(self, sid: str, payload: dict) -> None:
        """Recovery-replay path: seed the window directly (the record
        provably applied — it came out of the WAL)."""
        self.commit(sid, payload)

    def __len__(self) -> int:
        with self._lock:
            return len(self._done)


_DEDUP_LOCK = locks.named_lock("reliability.dedup_registry")


def dedup_for(catalog) -> MutationDedup:
    """Per-catalog window (shared across the `for_user` per-request
    sessions of one server, like the plan cache)."""
    d = getattr(catalog, "_mutation_dedup", None)
    if d is None:
        with _DEDUP_LOCK:
            d = getattr(catalog, "_mutation_dedup", None)
            if d is None:
                from snappydata_tpu_torch import config

                d = MutationDedup(int(
                    config.global_properties().mutation_dedup_entries))
                catalog._mutation_dedup = d
    return d


# -----------------------------------------------------------------------
# the typed retryable contract
# -----------------------------------------------------------------------

def is_retryable(exc: BaseException) -> bool:
    """The error contract clients can rely on: True means the request
    may be safely re-issued (connection-shaped failures; mutations are
    covered by the dedup window), False means retrying is wrong or
    pointless — a deadline expiry (XCL52 CancelException: the caller
    gave up), an application error, or an auth failure."""
    from snappydata_tpu_torch.resource.context import CancelException

    if isinstance(exc, CancelException):
        return False
    try:
        import pyarrow.flight as _flight

        if isinstance(exc, _flight.FlightTimedOutError):
            return False
        if isinstance(exc, (_flight.FlightUnavailableError,)):
            return True
        if isinstance(exc, _flight.FlightCancelledError):
            # a transport-level CANCELLED from the SERVER side (hard
            # kill mid-stream: "Server never sent a data message") is a
            # connection-shaped death, safe to re-issue — deadline
            # cancellations never reach here raw, they convert to
            # CancelException (XCL52, handled above) first
            return True
    except ImportError:          # pragma: no cover - pyarrow is baked in
        pass
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    # disk-tier EIO (memmap page-in / tier-file read): transient device
    # errors are re-issuable — the tier layer already does one bounded
    # re-read before giving up (tier_read_retries); a retry at statement
    # scope re-drives promotion, which quarantines + rebuilds on
    # persistent damage.  Same classification shape as the PR 9
    # FlightCancelledError fix: a connection/device-shaped death is
    # retryable, a semantic failure is not.
    import errno as _errno

    if isinstance(exc, OSError) \
            and getattr(exc, "errno", None) == _errno.EIO:
        return True
    # DistributedError carries failover context — the lead already
    # retried internally; another round trip may still succeed
    from snappydata_tpu_torch.cluster.distributed import DistributedError

    return isinstance(exc, DistributedError)
