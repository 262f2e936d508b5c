"""Named locks + an opt-in runtime lockdep witness.

Every lock in the engine is created through ``named_lock`` /
``named_rlock`` / ``named_condition`` so that (a) the static analyzer in
``tools/locklint`` can resolve each acquisition site to a stable,
human-reviewed name, and (b) an opt-in runtime witness
(``SNAPPY_TPU_LOCKDEP=1``, or ``enable()`` before the locks are built)
can track each thread's held-lock stack, accumulate the observed
acquisition-order graph across a whole test run, and fail FAST — with
both acquisition stacks — the moment an acquisition would close a
cycle, instead of letting two threads deadlock silently.

Names are lock CLASSES, not instances (lockdep's hash classes): every
per-table ``storage.column_table`` lock shares one name. Acquiring two
instances of the same class while one is held does not record an edge —
an instance-level order inside one class is the class's own documented
business (see LOCK_ORDER.md "self nesting").

When the witness is disabled (the default), the constructors return the
plain ``threading`` primitives — zero wrapper overhead on hot paths
(the metrics registry lock is taken per counter increment). Enablement
is therefore decided at LOCK CREATION time: set the env var, or call
``enable()`` before the process builds its sessions/stores (the test
conftest does this at import).
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple


class LockdepViolation(RuntimeError):
    """An acquisition would close a cycle in the observed lock-order
    graph (potential ABBA deadlock). Raised in the acquiring thread
    BEFORE it blocks on the lock, and recorded on the global state so a
    session-end check catches it even if the thread swallowed it."""


class _State:
    """Process-wide witness state. Its own lock (`_g`) is internal
    plumbing and deliberately NOT part of the witnessed graph — it is a
    leaf acquired only inside the witness itself, never while calling
    out."""

    def __init__(self) -> None:
        self.enabled = False
        # locklint: unnamed-lock witness-internal: the graph lock cannot
        # itself be witnessed (infinite regress); it is a leaf held only
        # inside this module, never while calling out
        self._g = threading.Lock()
        # (held_name, acquired_name) -> (held_stack, acquire_stack)
        # captured at FIRST observation — the evidence pair a cycle
        # report prints for the reverse direction.
        self.edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self.adj: Dict[str, Set[str]] = {}
        self.violations: List[str] = []
        self.names_seen: Set[str] = set()

    def reset(self) -> None:
        with self._g:
            self.edges.clear()
            self.adj.clear()
            self.violations.clear()
            self.names_seen.clear()


_state = _State()
_tls = threading.local()


def _held_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def enabled() -> bool:
    return _state.enabled


def enable() -> None:
    """Turn the witness on for locks created AFTER this call."""
    _state.enabled = True


def disable() -> None:
    _state.enabled = False


def reset() -> None:
    """Drop the accumulated graph + violations (test isolation)."""
    _state.reset()


def snapshot_state():
    """Copy of the witness state, for save/restore around tests that
    deliberately create violations — a global reset() would also wipe
    the real edges/violations a lockdep-enabled SESSION accumulated,
    blinding the conftest end-of-run check."""
    with _state._g:
        return (dict(_state.edges),
                {k: set(v) for k, v in _state.adj.items()},
                list(_state.violations),
                set(_state.names_seen))


def restore_state(snap) -> None:
    edges, adj, violations, names = snap
    with _state._g:
        _state.edges = dict(edges)
        _state.adj = {k: set(v) for k, v in adj.items()}
        _state.violations = list(violations)
        _state.names_seen = set(names)


def violations() -> List[str]:
    with _state._g:
        return list(_state.violations)


def observed_edges() -> Set[Tuple[str, str]]:
    with _state._g:
        return set(_state.edges.keys())


def observed_names() -> Set[str]:
    with _state._g:
        return set(_state.names_seen)


def _fmt_stack(skip: int = 3, limit: int = 14) -> str:
    frames = traceback.extract_stack()[:-skip]
    return "".join(traceback.format_list(frames[-limit:]))


def _path_exists(src: str, dst: str) -> Optional[List[str]]:
    """DFS over the observed graph; returns a src→dst name path or None.
    Caller holds _state._g."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _state.adj.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _before_acquire(lock: "_DepLockBase") -> None:
    held = _held_stack()
    for ent in held:
        if ent[0] is lock:
            if not lock.reentrant:
                # same-thread re-acquire of a plain Lock: guaranteed
                # self-deadlock (the PR 10 gauge shape) — report it
                # instead of hanging
                stack = _fmt_stack()
                msg = (
                    "lockdep: thread re-acquires non-reentrant lock '%s' "
                    "it already holds — guaranteed self-deadlock\n%s"
                    % (lock.name, stack))
                with _state._g:
                    _state.violations.append(msg)
                raise LockdepViolation(msg)
            ent[2] += 1             # reentrant re-acquire (RLock)
            return
    name = lock.name
    acquire_stack = None
    with _state._g:
        _state.names_seen.add(name)
        for obj, held_name, _n in held:
            if held_name == name:
                continue            # same lock class: self-nesting
            key = (held_name, name)
            if key in _state.edges:
                continue
            cyc = _path_exists(name, held_name)
            if cyc is not None:
                if acquire_stack is None:
                    acquire_stack = _fmt_stack()
                # evidence for the reverse direction: the first edge on
                # the name→…→held_name path, with the stacks captured
                # when it was first observed
                rev = (cyc[0], cyc[1])
                rheld, racq = _state.edges.get(rev, ("<unknown>", "<unknown>"))
                msg = (
                    "lockdep: acquiring '%s' while holding '%s' closes the "
                    "cycle %s\n--- this thread (holding '%s', acquiring "
                    "'%s'):\n%s--- reverse edge '%s' -> '%s' first observed "
                    "while holding:\n%s--- acquiring:\n%s"
                    % (name, held_name, " -> ".join(cyc + [name]), held_name,
                       name, acquire_stack, rev[0], rev[1], rheld, racq)
                )
                _state.violations.append(msg)
                raise LockdepViolation(msg)
            if acquire_stack is None:
                acquire_stack = _fmt_stack()
            held_stack = "".join(
                "  held: %s\n" % h for _o, h, _c in held)
            _state.edges[key] = (held_stack, acquire_stack)
            _state.adj.setdefault(held_name, set()).add(name)
    held.append([lock, name, 1])


def _after_acquire_failed(lock: "_DepLockBase") -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            held[i][2] -= 1
            if held[i][2] == 0:
                del held[i]
            return


def _after_release(lock: "_DepLockBase") -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            held[i][2] -= 1
            if held[i][2] == 0:
                del held[i]
            return


class _DepLockBase:
    __slots__ = ("_lock", "name", "reentrant")

    def __init__(self, name: str, lock, reentrant: bool = False) -> None:
        self._lock = lock
        self.name = name
        self.reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _before_acquire(self)
        # locklint: unresolved-acquisition witness-internal: self._lock
        # is the wrapped primitive itself — its name is self.name
        ok = self._lock.acquire(blocking, timeout)
        if not ok:
            _after_acquire_failed(self)
        return ok

    def release(self) -> None:
        self._lock.release()
        _after_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()

    # threading.Condition(lock) integration: it probes these when the
    # caller supplies the lock object.
    def _is_owned(self) -> bool:
        for obj, _n, _c in _held_stack():
            if obj is self:
                return True
        return False

    def _release_save(self):
        # Condition.wait() releases the lock FULLY (all reentrant
        # counts); drop the whole held entry and remember its count.
        if hasattr(self._lock, "_release_save"):
            st = self._lock._release_save()
        else:
            self._lock.release()
            st = None
        held = _held_stack()
        count = 1
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                count = held[i][2]
                del held[i]
                break
        return (st, count)

    def _acquire_restore(self, state) -> None:
        st, count = state
        _before_acquire(self)
        try:
            if hasattr(self._lock, "_acquire_restore"):
                self._lock._acquire_restore(st)
            else:
                # locklint: unresolved-acquisition witness-internal (the
                # wrapped primitive; named by self.name)
                self._lock.acquire()
        except BaseException:
            _after_acquire_failed(self)
            raise
        held = _held_stack()
        for ent in held:
            if ent[0] is self:
                ent[2] = count
                break


class _DepLock(_DepLockBase):
    __slots__ = ()


class _DepRLock(_DepLockBase):
    __slots__ = ()


def named_lock(name: str):
    """A mutex named `name` (a lock CLASS name from LOCK_ORDER.md).
    Plain threading.Lock when the witness is off."""
    if not _state.enabled:
        return threading.Lock()
    return _DepLock(name, threading.Lock())


def named_rlock(name: str):
    if not _state.enabled:
        return threading.RLock()
    return _DepRLock(name, threading.RLock(), reentrant=True)


def named_condition(name: str, lock=None):
    """A condition variable over `lock` (or a fresh named lock). Waits
    release the underlying lock, so the witness pops/repushes the held
    entry across the wait exactly like a release/acquire pair."""
    if lock is None:
        lock = named_rlock(name)
    return threading.Condition(lock)


def assert_subgraph(allowed, *, allow_names=None) -> List[str]:
    """Return the observed edges NOT covered by `allowed` — a callable
    (a, b) -> bool, normally `Manifest.allows` from tools.locklint.
    Used by the conftest session-end check: the graph the run actually
    exercised must be a subgraph of the declared hierarchy."""
    bad = []
    for a, b in sorted(observed_edges()):
        try:
            ok = allowed(a, b)
        except Exception:
            ok = False
        if not ok:
            bad.append("undeclared observed lock-order edge: %s -> %s" % (a, b))
    return bad


if os.environ.get("SNAPPY_TPU_LOCKDEP", "").strip() in ("1", "true", "on"):
    enable()
