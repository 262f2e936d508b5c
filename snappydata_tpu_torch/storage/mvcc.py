"""MVCC snapshot-isolation epochs: versioned storage that decouples
scans from ingest.

Port of snappydata_tpu/storage/mvcc.py.  Batches are write-once,
mutations are delta'd, and every committed write publishes a fresh
immutable ``Manifest`` — so snapshot isolation is a thin layer:

- **Epoch clock**: a process-wide monotone counter.  Every manifest
  publish stamps the next epoch.

- **Pins**: a statement pins ONE consistent cross-table cut at its start
  (``pinned_scope``).  The cut is atomic — publishes swap their manifest
  under the same clock lock the pin capture holds — so a join over two
  tables never sees table A before a commit and table B after it.
  Tables the statement discovers later extend the pin at first read.
  Row tables, which mutate in place, are captured as host-array
  snapshots at first read (repeatable reads within the statement).

- **Reads**: every scan-shaped read goes through ``snapshot_of`` /
  ``row_snapshot_of`` — the device bind (`storage/device._scan_units`),
  the host fallback, join key encodes, subquery rewrites, CTAS sources
  and the tiled pass with its prefetch worker resolve the pinned
  manifest instead of the live one.

- **Retention**: a pinned manifest is kept alive by refcounts
  (``data._retained_epochs``); on top of pins a short unpinned history
  (``mvcc_retained_epochs``) is retained.  The device cache keeps the
  plates of every pinned version (``pinned_versions``).

DDL that would mutate state a pinned reader is traversing IN PLACE
(``DROP COLUMN`` remaps dictionaries and shifts ordinals) raises a typed
``SnapshotConflictError`` (SQLSTATE 40001) while pins are active;
TRUNCATE / ADD COLUMN / DROP TABLE bump the epoch cleanly — pinned
readers keep their immutable manifests.

- **Accounting**: the resource broker's ledger reads the host bytes
  retained epochs hold beyond the current manifest
  (``retained_epoch_bytes_by_table``), and its degradation ladder drops
  every unpinned one with its stale device plates (``trim_unpinned``).

- **Materialized views** (views/matview.py): a view's sync re-pins the
  base table at its current manifest (``SnapshotPin.repin`` / ``repin_row``)
  so base and view agree to the row within one statement, and the view's
  statement-private scratch tables read live (``unpinned_scope``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Tuple

import numpy as np

from snappydata_tpu_torch.utils import locks


class SnapshotConflictError(RuntimeError):
    """DDL raced an active pinned snapshot in a way MVCC cannot make safe
    (in-place dictionary remap / ordinal shift).  SQLSTATE 40001
    (serialization failure) — the client retries once readers drain."""

    sqlstate = "40001"

    def __init__(self, msg: str):
        super().__init__(f"{msg} [SQLSTATE {self.sqlstate}]")


# --------------------------------------------------------------------------
# epoch clock
# --------------------------------------------------------------------------

# One lock orders everything cheap: epoch bumps, manifest swaps
# (ColumnTableData._publish takes it around the reference swap), pin
# capture and retention refcounts.  Nothing slow ever runs under it.
_clock_lock = locks.named_rlock("mvcc.clock")
_epoch = [0]


def clock():
    """The shared epoch lock (context manager).  ``_publish`` swaps its
    manifest reference under it so pin captures are atomic cuts."""
    return _clock_lock


def current_epoch() -> int:
    return _epoch[0]


def _bump_epoch_locked() -> int:
    _epoch[0] += 1
    return _epoch[0]


def advance_to(seq: int) -> None:
    """Recovery: resume the clock past a checkpoint / WAL fence so
    post-recovery epochs stay monotone with pre-crash ones."""
    with _clock_lock:
        if int(seq) > _epoch[0]:
            _epoch[0] = int(seq)


# WAL seq of the committing statement, set by the session's journal paths
# (and WAL replay) around apply — ``_publish`` stamps it on the manifest
# as the commit timestamp.
_commit_seq: contextvars.ContextVar = contextvars.ContextVar(
    "mvcc_commit_seq", default=0)


@contextlib.contextmanager
def commit_scope(seq: int):
    tok = _commit_seq.set(int(seq))
    try:
        yield
    finally:
        _commit_seq.reset(tok)


def current_commit_seq() -> int:
    return _commit_seq.get()


def enabled() -> bool:
    from snappydata_tpu_torch import config

    return bool(config.global_properties().get("snapshot_isolation", True))


def _retain_cap() -> int:
    from snappydata_tpu_torch import config

    try:
        return max(0, int(config.global_properties().get(
            "mvcc_retained_epochs", 2)))
    except (TypeError, ValueError):
        return 2


def _reg():
    from snappydata_tpu_torch.observability.metrics import global_registry

    return global_registry()


# --------------------------------------------------------------------------
# publish-side hook (called by ColumnTableData._publish under clock())
# --------------------------------------------------------------------------

def retain_locked(data, old_manifest) -> None:
    """Move the just-superseded manifest into the table's retained-epoch
    list: pinned versions stay while any pin holds them, plus the most
    recent ``mvcc_retained_epochs`` unpinned ones.  Caller holds the
    clock lock."""
    retained = getattr(data, "_retained_epochs", None)
    if retained is None:
        retained = data._retained_epochs = {}
    retained[int(old_manifest.version)] = old_manifest
    _trim_retained_locked(data)


def _trim_retained_locked(data, keep_unpinned: Optional[int] = None
                          ) -> int:
    retained = getattr(data, "_retained_epochs", None)
    if not retained:
        return 0
    pins = getattr(data, "_pin_counts", {})
    cap = _retain_cap() if keep_unpinned is None else keep_unpinned
    unpinned = sorted(v for v in retained if v not in pins)
    dropped = 0
    for v in unpinned[:max(0, len(unpinned) - cap)]:
        retained.pop(v, None)
        dropped += 1
    return dropped


# --------------------------------------------------------------------------
# pin refcounts
# --------------------------------------------------------------------------

def _ref_locked(data, manifest) -> None:
    counts = getattr(data, "_pin_counts", None)
    if counts is None:
        counts = data._pin_counts = {}
    v = int(manifest.version)
    counts[v] = counts.get(v, 0) + 1
    retained = getattr(data, "_retained_epochs", None)
    if retained is None:
        retained = data._retained_epochs = {}
    retained.setdefault(v, manifest)


def _unref(data, manifest) -> None:
    with _clock_lock:
        counts = getattr(data, "_pin_counts", None)
        if not counts:
            return
        v = int(manifest.version)
        n = counts.get(v, 0) - 1
        if n > 0:
            counts[v] = n
            return
        counts.pop(v, None)
        # an unpinned retained epoch survives only inside the history cap
        _trim_retained_locked(data)


def _ref_row_locked(data, version: int) -> None:
    counts = getattr(data, "_row_pin_counts", None)
    if counts is None:
        counts = data._row_pin_counts = {}
    counts[int(version)] = counts.get(int(version), 0) + 1


def _unref_row(data, version: int) -> None:
    with _clock_lock:
        counts = getattr(data, "_row_pin_counts", None)
        if not counts:
            return
        v = int(version)
        n = counts.get(v, 0) - 1
        if n > 0:
            counts[v] = n
        else:
            counts.pop(v, None)
            # the shared host snapshot of a now-unpinned old version is
            # dead weight (the current version re-captures on demand)
            cache = getattr(data, "_row_snapshot_cache", None)
            if cache is not None and v != int(getattr(data, "version", v)):
                cache.pop(v, None)


def _captured_row_arrays(data) -> Tuple[list, list, int, int]:
    """(arrays, null masks, n, version): the host materialization of a
    row table at its current version, shared through a per-version cache
    on the data object, so a warm pinned bind pays no O(table) copy.
    Consumers treat captured arrays as read-only."""
    cache = getattr(data, "_row_snapshot_cache", None)
    if cache is None:
        cache = data._row_snapshot_cache = {}
    ver = int(data.version)
    got = cache.get(ver)
    if got is not None:
        return got[0], got[1], got[2], ver
    arrays, masks, n = data.to_arrays_with_nulls()
    if int(data.version) != ver:
        # a mutation raced the copy: serve it privately, never cache
        return arrays, masks, n, ver
    with _clock_lock:
        cache[ver] = (arrays, masks, n)
        pinned = getattr(data, "_row_pin_counts", {})
        for v in [v for v in cache if v != ver and v not in pinned]:
            cache.pop(v, None)
    return arrays, masks, n, ver


def pinned_versions(data) -> frozenset:
    """Manifest versions some active pin holds on `data` — the device
    cache must not prune their plates mid-scan."""
    counts = getattr(data, "_pin_counts", None)
    if not counts:
        return frozenset()
    with _clock_lock:
        return frozenset(counts)


def pinned_versions_peek(data):
    """LOCK-FREE best-effort read of `pinned_versions` for callers that
    hold a lock below the clock (the device-cache budget's eviction).
    None when the racing snapshot fails: treat it as "assume pinned"
    (a stale positive only delays one eviction)."""
    counts = getattr(data, "_pin_counts", None)
    if not counts:
        return frozenset()
    try:
        return frozenset(counts)
    except RuntimeError:   # dict mutated mid-iteration
        return None


def pinned_row_versions(data) -> frozenset:
    counts = getattr(data, "_row_pin_counts", None)
    if not counts:
        return frozenset()
    with _clock_lock:
        return frozenset(counts)


def has_pins(data) -> bool:
    return bool(getattr(data, "_pin_counts", None)) \
        or bool(getattr(data, "_row_pin_counts", None))


def _check_pins_locked(data, what: str) -> None:
    if has_pins(data):
        _reg().inc("mvcc_ddl_conflicts")
        raise SnapshotConflictError(
            f"{what} conflicts with an active pinned snapshot "
            f"(a concurrent query is reading this table); retry when "
            f"readers drain")


def check_ddl(data, what: str) -> None:
    """Early gate for DDL that mutates storage state IN PLACE: refuse
    with a typed retryable error while any pinned snapshot could be
    traversing the old layout.  The mutation itself runs under
    ``ddl_scope``, which re-checks AND blocks new pins for its
    duration."""
    with _clock_lock:
        _check_pins_locked(data, what)


def _ddl_gate_locked(data) -> None:
    """Pin-capture side of the DDL fence (caller holds the clock lock):
    refuse to pin a table whose in-place remap is mid-flight."""
    if getattr(data, "_ddl_in_progress", 0):
        _reg().inc("mvcc_ddl_conflicts")
        raise SnapshotConflictError(
            "query admission raced in-place DDL (ALTER TABLE DROP "
            "COLUMN) on this table; retry when it completes")


@contextlib.contextmanager
def ddl_scope(data, what: str):
    """Bracket an in-place DDL mutation: refuses (40001) while pins exist
    and blocks NEW pins until the mutation finishes.  The clock lock is
    held only for the entry / exit bookkeeping."""
    with _clock_lock:
        _check_pins_locked(data, what)
        data._ddl_in_progress = getattr(data, "_ddl_in_progress", 0) + 1
    try:
        yield
    finally:
        with _clock_lock:
            data._ddl_in_progress -= 1


# --------------------------------------------------------------------------
# the pin
# --------------------------------------------------------------------------

class SnapshotPin:
    """One statement's consistent cut: {table data -> pinned Manifest}
    (+ captured host snapshots for in-place row tables).  Extended at
    first read for tables the statement discovers late; released once at
    statement end."""

    __slots__ = ("epoch", "_manifests", "_rows", "_datas", "_lock",
                 "released")

    def __init__(self):
        self.epoch = current_epoch()
        self._manifests: Dict[int, object] = {}
        self._rows: Dict[int, tuple] = {}
        self._datas: Dict[int, object] = {}
        self._lock = locks.named_lock("mvcc.pin")
        self.released = False

    def pin_many(self, datas) -> None:
        """Atomic cross-table capture: all manifests read under ONE
        clock-lock hold, so no commit can interleave between tables."""
        with _clock_lock:
            if self.released:
                return
            for data in datas:
                _ddl_gate_locked(data)
            for data in datas:
                key = id(data)
                if key in self._manifests:
                    continue
                m = data._manifest
                self._manifests[key] = m
                self._datas[key] = data
                _ref_locked(data, m)

    def manifest_for(self, data):
        got = self._manifests.get(id(data))
        if got is not None:
            return got
        with _clock_lock:
            if self.released:
                # a straggler thread extending a released pin: serve the
                # live manifest and hold nothing
                return data._manifest
            got = self._manifests.get(id(data))
            if got is None:
                _ddl_gate_locked(data)
                got = data._manifest
                self._manifests[id(data)] = got
                self._datas[id(data)] = data
                _ref_locked(data, got)
        return got

    def repin(self, data):
        """Re-capture `data` at its CURRENT manifest.  Matview sync uses
        this (briefly under ``mutation_lock``) so the base table's pinned
        epoch lands exactly where the view's folded state is: base and
        view then agree to the row."""
        with _clock_lock:
            cur = data._manifest
            if self.released:
                return cur
            old = self._manifests.get(id(data))
            if old is cur:
                return cur
            self._manifests[id(data)] = cur
            self._datas[id(data)] = data
            _ref_locked(data, cur)
        if old is not None:
            _unref(data, old)
        _reg().inc("mvcc_repins")
        return cur

    def repin_row(self, data) -> None:
        """Drop the captured host snapshot of a ROW table, so the next
        read re-captures at the CURRENT version: the row-table analogue
        of ``repin`` (a matview refresh under ``mutation_lock`` uses it:
        the pin's earlier capture may predate the refresh fence)."""
        key = id(data)
        with self._lock:
            got = self._rows.pop(key, None)
        if got is not None:
            _unref_row(data, got[3])
            _reg().inc("mvcc_repins")

    def row_snapshot(self, data) -> tuple:
        key = id(data)
        got = self._rows.get(key)
        if got is not None:
            return got
        with _clock_lock:
            _ddl_gate_locked(data)
        arrays, masks, n, ver = _captured_row_arrays(data)
        with self._lock:
            if self.released:
                return (arrays, masks, n, ver)   # live read, hold nothing
            got = self._rows.get(key)
            if got is None:
                got = (arrays, masks, n, ver)
                self._rows[key] = got
                self._datas.setdefault(key, data)
                with _clock_lock:
                    _ref_row_locked(data, ver)
        return got

    def release(self) -> None:
        with self._lock, _clock_lock:
            if self.released:
                return
            self.released = True
            manifests = [(self._datas[k], m)
                         for k, m in self._manifests.items()]
            rows = [(self._datas[k], v[3]) for k, v in self._rows.items()]
            self._manifests.clear()
            self._rows.clear()
            self._datas.clear()
            _ACTIVE_PINS.discard(self)
        for data, m in manifests:
            _unref(data, m)
        for data, ver in rows:
            _unref_row(data, ver)
        _reg().inc("mvcc_pin_releases")


_pin_var: contextvars.ContextVar = contextvars.ContextVar(
    "mvcc_pin", default=None)
_ACTIVE_PINS: set = set()


def current_pin() -> Optional[SnapshotPin]:
    return _pin_var.get()


def active_pin_count() -> int:
    with _clock_lock:
        return len(_ACTIVE_PINS)


@contextlib.contextmanager
def pinned_scope(catalog, table_names=()):
    """Pin one consistent snapshot for the duration of a statement.
    No-op (yields the ambient pin) when nested — tile passes, matview
    syncs, subquery rewrites and scratch merges read the OUTER
    statement's epoch.  Matview backing tables are left out of the eager
    cut: sync() rewrites them under this very pin, and the query must
    read the post-sync rows (they pin at first read instead)."""
    ambient = _pin_var.get()
    if ambient is not None or not enabled():
        yield ambient
        return
    pin = SnapshotPin()
    datas = []
    seen = set()
    names = list(table_names or ())
    while names:
        nm = names.pop()
        low = str(nm).lower()
        if low in seen:
            continue
        seen.add(low)
        info = catalog.lookup_table(nm) if catalog is not None else None
        if info is None:
            # plain views: expand one level so the cut covers the tables
            # a later analysis touches
            view = catalog.lookup_view(nm) if catalog is not None else None
            if view is not None:
                try:
                    from snappydata_tpu_torch.session import \
                        _referenced_tables

                    names.extend(_referenced_tables(view))
                except Exception:
                    # widening is best effort: the table still pins at
                    # first read; count it so a broken expansion shows
                    _reg().inc("mvcc_cut_expand_errors")
            continue
        if info.options.get("materialized_view"):
            continue   # pinned at first read, AFTER sync rewrites it
        maints = getattr(catalog, "_sample_maintainers", None)
        if maints and info.name in maints:
            # sample tables rebuild lazily (truncate + re-insert from the
            # reservoir) inside the statement, like a matview sync: they
            # pin at first read, AFTER the refresh publishes
            continue
        if hasattr(info.data, "_manifest"):
            datas.append(info.data)
    try:
        pin.pin_many(datas)
    except SnapshotConflictError:
        pin.release()
        raise
    with _clock_lock:
        _ACTIVE_PINS.add(pin)
    _reg().inc("mvcc_pins")
    tok = _pin_var.set(pin)
    try:
        yield pin
    finally:
        _pin_var.reset(tok)
        pin.release()


@contextlib.contextmanager
def unpinned_scope():
    """Suspend the ambient pin for statement-PRIVATE storage: matview
    scratch tables (``__mv_delta`` / ``__mv_partials``) are truncated,
    re-filled and re-read many times within one outer statement, so
    capturing them into the outer cut would serve the first rewrite's
    manifest to every later read.  Reads inside resolve live manifests;
    the outer pin resumes on exit."""
    tok = _pin_var.set(None)
    try:
        yield
    finally:
        _pin_var.reset(tok)


# --------------------------------------------------------------------------
# pin-aware read helpers (the seam every scan-shaped read goes through)
# --------------------------------------------------------------------------

def snapshot_of(data):
    """The manifest a read of `data` should traverse: the ambient pin's
    (extending the pin at first read) or, unpinned, the live one."""
    pin = _pin_var.get()
    if pin is not None and hasattr(data, "_manifest"):
        return pin.manifest_for(data)
    return data.snapshot()


def row_snapshot_of(data) -> Tuple[list, list, int, int]:
    """(arrays, null masks, n, version) of a ROW table — the ambient
    pin's captured copy (repeatable reads: the table mutates in place)
    or a fresh read."""
    pin = _pin_var.get()
    if pin is not None:
        return pin.row_snapshot(data)
    arrays, masks, n = data.to_arrays_with_nulls()
    return arrays, masks, n, int(data.version)


# --------------------------------------------------------------------------
# retained-epoch accounting (resource broker ledger + degradation)
# --------------------------------------------------------------------------

def _arr_bytes(a) -> int:
    if a is None:
        return 0
    if isinstance(a, np.ndarray) and a.dtype == object:
        return 8 * a.size          # pointer estimate, like the host ledger
    return int(getattr(a, "nbytes", 0))


def _manifest_extra_bytes(m, cur) -> int:
    """Bytes a retained manifest holds beyond what the CURRENT one
    shares: its row-buffer snapshot copies plus the delete masks and
    update deltas of views that diverged.  Batch payloads are write-once
    and shared across manifests: never double counted."""
    total = sum(_arr_bytes(a) for a in m.row_arrays)
    total += sum(_arr_bytes(a) for a in (m.row_nulls or ()))
    cur_views = {v.batch.batch_id: v for v in cur.views} \
        if cur is not None else {}
    for v in m.views:
        cv = cur_views.get(v.batch.batch_id)
        if cv is v:
            continue
        if v.delete_mask is not None and (
                cv is None or cv.delete_mask is not v.delete_mask):
            total += _arr_bytes(v.delete_mask)
        cur_deltas = set(map(id, cv.deltas)) if cv is not None else set()
        for d in v.deltas:
            if id(d) not in cur_deltas:
                total += _arr_bytes(d[1]) + _arr_bytes(d[2]) \
                    + _arr_bytes(d[3])
    return total


def retained_bytes_of(data) -> int:
    retained = getattr(data, "_retained_epochs", None)
    if not retained:
        return 0
    cur = data._manifest
    with _clock_lock:
        items = [(v, m) for v, m in retained.items() if v != cur.version]
    return sum(_manifest_extra_bytes(m, cur) for _v, m in items)


def retained_epoch_bytes_by_table(tables) -> Dict[str, int]:
    """Per-table retained-epoch bytes for the broker ledger.  `tables`
    is an iterable of (name, data)."""
    out: Dict[str, int] = {}
    for name, data in tables:
        if not hasattr(data, "_manifest"):
            continue
        try:
            b = retained_bytes_of(data)
        except Exception:
            b = 0
        if b:
            out[name] = out.get(name, 0) + b
    return out


def retained_epochs_of(data) -> List[dict]:
    """Observability rows for one table's retained-epoch list."""
    retained = getattr(data, "_retained_epochs", None)
    if not retained:
        return []
    cur = data._manifest
    pins = getattr(data, "_pin_counts", {})
    with _clock_lock:
        items = sorted(retained.items())
    out = []
    for v, m in items:
        out.append({
            "version": v,
            "epoch": int(getattr(m, "epoch", 0)),
            "wal_seq": int(getattr(m, "wal_seq", 0)),
            "pins": int(pins.get(v, 0)),
            "current": v == cur.version,
            "bytes": 0 if v == cur.version
            else _manifest_extra_bytes(m, cur),
        })
    return out


def trim_unpinned(tables) -> int:
    """Degradation-ladder step: drop every retained epoch no pin holds
    (keeping only the current manifest) and the device-cache entries of
    versions that are neither pinned nor current.  Returns how many
    epochs and cache entries were trimmed."""
    from snappydata_tpu_torch.storage.device import _cache_budget

    trimmed = 0
    for _nm, data in tables:
        if not hasattr(data, "_manifest"):
            continue
        with _clock_lock:
            trimmed += _trim_retained_locked(data, keep_unpinned=0)
        pinned = pinned_versions(data)
        cache = getattr(data, "_device_cache", None)
        if cache:
            cur_ver = data._manifest.version
            for k in [k for k in list(cache)
                      if k[0] != cur_ver and k[0] not in pinned]:
                cache.pop(k, None)
                _cache_budget.forget(cache, k)
                trimmed += 1
    if trimmed:
        _reg().inc("mvcc_epoch_trims", trimmed)
    return trimmed
