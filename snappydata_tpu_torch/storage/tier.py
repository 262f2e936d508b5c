"""Three-tier memory hierarchy: device HBM -> host pool -> CRC-framed
disk-tier batch files.

Port of snappydata_tpu/storage/tier.py.  The encoded batches are the
at-rest form at every level: the device tier caches plates built from
them (storage/device.py), the host tier holds the encoded batch arrays
resident in RAM, and the disk tier frames those arrays, unmodified,
through the persistence layer's CRC-checked record format
(`persistence.frame_record` with codec="none", so the raw numeric parts
land at computable offsets and memmap straight back; a record framed by
either package reads in the other).  Reference: SnappyData's disk oplogs
spill column batches and fault them back on demand.

Demotion ladder (`demote`, a resource-broker degradation step):

  HBM -> host  drop cold device-cache entries; the encoded batches they
               were built from stay resident, so the plates rebuild on
               the next bind.  Entries of MVCC-pinned epochs and windows
               a live prefetch pass keeps are NEVER demoted
               (`tier_pinned_skips` counts the refusals).
  host -> disk frame the oldest batches' numeric arrays into one
               CRC-checksummed record per batch and replace them with
               memmap views of the raw parts: residency moves to the OS
               page cache, the device bind uploads from the mapping, and
               `promote_table` re-reads the whole record, CRC-verified.

Self-healing: a record that fails its CRC at promotion is quarantined
(renamed aside) and its batch rebuilt from a resident twin in a retained
MVCC epoch, else from an attached DiskStore's checkpointed batch file
(`DiskStore.load_batch`); with no source the failure is the typed
`TierQuarantinedError`.

`maybe_demote` enforces `tier_device_bytes` / `tier_host_bytes` after a
statement's read pin is released (the session's `_tier_enforce_pending`).
The HBM rung also trims the mesh lane's exchanged layouts
(engine/mesh_exec.py), which rebuild at their next bind.

Lock order: `storage.tier` serializes demotion and promotion and is held
ABOVE the broker registry lock, `mvcc.clock` (pin reads),
`storage.device_cache` (budget forgets), `storage.prefetch` (kept
windows) and `storage.column_table` (the framed spill's manifest swap).
`storage.tier_files` is a leaf: file-byte accounting, safe in finalizers.
"""

from __future__ import annotations

import atexit
import dataclasses
import itertools
import json
import logging
import os
import shutil
import struct
import tempfile
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from snappydata_tpu_torch.reliability import failpoints as rfail
from snappydata_tpu_torch.utils import locks

_log = logging.getLogger("snappydata_tpu_torch.tier")

_tier_lock = locks.named_lock("storage.tier")
_files_lock = locks.named_lock("storage.tier_files")
_tier_dir: Optional[str] = None
_tier_ids = itertools.count()
_tier_file_bytes = 0
_gauges_registered = False

# disk stores whose checkpointed batch files can rebuild a quarantined
# tier batch (WAL+checkpoint replay source); sessions attach theirs
_STORES: "weakref.WeakSet" = weakref.WeakSet()


class TierQuarantinedError(IOError):
    """A tier file failed its CRC at promotion, was quarantined (renamed
    aside), and NO rebuild source existed — neither a resident twin in a
    retained MVCC epoch nor a checkpointed batch file.  Typed so callers
    can distinguish 'the data needs recovery' from a plain IO error."""


class _TierFileDamaged(Exception):
    """Internal promote_batch → promote_table signal: `path` failed
    verification with `err`; the healing path quarantines + rebuilds."""

    def __init__(self, path: str, err: BaseException):
        super().__init__(f"{path}: {err}")
        self.path = path
        self.err = err


def attach_store(store) -> None:
    """Register a DiskStore as a quarantine-rebuild source: its
    write-once checkpointed batch files re-materialize a tier batch
    whose CRC-framed spill record rotted on disk."""
    _STORES.add(store)


def bind_store(data, store) -> None:
    """Record `store` as the one whose checkpointed batch files hold
    `data`'s batches (the store checkpointed or recovered this very
    table).  A quarantine rebuild reads that store alone: another
    session's same-named table with the same batch ids is a different
    table, and grafting its batch would serve its rows."""
    data._tier_store = weakref.ref(store)


def _own_store(data):
    """The attached store that holds `data`'s checkpointed batches, or
    None."""
    ref = getattr(data, "_tier_store", None)
    store = ref() if ref is not None else None
    return store if store is not None and store in _STORES else None

# column arrays a batch spills, in frame order (hoststore's spill set:
# dictionaries and object-dtype arrays stay resident — small, and not
# memmappable)
_SPILL_FIELDS = ("data", "runs", "validity")


def _reg():
    from snappydata_tpu_torch.observability.metrics import global_registry

    return global_registry()


def _ensure_gauges() -> None:
    global _gauges_registered
    if _gauges_registered:
        return
    _gauges_registered = True
    _reg().gauge("tier_file_bytes", lambda: float(tier_file_bytes()))


def tier_file_bytes() -> int:
    """Live bytes in CRC-framed tier files — the disk rung of the
    broker's unified ledger (next to hoststore's spill_file_bytes)."""
    with _files_lock:
        return _tier_file_bytes


def _dir() -> str:
    global _tier_dir
    if _tier_dir is None:
        _tier_dir = tempfile.mkdtemp(prefix="snappy_tier_")
        atexit.register(shutil.rmtree, _tier_dir, ignore_errors=True)
    return _tier_dir


def _unlink_quiet(path: str, nbytes: int) -> None:
    global _tier_file_bytes
    with _files_lock:
        _tier_file_bytes -= nbytes
    try:
        os.unlink(path)
    except OSError:
        pass


# --------------------------------------------------------------------------
# disk tier: CRC-framed batch files
# --------------------------------------------------------------------------

def frame_batch(batch, header_extra: Optional[dict] = None) -> bytes:
    """One batch's spillable arrays as ONE persistence-layer record
    (magic + JSON head + raw parts + trailing CRC32).  codec="none":
    the arrays are already the encoded at-rest form, and raw parts are
    what lets the demoted batch memmap back without a decompress."""
    from snappydata_tpu_torch.storage import persistence

    header = {"kind": "tier_batch", "batch_id": int(batch.batch_id),
              "ncols": len(batch.columns)}
    if header_extra:
        header.update(header_extra)
    arrays: List[Optional[np.ndarray]] = []
    for col in batch.columns:
        for name in _SPILL_FIELDS:
            a = getattr(col, name)
            if a is None or isinstance(a, np.memmap) or a.dtype == object:
                arrays.append(None)
            else:
                arrays.append(np.ascontiguousarray(a))
    return persistence.frame_record(header, arrays, codec="none")


def _part_offsets(buf: bytes) -> Tuple[dict, List[int], List[dict]]:
    """(head, per-part file offsets, array metas) of one framed record —
    the geometry the memmap reconstruction needs.  Raw-codec parts only
    (frame_batch guarantees it)."""
    (hlen,) = struct.unpack("<I", buf[4:8])
    head = json.loads(buf[8:8 + hlen].decode("utf-8"))
    offsets = []
    pos = 8 + hlen
    for size in head["sizes"]:
        offsets.append(pos)
        pos += size
    return head, offsets, head["arrays"]


def demote_batch(batch, table_name: str = "") -> Tuple[int, object]:
    """host → disk: write one batch as a CRC-framed record and swap its
    resident numeric arrays for memmap views of the record's raw parts.
    Returns (resident_bytes_freed, new batch).  The file is unlinked
    when the new batch object is collected."""
    rfail.hit("tier.demote")
    buf = frame_batch(batch, {"table": table_name})
    head, offsets, metas = _part_offsets(buf)
    freed = sum(
        a.nbytes for col in batch.columns for name in _SPILL_FIELDS
        for a in (getattr(col, name),)
        if a is not None and not isinstance(a, np.memmap)
        and a.dtype != object)
    if freed == 0:
        return 0, batch
    path = os.path.join(
        _dir(), f"tier_{next(_tier_ids)}_{batch.batch_id}.snt")
    rfail.hit("tier.write")
    # the data-plane failpoint damages the WIRE bytes only (geometry
    # above parsed the clean frame): corrupt_bytes models NVMe bit rot
    # the promote-side CRC must catch, short_write a torn spill
    wire = rfail.mangle("tier.write", buf)
    with open(path, "wb") as fh:
        fh.write(wire)
        fh.flush()
        # locklint: blocking-under-lock the framed spill runs on the
        # degradation ladder under the table lock by design (the
        # manifest swap is atomic against mutation; the write is the
        # memory relief)
        os.fsync(fh.fileno())
    if len(wire) < len(buf):
        # short write detected (the kernel's write count is the seam a
        # real ENOSPC/torn spill surfaces through): abort the spill —
        # the batch simply stays resident; no memmap views may be built
        # over a file shorter than the frame geometry says
        try:
            os.unlink(path)
        except OSError:
            pass
        _log.warning("tier spill of batch %s aborted: short write "
                     "(%d of %d bytes)", batch.batch_id, len(wire),
                     len(buf))
        return 0, batch
    # ONE mapping (one fd) per tier file: every column array is a view
    # into this base.  A long schedule demotes thousands of small
    # batches, and an fd per array (np.memmap holds its descriptor for
    # the mapping's lifetime) exhausts the process fd limit.  Views
    # inherit the np.memmap subclass and .filename, which is what
    # promote_batch keys on.
    base = np.memmap(path, dtype=np.uint8, mode="r")
    new_cols = []
    ai = 0   # array index across the flattened (col × field) grid
    pi = 0   # part index (kind "none" metas contribute zero parts)
    for col in batch.columns:
        repl = {}
        for name in _SPILL_FIELDS:
            m = metas[ai]
            ai += 1
            if m["kind"] == "none":
                continue
            assert m["kind"] == "raw", m  # frame_batch spills numerics only
            dt = np.dtype(m["dtype"])
            shape = tuple(m["shape"])
            nb = dt.itemsize * int(np.prod(shape, dtype=np.int64))
            view = base[offsets[pi]:offsets[pi] + nb] \
                .view(dt).reshape(shape)
            # __array_finalize__ copied the BASE's offset (0); restore
            # the part's real file offset — corruption tests and any
            # reframe logic locate bytes through it
            view.offset = offsets[pi]
            repl[name] = view
            pi += 1
        new_cols.append(dataclasses.replace(col, **repl) if repl else col)
    new_batch = dataclasses.replace(batch, columns=tuple(new_cols))
    global _tier_file_bytes
    with _files_lock:
        _tier_file_bytes += len(buf)
    weakref.finalize(new_batch, _unlink_quiet, path, len(buf))
    _reg().inc("tier_demotions_host")
    return freed, new_batch


def _read_tier_record(path: str):
    """CRC-verified read of one tier record, with ONE bounded re-read on
    an OS-level failure (EIO and friends are transient on real NVMe —
    the same one-retry-then-classify shape as the Flight seams); CRC
    damage is never retried (re-reading flipped bits re-reads flipped
    bits) — it propagates to the quarantine path."""
    from snappydata_tpu_torch.storage import persistence

    try:
        # the seam sits INSIDE the retry scope: an injected EIO must
        # exercise the same bounded re-read a real one would
        rfail.hit("tier.memmap_read")
        with open(path, "rb") as fh:
            # read_records re-runs the trailing-CRC pass — this IS the
            # promote-side integrity check
            return next(persistence.read_records(fh))
    except persistence.CorruptRecordError:
        raise
    except OSError:
        _reg().inc("tier_read_retries")
        with open(path, "rb") as fh:
            return next(persistence.read_records(fh))


def promote_batch(batch) -> Tuple[int, object]:
    """disk → host: CRC-verify the batch's tier record and replace its
    memmap views with resident copies.  A damaged record raises
    _TierFileDamaged for promote_table's quarantine+rebuild; direct
    callers see the underlying CorruptRecordError via its `err`."""
    from snappydata_tpu_torch.storage import persistence

    rfail.hit("tier.promote")
    paths = {a.filename for col in batch.columns
             for name in _SPILL_FIELDS for a in (getattr(col, name),)
             if isinstance(a, np.memmap)
             and str(a.filename).endswith(".snt")}
    if not paths:
        return 0, batch
    verified: Dict[str, List[Optional[np.ndarray]]] = {}
    for path in paths:
        try:
            header, arrays = _read_tier_record(path)
        except (persistence.CorruptRecordError, OSError, StopIteration) \
                as e:
            raise _TierFileDamaged(str(path), e) from e
        verified[path] = arrays
        _reg().inc("tier_crc_verifies")
    new_cols = []
    loaded = 0
    for ci, col in enumerate(batch.columns):
        repl = {}
        for fi, name in enumerate(_SPILL_FIELDS):
            a = getattr(col, name)
            if not (isinstance(a, np.memmap)
                    and str(a.filename) in verified):
                continue
            arr = verified[str(a.filename)][ci * len(_SPILL_FIELDS) + fi]
            if arr is not None:
                repl[name] = arr
                loaded += arr.nbytes
        new_cols.append(dataclasses.replace(col, **repl) if repl else col)
    new_batch = dataclasses.replace(batch, columns=tuple(new_cols))
    _reg().inc("tier_promotions")
    return loaded, new_batch


def _table_name_of(data) -> Optional[str]:
    """Resolve a table data object back to its registered name through
    the broker ledger (tier batches don't carry a back-pointer)."""
    from snappydata_tpu_torch.resource.broker import global_broker

    for nm, d in global_broker()._iter_tables():
        if d is data:
            return nm
    return None


def _quarantine_file(path: str) -> None:
    """Rename a CRC-failed tier file aside (`.quarantined`) so nothing
    re-reads the rotten bytes; the original batch's finalizer keeps
    owning the byte accounting (its unlink of the old name is a no-op).
    The renamed file is evidence — it dies with the tier dir at exit."""
    try:
        os.replace(path, path + ".quarantined")
    except OSError:
        pass                       # already renamed / raced a finalizer
    _reg().inc("tier_quarantined_files")
    _log.error("tier file %s failed verification — quarantined to %s",
               path, path + ".quarantined")


def _rebuild_batch(data, batch, table_name: Optional[str]):
    """Re-materialize a quarantined batch's spilled arrays from a
    surviving source, cheapest first:

    1. a resident TWIN in a retained MVCC epoch — `_publish` moved the
       pre-demotion manifest (resident arrays and all) into
       ``data._retained_epochs``, so a recent demotion usually still
       has its source in RAM;
    2. the checkpointed immutable batch file (``batch-<id>.col``) of an
       attached DiskStore — the WAL+checkpoint replay source.

    Returns the healed batch, or None when no source covers it."""
    from snappydata_tpu_torch.storage import mvcc

    damaged = {}                   # (col idx, field) -> needs rebuild
    for ci, col in enumerate(batch.columns):
        for name in _SPILL_FIELDS:
            a = getattr(col, name)
            if isinstance(a, np.memmap) \
                    and str(a.filename).endswith((".snt",
                                                  ".snt.quarantined")):
                damaged[(ci, name)] = True
    if not damaged:
        return batch

    def _graft(source_batch):
        """Replace the damaged memmap fields with the source's resident
        arrays; refuse partial coverage (a half-healed batch is worse
        than a typed error)."""
        if source_batch is None \
                or source_batch.num_rows != batch.num_rows \
                or len(source_batch.columns) != len(batch.columns):
            return None
        new_cols = list(batch.columns)
        for (ci, name) in damaged:
            src = getattr(source_batch.columns[ci], name)
            if src is None or (isinstance(src, np.memmap)
                               and str(src.filename).endswith(
                                   (".snt", ".snt.quarantined"))):
                return None
            new_cols[ci] = dataclasses.replace(
                new_cols[ci], **{name: np.asarray(src)})
        return dataclasses.replace(batch, columns=tuple(new_cols))

    # 1. resident twin in a retained epoch (newest first: the epoch
    #    published right before the demotion holds the freshest source)
    with mvcc.clock():
        retained = list(
            (getattr(data, "_retained_epochs", None) or {}).items())
    for _ver, manifest in sorted(retained, reverse=True):
        for v in getattr(manifest, "views", ()):
            if v.batch.batch_id != batch.batch_id:
                continue
            healed = _graft(v.batch)
            if healed is not None:
                return healed
    # 2. the table's own checkpointed batch file, through the attached
    #    disk store that wrote it (never another session's namesake)
    store = _own_store(data)
    if table_name and store is not None:
        try:
            healed = _graft(store.load_batch(table_name, batch.batch_id))
        except Exception:
            healed = None
        if healed is not None:
            return healed
    return None


def _heal_batch(data, batch, dmg: _TierFileDamaged,
                table_name: Optional[str]):
    """Quarantine the damaged tier file and rebuild the batch, or raise
    the typed TierQuarantinedError when no source survives."""
    reg = _reg()
    _quarantine_file(dmg.path)
    healed = _rebuild_batch(data, batch, table_name)
    if healed is None:
        reg.inc("tier_rebuild_failures")
        raise TierQuarantinedError(
            f"tier record of batch {batch.batch_id} "
            f"({table_name or 'unknown table'}) quarantined after "
            f"{dmg.err!r}; no rebuild source (no resident retained "
            f"epoch, no checkpointed batch file) — recover the table "
            f"from WAL+checkpoint") from dmg.err
    reg.inc("tier_rebuilds")
    _log.warning("rebuilt batch %s of %s from %s after quarantine",
                 batch.batch_id, table_name or "?",
                 "a surviving source")
    return healed


def promote_table(data) -> int:
    """Pull every disk-demoted batch of one table resident again
    (CRC-verified).  A batch whose tier record fails verification is
    QUARANTINED (file renamed aside, `tier_quarantined_files`) and
    rebuilt from its host/HBM source or the checkpointed batch file —
    the query never sees flipped bits, and only a batch with NO
    surviving source raises (typed: TierQuarantinedError).
    Returns batches promoted."""
    promoted = 0
    _ensure_gauges()
    with _tier_lock:
        # resolved OUTSIDE the table lock: the broker registry walk
        # must not nest under storage.column_table
        tname = _table_name_of(data)
        # locklint: lock=storage.column_table (only column tables tier)
        with data._lock:
            m = data._manifest
            new_views = list(m.views)
            for i, v in enumerate(new_views):
                try:
                    loaded, nb = promote_batch(v.batch)
                except _TierFileDamaged as dmg:
                    nb = _heal_batch(data, v.batch, dmg, tname)
                    loaded = 1
                if loaded:
                    new_views[i] = dataclasses.replace(v, batch=nb)
                    promoted += 1
            if promoted:
                data._publish(tuple(new_views))
    return promoted


# --------------------------------------------------------------------------
# the demotion ladder
# --------------------------------------------------------------------------

def _device_entries(tables) -> List[Tuple[object, tuple, int]]:
    """(data, cache_key, nbytes) of every device-cache entry, coldest
    first: windowed tile entries, then old versions, then current."""
    from snappydata_tpu_torch.storage.device import _entry_bytes

    out = []
    for _nm, data in tables:
        cache = getattr(data, "_device_cache", None)
        if not cache:
            continue
        cur = data._manifest.version if hasattr(data, "_manifest") else -1
        for k in list(cache):
            entry = cache.get(k)
            if entry is None:
                continue
            # order key: tiles coldest, then by version age
            rank = (0 if k[2] is not None else (1 if k[0] != cur else 2),
                    k[0])
            out.append((rank, data, k, _entry_bytes(entry)))
    out.sort(key=lambda t: t[0])
    return [(d, k, b) for _r, d, k, b in out]


def demote_device(tables, excess_bytes: int) -> int:
    """HBM -> host: drop up to `excess_bytes` of cold device-cache
    entries.  Entries of MVCC-pinned epochs and windows a live prefetch
    pass keeps are skipped (counted: tier_pinned_skips): a long scan, or
    the tile pass running now, never loses its plates mid-query.  A
    dropped entry's bytes leave `torch.cuda.memory_allocated()` once
    nothing else holds its tensors."""
    from snappydata_tpu_torch.storage import mvcc, prefetch
    from snappydata_tpu_torch.storage.device import _cache_budget

    reg = _reg()
    freed = dropped = 0
    pinned_of: Dict[int, frozenset] = {}
    kept_of: Dict[int, set] = {}
    for data, k, nbytes in _device_entries(tables):
        if freed >= excess_bytes:
            break
        if id(data) not in pinned_of:
            pinned_of[id(data)] = mvcc.pinned_versions(data)
            kept_of[id(data)] = prefetch.keep_windows(data)
        if k[0] in pinned_of[id(data)] or (
                k[2] is not None and k[2] in kept_of[id(data)]):
            reg.inc("tier_pinned_skips")
            continue
        data._device_cache.pop(k, None)
        _cache_budget.forget(data._device_cache, k)
        freed += nbytes
        dropped += 1
    if dropped:
        reg.inc("tier_demotions_hbm", dropped)
    # mesh exchange layouts are device-tier residents too: trim them on
    # the same rung (they rebuild from the next bind)
    if freed < excess_bytes:
        from snappydata_tpu_torch.engine import mesh_exec

        freed += mesh_exec.trim_layout_caches(
            max(0, mesh_exec.mesh_layout_cache_nbytes()
                - (excess_bytes - freed)))
    return dropped


def demote_host(tables, excess_bytes: int) -> int:
    """host → disk: frame the oldest resident batches into CRC-checked
    tier files until `excess_bytes` of host pool is released."""
    from snappydata_tpu_torch.storage.hoststore import batch_resident_bytes

    freed = spilled = 0
    for nm, data in tables:
        if freed >= excess_bytes:
            break
        if not hasattr(data, "_manifest") or not hasattr(data, "_lock"):
            continue
        # locklint: lock=storage.column_table (only column tables tier)
        with data._lock:
            m = data._manifest
            new_views = list(m.views)
            changed = False
            for i, v in enumerate(new_views):   # oldest first
                if freed >= excess_bytes:
                    break
                if batch_resident_bytes(v.batch) == 0:
                    continue
                got, nb = demote_batch(v.batch, table_name=nm)
                if got == 0:
                    continue
                new_views[i] = dataclasses.replace(v, batch=nb)
                freed += got
                spilled += 1
                changed = True
            if changed:
                data._publish(tuple(new_views))
    return spilled


def demote(tables, excess_bytes: int) -> int:
    """The `tier.demote` degradation step: walk the ladder top-down —
    HBM → host first (cheapest: plates rebuild from resident encoded
    batches), then host → disk (framed spill; reads fault pages back).
    Returns entries+batches demoted."""
    _ensure_gauges()
    if excess_bytes <= 0:
        return 0
    with _tier_lock:
        n = demote_device(tables, excess_bytes)
        n += demote_host(tables, excess_bytes)
    return n


def pressure_demote(broker, target_bytes: int) -> int:
    """The background pressure-relief pass (ROADMAP 4(c)): demote the
    ladder toward `target_bytes` of measured residency — called from the
    broker's pressure watcher when admission sees the watermark crossed,
    so relief starts BEFORE an allocation fails mid-statement.  Returns
    entries+batches demoted."""
    host, device = broker.measured_bytes()
    excess = host + device - max(0, int(target_bytes))
    if excess <= 0:
        return 0
    n = demote(broker._iter_tables(), excess)
    if n:
        # one increment per relief PASS (not per entry): the signal an
        # operator correlates with pressure wakeups
        _reg().inc("tier_pressure_demotions")
    return n


def maybe_demote() -> int:
    """Steady-state enforcement of the tier knobs (`tier_device_bytes`,
    `tier_host_bytes`), called from the tiled lane after a pass: when a
    tier sits over its cap, demote it back under.  Holds the tier lock
    across the broker-registry consult — the `storage.tier →
    resource.broker_global` ordering LOCK_ORDER.md codifies."""
    from snappydata_tpu_torch import config

    props = config.global_properties()
    dev_cap = int(props.tier_device_bytes or 0)
    host_cap = int(props.tier_host_bytes or 0)
    if dev_cap <= 0 and host_cap <= 0:
        return 0
    _ensure_gauges()
    from snappydata_tpu_torch.resource.broker import global_broker

    n = 0
    with _tier_lock:
        tables = global_broker()._iter_tables()
        if dev_cap > 0:
            from snappydata_tpu_torch.storage.device import \
                device_cache_bytes_by_table

            used = sum(device_cache_bytes_by_table(tables).values())
            if used > dev_cap:
                n += demote_device(tables, used - dev_cap)
        if host_cap > 0:
            from snappydata_tpu_torch.resource.broker import _host_table_bytes

            used = sum(_host_table_bytes(d) for _nm, d in tables)
            if used > host_cap:
                n += demote_host(tables, used - host_cap)
    return n


def tier_snapshot() -> dict:
    """Point-in-time tier ledger for observability/tests: bytes resident
    at each rung plus the demotion counters' current values."""
    from snappydata_tpu_torch.resource.broker import (_host_table_bytes,
                                                global_broker)
    from snappydata_tpu_torch.storage.device import device_cache_bytes_by_table

    from snappydata_tpu_torch.observability.metrics import global_registry

    _ensure_gauges()
    with _tier_lock:
        tables = global_broker()._iter_tables()
        device = sum(device_cache_bytes_by_table(tables).values())
        host = sum(_host_table_bytes(d) for _nm, d in tables)
    reg = global_registry()
    return {"device_bytes": device, "host_pool_bytes": host,
            "tier_file_bytes": tier_file_bytes(),
            "quarantined_files": reg.counter("tier_quarantined_files"),
            "rebuilds": reg.counter("tier_rebuilds"),
            "rebuild_failures": reg.counter("tier_rebuild_failures"),
            "read_retries": reg.counter("tier_read_retries"),
            "pressure_demotions": reg.counter("tier_pressure_demotions")}
