"""Disk persistence: checkpointed column batches + statement WAL.

Port of snappydata_tpu/storage/persistence.py.  The on-disk format is the
reference's byte for byte (record framing, CRC, codec tags, schema JSON,
manifests), so either package recovers a data directory the other wrote.
Views, materialized views (their [G] state checkpoints under
`views/<name>.state` with its WAL fence, `checkpoint_matview`), SQL
functions, row-level policies, secondary indexes, sample tables and
TopKs persist and recover as the reference's do.  Left out with the
subsystems they serve: the re-registration of deployed code, streams and
grants on recovery — a data directory that records any of them raises
NotImplementedError when it is recovered, never skipping it silently.

The reference persists regions as oplogs/krfs in disk stores with crash
recovery on boot, plus backup/restore CLI (SURVEY.md §5 checkpoint/resume;
CREATE DISKSTORE DDL SnappyDDLParser ddl:1051; OpLogRdd reads raw oplog
bytes core/.../execution/oplog/impl/OpLogRdd.scala). TPU-first shape of
the same guarantees:

- Column batches are immutable → persisted once as self-describing files
  (JSON header + raw little-endian array bytes; string dictionaries as
  UTF-8 blob + offsets). A checkpoint only writes batches that aren't on
  disk yet.
- A manifest JSON per checkpoint pins (batch ids, delete masks, deltas,
  row-buffer rows) — the durable twin of the in-memory MVCC manifest.
- Between checkpoints, a statement WAL (length-prefixed records of DML
  SQL + params, or raw insert arrays) makes mutations durable; recovery =
  load last checkpoint + replay WAL tail. This is the deterministic-replay
  design SURVEY.md §5 prescribes in place of the reference's physical
  oplogs.
- `recover_catalog` doubles as the data-extractor recovery mode
  (RecoveryService analogue): it reconstructs tables from disk bytes alone,
  no running engine needed.
"""

from __future__ import annotations

import io
import json
import logging
import os
import struct
import sys
import threading
from snappydata_tpu_torch.utils import locks
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.reliability import failpoints
from snappydata_tpu_torch.storage.batch import ColumnBatch
from snappydata_tpu_torch.storage.encoding import (ColumnStats, EncodedColumn,
                                             Encoding)
from snappydata_tpu_torch.storage.table_store import (BatchView, ColumnTableData,
                                                RowTableData)

_MAGIC = b"SNTP"    # legacy records: no checksum (read-compat only)
_MAGIC2 = b"SNT2"   # checksummed records: trailing CRC32 over head+parts

_log = logging.getLogger("snappydata_tpu_torch.storage.persistence")


class CorruptRecordError(IOError):
    """A record whose bytes are provably damaged (bad magic, CRC mismatch,
    garbled checksummed header) — as opposed to a torn TAIL, which is the
    expected shape of a crash mid-append and is simply where replay stops.
    Callers on the recovery path salvage the valid prefix and quarantine
    the rest (salvage_file) instead of failing boot."""


import contextlib


@contextlib.contextmanager
def _no_journal(session):
    """Detach the session's disk store so statements executed during
    recovery are not re-journaled (they came FROM the journal/catalog)."""
    saved = session.disk_store
    session.disk_store = None
    try:
        yield
    finally:
        session.disk_store = saved


def _np_json(v):
    """json serializer for numpy scalars/arrays inside ARRAY cells."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    raise TypeError(f"not JSON serializable: {type(v)}")


# --------------------------------------------------------------------------
# array (de)serialization — no pickle, self-describing
# --------------------------------------------------------------------------

def _arr_to_parts(arr: Optional[np.ndarray]) -> Tuple[dict, List[bytes]]:
    if arr is None:
        return {"kind": "none"}, []
    if arr.dtype == object:
        vals = arr.tolist()
        if not set(map(type, vals)) <= {str, type(None)}:
            # complex cells, and the numbers of a row table's object
            # column holding a NULL (the reference's utf8 branch raised
            # on them; its reader takes this JSON form)
            payload = json.dumps(vals, default=_np_json).encode("utf-8")
            return {"kind": "json", "n": len(arr)}, [payload]
        # string values -> utf8 blob + byte offsets + null flags, joined
        # and measured in C (per-value lengths in bytes only when the
        # text is not ASCII)
        strs = ["" if v is None else v for v in vals]
        text = "".join(strs)
        blob = text.encode("utf-8")
        if len(blob) == len(text):
            lens = np.fromiter(map(len, strs), dtype=np.int64,
                               count=len(strs))
        else:
            lens = np.fromiter((len(v.encode("utf-8")) for v in strs),
                               dtype=np.int64, count=len(strs))
        offsets = np.zeros(len(strs) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        nulls = np.fromiter((v is None for v in vals), dtype=np.uint8,
                            count=len(vals))
        return ({"kind": "utf8", "n": len(strs)},
                [offsets.tobytes(), blob, nulls.tobytes()])
    a = np.ascontiguousarray(arr)
    return ({"kind": "raw", "dtype": a.dtype.str, "shape": list(a.shape)},
            [a.tobytes()])


def _arr_from_parts(meta: dict, parts: List[bytes]) -> Optional[np.ndarray]:
    if meta["kind"] == "none":
        return None
    if meta["kind"] == "json":
        out = np.empty(meta["n"], dtype=object)
        for i, v in enumerate(json.loads(parts[0].decode("utf-8"))):
            out[i] = v
        return out
    if meta["kind"] == "utf8":
        n = meta["n"]
        offsets = np.frombuffer(parts[0], dtype=np.int64).tolist()
        blob = bytes(parts[1])
        nulls = np.frombuffer(parts[2], dtype=np.uint8).astype(bool)
        text = blob.decode("utf-8")
        if len(text) == len(blob):
            # ASCII: byte offsets are character offsets
            vals = [text[a:b] for a, b in zip(offsets[:-1], offsets[1:])]
        else:
            vals = [blob[a:b].decode("utf-8")
                    for a, b in zip(offsets[:-1], offsets[1:])]
        out = np.empty(n, dtype=object)
        out[:] = vals
        out[nulls] = None
        return out
    return np.frombuffer(parts[0], dtype=np.dtype(meta["dtype"])) \
        .reshape(meta["shape"]).copy()


def frame_record(header: dict, arrays: List[Optional[np.ndarray]],
                 codec: Optional[str] = None) -> bytes:
    """Assemble one record as a single contiguous buffer: magic, head
    length, JSON head, parts, trailing CRC32. The CRC is computed in ONE
    pass over the assembled head+parts region (no per-part incremental
    loop) and callers issue ONE write for the whole record — the group
    commit drain concatenates these frames and syncs them with one
    write+fsync per group.

    `codec` overrides the global at-rest codec for THIS record: the disk
    tier (storage/tier.py) frames demoted batches with codec="none", so
    raw numeric parts land at computable offsets and memmap back without
    a decompress pass."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.storage.encoding import compress_bytes

    if codec is None:
        codec = config.global_properties().compression_codec
    metas = []
    parts: List[bytes] = []
    codecs: List[str] = []
    for a in arrays:
        m, ps = _arr_to_parts(a)
        m["nparts"] = len(ps)
        metas.append(m)
        for p in ps:
            # at-rest compression ON by default (ref: LZ4'd oplogs);
            # stored only when it actually shrinks the part
            if codec != "none" and len(p) > 512:
                used, blob = compress_bytes(p, codec)
                if len(blob) < len(p):
                    parts.append(blob)
                    codecs.append(used)
                    continue
            parts.append(p)
            codecs.append("none")
    head_obj = {"h": header, "arrays": metas,
                "sizes": [len(p) for p in parts]}
    if any(c != "none" for c in codecs):
        head_obj["codecs"] = codecs
    head = json.dumps(head_obj).encode("utf-8")
    buf = bytearray()
    buf += _MAGIC2
    buf += struct.pack("<I", len(head))
    buf += head
    for p in parts:
        buf += p
    # CRC32 over head + stored (possibly compressed) parts, trailing the
    # record: verify-on-read catches bit rot that is the right LENGTH (a
    # torn tail is caught by short reads; a flipped byte was not, and
    # used to replay silently — the whole point of the checksum)
    crc = zlib.crc32(memoryview(buf)[8:])
    buf += struct.pack("<I", crc & 0xFFFFFFFF)
    return bytes(buf)


def write_record(fh, header: dict, arrays: List[Optional[np.ndarray]]) -> None:
    fh.write(frame_record(header, arrays))


def read_records(fh):
    """Yield (header, arrays) until EOF or a torn tail (crash mid-append:
    stop cleanly). Raise CorruptRecordError on provable mid-file damage —
    bad magic or a CRC mismatch on a checksummed record."""
    while True:
        magic = fh.read(4)
        if len(magic) < 4:
            return
        if magic == _MAGIC2:
            checksummed = True
        elif magic == _MAGIC:
            checksummed = False
        else:
            raise CorruptRecordError("corrupt record (bad magic)")
        lenbytes = fh.read(4)
        if len(lenbytes) < 4:
            return  # torn tail
        (hlen,) = struct.unpack("<I", lenbytes)
        raw_head = fh.read(hlen)
        if len(raw_head) < hlen:
            return  # torn tail
        try:
            head = json.loads(raw_head.decode("utf-8"))
            sizes = list(head["sizes"])
        except (ValueError, UnicodeDecodeError, KeyError, TypeError):
            if checksummed:
                # a checksummed record's header was fully present but
                # does not parse: damage, not a tear
                raise CorruptRecordError("corrupt record (garbled header)")
            return  # legacy torn/garbled tail record (crash mid-write)
        # ONE read for all parts (+ the CRC when checksummed) and ONE
        # CRC pass over the contiguous body — the read-side twin of the
        # zero-copy frame assembly on the write side
        total = sum(sizes)
        body = fh.read(total + (4 if checksummed else 0))
        if len(body) < total + (4 if checksummed else 0):
            return  # torn tail write (crash mid-record / mid-group)
        if checksummed:
            crc = zlib.crc32(memoryview(body)[:total],
                             zlib.crc32(raw_head))
            if (crc & 0xFFFFFFFF) != \
                    struct.unpack("<I", body[total:total + 4])[0]:
                raise CorruptRecordError("corrupt record (CRC mismatch)")
        raw_parts = []
        pos0 = 0
        for size in sizes:
            raw_parts.append(body[pos0:pos0 + size])
            pos0 += size
        parts = []
        codecs = head.get("codecs")
        for pi, p in enumerate(raw_parts):
            if codecs is not None and codecs[pi] != "none":
                from snappydata_tpu_torch.storage.encoding import decompress_bytes

                try:
                    p = decompress_bytes(codecs[pi], p)
                except ImportError:
                    # codec module missing on THIS machine (e.g. a zstd
                    # record read where only zlib exists): a config
                    # problem — never quarantine sound data over it
                    raise
                except Exception:
                    if checksummed:
                        # CRC passed yet the codec rejects it: damage in
                        # a shape the checksum covered — impossible
                        # without a writer bug, but never replay it
                        raise CorruptRecordError(
                            "corrupt record (undecodable part)")
                    return  # garbled legacy tail: stop cleanly
            parts.append(p)
        arrays: List[Optional[np.ndarray]] = []
        pos = 0
        for m in head["arrays"]:
            ps = parts[pos:pos + m["nparts"]]
            pos += m["nparts"]
            arrays.append(_arr_from_parts(m, ps))
        yield head["h"], arrays


def read_frames(fh):
    """Yield (user header, whole framed bytes) of each record, CRC-checked
    like `read_records` and stopping at a torn tail the same way, without
    decompressing or decoding the parts.  The walks that need only the
    headers (salvage, the seq floor, the drop markers, rotation, the
    replay's fence) take this; a kept frame decodes on its own through
    `read_records(io.BytesIO(frame))`."""
    while True:
        start = fh.read(8)
        if len(start) < 4:
            return
        magic = start[:4]
        if magic == _MAGIC2:
            checksummed = True
        elif magic == _MAGIC:
            checksummed = False
        else:
            raise CorruptRecordError("corrupt record (bad magic)")
        if len(start) < 8:
            return  # torn tail
        (hlen,) = struct.unpack("<I", start[4:])
        raw_head = fh.read(hlen)
        if len(raw_head) < hlen:
            return  # torn tail
        try:
            head = json.loads(raw_head.decode("utf-8"))
            total = sum(head["sizes"])
            user = head["h"]
        except (ValueError, UnicodeDecodeError, KeyError, TypeError):
            if checksummed:
                raise CorruptRecordError("corrupt record (garbled header)")
            return
        body = fh.read(total + (4 if checksummed else 0))
        if len(body) < total + (4 if checksummed else 0):
            return  # torn tail
        if checksummed:
            crc = zlib.crc32(memoryview(body)[:total], zlib.crc32(raw_head))
            if (crc & 0xFFFFFFFF) != \
                    struct.unpack("<I", body[total:total + 4])[0]:
                raise CorruptRecordError("corrupt record (CRC mismatch)")
        yield user, start + raw_head + body


def _decode_frame(frame: bytes):
    """(header, arrays) of one framed record."""
    return next(read_records(io.BytesIO(frame)))


def _read_first_header(path: str) -> Optional[dict]:
    """First record's user header (the `h` field) WITHOUT reading or
    decoding the payload parts — for boot-time metadata peeks. Returns
    None on an empty/torn/damaged head; no CRC verification (callers
    that consume the payload go through read_records)."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
        if magic not in (_MAGIC, _MAGIC2):
            return None
        lenbytes = fh.read(4)
        if len(lenbytes) < 4:
            return None
        (hlen,) = struct.unpack("<I", lenbytes)
        raw_head = fh.read(hlen)
        if len(raw_head) < hlen:
            return None
        try:
            return json.loads(raw_head.decode("utf-8")).get("h")
        except (ValueError, UnicodeDecodeError, AttributeError):
            return None


def salvage_scan(path: str) -> Tuple[int, Optional[CorruptRecordError]]:
    """Walk `path`'s records; return (byte offset past the last fully
    valid record, the CorruptRecordError if damage stopped the walk —
    None for a clean file or a plain torn tail)."""
    with open(path, "rb") as fh:
        valid_end = 0
        gen = read_frames(fh)
        while True:
            try:
                next(gen)
            except StopIteration:
                return valid_end, None
            except CorruptRecordError as e:
                return valid_end, e
            valid_end = fh.tell()


def salvage_file(path: str, counter: str = "wal_corrupt_records") -> int:
    """Repair a record file in place: quarantine everything past the last
    valid record to `path + '.corrupt'` and truncate the file to the
    valid prefix, so recovery keeps every intact record AND subsequent
    appends land at a readable position (an un-truncated torn tail would
    strand later appends behind unreadable bytes). Bumps `counter` when
    the cut was provable corruption rather than a crash tear. Returns
    the number of quarantined bytes (0 = file was clean/absent)."""
    if not os.path.exists(path):
        return 0
    failpoints.hit("wal.salvage")
    valid_end, err = salvage_scan(path)
    size = os.path.getsize(path)
    if valid_end >= size:
        return 0
    with open(path, "rb") as fh:
        fh.seek(valid_end)
        bad = fh.read()
    with open(path + ".corrupt", "ab") as out:
        out.write(bad)
        out.flush()
        # locklint: blocking-under-lock salvage runs at boot/first-touch
        # under the io lock BY DESIGN: no write may land on an unsalvaged
        # tail, and nothing serves traffic during recovery
        os.fsync(out.fileno())
    with open(path, "rb+") as fh:
        fh.truncate(valid_end)
        fh.flush()
        # locklint: blocking-under-lock same salvage invariant as above
        os.fsync(fh.fileno())
    if err is not None:
        from snappydata_tpu_torch.observability.metrics import global_registry

        # locklint: metric-dynamic counter is one of the two declared
        # names "wal_corrupt_records" (default) / "batch_corrupt_records"
        global_registry().inc(counter)
        _log.warning(
            "%s: %s at byte %d — salvaged %d-byte prefix, quarantined "
            "%d bytes to %s", path, err, valid_end, valid_end, len(bad),
            path + ".corrupt")
    else:
        _log.info("%s: torn tail (%d bytes) truncated after crash; "
                  "quarantined to %s", path, len(bad), path + ".corrupt")
    return len(bad)


# --------------------------------------------------------------------------
# schema / type JSON
# --------------------------------------------------------------------------

def _dtype_to_json(dt: T.DataType) -> dict:
    out = {"name": dt.name}
    if isinstance(dt, T.DecimalType):
        out["precision"] = dt.precision
        out["scale"] = dt.scale
    elif isinstance(dt, T.ArrayType):
        out["element"] = _dtype_to_json(dt.element)
    elif isinstance(dt, T.MapType):
        out["key"] = _dtype_to_json(dt.key)
        out["value"] = _dtype_to_json(dt.value)
    elif isinstance(dt, T.StructType):
        out["fields"] = [[n, _dtype_to_json(t)] for n, t in dt.fields]
    return out


def _dtype_from_json(d: dict) -> T.DataType:
    if d["name"] == "decimal":
        return T.DecimalType("decimal", d.get("precision", 38),
                             d.get("scale", 2))
    if d["name"] == "array":
        # legacy records (pre element-type persistence) default to STRING:
        # a non-numeric element keeps the column on the always-correct
        # host path instead of guessing it onto the numeric device build
        return T.ArrayType("array", _dtype_from_json(
            d.get("element", {"name": "string"})))
    if d["name"] == "map":
        return T.MapType("map",
                         _dtype_from_json(d.get("key", {"name": "string"})),
                         _dtype_from_json(d.get("value",
                                                {"name": "double"})))
    if d["name"] == "struct":
        return T.StructType("struct", tuple(
            (n, _dtype_from_json(t)) for n, t in d.get("fields", [])))
    return T.parse_type(d["name"])


def schema_to_json(schema: T.Schema) -> list:
    return [{"name": f.name, "type": _dtype_to_json(f.dtype),
             "nullable": f.nullable} for f in schema.fields]


def schema_from_json(cols: list) -> T.Schema:
    return T.Schema([T.Field(c["name"], _dtype_from_json(c["type"]),
                             c.get("nullable", True)) for c in cols])


# --------------------------------------------------------------------------
# DiskStore
# --------------------------------------------------------------------------

class DiskStore:
    """One durable store directory (ref: CREATE DISKSTORE / sys-disk-dir).

    Layout:
      catalog.json                      table metadata (+ views, topks)
      wal.log                           ONE global ordered WAL (all tables)
      tables/<name>/batch-<id>.col      immutable encoded batch
      tables/<name>/manifest.json       checkpointed manifest (+ wal_seq)
      tables/<name>/rows.dat|rowbuf.dat row-table / row-buffer snapshot

    Durability contract:
    - Every WAL record carries a global monotone `seq`. Each checkpoint
      records the `wal_seq` it folded per table; recovery replays only
      records with seq > that table's folded seq — so a crash between
      manifest write and WAL rotation can never double-apply.
    - The log is global and replayed in order, so cross-table statements
      (INSERT INTO a SELECT FROM b) see the b-state they saw originally.
    - Writers journal BEFORE applying (see SnappySession.mutation paths),
      under `mutation_lock`, and checkpoints take the same lock — the
      classic WAL invariant.
    - DROP TABLE writes a `drop` marker; replay ignores records older than
      the last drop marker of their table (recreated tables can't
      resurrect a dead incarnation's records).
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.join(path, "tables"), exist_ok=True)
        self._lock = locks.named_lock("storage.wal_buffer")
        self.mutation_lock = locks.named_rlock("storage.mutation_lock")
        # serializes WAL file writes/rotation; lock order is always
        # _io_lock -> _lock, never the reverse
        self._io_lock = locks.named_rlock("storage.wal_io")
        self._wal_fh: Optional[io.BufferedWriter] = None
        # boot-time repair: quarantine damaged/torn suffixes BEFORE the
        # first append — appending after a torn tail would strand the new
        # (acked!) records behind bytes replay can never traverse
        salvage_file(self._wal_path())
        # the log stays clean across ordinary appends (whole records,
        # flushed+fsynced); only a torn-write crash dirties it again —
        # this flag lets replay/reopen skip redundant full-file rescans
        self._wal_clean = True
        self._wal_seq = self._scan_last_seq()
        # --- group commit state (wal_fsync_mode group|interval) --------
        # appends land here as (seq, framed bytes); a drain concatenates
        # the group and issues ONE write+fsync. Acks go through wal_sync,
        # which blocks until the covering fsync — the no-acked-row-
        # lost invariant is preserved by gating the ack, not the append.
        self._commit_buf: List[Tuple[int, bytes]] = []
        self._commit_bytes = 0
        self._commit_first_t: Optional[float] = None
        self._buffered_seq = self._wal_seq    # highest seq in the buffer
        self._durable_seq = self._wal_seq     # highest fsync-covered seq
        # seq ranges whose group drain failed (torn/IO error): waiters on
        # them must raise their ack instead of hanging forever. The
        # durable watermark is advanced PAST a lost range when it is
        # poisoned (nothing will ever make those records durable), so
        # barrier syncs and later waiters don't wedge on it — the
        # specific-seq lost check still fails the lost records' own acks.
        self._lost: List[Tuple[int, int, BaseException]] = []
        # highest seq whose wal_append RETURNED (its statement went on
        # to apply): losing a record at or below this watermark means
        # memory may exceed the journal; losing one above it cannot
        # (the append raised before the caller applied anything)
        self._returned_seq = self._wal_seq
        # set when a drain failure left APPLIED-but-unjournaled state in
        # memory (the mutation raised at ack time, after apply): the
        # store is crash-shaped — checkpoints refuse to fold that state
        # into durable artifacts until the store is reopened/recovered
        self._wal_damaged = False
        # torn wal.append groups waiting for their crash write: FIFO,
        # flushed under _io_lock by WHOEVER writes next, so no other
        # bytes can reach the log before them (file order == seq order)
        self._pending_torn: List[Tuple[List[Tuple[int, bytes]], int]] = []
        self._commit_cond = locks.named_condition("storage.wal_buffer", self._lock)
        self._flusher: Optional[threading.Thread] = None
        self._closed = False

    def _wal_path(self) -> str:
        return os.path.join(self.path, "wal.log")

    @staticmethod
    def _durable_replace(tmp: str, dst: str) -> None:
        """fsync(tmp) → rename → fsync(dir): a checkpoint artifact must be
        on stable storage BEFORE anything (like WAL rotation) assumes it is
        — the reference's oplog stores fsync before truncating. A power
        loss right after os.replace without these leaves an empty/partial
        file whose covering WAL records were already discarded."""
        spec = failpoints.hit("checkpoint.write")
        if spec is not None and spec.action == "torn_write":
            # crash mid-write of the checkpoint artifact: the tmp file
            # loses its tail and the replace never happens — the previous
            # artifact (and the un-rotated WAL) stay authoritative
            with open(tmp, "rb+") as fh:
                fh.truncate(max(0, os.path.getsize(tmp)
                                - max(1, int(spec.param))))
            raise failpoints.InjectedFault(
                "failpoint checkpoint.write: injected torn write")
        with open(tmp, "rb") as fh:
            # locklint: blocking-under-lock checkpoints hold mutation_lock
            # across their durable-replace fsyncs BY DESIGN: the fold must
            # be atomic vs committers (journal >= state invariant); rare,
            # operator-paced
            os.fsync(fh.fileno())
        # the PUBLISH seam: a fault here models a crash between the
        # artifact fsync and the atomic rename — the previous artifact
        # stays authoritative and the un-rotated WAL still covers it
        failpoints.hit("checkpoint.publish")
        os.replace(tmp, dst)
        dfd = os.open(os.path.dirname(dst) or ".", os.O_RDONLY)
        try:
            # locklint: blocking-under-lock same checkpoint invariant
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _scan_last_seq(self) -> int:
        """Next-seq floor = max over the WAL *and* every checkpoint's
        folded wal_seq. The checkpoint fences are load-bearing: rotation
        can leave the WAL EMPTY while manifests hold the high-water
        mark — seeding from the WAL alone made a post-rotation reboot
        mint seqs BELOW the fence, and recovery silently skipped those
        acked records (found by the seeded chaos harness)."""
        last = 0
        if os.path.exists(self._wal_path()):
            with open(self._wal_path(), "rb") as fh:
                for header, _ in read_frames(fh):
                    last = max(last, header.get("seq", 0))
        tdir = os.path.join(self.path, "tables")
        for name in (os.listdir(tdir) if os.path.isdir(tdir) else ()):
            mpath = os.path.join(tdir, name, "manifest.json")
            if os.path.exists(mpath):
                try:
                    with open(mpath) as fh:
                        last = max(last,
                                   int(json.load(fh).get("wal_seq", 0)))
                except (OSError, ValueError, TypeError):
                    pass   # damaged manifest: recovery handles it
            rpath = os.path.join(tdir, name, "rows.dat")
            if os.path.exists(rpath):
                try:
                    # header-only read: the folded wal_seq sits in the
                    # first record's JSON head — decoding the full row
                    # snapshot here would double recovery's boot cost
                    head = _read_first_header(rpath)
                    if head is not None:
                        last = max(last, int(head.get("wal_seq", 0)))
                except (OSError, IOError, ValueError, TypeError):
                    pass
        return last

    # -- catalog ---------------------------------------------------------

    def save_catalog(self, catalog) -> None:
        tables = []
        for info in catalog.list_tables():
            if info.options.get("materialized_view"):
                # a view's backing table rebuilds from its state record
                # and DDL; persisted as a table it would collide with the
                # DDL replay that recreates it
                continue
            tables.append({
                "name": info.name, "provider": info.provider,
                "schema": schema_to_json(info.schema),
                "options": info.options,
                "key_columns": list(info.key_columns),
                "partition_by": list(info.partition_by),
                "buckets": info.buckets,
                "colocate_with": info.colocate_with,
                "redundancy": info.redundancy,
                "base_table": info.base_table,
            })
        # views persist as their DDL text, re-executed on recovery; the
        # grants key stays empty until the port holds grants
        views = dict(getattr(catalog, "_view_ddl", {}))
        matviews = dict(getattr(catalog, "_matview_ddl", {}))
        topks = dict(getattr(catalog, "_topk_defs", {}))
        # functions, policies and indexes
        aux = dict(getattr(catalog, "_aux_ddl", {}))
        tmp = os.path.join(self.path, "catalog.json.tmp")
        with open(tmp, "w") as fh:
            json.dump({"version": 1, "tables": tables, "views": views,
                       "matviews": matviews, "topks": topks,
                       "aux_ddl": aux, "grants": []}, fh, indent=1)
        self._durable_replace(tmp, os.path.join(self.path, "catalog.json"))

    # -- materialized-view state ------------------------------------------

    @staticmethod
    def _live_row_count_of(data) -> int:
        if hasattr(data, "snapshot"):          # column table: manifest sum
            return int(data.snapshot().total_rows())
        return int(data.count())               # row table

    def _views_dir(self) -> str:
        return os.path.join(self.path, "views")

    def _view_state_path(self, name: str) -> str:
        return os.path.join(self._views_dir(), f"{name}.state")

    def checkpoint_matview(self, mv, wal_seq: int, catalog=None) -> None:
        """Persist one view's [G] partial state with its WAL fence: a
        CRC-framed record, durable-replaced so a crash mid-write keeps
        the previous state authoritative.  The caller holds
        mutation_lock: the state is consistent with everything journaled
        up to `wal_seq`.  With a catalog, the base table's live row count
        rides the header, so recovery can detect a base that lost
        unjournaled rows (such a state degrades to STALE)."""
        mv.wal_seq = wal_seq
        base_rows = None
        if catalog is not None:
            base = catalog.lookup_table(mv.base_table)
            if base is not None:
                base_rows = self._live_row_count_of(base.data)
        header, arrays = mv.state_record(base_rows=base_rows)
        os.makedirs(self._views_dir(), exist_ok=True)
        tmp = os.path.join(self._views_dir(), f"{mv.name}.tmp")
        with open(tmp, "wb") as fh:
            write_record(fh, header, arrays)
        self._durable_replace(tmp, self._view_state_path(mv.name))

    def drop_matview_state(self, name: str) -> None:
        try:
            os.remove(self._view_state_path(name))
        except FileNotFoundError:
            pass

    # -- checkpoint ------------------------------------------------------

    def checkpoint_table(self, info, wal_seq: int) -> None:
        tdir = os.path.join(self.path, "tables", info.name)
        os.makedirs(tdir, exist_ok=True)
        from snappydata_tpu_torch.storage import tier

        # this store's batch files are the table's quarantine-rebuild
        # source from now on
        tier.bind_store(info.data, self)
        if isinstance(info.data, RowTableData):
            arrays, masks, n = info.data.to_arrays_with_nulls()
            with open(os.path.join(tdir, "rows.tmp"), "wb") as fh:
                write_record(fh, {"kind": "rowtable", "n": n,
                                  "ncols": len(arrays),
                                  "columns": [f.name.lower() for f in
                                              info.schema.fields],
                                  "wal_seq": wal_seq},
                             list(arrays) + list(masks))
            self._durable_replace(os.path.join(tdir, "rows.tmp"),
                                  os.path.join(tdir, "rows.dat"))
            return
        data: ColumnTableData = info.data
        m = data.snapshot()
        batch_entries = []
        for view in m.views:
            b = view.batch
            fname = f"batch-{b.batch_id}.col"
            fpath = os.path.join(tdir, fname)
            if not os.path.exists(fpath):  # immutable → write once
                self._write_batch(fpath, b, info.schema)
            entry = {"file": fname, "batch_id": b.batch_id,
                     "num_rows": b.num_rows, "capacity": b.capacity}
            if view.delete_mask is not None:
                entry["delete_mask"] = _b64(view.delete_mask)
            if view.deltas:
                entry["deltas"] = [
                    {"col": ci, "hit": _b64(hit), "values": _b64(values),
                     "nulls": _b64(vnulls) if vnulls is not None else None}
                    for ci, hit, values, vnulls in view.deltas]
            batch_entries.append(entry)
        manifest = {
            "version": m.version,
            # epoch fence: recovery advances the mvcc clock past it so
            # post-recovery commit epochs stay monotone with pre-crash
            # ones (the per-table version vector resumes, never rewinds)
            "epoch": int(getattr(m, "epoch", 0)),
            "batches": batch_entries,
            "row_count": m.row_count,
            # schema as of this checkpoint: ALTER TABLE between checkpoints
            # makes load align columns by NAME (missing → NULL, extra →
            # dropped), then the fenced WAL replays the ALTER itself
            "columns": [f.name.lower() for f in info.schema.fields],
            "wal_seq": wal_seq,   # replay fence: records ≤ this are folded
        }
        with open(os.path.join(tdir, "rowbuf.tmp"), "wb") as fh:
            write_record(fh, {"kind": "rowbuf", "n": m.row_count},
                         list(m.row_arrays) + [
                             nm for nm in (m.row_nulls or
                                           [None] * len(m.row_arrays))])
        self._durable_replace(os.path.join(tdir, "rowbuf.tmp"),
                              os.path.join(tdir, "rowbuf.dat"))
        tmp = os.path.join(tdir, "manifest.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(manifest, fh)
        self._durable_replace(tmp, os.path.join(tdir, "manifest.json"))
        # GC batches dropped from the manifest (deletes/truncate)
        live = {e["file"] for e in batch_entries}
        for f in os.listdir(tdir):
            if f.startswith("batch-") and f not in live:
                os.remove(os.path.join(tdir, f))

    def checkpoint(self, catalog) -> None:
        # crash fence: after a failed group drain, in-memory state can
        # hold rows whose statements RAISED at ack time (applied, then
        # the covering fsync failed). Folding that state into a durable
        # checkpoint would silently persist rows the client was told
        # failed — the Postgres fsync-panic lesson. Recovery (reopen)
        # rebuilds memory from the journal alone and clears the fence.
        if self._wal_damaged:
            raise IOError(
                "WAL group drain failed earlier; in-memory state may "
                "exceed the journal — reopen/recover the store before "
                "checkpointing")
        # mutation_lock: no writer can be between journal and apply, so
        # every snapshot state == everything journaled up to wal_seq
        with self.mutation_lock:
            # locklint: blocking-under-lock checkpoint must drain+fsync
            # INSIDE its mutation hold (see below) — rare, operator-paced
            # drain the commit buffer BEFORE folding anything: the
            # snapshot below must only ever fold rows whose WAL records
            # are already fsynced — folding a buffered record and THEN
            # failing its drain would durably persist a statement whose
            # ack raised (the fence above can't catch a failure that
            # happens after folding). A failed drain aborts the
            # checkpoint here, before any durable artifact is touched.
            self.wal_sync(force=True)
            if self._wal_damaged:
                raise IOError(
                    "WAL group drain failed; store must be reopened "
                    "before checkpointing")
            self.save_catalog(catalog)
            seq = self.current_wal_seq()
            folded = {}
            for info in catalog.list_tables():
                if info.options.get("materialized_view"):
                    continue   # rebuilt from the view state below
                self.checkpoint_table(info, seq)
                folded[info.name] = seq
            from snappydata_tpu_torch.views.matview import matviews

            for mv in matviews(catalog).values():
                self.checkpoint_matview(mv, seq, catalog=catalog)
            self._rotate_wal(folded)

    def _write_batch(self, fpath: str, batch: ColumnBatch,
                     schema: Optional[T.Schema] = None) -> None:
        with open(fpath + ".tmp", "wb") as fh:
            for i, col in enumerate(batch.columns):
                stats = col.stats
                header = {
                    "col": i, "encoding": int(col.encoding),
                    "dtype": _dtype_to_json(col.dtype),
                    # column NAME at write time: batch files are
                    # write-once, so a later ALTER leaves them with a
                    # different column set than the manifest — load
                    # aligns by these names (legacy files without them
                    # fall back to the manifest's positional remap)
                    "name": (schema.fields[i].name.lower()
                             if schema is not None
                             and i < len(schema.fields) else None),
                    "num_rows": col.num_rows,
                    "stats": None if stats is None else {
                        "min": _json_safe(stats.min),
                        "max": _json_safe(stats.max),
                        "null_count": stats.null_count,
                        "count": stats.count},
                }
                write_record(fh, header,
                             [col.data, col.dictionary, col.runs,
                              col.validity])
        self._durable_replace(fpath + ".tmp", fpath)

    # -- WAL (group commit) ----------------------------------------------

    @staticmethod
    def _wal_policy() -> Tuple[str, float, int]:
        """(mode, group window seconds, buffer bytes) parsed from config.
        Modes (`wal_fsync_mode`):

        always        every append drains+fsyncs before returning (the
                      pre-group-commit behavior; one fsync per record);
        group         appends buffer; the ACK (wal_sync) drains the whole
                      group with one write+fsync — concurrent committers
                      coalesce, a lone committer pays one fsync that the
                      background flusher usually starts while the caller
                      is still applying/encoding (pipelined);
        interval:<ms> appends buffer and acks return WITHOUT waiting; the
                      flusher fsyncs every <ms>. Relaxed durability: a
                      crash may lose up to <ms> of ACKED local writes
                      (network surfaces still force a covering fsync)."""
        from snappydata_tpu_torch import config

        props = config.global_properties()
        raw = str(props.get("wal_fsync_mode") or "group").strip().lower()
        group_s = max(0.0, float(props.get("wal_group_ms") or 0.0)) / 1e3
        buffer_bytes = int(props.get("wal_buffer_bytes") or (8 << 20))
        if raw.startswith("interval"):
            _, _, ms = raw.partition(":")
            try:
                if ms:
                    group_s = max(0.0, float(ms)) / 1e3
            except ValueError:
                pass
            return "interval", group_s, buffer_bytes
        if raw not in ("always", "group"):
            raw = "group"
        return raw, group_s, buffer_bytes

    def _ensure_fh(self) -> io.BufferedWriter:
        """Open (and, after a torn-write crash, salvage) the log for
        appending. Caller holds _io_lock."""
        if self._wal_fh is None:
            # reopen-time repair: if a tear was left since the log was
            # last open (torn-write fault paths), appending after it
            # would strand new records behind bytes replay can never
            # traverse
            if not self._wal_clean:
                salvage_file(self._wal_path())
                self._wal_clean = True
            self._wal_fh = open(self._wal_path(), "ab")
        return self._wal_fh

    def wal_append(self, table: str, kind: str, sql: Optional[str] = None,
                   params: Optional[tuple] = None,
                   arrays: Optional[List[np.ndarray]] = None,
                   nulls: Optional[List[Optional[np.ndarray]]] = None,
                   extra: Optional[dict] = None) -> int:
        """Append one record to the global log. kinds:
        'sql' (statement text + scalar params), 'insert'/'put' (raw column
        arrays), 'delete_keys' (key-tuple arrays + key column names),
        'drop' (incarnation marker). Returns the record's seq.

        Group commit: the framed record lands in the commit buffer; the
        covering fsync is released by wal_sync(seq) — callers MUST gate
        their ack on it (session/_journal_then/flight do_put all do)."""
        mode, _group_s, buffer_bytes = self._wal_policy()
        # per-RECORD failpoint: raise/sleep fire here with the same hit
        # cadence as before group commit existed
        spec = failpoints.hit("wal.append")
        with self._lock:
            self._wal_seq += 1
            seq = self._wal_seq
            header = {"kind": kind, "table": table, "seq": seq}
            if extra:
                header.update(extra)
            payload: List[Optional[np.ndarray]] = []
            if kind == "sql":
                header["sql"] = sql
                header["params"] = [_json_safe(p) for p in (params or ())]
            elif kind in ("insert", "put", "delete_keys"):
                payload = list(arrays or [])
                header["ncols"] = len(payload)
                payload += list(nulls or [None] * len(payload))
            # frame through the module-level frame_record (the seam the
            # disk-full tests patch) so injected write failures surface
            # HERE, before the caller applies — an encode/frame error
            # must fail the statement synchronously, never the
            # background drain. One buffer, no intermediate copies.
            raw = frame_record(header, payload)
            torn = spec is not None and spec.action == "torn_write"
            if torn:
                cut = max(1, int(spec.param))
                raw = raw[:max(0, len(raw) - cut)]
            self._commit_buf.append((seq, raw))
            self._commit_bytes += len(raw)
            self._buffered_seq = seq
            if self._commit_first_t is None:
                self._commit_first_t = time.monotonic()
            full = self._commit_bytes >= buffer_bytes
            if torn:
                # swap the group out IN THIS critical section so no
                # concurrent append can land BEHIND the torn bytes (it
                # would be fsynced yet truncated by salvage — an acked
                # row lost), and queue it as a PENDING torn write: the
                # next writer to hold _io_lock (us, a concurrent drain,
                # or the flusher) writes it FIRST, so no higher-seq
                # record can reach the file before this group and
                # replay order stays seq order
                group, self._commit_buf = self._commit_buf, []
                self._commit_bytes = 0
                self._commit_first_t = None
                self._pending_torn.append((group, seq))
            elif mode != "always":
                self._ensure_flusher_locked()
                self._commit_cond.notify_all()
        if torn:
            # crash mid-append: earlier buffered records reach disk whole
            # (they were never at fault — their acks still release), THIS
            # record loses its tail, and the store must be reopened like
            # a real crash — boot-time salvage then truncates the tear.
            with self._io_lock:
                self._flush_pending_torn()
            raise failpoints.InjectedFault(
                f"failpoint wal.append: injected torn write "
                f"({max(1, int(spec.param))} bytes cut)")
        if mode == "always" or full:
            # always: per-record durability (the legacy contract);
            # full: backpressure — the buffer bound is wal_buffer_bytes
            self._drain_upto(seq)
        with self._lock:
            # from here the caller applies: losing this record later
            # (failed drain) means memory-exceeds-journal divergence
            self._returned_seq = max(self._returned_seq, seq)
        return seq

    def _flush_pending_torn(self) -> None:
        """Write queued torn groups (crash mid-append). Caller holds
        _io_lock — called by every writer before it touches the file, so
        torn bytes always precede later records. Each group's LAST
        record is torn; it is written, fsynced, and the log is closed
        dirty (boot/reopen salvage truncates the tear). Complete records
        keep their acks (durable watermark advances over them); the torn
        record's seq is poisoned so any other waiter on it raises
        instead of hanging."""
        while True:
            with self._lock:
                if not self._pending_torn:
                    return
                group, torn_seq = self._pending_torn.pop(0)
            try:
                fh = self._ensure_fh()
                fh.write(b"".join(raw for _, raw in group))
                fh.flush()
                # locklint: blocking-under-lock the pending-torn FIFO must
                # flush under the io lock before ANY later write so file
                # order == seq order after a crash-shaped tear; rare path
                os.fsync(fh.fileno())
                covered = group[-2][0] if len(group) > 1 else None
                with self._lock:
                    if covered is not None:
                        self._durable_seq = max(self._durable_seq,
                                                covered)
                    self._lost.append((torn_seq, torn_seq,
                                       failpoints.InjectedFault(
                                           "wal.append: torn write")))
                    # the torn record never returned from wal_append
                    # (never applied): no divergence/fence — and the
                    # watermark moves past it so barriers don't wedge
                    # on a seq that can never drain
                    self._durable_seq = max(self._durable_seq, torn_seq)
                    self._commit_cond.notify_all()
            # locklint: swallowed-exception not swallowed: the error
            # object itself is routed to EVERY waiter through the
            # poisoned seq range (_lost) and the _wal_damaged fence —
            # strictly louder than a log line
            except Exception as e:
                # a REAL I/O failure on top of the injected tear: nothing
                # in this group is provably durable — poison it all so no
                # waiter hangs on an unreachable watermark
                with self._lock:
                    self._lost.append((group[0][0], torn_seq, e))
                    if group[0][0] <= self._returned_seq:
                        # earlier records in the group were applied but
                        # are now unjournaled — crash-shaped divergence
                        self._wal_damaged = True
                    self._durable_seq = max(self._durable_seq, torn_seq)
                    self._commit_cond.notify_all()
            finally:
                if self._wal_fh is not None:
                    try:
                        self._wal_fh.close()
                    # locklint: swallowed-exception best-effort close on
                    # an already-failing handle; the tear itself is
                    # recorded via _lost/_wal_damaged above
                    except Exception:
                        pass
                    self._wal_fh = None
                self._wal_clean = False   # tear on disk until salvaged

    def wal_sync(self, seq: Optional[int] = None,
                 force: bool = False) -> None:
        """Block until every record with seq ≤ `seq` is covered by an
        fsync — THE ack gate of the group-commit write path. `seq=None`
        targets everything appended so far. In `interval` mode the ack is
        relaxed (returns immediately) unless `force=True` — network
        surfaces (Flight do_put, replica fan-out) force it so a remote
        ack always implies durability."""
        mode, _group_s, _bb = self._wal_policy()
        with self._lock:
            barrier = seq is None
            if barrier:
                seq = self._buffered_seq
            else:
                # a specific record's ack: raise if IT was lost
                self._check_lost_locked(seq)
            if self._durable_seq >= seq:
                return
        if mode == "interval" and not force:
            return
        if barrier:
            # barrier semantics (checkpoint, /wal/flush, wal_sync
            # action): make everything still PENDING durable. Records
            # lost to an EARLIER failed drain are gone — their own acks
            # already raised — and must not fail every future barrier;
            # only a failure of the drain we perform NOW propagates.
            while True:
                self._drain()
                with self._lock:
                    if self._durable_seq >= seq:
                        return
        else:
            self._drain_upto(seq)

    def _check_lost_locked(self, seq: int) -> None:
        for lo, hi, exc in self._lost:
            if lo <= seq <= hi:
                raise exc

    def _drain(self) -> None:
        """Flush the commit buffer as ONE contiguous write + ONE fsync
        (the group). Serialized on _io_lock: while one drainer fsyncs,
        later appends pile into the fresh buffer and the next drain
        covers them all — the classic leader-based group commit."""
        with self._io_lock:
            # torn crash writes queued ahead of us go to the file FIRST
            # (their seqs are lower), then _ensure_fh below salvages the
            # tear before this group lands
            self._flush_pending_torn()
            with self._lock:
                if not self._commit_buf:
                    return
                group, self._commit_buf = self._commit_buf, []
                nbytes, self._commit_bytes = self._commit_bytes, 0
                self._commit_first_t = None
            first, last = group[0][0], group[-1][0]
            lost_from = first
            t0 = time.monotonic()
            try:
                # per-GROUP failpoint: torn-write tears the group's tail
                # (the mid-group crash shape); raise fails the whole
                # drain — INSIDE the try so the swapped-out group is
                # poisoned like any real drain failure (a waiter must
                # never spin on records that left the buffer unwritten)
                spec = failpoints.hit("wal.group_commit")
                data = group[0][1] if len(group) == 1 else \
                    b"".join(raw for _, raw in group)
                if spec is not None and spec.action == "torn_write":
                    cut = max(1, int(spec.param))
                    keep = max(0, len(data) - cut)
                    fh = self._ensure_fh()
                    fh.write(data[:keep])
                    fh.flush()
                    # locklint: blocking-under-lock the drain IS the group
                    # fsync: wal_io exists to serialize it; acks
                    # wait on _commit_cond, never on wal_io
                    os.fsync(fh.fileno())
                    # records whose frames lie ENTIRELY inside the
                    # written-and-fsynced prefix are durable — their acks
                    # must still release; only the torn tail's waiters
                    # fail (salvage truncates exactly that tail on boot)
                    end = 0
                    covered = first - 1
                    for s_, raw_ in group:
                        end += len(raw_)
                        if end <= keep:
                            covered = s_
                    with self._lock:
                        self._durable_seq = max(self._durable_seq,
                                                covered)
                    lost_from = covered + 1
                    raise failpoints.InjectedFault(
                        f"failpoint wal.group_commit: injected torn "
                        f"group write ({cut} bytes cut, "
                        f"{len(group)} records)")
                fh = self._ensure_fh()
                fh.write(data)
                fh.flush()
                # the fsync seam: a raise here is the fsync-failure
                # crash shape (Postgres fsync-gate lesson) — INSIDE the
                # try, so the group is poisoned and _wal_damaged fences
                # checkpoints exactly like a real EIO from the kernel
                failpoints.hit("wal.fsync")
                # locklint: blocking-under-lock the drain IS the group
                # fsync; see the torn-branch note above
                os.fsync(fh.fileno())
            except BaseException as e:
                # the group's records may be torn or absent on disk: the
                # store is crash-shaped. Poison the seq range so every
                # waiter's ack RAISES (instead of hanging on a durable
                # watermark that will never cover it), and force a
                # reopen-salvage before the next append.
                with self._lock:
                    self._lost.append((lost_from, last, e))
                    if lost_from <= self._returned_seq:
                        # a RETURNED record was lost: its statement went
                        # on to apply, so memory now exceeds the journal
                        # — fence checkpoints until reopen. (A record
                        # lost before its append returned — always-mode
                        # inline drain — never applied: no divergence.)
                        self._wal_damaged = True
                    # nothing will ever make the lost range durable:
                    # advance the watermark past it so barriers and
                    # later waiters don't wedge (the lost records' own
                    # acks still raise via _check_lost_locked)
                    self._durable_seq = max(self._durable_seq, last)
                    self._commit_cond.notify_all()
                if self._wal_fh is not None:
                    try:
                        self._wal_fh.close()
                    except Exception:
                        pass
                    self._wal_fh = None
                self._wal_clean = False
                raise
            from snappydata_tpu_torch.observability.metrics import global_registry

            reg = global_registry()
            reg.inc("wal_fsync_count")
            reg.inc("wal_group_commit_batches")
            reg.inc("wal_records_written", len(group))
            reg.inc("wal_bytes_written", len(data))
            reg.record_time("wal_group_flush", time.monotonic() - t0)
            with self._lock:
                self._durable_seq = max(self._durable_seq, last)
                self._commit_cond.notify_all()

    def _drain_upto(self, seq: int) -> None:
        while True:
            with self._lock:
                self._check_lost_locked(seq)
                if self._durable_seq >= seq:
                    return
            self._drain()
            with self._lock:
                self._check_lost_locked(seq)
                if self._durable_seq >= seq:
                    return

    def _ensure_flusher_locked(self) -> None:
        """Start (or restart) the background flusher. It drains groups
        that aged past the group window / interval, which (a) overlaps
        the fsync with the caller's encode/apply work — the pipelined
        ingest lane — and (b) bounds the relaxed-ack window of interval
        mode. Caller holds _lock."""
        from snappydata_tpu_torch import config

        self._closed = False
        if self._flusher is None or not self._flusher.is_alive():
            # threads the port starts run inside the device scope of the
            # session that started them
            t = threading.Thread(target=self._flusher_loop, daemon=True,
                                 args=(config._device.get(),),
                                 name=f"wal-flusher-{id(self):x}")
            self._flusher = t
            t.start()

    def _flusher_loop(self, device=None) -> None:
        from snappydata_tpu_torch import config

        with config.device_scope(device):
            self._flusher_body()

    def _flusher_body(self) -> None:
        while True:
            with self._lock:
                idle = 0
                while not self._commit_buf and not self._closed:
                    self._commit_cond.wait(timeout=0.5)
                    idle += 1
                    if idle >= 10 and not self._commit_buf:
                        # park after ~5s idle; respawned on demand
                        self._flusher = None
                        return
                if self._closed:
                    self._flusher = None
                    return
                mode, group_s, buffer_bytes = self._wal_policy()
                age = time.monotonic() - (self._commit_first_t
                                          or time.monotonic())
                if age < group_s and self._commit_bytes < buffer_bytes:
                    self._commit_cond.wait(timeout=group_s - age)
                    continue   # re-evaluate: an ack drain may have run
            try:
                self._drain()
            except Exception:
                # the failed seq range is poisoned — every waiter RAISES
                # it as its ack — but count the event too: a flusher
                # failing every tick should show on the dashboard, not
                # only on whichever request happens to wait
                from snappydata_tpu_torch.observability.metrics import \
                    global_registry

                global_registry().inc("wal_flusher_errors")

    def current_wal_seq(self) -> int:
        with self._lock:
            return self._wal_seq

    def _rotate_wal(self, folded: Dict[str, int]) -> None:
        """Drop records already folded into every table's checkpoint.
        Safe because replay fences on per-table wal_seq anyway — rotation
        is pure space reclamation."""
        self._drain()   # the file we rewrite must hold every append
        with self._io_lock:
            with self._lock:
                if not os.path.exists(self._wal_path()):
                    return
                if self._wal_fh is not None:
                    self._wal_fh.close()
                    self._wal_fh = None
            # a mid-file corrupt record must not abort the checkpoint:
            # salvage the prefix, quarantine the damage, rotate what's
            # readable (the damaged record's mutation was acked against
            # bytes that no longer exist — quarantine + counter is the
            # honest response, failing every future checkpoint is not)
            salvage_file(self._wal_path())
            # kept records are copied as framed, never re-encoded
            keep: List[bytes] = []
            with open(self._wal_path(), "rb") as fh:
                for header, frame in read_frames(fh):
                    t = header.get("table")
                    if header.get("seq", 0) > folded.get(t, 0):
                        keep.append(frame)
            tmp = self._wal_path() + ".tmp"
            with open(tmp, "wb") as fh:
                for frame in keep:
                    fh.write(frame)
            self._durable_replace(tmp, self._wal_path())

    def drop_table_dir(self, table: str) -> None:
        """DROP TABLE: journal a drop marker, remove the on-disk dir (a
        recreate must not resurrect old batches)."""
        import shutil

        seq = self.wal_append(table, "drop")
        # the marker must be ON DISK before the table dir disappears —
        # force past interval mode's relaxed ack
        self.wal_sync(seq, force=True)
        tdir = os.path.join(self.path, "tables", table)
        if os.path.isdir(tdir):
            shutil.rmtree(tdir)

    def close(self) -> None:
        try:
            # a clean shutdown must not lose interval-mode acked tails
            self._drain()
        except Exception:
            pass   # crash-shaped close: salvage handles it on reboot
        with self._lock:
            self._closed = True
            self._commit_cond.notify_all()
        with self._io_lock:
            if self._wal_fh is not None:
                self._wal_fh.close()
                self._wal_fh = None

    # -- recovery --------------------------------------------------------

    def recover_catalog(self, session):
        """Rebuild the catalog and table data from disk into `session`
        (on its device): checkpointed batches and row buffers, then ONE
        ordered replay of the global WAL fenced per table on the
        checkpoint's wal_seq, then views, materialized views (their
        checkpointed state, then the WAL tail past each one's watermark)
        and functions, policies and indexes, then the sample tables'
        maintainers and the TopKs.  A directory that records deployed
        code, streams or grants raises NotImplementedError: those are not
        ported."""
        from snappydata_tpu_torch import config
        from snappydata_tpu_torch.catalog import Catalog
        from snappydata_tpu_torch.engine.executor import Executor
        from snappydata_tpu_torch.sql.analyzer import Analyzer
        from snappydata_tpu_torch.storage import mvcc

        # the WAL seq floor doubles as the epoch floor (seqs ARE commit
        # timestamps): the mvcc clock resumes past everything this store
        # ever acked, before any replay publishes
        mvcc.advance_to(self._wal_seq)
        cat_path = os.path.join(self.path, "catalog.json")
        catalog = Catalog()
        meta = {"tables": []}
        if os.path.exists(cat_path):
            with open(cat_path) as fh:
                meta = json.load(fh)
        unported = ["grants"] if meta.get("grants") else []
        unported += sorted(k for k in (meta.get("aux_ddl") or {})
                           if not k.startswith(("function:", "policy:",
                                                "index:")))
        if unported:
            raise NotImplementedError(
                f"{self.path}: the catalog records {', '.join(unported)}, "
                f"whose recovery is not ported")
        # the caller's analyzer / executor bound the pre-recovery catalog
        # at construction: rebind BEFORE replay executes any statement
        session.catalog = catalog
        session.analyzer = Analyzer(catalog)
        session.executor = Executor(catalog, session.conf, session.device)
        # storage encodes at the device's width: load and replay inside
        # the session's device scope
        with config.device_scope(session.device):
            folded: Dict[str, int] = {}
            sample_tables = []
            for t in meta["tables"]:
                schema = schema_from_json(t["schema"])
                info = catalog.create_table(
                    t["name"], schema, t["provider"], t.get("options", {}),
                    key_columns=t.get("key_columns", ()))
                folded[info.name] = self._load_table_data(info)
                if t["provider"] == "sample":
                    sample_tables.append(info)
            self._recover_views(catalog, session, meta, folded)
            # AQP re-registration: the maintainers and TopKs re-seed from
            # the recovered base tables
            for info in sample_tables:
                session.register_sample(info)
            for name, d in (meta.get("topks") or {}).items():
                session.create_topk(
                    name, d["base_table"], d["key_column"],
                    k=d.get("k", 50), time_column=d.get("time_column"),
                    bucket_seconds=d.get("bucket_seconds", 60))
        return catalog

    def _recover_views(self, catalog, session, meta, folded) -> None:
        """Views, then materialized views (state reload, fence checks),
        then the WAL replay (which folds only each view's tail), then the
        views that could not restore before it, then functions."""
        # views come BEFORE the replay: a journaled statement may read
        # one (INSERT INTO t SELECT ... FROM some_view), and a view over
        # a table only created later in the WAL retries after it
        pending_views = {}
        with _no_journal(session):
            for name, ddl in (meta.get("views") or {}).items():
                try:
                    session.sql(ddl)
                except Exception:
                    pending_views[name] = ddl
        # materialized views restore BEFORE the replay, so the tail past
        # each view's checkpointed watermark folds exactly once: a state
        # loaded at fence W skips records <= W; a missing or damaged
        # state, or a fence that does not match the base table's, brings
        # the view up STALE (it re-aggregates at its first read)
        matview_ddl = dict(meta.get("matviews") or {})
        if matview_ddl:
            session._mv_recovering = True
            try:
                with _no_journal(session):
                    for name, ddl in matview_ddl.items():
                        try:
                            session.sql(ddl)
                        except Exception:
                            continue
                        mv = getattr(catalog, "_matviews", {}).get(name)
                        if mv is not None:
                            self._load_matview_state(catalog, mv, folded)
            finally:
                session._mv_recovering = False
            catalog._matview_ddl = matview_ddl
        self._replay_wal(catalog, session, folded)
        with _no_journal(session):
            for ddl in pending_views.values():
                try:
                    session.sql(ddl)
                except Exception:
                    pass  # a view over a dropped table: skipped
        catalog._view_ddl = dict(meta.get("views") or {})
        # functions, policies and indexes re-execute their DDL.  A policy
        # that fails is a security regression (the table would come up
        # unfiltered): recovery refuses; a failed index only loses a fast
        # path: warn
        for name, ddl in (meta.get("aux_ddl") or {}).items():
            try:
                session.sql(ddl)
            except Exception as e:
                if name.startswith("policy:"):
                    raise RuntimeError(
                        f"recovery could not restore row-level policy "
                        f"{name!r} ({e}); refusing to come up without it")
                print(f"warning: recovery skipped {name!r}: {e}",
                      file=sys.stderr)
        catalog._aux_ddl = dict(meta.get("aux_ddl") or {})

    def _load_matview_state(self, catalog, mv, folded) -> None:
        loaded = False
        ckpt_base_rows = None
        spath = self._view_state_path(mv.name)
        if os.path.exists(spath):
            try:
                salvage_file(spath, counter="batch_corrupt_records")
                with open(spath, "rb") as fh:
                    for header, arrays in read_records(fh):
                        mv.load_state(header, arrays)
                        ckpt_base_rows = header.get("base_rows")
                        loaded = True
            except Exception:
                loaded = False
        base = catalog.lookup_table(mv.base_table)
        if not loaded:
            mv.stale = True
        elif mv.wal_seq != folded.get(mv.base_table, 0):
            mv.mark_stale("recovery fence mismatch")
        elif (ckpt_base_rows is not None and base is not None
              and self._live_row_count_of(base.data) != ckpt_base_rows):
            # the restored base holds another row set than the one the
            # state aggregated (unjournaled writes are gone and the WAL
            # can never replay them): serving the state would be wrong
            mv.mark_stale("recovery base-rows mismatch")

    def _load_table_data(self, info) -> int:
        """Load checkpointed state; returns the folded wal_seq (0 = no
        checkpoint on disk)."""
        tdir = os.path.join(self.path, "tables", info.name)
        from snappydata_tpu_torch.storage import tier

        tier.bind_store(info.data, self)
        if isinstance(info.data, RowTableData):
            rpath = os.path.join(tdir, "rows.dat")
            seq = 0
            if os.path.exists(rpath):
                salvage_file(rpath, counter="batch_corrupt_records")
                with open(rpath, "rb") as fh:
                    for header, arrays in read_records(fh):
                        seq = header.get("wal_seq", 0)
                        if header["n"]:
                            ncols = header.get("ncols", len(arrays))
                            cols, masks = arrays[:ncols], arrays[ncols:]
                            if masks:
                                from snappydata_tpu_torch.session import \
                                    _restore_none_arrays

                                cols = _restore_none_arrays(cols, masks)
                            cols = _align_by_name(
                                cols, header.get("columns"),
                                info.schema, header["n"])
                            info.data.insert_arrays(cols)
            return seq
        mpath = os.path.join(tdir, "manifest.json")
        if not os.path.exists(mpath):
            return 0
        with open(mpath) as fh:
            manifest = json.load(fh)
        data: ColumnTableData = info.data
        cur_names = [f.name.lower() for f in info.schema.fields]
        saved_names = manifest.get("columns", cur_names)
        remap = None          # saved col idx -> current col idx (or None)
        if saved_names != cur_names:
            remap = [cur_names.index(nm) if nm in cur_names else None
                     for nm in saved_names]
        views = []
        for entry in manifest["batches"]:
            fpath = os.path.join(tdir, entry["file"])
            try:
                # FileNotFoundError covers the boot AFTER a quarantine:
                # the manifest still names the file until the next
                # checkpoint rewrites it — a missing batch must skip the
                # same way the corrupt one did, not fail boot
                batch, file_names = self._read_batch(fpath, entry,
                                                     info.schema)
            except (CorruptRecordError, FileNotFoundError) as e:
                # a damaged immutable batch cannot be partially used (a
                # missing column would desync the columnar views):
                # quarantine the whole file, count it, keep booting —
                # the reference's disk stores quarantine bad oplogs the
                # same way rather than refusing to start
                from snappydata_tpu_torch.observability.metrics import \
                    global_registry

                global_registry().inc("batch_corrupt_records")
                _log.error(
                    "%s: %s — quarantining batch file (%d rows lost) "
                    "and continuing recovery", fpath, e,
                    entry.get("num_rows", -1))
                if os.path.exists(fpath):
                    os.replace(fpath, fpath + ".corrupt")
                continue
            delete_mask = _unb64(entry.get("delete_mask"), np.bool_)
            deltas = tuple(
                (d["col"], _unb64(d["hit"], np.bool_),
                 _unb64_any(d["values"]),
                 _unb64(d["nulls"], np.bool_) if d.get("nulls") else None)
                for d in entry.get("deltas", ()))
            import dataclasses as _dc

            # align the batch's columns to the CURRENT schema. Batch
            # files are write-once, so their column set reflects the
            # schema at WRITE time — which may predate both the
            # manifest's saved_names and today's schema (ALTERs in
            # between). Files that recorded names align exactly; legacy
            # files fall back to the manifest's positional remap.
            if file_names is not None:
                align_names = file_names if file_names != cur_names \
                    else None
            else:
                align_names = saved_names if remap is not None else None
            if align_names is not None:
                by_name = dict(zip(align_names, batch.columns))
                batch = _dc.replace(batch, columns=tuple(
                    by_name[nm] if nm in by_name
                    else data._all_null_column(ci, f.dtype, batch.num_rows)
                    for ci, (nm, f) in enumerate(
                        zip(cur_names, info.schema.fields))))
            if remap is not None:
                deltas = tuple((remap[ci], hit, vals, vn)
                               for ci, hit, vals, vn in deltas
                               if remap[ci] is not None)
            views.append(BatchView(batch, delete_mask, deltas))
        # locklint: lock=storage.column_table (batch recovery is
        # column-table only; row tables restore through their own path)
        with data._lock:
            # re-intern dictionaries so table-level codes match batch codes
            for ci in data._dicts:
                for v in views:
                    col = v.batch.columns[ci]
                    if col.dictionary is not None:
                        data._intern_strings(
                            ci, np.asarray(col.dictionary, dtype=object))
            rb = os.path.join(tdir, "rowbuf.dat")
            if os.path.exists(rb):
                salvage_file(rb, counter="batch_corrupt_records")
                with open(rb, "rb") as fh:
                    for header, arrays in read_records(fh):
                        n_cols = len(saved_names)
                        if header["n"]:
                            cols = list(arrays[:n_cols])
                            nls = list(arrays[n_cols:]) or [None] * n_cols
                            if remap is not None:
                                cols, nls = _align_rowbuf(
                                    cols, nls, saved_names, info.schema,
                                    header["n"])
                            # row-buffer strings must re-enter the shared
                            # dictionary (batches carry their own dict;
                            # buffer rows don't)
                            for ci in data._dicts:
                                data._intern_strings(
                                    ci, np.asarray(cols[ci], dtype=object))
                            data._row_buffer.append(cols, nls)
            # advance batch id counter past recovered ids
            import itertools

            max_id = max((e["batch_id"] for e in manifest["batches"]),
                         default=-1)
            data._batch_ids = itertools.count(max_id + 1)
            from snappydata_tpu_torch.storage import mvcc

            # rebuild the version vector: the clock resumes past the
            # checkpointed epoch, and the recovered manifest is stamped
            # with the checkpoint's wal_seq (its commit fence)
            mvcc.advance_to(int(manifest.get("epoch", 0)))
            with mvcc.commit_scope(int(manifest.get("wal_seq", 0))):
                data._publish(tuple(views))
        return manifest.get("wal_seq", 0)

    def load_batch(self, table: str, batch_id: int
                   ) -> Optional[ColumnBatch]:
        """Re-read ONE checkpointed batch by id: the tier quarantine's
        rebuild source (storage/tier.py).  Batch files are write-once, so
        a clean read IS the batch as of its last checkpoint; None when the
        table or batch has no durable artifact, or that artifact is itself
        damaged (the caller's typed-error path takes over)."""
        tdir = os.path.join(self.path, "tables", table)
        mpath = os.path.join(tdir, "manifest.json")
        if not os.path.exists(mpath):
            return None
        try:
            with open(mpath) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError):
            return None
        for entry in manifest.get("batches", ()):
            if int(entry.get("batch_id", -1)) != int(batch_id):
                continue
            fpath = os.path.join(tdir, entry["file"])
            try:
                batch, _names = self._read_batch(fpath, entry, None)
            except (CorruptRecordError, OSError):
                return None
            return batch
        return None

    def _read_batch(self, fpath: str, entry: dict, schema: T.Schema
                    ) -> Tuple[ColumnBatch, Optional[List[str]]]:
        """Read a batch file; returns (batch, column names recorded at
        write time — None for legacy files without them). Quarantine-
        worthy damage (CRC mismatch, bad magic, unreadable trailing
        bytes) raises CorruptRecordError; a CLEAN file with a different
        column set than today's schema is NOT damage — batch files are
        write-once and may predate an ALTER (the caller aligns by
        name)."""
        cols = []
        names: List[Optional[str]] = []
        with open(fpath, "rb") as fh:
            gen = read_records(fh)
            last_good = 0
            while True:
                try:
                    rec = next(gen)       # CorruptRecordError propagates
                except StopIteration:
                    break
                header, arrays = rec
                data_arr, dictionary, runs, validity = arrays
                st = header.get("stats")
                stats = None if st is None else ColumnStats(
                    st["min"], st["max"], st["null_count"], st["count"])
                cols.append(EncodedColumn(
                    Encoding(header["encoding"]),
                    _dtype_from_json(header["dtype"]),
                    header["num_rows"], data_arr, dictionary=dictionary,
                    runs=runs, validity=validity, stats=stats))
                names.append(header.get("name"))
                last_good = fh.tell()
        size = os.path.getsize(fpath)
        if last_good < size:
            # the file ends in bytes no record accounts for: a tear,
            # not a schema-drift artifact
            raise CorruptRecordError(
                f"batch file torn: {size - last_good} unreadable "
                f"trailing bytes after {len(cols)} columns")
        if not cols:
            raise CorruptRecordError("batch file holds no records")
        file_names = [n for n in names] \
            if all(n is not None for n in names) else None
        return (ColumnBatch(entry["batch_id"], 0, entry["num_rows"],
                            entry["capacity"], tuple(cols)), file_names)

    def _replay_wal(self, catalog, session, folded: Dict[str, int]) -> None:
        wal = self._wal_path()
        if not os.path.exists(wal):
            return
        # the store may have been dirtied since construction (torn-write
        # crash): re-salvage so the tear is quarantined instead of
        # aborting boot mid-replay; skipped when the log is known clean
        # (construction salvaged it and only whole records followed)
        if not getattr(self, "_wal_clean", False):
            salvage_file(wal)
            self._wal_clean = True
        # replay must not re-journal (records already ARE the journal);
        # the managed scope keeps the unmanaged-write guard from marking
        # views stale for the replay's own data-layer applies
        from snappydata_tpu_torch.views import matview as _mv

        with _no_journal(session), _mv.managed_base_write():
            self._replay_wal_inner(catalog, session, folded, wal)

    def _replay_wal_inner(self, catalog, session, folded: Dict[str, int],
                          wal: str) -> None:
        # pre-scan: last drop marker per table — records of a previous
        # incarnation (before the drop) must not be applied
        last_drop: Dict[str, int] = {}
        with open(wal, "rb") as fh:
            for header, _ in read_frames(fh):
                if header["kind"] == "drop":
                    last_drop[header["table"]] = header["seq"]
        def reseed_dedup(header, n_rows):
            # a client-stamped statement id in the record header means
            # this mutation was acked (or at least journaled) before the
            # crash: re-seed the at-most-once window so a lost-ack retry
            # arriving AFTER recovery returns the recorded result
            # instead of double-applying (reliability.MutationDedup)
            sid = header.get("stmt_id")
            if not sid:
                return
            from snappydata_tpu_torch.reliability import dedup_for

            dedup_for(catalog).record(
                sid, {"names": ["count"], "rows": [[int(n_rows)]],
                      "replayed": True})

        from snappydata_tpu_torch.storage import mvcc

        # every replayed record re-applies under its ORIGINAL seq as the
        # commit timestamp, so re-published manifests carry the same
        # epoch fences the pre-crash ones did (one token pair brackets
        # the whole loop; the replay is single-threaded)
        _seq_tok = mvcc._commit_seq.set(0)
        try:
            self._replay_records(catalog, session, folded, wal,
                                 last_drop, reseed_dedup, mvcc)
        finally:
            mvcc._commit_seq.reset(_seq_tok)

    def _replay_records(self, catalog, session, folded, wal, last_drop,
                        reseed_dedup, mvcc) -> None:
        with open(wal, "rb") as fh:
            for header, frame in read_frames(fh):
                table = header.get("table")
                seq = header.get("seq", 0)
                kind = header["kind"]
                mvcc._commit_seq.set(int(seq))
                if kind == "drop":
                    continue
                if seq <= folded.get(table, 0) or \
                        seq < last_drop.get(table, 0):
                    # already folded into a checkpoint — the mutation
                    # still APPLIED, so its dedup id must survive too
                    reseed_dedup(header, 0)
                    continue
                info = catalog.lookup_table(table)
                if info is None:
                    continue  # table dropped for good
                if kind == "sql":
                    n = 0
                    try:
                        res = session.sql(header["sql"],
                                          params=tuple(
                                              header.get("params", ())))
                        if res.num_rows and res.columns:
                            v = res.rows()[0][0]
                            n = int(v) if isinstance(v, (int, float)) else 0
                    except Exception:
                        # a statement that failed originally fails the same
                        # way on replay — same end state, keep going
                        pass
                    reseed_dedup(header, n)
                    continue
                from snappydata_tpu_torch.views import matview as _mv

                ncols = header["ncols"]
                _h, arrays = _decode_frame(frame)
                cols, nulls = arrays[:ncols], arrays[ncols:]
                if kind == "delete_keys":
                    key_cols = header["key_columns"]
                    keys = {tuple(c[i] for c in cols)
                            for i in range(len(cols[0]))}
                    wrapped, captured = _mv.wrap_delete_predicate(
                        catalog, table, _key_predicate(key_cols, keys))
                    deleted = info.data.delete(wrapped)
                    if captured:
                        _mv.replay_fold_deleted(catalog, table, captured,
                                                seq)
                    reseed_dedup(header, deleted)
                    continue
                reseed_dedup(header,
                             int(cols[0].shape[0]) if cols else 0)
                any_nulls = any(nm is not None for nm in nulls)
                if isinstance(info.data, RowTableData):
                    if kind == "put":
                        info.data.put_arrays(cols)
                        if info.key_columns:
                            _mv.mark_stale(catalog, table, "replay put")
                        else:
                            _mv.replay_fold(catalog, table, cols, None,
                                            seq)
                    else:
                        info.data.insert_arrays(cols)
                        _mv.replay_fold(catalog, table, cols, None, seq)
                elif kind == "put":
                    # _column_put subtracts and folds through the live
                    # hooks; replayed records sit past every fence by the
                    # replay filter, so those folds are the tail folds
                    session._column_put(info, cols)
                else:
                    info.data.insert_arrays(
                        cols, nulls=nulls if any_nulls else None)
                    _mv.replay_fold(catalog, table, cols,
                                    nulls if any_nulls else None, seq)


def _key_predicate(key_columns, keys):
    """Mutation predicate of a `delete_keys` record: rows whose key
    tuple is in `keys`."""
    def pred(batch_cols):
        stacked = [np.asarray(batch_cols[k]) for k in key_columns]
        n = stacked[0].shape[0]
        hits = np.zeros(n, dtype=bool)
        for r in range(n):
            if tuple(c[r] for c in stacked) in keys:
                hits[r] = True
        return hits

    return pred


def _json_safe(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def _b64(arr: np.ndarray) -> dict:
    import base64

    a = np.ascontiguousarray(arr)
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def _unb64(d: Optional[dict], dtype=None) -> Optional[np.ndarray]:
    if d is None:
        return None
    return _unb64_any(d)


def _unb64_any(d: dict) -> np.ndarray:
    import base64

    return np.frombuffer(base64.b64decode(d["b64"]),
                         dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()

def _align_by_name(cols, saved_names, schema, n):
    """Row-table checkpoint → current schema: match columns by name; a
    column added since the checkpoint reads NULL, a dropped one is skipped
    (the fenced WAL then replays the ALTER itself, which no-ops)."""
    cur = [f.name.lower() for f in schema.fields]
    if saved_names is None or list(saved_names) == cur:
        return cols
    by_name = dict(zip(saved_names, cols))
    out = []
    for nm in cur:
        if nm in by_name:
            out.append(by_name[nm])
        else:
            out.append(np.full(n, None, dtype=object))
    return out


def _align_rowbuf(cols, nls, saved_names, schema, n):
    """Column-table row-buffer checkpoint → current schema (see
    _align_by_name); missing columns read NULL via an all-set mask."""
    cur_fields = [(f.name.lower(), f) for f in schema.fields]
    by_name = dict(zip(saved_names, zip(cols, nls)))
    out_c, out_n = [], []
    for nm, f in cur_fields:
        if nm in by_name:
            c, m = by_name[nm]
            out_c.append(c)
            out_n.append(m)
        else:
            npd = f.dtype.np_dtype
            out_c.append(np.full(n, None, dtype=object) if npd == object
                         else np.zeros(n, dtype=npd))
            out_n.append(np.ones(n, dtype=np.bool_))
    return out_c, out_n
