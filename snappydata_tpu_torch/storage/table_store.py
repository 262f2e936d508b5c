"""In-memory column-table storage: immutable encoded batches, a row delta
buffer, and a manifest chain.

Port of snappydata_tpu/storage/table_store.py cut to what an in-memory
single-session column table needs:

- Row delta buffer + rollover into column batches at `column_max_delta_rows`
  (ref: ColumnBatchCreator.createAndStoreBatch core/.../columnar/
  ColumnBatchCreator.scala:46, fired from StoreCallbacksImpl.createColumnBatch:77).
- Update / delete deltas merged at scan time (ref: ColumnDeltaEncoder /
  UpdatedColumnDecoder / delete mask column -3, encoders/.../impl/
  ColumnFormatEntry.scala:89-95): a BatchView carries its batch, a delete
  mask and per-column replacement deltas; row-buffer rows mutate in
  place.
- Snapshot isolation: writers build a new immutable Manifest and publish
  it by one reference swap under the MVCC clock (storage/mvcc.py), which
  stamps its epoch and retains the superseded one while pins hold it.
- Row tables (`RowTableData`): host rows with a primary-key hash index
  for point lookups and PUT upserts.
- ALTER TABLE ADD / DROP COLUMN on both table kinds.

The same inserts produce the same encodings as the reference package
(VALUE_DICT, RLE, DICTIONARY, bitset), because batch cutting and encoding
are copied unchanged.  ARRAY / MAP / STRUCT columns store their cells
as OBJECT and keep append-only dictionaries of their string parts
(array elements, map keys and values, struct fields) for the device
bind.  Inserts refuse work past `critical_host_bytes`, and a column
table spills its oldest batches to memmaps past its host budget
(storage/hoststore.py; the disk tier is storage/tier.py).  Secondary
indexes on row tables are not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from snappydata_tpu_torch import config
from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.native import fast_encode_strings
from snappydata_tpu_torch.storage import mvcc
from snappydata_tpu_torch.storage.batch import ColumnBatch
from snappydata_tpu_torch.storage.encoding import decode_to_numpy, decode_validity
from snappydata_tpu_torch.utils import locks


def _struct_get(cell: dict, fname: str):
    """Case-insensitive struct field read (analyzer semantics)."""
    got = cell.get(fname)
    if got is None:
        fl = fname.lower()
        for k, v in cell.items():
            if isinstance(k, str) and k.lower() == fl:
                return v
    return got


@dataclasses.dataclass(frozen=True)
class BatchView:
    """One batch as visible in a particular Manifest version."""

    batch: ColumnBatch
    delete_mask: Optional[np.ndarray] = None     # bool[capacity]; True = deleted
    # update deltas: col_idx -> (hit mask bool[capacity],
    #   values host-domain [capacity], value-null mask bool[capacity] | None)
    deltas: Tuple[Tuple[int, np.ndarray, np.ndarray,
                        Optional[np.ndarray]], ...] = ()

    def decoded_column(self, col_idx: int, strings: bool = False) -> np.ndarray:
        """Base decode + delta merge (ref UpdatedColumnDecoder semantics)."""
        out = decode_to_numpy(self.batch.columns[col_idx],
                              self.batch.capacity, strings=strings)
        for ci, mask, values, _ in self.deltas:
            if ci == col_idx:
                out = np.where(mask, values, out)
        return out

    def null_mask(self, col_idx: int) -> Optional[np.ndarray]:
        """Effective null mask after the delta merge (a delta can both
        clear a NULL by assigning a value and set one by assigning
        NULL)."""
        base = decode_validity(self.batch.columns[col_idx],
                               self.batch.capacity)
        mask = (~base) if base is not None else None
        for ci, hit, _, value_nulls in self.deltas:
            if ci != col_idx:
                continue
            if mask is None:
                mask = np.zeros(self.batch.capacity, dtype=np.bool_)
            vn = value_nulls if value_nulls is not None else False
            mask = np.where(hit, vn, mask)
        if mask is not None and not mask.any():
            return None
        return mask

    def live_mask(self) -> np.ndarray:
        m = np.arange(self.batch.capacity) < self.batch.num_rows
        if self.delete_mask is not None:
            m = m & ~self.delete_mask
        return m

    @functools.cached_property
    def live_rows(self) -> int:
        """Rows not deleted (computed once: a view never changes)."""
        return int(self.batch.num_rows - (0 if self.delete_mask is None
                                          else int(self.delete_mask.sum())))


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Immutable table snapshot (the MVCC unit)."""

    version: int
    views: Tuple[BatchView, ...]
    # row-buffer snapshot: per-column host arrays of the delta rows
    row_arrays: Tuple[np.ndarray, ...]
    row_count: int
    # per-column bool null masks for the row-buffer rows (None = no nulls)
    row_nulls: Tuple[Optional[np.ndarray], ...] = ()
    # commit stamps (storage/mvcc.py): the process-wide epoch this
    # publish advanced to, and — on durable sessions — the WAL seq of the
    # committing statement (0 for in-memory publishes; a recovered
    # checkpoint carries its fence)
    epoch: int = 0
    wal_seq: int = 0

    def total_rows(self) -> int:
        return sum(v.live_rows for v in self.views) + self.row_count


class RowBuffer:
    """Mutable per-table row delta buffer (ref: the table.SHADOW row table
    that small inserts land in, SURVEY.md §3.3). Columnar numpy storage,
    mutated in place under the table writer lock; snapshots copy (≤
    column_max_delta_rows rows, so copies are cheap)."""

    def __init__(self, schema: T.Schema, capacity: int):
        self.schema = schema
        self.capacity = capacity
        self._cols: List[np.ndarray] = [
            np.empty(capacity, dtype=f.dtype.np_dtype) for f in schema.fields]
        self._nulls: List[Optional[np.ndarray]] = [None] * len(schema.fields)
        self._valid = np.ones(capacity, dtype=np.bool_)  # False = deleted in place
        self.count = 0

    def append(self, arrays: Sequence[np.ndarray],
               nulls: Optional[Sequence[Optional[np.ndarray]]] = None) -> int:
        n = int(np.asarray(arrays[0]).shape[0])
        assert self.count + n <= self.capacity
        for i, (dst, src) in enumerate(zip(self._cols, arrays)):
            dst[self.count:self.count + n] = np.asarray(src)
            nm = nulls[i] if nulls is not None else None
            if nm is not None and nm.any():
                if self._nulls[i] is None:
                    self._nulls[i] = np.zeros(self.capacity, dtype=np.bool_)
                self._nulls[i][self.count:self.count + n] = nm
            elif self._nulls[i] is not None:
                self._nulls[i][self.count:self.count + n] = False
        self._valid[self.count:self.count + n] = True
        self.count += n
        return n

    def snapshot(self) -> Tuple[Tuple[np.ndarray, ...],
                                Tuple[Optional[np.ndarray], ...], int]:
        live = self._valid[:self.count]
        if live.all():
            arrs = tuple(c[:self.count].copy() for c in self._cols)
            nls = tuple(m[:self.count].copy() if m is not None else None
                        for m in self._nulls)
            return arrs, nls, self.count
        arrs = tuple(c[:self.count][live].copy() for c in self._cols)
        nls = tuple(m[:self.count][live].copy() if m is not None else None
                    for m in self._nulls)
        return arrs, nls, int(live.sum())

    def clear(self) -> None:
        self.count = 0
        self._nulls = [None] * len(self.schema.fields)

    def add_field(self, field: T.Field) -> None:
        """Schema evolution: existing buffered rows read NULL."""
        self.schema = T.Schema(tuple(self.schema.fields) + (field,))
        npd = field.dtype.np_dtype
        self._cols.append(np.empty(self.capacity, dtype=npd)
                          if npd == object
                          else np.zeros(self.capacity, dtype=npd))
        nm = None
        if self.count:
            nm = np.zeros(self.capacity, dtype=np.bool_)
            nm[:self.count] = True
        self._nulls.append(nm)

    def drop_field(self, idx: int) -> None:
        self.schema = T.Schema(tuple(
            f for i, f in enumerate(self.schema.fields) if i != idx))
        del self._cols[idx]
        del self._nulls[idx]


class ColumnTableData:
    """Storage for one COLUMN table: immutable batches + row delta buffer +
    manifest chain. Thread-safe: one writer lock, lock-free readers."""

    def __init__(self, schema: T.Schema, capacity: Optional[int] = None,
                 max_delta_rows: Optional[int] = None):
        props = config.global_properties()
        self.schema = schema
        self.capacity = capacity or props.column_batch_rows
        self.max_delta_rows = max_delta_rows or props.column_max_delta_rows
        self._lock = locks.named_lock("storage.column_table")
        self._batch_ids = itertools.count()
        # post-insert observers (the materialized views' unmanaged-write
        # guard; ref: SampleInsertExec keeps samples in sync with inserts)
        self.on_insert = []
        self._row_buffer = RowBuffer(schema, max(self.max_delta_rows * 2,
                                                 self.capacity))
        # table-level shared dictionaries for string columns: codes stay
        # comparable across batches (device group-by/join runs on codes)
        self._dicts: Dict[int, List] = {
            i: [] for i, f in enumerate(schema.fields) if f.dtype.name == "string"}
        self._dict_lookup: Dict[int, Dict] = {i: {} for i in self._dicts}
        # ARRAY<STRING> columns: append-only ELEMENT dictionaries (same
        # protocol as scalar strings — codes never shift, so device
        # plates built under any pinned manifest stay decodable by every
        # later dictionary read)
        self._elem_dicts: Dict[int, List] = {
            i: [] for i, f in enumerate(schema.fields)
            if f.dtype.name == "array"
            and getattr(f.dtype, "element", None) is not None
            and f.dtype.element.name == "string"}
        self._elem_lookup: Dict[int, Dict] = {i: {}
                                              for i in self._elem_dicts}
        # MAP<STRING, V> columns: append-only KEY dictionaries, plus
        # VALUE dictionaries when V is also string
        self._map_key_dicts: Dict[int, List] = {
            i: [] for i, f in enumerate(schema.fields)
            if f.dtype.name == "map"
            and getattr(f.dtype, "key", None) is not None
            and f.dtype.key.name == "string"}
        self._map_key_lookup: Dict[int, Dict] = {
            i: {} for i in self._map_key_dicts}
        self._map_val_dicts: Dict[int, List] = {
            i: [] for i, f in enumerate(schema.fields)
            if i in self._map_key_dicts
            and f.dtype.value.name == "string"}
        self._map_val_lookup: Dict[int, Dict] = {
            i: {} for i in self._map_val_dicts}
        # STRUCT columns: per-(column, field-name) value dictionaries
        # for string fields, created lazily at the first intern
        self._struct_dicts: Dict[int, Dict[str, List]] = {}
        self._struct_lookup: Dict[int, Dict[str, Dict]] = {}
        self._manifest = Manifest(
            0, (), tuple(np.empty(0, dtype=f.dtype.np_dtype)
                         for f in schema.fields), 0,
            tuple(None for _ in schema.fields))
        # device cache: manifest version -> {key: device arrays}. Keyed per
        # version so concurrent readers of different snapshots never mix
        # entries (review finding: clear+overwrite raced).
        self._device_cache: Dict[int, Dict] = {}

    # --- snapshots -------------------------------------------------------

    def snapshot(self) -> Manifest:
        return self._manifest

    def _publish(self, views: Tuple[BatchView, ...]) -> Manifest:
        row_arrays, row_nulls, row_count = self._row_buffer.snapshot()
        # the epoch stamp and the reference swap happen under ONE clock
        # hold, so a pin capturing a cross-table cut never observes half
        # a commit (mvcc.SnapshotPin.pin_many holds the same lock)
        with mvcc.clock():
            m = Manifest(self._manifest.version + 1, views, row_arrays,
                         row_count, row_nulls,
                         epoch=mvcc._bump_epoch_locked(),
                         wal_seq=mvcc.current_commit_seq())
            mvcc.retain_locked(self, self._manifest)
            self._manifest = m
        return m

    # --- dictionaries ----------------------------------------------------

    def _intern_strings(self, col_idx: int, values: np.ndarray) -> np.ndarray:
        """Extend the shared dictionary with unseen values; old codes stay
        valid because the dictionary is append-only."""
        fast_encode_strings(np.asarray(values, dtype=object),
                            self._dict_lookup[col_idx],
                            self._dicts[col_idx])
        return np.array(self._dicts[col_idx], dtype=object)

    def dictionary(self, col_idx: int) -> Optional[np.ndarray]:
        if col_idx in self._dicts:
            return np.array(self._dicts[col_idx], dtype=object)
        return None

    def intern_array_elements(self, col_idx: int, cells) -> Dict:
        """Append-only intern of an ARRAY<STRING> column's element
        values (device binds call this over their PINNED manifest's
        cells, so a bind is always self-sufficient — recovery included).
        Returns a point-in-time copy of the lookup for code assignment."""
        lk = self._elem_lookup[col_idx]
        d = self._elem_dicts[col_idx]
        with self._lock:
            for cell in cells:
                if isinstance(cell, (list, tuple, np.ndarray)):
                    for el in cell:
                        if el is not None:
                            key = str(el)
                            if key not in lk:
                                lk[key] = len(d)
                                d.append(key)
            return dict(lk)

    def array_element_dictionary(self, col_idx: int) -> np.ndarray:
        """Element dictionary of an ARRAY<STRING> column. Append-only:
        a superset of the values any existing device plates encode."""
        with self._lock:
            return np.array(self._elem_dicts[col_idx], dtype=object)

    def intern_map_entries(self, col_idx: int, cells
                           ) -> Tuple[Dict, Optional[Dict]]:
        """Append-only intern of a MAP<STRING, V> column's keys (and
        values when V is string). Returns point-in-time copies of the
        (key lookup, value lookup | None) for code assignment."""
        klk = self._map_key_lookup[col_idx]
        kd = self._map_key_dicts[col_idx]
        vlk = self._map_val_lookup.get(col_idx)
        vd = self._map_val_dicts.get(col_idx)
        with self._lock:
            for cell in cells:
                if isinstance(cell, dict):
                    for k, v in cell.items():
                        ks = str(k)
                        if ks not in klk:
                            klk[ks] = len(kd)
                            kd.append(ks)
                        if vlk is not None and v is not None:
                            vs = str(v)
                            if vs not in vlk:
                                vlk[vs] = len(vd)
                                vd.append(vs)
            return dict(klk), (dict(vlk) if vlk is not None else None)

    def map_key_dictionary(self, col_idx: int) -> np.ndarray:
        with self._lock:
            return np.array(self._map_key_dicts[col_idx], dtype=object)

    def map_value_dictionary(self, col_idx: int) -> Optional[np.ndarray]:
        with self._lock:
            if col_idx not in self._map_val_dicts:
                return None
            return np.array(self._map_val_dicts[col_idx], dtype=object)

    def intern_struct_fields(self, col_idx: int, fnames, cells
                             ) -> Dict[str, Dict]:
        """Append-only intern of a STRUCT column's string-field values
        — ALL fields in one pass over the cells (case-insensitive field
        resolution like the analyzer). Returns {field: point-in-time
        lookup copy}."""
        with self._lock:
            col_lk = self._struct_lookup.setdefault(col_idx, {})
            col_d = self._struct_dicts.setdefault(col_idx, {})
            lks = {fn: col_lk.setdefault(fn, {}) for fn in fnames}
            ds = {fn: col_d.setdefault(fn, []) for fn in fnames}
            for cell in cells:
                if isinstance(cell, dict):
                    for fn in fnames:
                        v = _struct_get(cell, fn)
                        if v is not None:
                            key = str(v)
                            lk = lks[fn]
                            if key not in lk:
                                d = ds[fn]
                                lk[key] = len(d)
                                d.append(key)
            return {fn: dict(lk) for fn, lk in lks.items()}

    def struct_field_dictionary(self, col_idx: int, fname: str
                                ) -> np.ndarray:
        with self._lock:
            d = self._struct_dicts.get(col_idx, {}).get(fname, [])
            return np.array(d, dtype=object)


    def insert_arrays(self, arrays: Sequence[np.ndarray],
                      nulls: Optional[Sequence[Optional[np.ndarray]]] = None
                      ) -> int:
        """Bulk/small insert. Large inserts cut column batches directly
        (ref ColumnInsertExec bulk path); small ones land in the row buffer
        and roll over when it exceeds max_delta_rows (ref §3.3).

        `nulls[i]` is an optional bool mask marking SQL NULLs in column i
        (values at those positions are fillers)."""
        from snappydata_tpu_torch.storage import hoststore

        hoststore.check_critical_memory()
        arrays = [np.asarray(a) for a in arrays]
        if len(arrays) != len(self.schema.fields):
            raise ValueError(
                f"expected {len(self.schema.fields)} columns, got {len(arrays)}")
        n = int(arrays[0].shape[0])
        for a, f in zip(arrays, self.schema.fields):
            if int(a.shape[0]) != n:
                raise ValueError(
                    f"column {f.name}: length {a.shape[0]} != {n}")
        if nulls is None:
            nulls = [None] * len(arrays)
        with self._lock:
            # intern + dictionary-encode strings in ONE fused pass so
            # batch cutting below just slices the precomputed codes
            nulls = list(nulls)
            str_codes: Dict[int, np.ndarray] = {}
            for i in self._dicts:
                arrays[i] = np.asarray(arrays[i], dtype=object)
                codes, cnulls = fast_encode_strings(
                    arrays[i], self._dict_lookup[i], self._dicts[i])
                str_codes[i] = codes
                if cnulls is not None:
                    nulls[i] = cnulls if nulls[i] is None \
                        else (nulls[i] | cnulls)
            views = list(self._manifest.views)
            pos = 0
            if n >= self.max_delta_rows:
                slices = []
                while n - pos >= self.max_delta_rows:
                    take = min(self.capacity, n - pos)
                    slices.append(slice(pos, pos + take))
                    pos += take
                views.extend(self._cut_batches_pipelined(
                    arrays, nulls, str_codes, slices))
            if pos < n:
                self._row_buffer.append(
                    [a[pos:] for a in arrays],
                    [m[pos:] if m is not None else None for m in nulls])
            if self._row_buffer.count >= self.max_delta_rows:
                views.extend(self._rollover_locked())
            self._publish(tuple(views))
        self._maybe_spill()
        for cb in self.on_insert:
            cb(arrays, nulls)
        return n

    def _maybe_spill(self) -> None:
        """Spill the coldest batches to disk when the host budget is
        exceeded (ref: SnappyStorageEvictor region eviction).  The table's
        own budget (OPTIONS eviction_bytes 'N', the EVICTION clause's
        analogue) overrides the global `host_store_bytes`."""
        budget = getattr(self, "eviction_bytes", None) \
            or config.global_properties().host_store_bytes
        if budget:
            from snappydata_tpu_torch.storage import hoststore

            hoststore.spill_to_budget(self, budget)

    # rows below which the pipelined cut isn't worth its thread overhead
    _PIPELINE_MIN_ROWS = 1 << 16

    def _cut_batches_pipelined(self, arrays, nulls, str_codes, slices
                               ) -> List[BatchView]:
        """Ingest fast lane: encode the batches of one bulk insert on a
        two-worker pipeline (double-buffered) so batch k+1's CRC/encode
        CPU work overlaps batch k's — and, on the durable path, overlaps
        the WAL group fsync the background flusher is running for this
        statement's journal record. Safe because the fused string encode
        already interned every value (str_codes covers all dictionary
        columns), so workers only READ the append-only dictionaries.
        Batch ids are pre-assigned in slice order; views keep insertion
        order."""
        if not slices:
            return []
        total = sum(sl.stop - sl.start for sl in slices)
        pipelined = (len(slices) > 1 and total >= self._PIPELINE_MIN_ROWS
                     and all(i in str_codes for i in self._dicts))

        def args_for(sl):
            return ([a[sl] for a in arrays],
                    [m[sl] if m is not None else None for m in nulls],
                    {i: c[sl] for i, c in str_codes.items()})

        if not pipelined:
            return [self._cut_batch(*args_for(sl)) for sl in slices]
        from concurrent.futures import ThreadPoolExecutor

        ids = [next(self._batch_ids) for _ in slices]
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(self._cut_batch, *args_for(sl), batch_id=bid)
                    for sl, bid in zip(slices, ids)]
            return [f.result() for f in futs]

    def _cut_batch(self, arrays: List[np.ndarray],
                   nulls: Optional[List[Optional[np.ndarray]]] = None,
                   str_codes: Optional[Dict[int, np.ndarray]] = None,
                   batch_id: Optional[int] = None) -> BatchView:
        from snappydata_tpu_torch.storage import bitmask
        from snappydata_tpu_torch.storage.encoding import (ColumnStats,
                                                     EncodedColumn, Encoding)

        dicts = {}
        precoded: Dict[int, EncodedColumn] = {}
        for i in self._dicts:
            if str_codes is not None and i in str_codes:
                # fused-encode fast path: codes are ready, just wrap them
                codes = np.ascontiguousarray(str_codes[i], dtype=np.int32)
                cn = nulls[i] if nulls is not None else None
                n_rows = int(codes.shape[0])
                packed = bitmask.pack(~cn) \
                    if cn is not None and cn.any() else None
                precoded[i] = EncodedColumn(
                    Encoding.DICTIONARY, self.schema.fields[i].dtype,
                    n_rows, codes,
                    dictionary=np.array(self._dicts[i], dtype=object),
                    validity=packed,
                    stats=ColumnStats(None, None,
                                      int(cn.sum()) if cn is not None else 0,
                                      n_rows))
            else:
                dicts[i] = self._intern_strings(i, arrays[i])
        validities = None
        if nulls is not None and any(m is not None and m.any() for m in nulls):
            validities = [~m if m is not None else None for m in nulls]
        batch = ColumnBatch.from_arrays(
            next(self._batch_ids) if batch_id is None else batch_id,
            0, self.schema, arrays, self.capacity,
            validities=validities, dictionaries=dicts,
            precoded=precoded)
        return BatchView(batch)

    def _rollover_locked(self) -> List[BatchView]:
        arrays, nulls, cnt = self._row_buffer.snapshot()
        self._row_buffer.clear()
        out = []
        pos = 0
        while pos < cnt:
            take = min(self.capacity, cnt - pos)
            sl = slice(pos, pos + take)
            out.append(self._cut_batch(
                [a[sl] for a in arrays],
                [m[sl] if m is not None else None for m in nulls]))
            pos += take
        return out

    def force_rollover(self) -> None:
        """Cut every row-buffer row into column batches now, whatever the
        buffer's size (the tail of a bulk load stays in the row buffer
        otherwise, and row-buffer rows bind decoded)."""
        with self._lock:
            views = list(self._manifest.views)
            views.extend(self._rollover_locked())
            self._publish(tuple(views))

    def append_batches(self, batches: Sequence[ColumnBatch],
                       string_dicts: Dict[int, np.ndarray]) -> None:
        """Publish ready-encoded batches (storage/transfer.py).  Their
        string codes index `string_dicts`, which must extend this table's
        own dictionaries (append-only on both sides)."""
        with self._lock:
            for ci, values in string_dicts.items():
                mine = self._dicts[ci]
                incoming = list(values)
                if incoming[:len(mine)] != mine:
                    raise ValueError(
                        f"column {self.schema.fields[ci].name}: incoming "
                        f"dictionary does not extend the table's")
                for v in incoming[len(mine):]:
                    self._dict_lookup[ci][v] = len(mine)
                    mine.append(v)
            views = [BatchView(dataclasses.replace(
                b, batch_id=next(self._batch_ids))) for b in batches]
            self._publish(tuple(self._manifest.views) + tuple(views))

    # --- schema evolution (ref: AlterTableAddColumnCommand /
    # AlterTableDropColumnCommand, SnappySession.alterTable:1628; existing
    # rows read an added column as NULL) ---

    def _all_null_column(self, col_idx: int, dtype: T.DataType, n: int):
        from snappydata_tpu_torch.storage import bitmask
        from snappydata_tpu_torch.storage.encoding import (ColumnStats,
                                                           EncodedColumn,
                                                           Encoding)

        validity = bitmask.pack(np.zeros(n, dtype=np.bool_))
        stats = ColumnStats(None, None, n, n)
        if dtype.name in ("array", "map"):
            return EncodedColumn(Encoding.OBJECT, dtype, n,
                                 np.full(n, None, dtype=object),
                                 validity=validity, stats=stats)
        if dtype.name == "string":
            return EncodedColumn(
                Encoding.DICTIONARY, dtype, n, np.zeros(n, dtype=np.int32),
                dictionary=np.array(self._dicts[col_idx], dtype=object),
                validity=validity, stats=stats)
        if dtype.name == "boolean":
            return EncodedColumn(Encoding.BOOLEAN_BITSET, dtype, n,
                                 bitmask.pack(np.zeros(n, dtype=np.bool_)),
                                 validity=validity, stats=stats)
        # run-length [0]*n: one cell whatever the batch size (at-rest bytes
        # live in the HOST domain: np_dtype for decimals)
        return EncodedColumn(Encoding.RUN_LENGTH, dtype, n,
                             np.zeros(1, dtype=dtype.np_dtype
                                      if dtype.name == "decimal"
                                      else dtype.device_dtype()),
                             runs=np.array([n], dtype=np.int32),
                             validity=validity, stats=stats)

    def add_column(self, field: T.Field) -> None:
        """ALTER TABLE ADD COLUMN: existing batches get a constant-size
        all-null encoded column; the manifest version bump invalidates
        device caches and compiled plans."""
        with self._lock:
            idx = len(self.schema.fields)
            self.schema = T.Schema(tuple(self.schema.fields) + (field,))
            if field.dtype.name == "string":
                # non-empty shared dictionary so device LUTs over it are
                # never zero-sized (codes are masked null anyway)
                self._dicts[idx] = [""]
                self._dict_lookup[idx] = {"": 0}
            # the per-column complex-type dictionary families need
            # entries too, or the first device bind of an ALTER-added
            # column dies on a raw KeyError
            if field.dtype.name == "array" \
                    and getattr(field.dtype, "element", None) is not None \
                    and field.dtype.element.name == "string":
                self._elem_dicts[idx] = []
                self._elem_lookup[idx] = {}
            if field.dtype.name == "map" \
                    and getattr(field.dtype, "key", None) is not None \
                    and field.dtype.key.name == "string":
                self._map_key_dicts[idx] = []
                self._map_key_lookup[idx] = {}
                if field.dtype.value.name == "string":
                    self._map_val_dicts[idx] = []
                    self._map_val_lookup[idx] = {}
            self._row_buffer.add_field(field)
            views = []
            for v in self._manifest.views:
                b = v.batch
                nb = dataclasses.replace(
                    b, columns=b.columns + (self._all_null_column(
                        idx, field.dtype, b.num_rows),))
                views.append(dataclasses.replace(v, batch=nb))
            self._publish(tuple(views))

    def drop_column(self, name: str) -> None:
        """ALTER TABLE DROP COLUMN remaps the shared dictionaries in place
        and shifts ordinals — state a pinned reader may be traversing — so
        it refuses (40001) while snapshots are active, and `ddl_scope`
        blocks new pins for the remap's duration."""
        with mvcc.ddl_scope(self, "ALTER TABLE DROP COLUMN"), self._lock:
            idx = self.schema.index(name)
            if len(self.schema.fields) == 1:
                raise ValueError("cannot drop the only column")
            self.schema = T.Schema(tuple(
                f for i, f in enumerate(self.schema.fields) if i != idx))

            def remap(i):
                return i - 1 if i > idx else i

            self._dicts = {remap(i): d for i, d in self._dicts.items()
                           if i != idx}
            self._dict_lookup = {remap(i): d
                                 for i, d in self._dict_lookup.items()
                                 if i != idx}
            # remap the complex-type dictionary families the same way
            # (stale ordinals would make a survivor column
            # intern into its neighbour's dictionary)
            for attr in ("_elem_dicts", "_elem_lookup", "_map_key_dicts",
                         "_map_key_lookup", "_map_val_dicts",
                         "_map_val_lookup", "_struct_dicts",
                         "_struct_lookup"):
                setattr(self, attr,
                        {remap(i): d
                         for i, d in getattr(self, attr).items()
                         if i != idx})
            self._row_buffer.drop_field(idx)
            views = []
            for v in self._manifest.views:
                b = v.batch
                nb = dataclasses.replace(b, columns=tuple(
                    c for i, c in enumerate(b.columns) if i != idx))
                deltas = tuple((remap(ci), hit, vals, vn)
                               for ci, hit, vals, vn in v.deltas if ci != idx)
                views.append(dataclasses.replace(v, batch=nb, deltas=deltas))
            self._publish(tuple(views))

    # --- mutations -------------------------------------------------------

    def update(self, predicate: Callable[[Dict[str, np.ndarray]], np.ndarray],
               assignments: Dict[str, Callable[[Dict[str, np.ndarray]],
                                               np.ndarray]]) -> int:
        """UPDATE ... SET: per-batch replacement deltas (ref
        ColumnUpdateExec -> ColumnDelta entries) and row-buffer rows
        mutated in place.  `predicate` / assignment callables take {column
        name: decoded host values} and return a bool mask / new values."""
        with self._lock:
            touched = 0
            new_views = []
            for view in self._manifest.views:
                cols = self._decode_all(view)
                hit = np.asarray(predicate(cols)) & view.live_mask()
                if not hit.any():
                    new_views.append(view)
                    continue
                touched += int(hit.sum())
                deltas = list(view.deltas)
                for name, fn in assignments.items():
                    ci = self.schema.index(name)
                    # locklint: callback-under-lock assignment evaluators
                    # are pure host functions over the captured arrays;
                    # they never touch storage locks or this table
                    raw = fn(cols)
                    values, vnulls = self._to_device_domain(
                        ci, raw, cols[self.schema.fields[ci].name])
                    deltas.append((ci, hit.copy(), values, vnulls))
                new_views.append(dataclasses.replace(view,
                                                     deltas=tuple(deltas)))
            rb_cols = self._row_buffer_dict()
            if rb_cols is not None:
                rb = self._row_buffer
                hit = np.asarray(predicate(rb_cols)) & rb._valid[:rb.count]
                if hit.any():
                    touched += int(hit.sum())
                    for name, fn in assignments.items():
                        ci = self.schema.index(name)
                        col = rb._cols[ci][:rb.count]
                        # locklint: callback-under-lock assignment
                        # evaluators are pure host functions over the
                        # captured arrays (compiled by the executor);
                        # they never touch storage locks or this table
                        raw = fn(rb_cols)
                        if raw is None:  # SQL NULL assignment
                            if rb._nulls[ci] is None:
                                rb._nulls[ci] = np.zeros(rb.capacity,
                                                         dtype=np.bool_)
                            rb._nulls[ci][:rb.count][hit] = True
                            continue
                        vals = np.asarray(raw)
                        new = np.broadcast_to(
                            np.asarray(vals, dtype=col.dtype),
                            col.shape)[hit] \
                            if vals.shape == () else vals[hit]
                        if ci in self._dicts:
                            # intern, so the device bind resolves the codes
                            self._intern_strings(
                                ci, np.asarray(new, dtype=object))
                        col[hit] = new
                        if rb._nulls[ci] is not None:
                            rb._nulls[ci][:rb.count][hit] = False
            self._publish(tuple(new_views))
            return touched

    def delete(self, predicate) -> int:
        """DELETE: new delete-mask arrays per batch (ref ColumnDeleteExec
        -> ColumnDeleteDelta bitmap, meta column -3); row-buffer rows are
        marked dead in place."""
        with self._lock:
            touched = 0
            new_views = []
            for view in self._manifest.views:
                cols = self._decode_all(view)
                hit = np.asarray(predicate(cols)) & view.live_mask()
                if not hit.any():
                    new_views.append(view)
                    continue
                touched += int(hit.sum())
                mask = hit if view.delete_mask is None \
                    else (view.delete_mask | hit)
                new_views.append(dataclasses.replace(view, delete_mask=mask))
            rb_cols = self._row_buffer_dict()
            if rb_cols is not None:
                rb = self._row_buffer
                hit = np.asarray(predicate(rb_cols)) & rb._valid[:rb.count]
                if hit.any():
                    touched += int(hit.sum())
                    rb._valid[:rb.count][hit] = False
            self._publish(tuple(new_views))
            return touched

    def truncate(self) -> None:
        with self._lock:
            self._row_buffer.clear()
            self._publish(())

    # --- helpers ---------------------------------------------------------

    def _decode_all(self, view: BatchView) -> "LazyBatchColumns":
        """Lazily-decoding column mapping for mutation predicates and the
        host evaluator: only the columns a plan touches get decoded.
        String columns decode in the CODE domain first (so update deltas,
        stored as codes, merge correctly), then map through the table
        dictionary."""
        return LazyBatchColumns(self, view)

    def _row_buffer_dict(self) -> Optional["_RowBufferCols"]:
        rb = self._row_buffer
        if rb.count == 0:
            return None
        out = _RowBufferCols({f.name: rb._cols[i][:rb.count]
                              for i, f in enumerate(self.schema.fields)})
        out._rb = rb
        out._schema = self.schema
        return out

    def _to_device_domain(self, col_idx: int, values, like: np.ndarray
                          ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Assignment values -> (storage-domain array, null mask | None).
        Accepts python scalars (None = SQL NULL) or arrays with None
        entries for string columns.  Deltas live in the HOST storage
        domain: dictionary codes for strings (new values are interned
        into the table dictionary), plain float64 for decimals."""
        f = self.schema.fields[col_idx]
        shape = like.shape
        if values is None:
            dt = np.int32 if f.dtype.name == "string" \
                else (f.dtype.np_dtype if f.dtype.name == "decimal"
                      else f.dtype.device_dtype())
            return (np.zeros(shape, dtype=dt),
                    np.ones(shape, dtype=np.bool_))
        values = np.asarray(values)
        if f.dtype.name == "string":
            vals = np.broadcast_to(values, shape) if values.shape == () \
                else values
            vals = np.asarray(vals, dtype=object)
            self._intern_strings(col_idx, vals)
            lookup = self._dict_lookup[col_idx]
            codes = np.fromiter(
                (lookup[v] if v is not None else 0 for v in vals),
                dtype=np.int32, count=len(vals))
            vnulls = np.fromiter((v is None for v in vals), dtype=np.bool_,
                                 count=len(vals))
            return codes, (vnulls if vnulls.any() else None)
        dt = f.dtype.np_dtype if f.dtype.name == "decimal" \
            else f.dtype.device_dtype()
        if values.shape == ():
            return np.full(shape, values, dtype=dt), None
        return values.astype(dt), None


class LazyBatchColumns:
    """dict-like {column name -> decoded host values} that decodes on first
    access."""

    def __init__(self, data: "ColumnTableData", view: BatchView):
        self._data = data
        self._view = view
        self._cache: Dict[str, np.ndarray] = {}

    def __getitem__(self, name: str) -> np.ndarray:
        got = self._cache.get(name)
        if got is None:
            i = self._data.schema.index(name)
            f = self._data.schema.fields[i]
            if f.dtype.name == "string":
                codes = self._view.decoded_column(i, strings=False)
                dictionary = self._data.dictionary(i)
                if dictionary is None or dictionary.size == 0:
                    got = np.full(codes.shape, None, dtype=object)
                else:
                    got = dictionary[np.clip(codes, 0, dictionary.size - 1)]
            else:
                got = self._view.decoded_column(i)
            self._cache[name] = got
        return got

    def keys(self):
        return self._data.schema.names()

    def null_mask(self, name: str) -> Optional[np.ndarray]:
        """Delta-aware SQL-NULL mask of one column (the delete capture
        needs it: a view's subtraction must skip the values its fold
        skipped)."""
        return self._view.null_mask(self._data.schema.index(name))

    def live_mask(self) -> np.ndarray:
        """Rows a DELETE can remove (no capacity padding, no row deleted
        before): the delete capture intersects with it, or a re-matching
        predicate would subtract dead rows from a view a second time."""
        return self._view.live_mask()


class _RowBufferCols(dict):
    """Row-buffer column mapping for mutation predicates, carrying the
    buffer's null masks and live rows for the delete capture."""

    _rb = None
    _schema = None

    def null_mask(self, name: str) -> Optional[np.ndarray]:
        if self._rb is None:
            return None
        m = self._rb._nulls[self._schema.index(name)]
        return m[:self._rb.count] if m is not None else None

    def live_mask(self) -> Optional[np.ndarray]:
        if self._rb is None:
            return None
        return self._rb._valid[:self._rb.count]


class _LiveRowCols(dict):
    """Row-table column mapping for DELETE predicates, carrying the live
    rows (the delete capture skips rows deleted before) and the SQL-NULL
    masks (a captured subtraction skips exactly the values the fold
    skipped: a NULL fills as NaN or 0 in the typed arrays, and without
    the mask a view would subtract a contribution that never was)."""

    _live = None
    _nulls = None

    def live_mask(self) -> Optional[np.ndarray]:
        return self._live

    def null_mask(self, name: str) -> Optional[np.ndarray]:
        if self._nulls is None:
            return None
        return self._nulls.get(name)


class RowTableData:
    """Storage for a ROW table: host rows with an optional primary-key
    hash index for point operations that bypass the query engine (ref:
    ExecutionEngineArbiter routing, docs/architecture/
    cluster_architecture.md:31-33; row store GemFireContainer rows).
    Rows mutate in place under the table lock; `version` counts
    mutations, and the MVCC pin captures a host snapshot per version
    (storage/mvcc.row_snapshot_of)."""

    def __init__(self, schema: T.Schema, key_columns: Sequence[str] = ()):
        self.schema = schema
        self.key_columns = [k.lower() for k in key_columns]
        self._key_idx = [schema.index(k) for k in self.key_columns]
        self._lock = locks.named_lock("storage.row_table")
        self._cols: List[List] = [[] for _ in schema.fields]
        self._live: List[bool] = []
        self._pk: Dict[tuple, int] = {}
        self._version = 0
        self.on_insert = []

    @property
    def version(self) -> int:
        return self._version

    def insert_arrays(self, arrays: Sequence[np.ndarray]) -> int:
        from snappydata_tpu_torch.storage import hoststore

        hoststore.check_critical_memory()
        arrays = [np.asarray(a) for a in arrays]
        n = int(arrays[0].shape[0])
        with self._lock:
            if self._key_idx:
                # validate the whole batch before touching state, so a
                # key violation leaves the table unchanged
                seen = set()
                for i in range(n):
                    key = tuple(arrays[j][i] for j in self._key_idx)
                    old = self._pk.get(key)
                    if (old is not None and self._live[old]) or key in seen:
                        raise ValueError(f"primary key violation: {key}")
                    seen.add(key)
            for i in range(n):
                self._append_row(tuple(a[i] for a in arrays), upsert=False)
            self._version += 1
        for cb in self.on_insert:
            cb(arrays, None)
        return n

    def put_arrays(self, arrays: Sequence[np.ndarray]) -> int:
        """PUT INTO upsert by primary key (ref: SnappySession.put:2024)."""
        arrays = [np.asarray(a) for a in arrays]
        n = int(arrays[0].shape[0])
        with self._lock:
            for i in range(n):
                self._append_row(tuple(a[i] for a in arrays), upsert=True)
            self._version += 1
        return n

    def _append_row(self, row: tuple, upsert: bool) -> None:
        if self._key_idx:
            key = tuple(row[i] for i in self._key_idx)
            old = self._pk.get(key)
            if old is not None and self._live[old]:
                if not upsert:
                    raise ValueError(f"primary key violation: {key}")
                self._live[old] = False
            self._pk[key] = len(self._live)
        for c, v in zip(self._cols, row):
            c.append(v)
        self._live.append(True)

    def get(self, key: tuple):
        """Point lookup: never enters the query engine."""
        ordinal = self._pk.get(tuple(key))
        if ordinal is None or not self._live[ordinal]:
            return None
        return tuple(c[ordinal] for c in self._cols)

    def to_arrays(self) -> Tuple[List[np.ndarray], int]:
        arrays, _nulls, n = self.to_arrays_with_nulls()
        return arrays, n

    def to_arrays_with_nulls(self):
        """(arrays, null masks, count) of the live rows: rows store python
        values incl. None; numeric Nones fill as 0 with the mask set."""
        with self._lock:
            live = np.array(self._live, dtype=np.bool_)
            out: List[np.ndarray] = []
            masks: List[Optional[np.ndarray]] = []
            for f, c in zip(self.schema.fields, self._cols):
                nm = np.array([v is None for v in c], dtype=np.bool_)
                if f.dtype.name == "string":
                    arr = np.array(c, dtype=object)
                else:
                    arr = np.array([0 if v is None else v for v in c],
                                   dtype=f.dtype.np_dtype)
                if len(live):
                    arr = arr[live]
                    nm = nm[live]
                out.append(arr)
                masks.append(nm if nm.any() else None)
            n = int(live.sum()) if len(live) else 0
            return out, masks, n

    def update(self, predicate, assignments) -> int:
        with self._lock:
            if not self._live:
                return 0
            # typed like the DELETE predicate's columns: the reference
            # builds np.array(c, dtype) here and raises on a NULL in an
            # integer column (ROADMAP C, faults of the reference)
            cols = self._typed_cols_locked()
            hit = np.asarray(predicate(cols)) & np.array(self._live)
            for name, fn in assignments.items():
                ci = self.schema.index(name)
                # locklint: callback-under-lock assignment evaluators are
                # pure host functions over the captured arrays; they
                # never touch storage locks or this table
                vals = np.asarray(fn(cols))
                for ordinal in np.flatnonzero(hit):
                    v = vals if vals.shape == () else vals[ordinal]
                    self._cols[ci][ordinal] = v.item() \
                        if hasattr(v, "item") else v
            if self._key_idx and any(self.schema.index(n) in self._key_idx
                                     for n in assignments):
                self._rebuild_pk_locked()
            self._version += 1
            return int(hit.sum())

    def _rebuild_pk_locked(self) -> None:
        """Key-column updates invalidate the hash index: rebuild it and
        verify uniqueness."""
        pk: Dict[tuple, int] = {}
        for ordinal, live in enumerate(self._live):
            if not live:
                continue
            key = tuple(self._cols[i][ordinal] for i in self._key_idx)
            if key in pk:
                raise ValueError(f"primary key violation after update: {key}")
            pk[key] = ordinal
        self._pk = pk

    def _typed_cols_locked(self) -> Dict[str, np.ndarray]:
        """Typed column arrays of every row for a mutation predicate.  NaN
        fills a float NULL (it never compares equal), other dtypes take 0;
        string columns keep their None."""
        typed = {}
        for f, c in zip(self.schema.fields, self._cols):
            dt = f.dtype.np_dtype
            if dt != np.dtype(object) and any(v is None for v in c):
                fill = np.nan if np.issubdtype(dt, np.floating) else 0
                c = [fill if v is None else v for v in c]
            typed[f.name] = np.array(c, dtype=dt)
        return typed

    def delete(self, predicate) -> int:
        with self._lock:
            if not self._live:
                return 0
            cols = _LiveRowCols(self._typed_cols_locked())
            cols._live = np.array(self._live)
            nmasks = {}
            for f, c in zip(self.schema.fields, self._cols):
                if any(v is None for v in c):
                    nmasks[f.name] = np.fromiter(
                        (v is None for v in c), dtype=np.bool_, count=len(c))
            cols._nulls = nmasks or None
            hit = np.asarray(predicate(cols)) & cols._live
            for ordinal in np.flatnonzero(hit):
                self._live[ordinal] = False
                if self._key_idx:
                    key = tuple(self._cols[i][ordinal] for i in self._key_idx)
                    if self._pk.get(key) == ordinal:
                        del self._pk[key]
            self._version += 1
            return int(hit.sum())

    def truncate(self) -> None:
        with self._lock:
            self._cols = [[] for _ in self.schema.fields]
            self._live = []
            self._pk = {}
            self._version += 1

    def count(self) -> int:
        return int(sum(self._live))

    def add_column(self, field: T.Field) -> None:
        """ALTER TABLE ADD COLUMN: existing rows read NULL."""
        with self._lock:
            self.schema = T.Schema(tuple(self.schema.fields) + (field,))
            self._cols.append([None] * len(self._live))
            self._version += 1

    def drop_column(self, name: str) -> None:
        # rows mutate in place: a pinned reader that has not captured its
        # host snapshot yet would resolve stale ordinals — the same typed
        # refusal and new-pin fence as the column-table form
        with mvcc.ddl_scope(self, "ALTER TABLE DROP COLUMN"), self._lock:
            idx = self.schema.index(name)
            if len(self.schema.fields) == 1:
                raise ValueError("cannot drop the only column")
            if idx in self._key_idx:
                raise ValueError(f"cannot drop primary key column {name}")
            for iname, icols in getattr(self, "_indexes", {}).items():
                if name.lower() in icols:
                    raise ValueError(
                        f"column {name} is referenced by index {iname}")
            self.schema = T.Schema(tuple(
                f for i, f in enumerate(self.schema.fields) if i != idx))
            del self._cols[idx]
            self._key_idx = [i - 1 if i > idx else i for i in self._key_idx]
            self._version += 1

    def create_index(self, name: str, columns: Sequence[str]) -> None:
        """Secondary index (ref: row-store indexes, CreateIndexTest),
        rebuilt lazily per version: point lookups are O(1) after the
        first access that follows a mutation."""
        if not hasattr(self, "_indexes"):
            self._indexes: Dict[str, tuple] = {}
            self._index_maps: Dict[str, tuple] = {}
        self._indexes[name.lower()] = tuple(c.lower() for c in columns)

    def drop_index(self, name: str) -> None:
        getattr(self, "_indexes", {}).pop(name.lower(), None)
        getattr(self, "_index_maps", {}).pop(name.lower(), None)

    def index_for_columns(self, columns: Sequence[str]):
        want = {c.lower() for c in columns}
        for name, cols in getattr(self, "_indexes", {}).items():
            if set(cols) == want:
                return name
        return None

    def index_lookup(self, name: str, key: tuple) -> List[tuple]:
        """Every live row whose indexed columns equal `key`."""
        cols = self._indexes[name.lower()]
        cached = getattr(self, "_index_maps", {}).get(name.lower())
        if cached is None or cached[0] != self._version:
            idx_cols = [self.schema.index(c) for c in cols]
            mapping: Dict[tuple, List[int]] = {}
            with self._lock:
                for ordinal, live in enumerate(self._live):
                    if live:
                        k = tuple(self._cols[i][ordinal] for i in idx_cols)
                        mapping.setdefault(k, []).append(ordinal)
                cached = (self._version, mapping)
            self._index_maps[name.lower()] = cached
        ordinals = cached[1].get(tuple(key), [])
        return [tuple(c[o] for c in self._cols) for o in ordinals]

    def string_dict(self, col_idx: int) -> np.ndarray:
        """Version-cached sorted dictionary of a string column, so the
        device bind and result assembly agree on codes within one
        version."""
        with self._lock:
            cache = getattr(self, "_sdict_cache", None)
            if cache is None or cache[0] != self._version:
                cache = (self._version, {})
                self._sdict_cache = cache
            if col_idx not in cache[1]:
                vals = [v for v, live in zip(self._cols[col_idx], self._live)
                        if live]
                cache[1][col_idx] = np.unique(np.array(
                    [v if v is not None else "" for v in vals],
                    dtype=object)) if vals else np.empty(0, dtype=object)
            return cache[1][col_idx]


