"""In-memory column-table storage: immutable encoded batches, a row delta
buffer, and a manifest chain.

Port of snappydata_tpu/storage/table_store.py cut to what an in-memory
single-session column table needs:

- Row delta buffer + rollover into column batches at `column_max_delta_rows`
  (ref: ColumnBatchCreator.createAndStoreBatch core/.../columnar/
  ColumnBatchCreator.scala:46, fired from StoreCallbacksImpl.createColumnBatch:77).
- Writers build a new immutable Manifest and publish it by one reference
  swap; a reader holds whichever Manifest it read.

The same inserts produce the same encodings as the reference package
(VALUE_DICT, RLE, DICTIONARY, bitset), because batch cutting and encoding
are copied unchanged.  MVCC epoch pins, host spill, tiered storage,
compaction, UPDATE/DELETE deltas and complex-typed columns are not ported:
a batch view is just its batch.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from snappydata_tpu_torch import config
from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.storage.batch import ColumnBatch
from snappydata_tpu_torch.storage.encoding import decode_to_numpy, decode_validity
from snappydata_tpu_torch.storage.strings import fast_encode_strings
from snappydata_tpu_torch.utils import locks


@dataclasses.dataclass(frozen=True)
class BatchView:
    """One batch as visible in a particular Manifest version (the port has
    no UPDATE/DELETE, so a view carries no deltas or delete mask)."""

    batch: ColumnBatch

    def decoded_column(self, col_idx: int, strings: bool = False) -> np.ndarray:
        return decode_to_numpy(self.batch.columns[col_idx],
                               self.batch.capacity, strings=strings)

    def null_mask(self, col_idx: int) -> Optional[np.ndarray]:
        base = decode_validity(self.batch.columns[col_idx],
                               self.batch.capacity)
        if base is None:
            return None
        mask = ~base
        return mask if mask.any() else None

    def live_mask(self) -> np.ndarray:
        return np.arange(self.batch.capacity) < self.batch.num_rows

    def live_rows(self) -> int:
        return int(self.batch.num_rows)


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

    def total_rows(self) -> int:
        return sum(v.live_rows() for v in self.views) + self.row_count


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
        self.count += n
        return n

    def snapshot(self) -> Tuple[Tuple[np.ndarray, ...],
                                Tuple[Optional[np.ndarray], ...], int]:
        arrs = tuple(c[:self.count].copy() for c in self._cols)
        nls = tuple(m[:self.count].copy() if m is not None else None
                    for m in self._nulls)
        return arrs, nls, self.count

    def clear(self) -> None:
        self.count = 0
        self._nulls = [None] * len(self.schema.fields)


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
        self._row_buffer = RowBuffer(schema, max(self.max_delta_rows * 2,
                                                 self.capacity))
        # table-level shared dictionaries for string columns: codes stay
        # comparable across batches (device group-by/join runs on codes)
        self._dicts: Dict[int, List] = {
            i: [] for i, f in enumerate(schema.fields) if f.dtype.name == "string"}
        self._dict_lookup: Dict[int, Dict] = {i: {} for i in self._dicts}
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
        m = Manifest(self._manifest.version + 1, views, row_arrays,
                     row_count, row_nulls)
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


    def insert_arrays(self, arrays: Sequence[np.ndarray],
                      nulls: Optional[Sequence[Optional[np.ndarray]]] = None
                      ) -> int:
        """Bulk/small insert. Large inserts cut column batches directly
        (ref ColumnInsertExec bulk path); small ones land in the row buffer
        and roll over when it exceeds max_delta_rows (ref §3.3).

        `nulls[i]` is an optional bool mask marking SQL NULLs in column i
        (values at those positions are fillers)."""
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
        return n

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

    def truncate(self) -> None:
        with self._lock:
            self._row_buffer.clear()
            self._publish(())

    # --- helpers ---------------------------------------------------------

    def _decode_all(self, view: BatchView) -> "LazyBatchColumns":
        """Lazily-decoding column mapping for the host evaluator: only the
        columns a plan touches get decoded; string columns decode through
        the table dictionary."""
        return LazyBatchColumns(self, view)


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


