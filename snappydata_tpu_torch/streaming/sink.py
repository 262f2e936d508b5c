"""Exactly-once streaming sink (port of
snappydata_tpu/streaming/sink.py).

Direct behavioral port of the reference's structured-streaming sink
protocol (core/.../streaming/SnappySinkCallback.scala:49-360):

- state table `snappysys_internal____sink_state_table(query_id, batch_id)`
  records the last batch id processed per query (:196-216): a batch id
  ≤ the recorded one marks the batch `possible_duplicate`.
- `_eventType` column (insert=0 / update=1 / delete=2) drives CDC
  semantics; events are conflated to the last one per key when
  `conflation` is on (DefaultSnappySinkCallback.process:239).
- duplicate batches replay idempotently: inserts become puts on key'd
  tables (so re-applying is a no-op), mirroring the reference's
  possibleDuplicate handling.
- retries with backoff on transient conflicts (processBatchWithRetries
  :166-181).
"""

from __future__ import annotations

import enum
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from snappydata_tpu_torch import config


class EventType(enum.IntEnum):
    INSERT = 0
    UPDATE = 1
    DELETE = 2


EVENT_TYPE_COLUMN = "_eventType"


class SnappySink:
    def __init__(self, session, query_name: str, table: str,
                 conflation: bool = False):
        self.session = session
        self.query_name = query_name
        self.table = table.lower()
        self.conflation = conflation
        props = config.global_properties()
        self.state_table = props.sink_state_table
        self.max_retries = props.sink_max_retries
        self._ensure_state_table()

    def _ensure_state_table(self) -> None:
        self.session.sql(
            f"CREATE TABLE IF NOT EXISTS {self.state_table} "
            f"(query_id STRING PRIMARY KEY, batch_id BIGINT) USING row")

    # -- the exactly-once contract ---------------------------------------

    def last_batch_id(self) -> int:
        row = self.session.get(self.state_table, (self.query_name,))
        return int(row[1]) if row is not None else -1

    def process_batch(self, batch_id: int, columns: Dict[str, np.ndarray]
                      ) -> bool:
        """Apply one micro-batch. Returns False when the batch was already
        fully processed (skipped). `columns` maps target column names to
        arrays, optionally plus `_eventType`."""
        attempt = 0
        while True:
            try:
                return self._process_once(batch_id, columns)
            except Exception:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                time.sleep(0.05 * attempt)

    def _process_once(self, batch_id: int, columns) -> bool:
        last = self.last_batch_id()
        if batch_id < last:
            return False  # strictly older than the recorded batch: drop
        possible_duplicate = batch_id == last
        # APPLY first, record progress after: a crash between the two
        # replays the batch, which the idempotent apply (puts on key'd
        # tables) tolerates. Record-first would instead LOSE the batch on
        # crash — restart fetches from last_batch_id()+1 (review finding).
        # Keyless tables can duplicate on crash replay; the reference's
        # exactly-once likewise requires key columns.
        self._apply(columns, possible_duplicate)
        self.session.put(self.state_table, (self.query_name, batch_id))
        return True

    def _apply(self, columns: Dict[str, np.ndarray],
               possible_duplicate: bool) -> None:
        info = self.session.catalog.describe(self.table)
        names = [f.name for f in info.schema.fields]
        events = columns.get(EVENT_TYPE_COLUMN)
        n = len(np.asarray(columns[names[0]]))
        key_cols = list(info.key_columns)

        if events is None:
            arrays = [np.asarray(columns[c]) for c in names]
            if key_cols:
                # always upsert on key'd tables: crash replay of a batch
                # whose progress record was lost must be a no-op
                self._put_arrays(info, arrays)
            else:
                # keyless replay can't dedupe — the reference has the same
                # semantics (exactly-once needs key columns)
                self._insert_arrays(info, arrays)
            return

        events = np.asarray(events).astype(np.int64)
        order = np.arange(n)
        if self.conflation and key_cols:
            # keep only the LAST event per key (ref conflation)
            kidx = [names.index(k) for k in key_cols]
            seen = {}
            for i in range(n):
                key = tuple(np.asarray(columns[names[j]])[i] for j in kidx)
                seen[key] = i
            order = np.array(sorted(seen.values()), dtype=np.int64)
        deletes = order[events[order] == EventType.DELETE]
        upserts = order[events[order] != EventType.DELETE]

        if len(deletes) and key_cols:
            self.session.delete_keys(
                self.table, key_cols,
                [np.asarray(columns[k])[deletes] for k in key_cols])
        if len(upserts):
            arrays = [np.asarray(columns[c])[upserts] for c in names]
            if key_cols:
                self._put_arrays(info, arrays)
            else:
                self._insert_arrays(info, arrays)

    # all writes go through session APIs so a durable session journals
    # them (review finding: direct info.data calls bypassed the WAL)
    def _insert_arrays(self, info, arrays: List[np.ndarray]) -> None:
        self.session.insert_arrays(self.table, arrays)

    def _put_arrays(self, info, arrays: List[np.ndarray]) -> None:
        self.session.put_arrays(self.table, arrays)
