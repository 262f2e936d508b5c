"""Micro-batch streaming queries over pluggable sources (port of
snappydata_tpu/streaming/query.py).

The reference runs Spark structured streaming (micro-batches from Kafka/
file/socket sources) into the snappy sink (SURVEY.md §3.5) plus a legacy
DStream layer (SchemaDStream). Here: a thread-driven micro-batch loop with
the same progress/exactly-once contract, and sources for in-memory queues,
growing files, and Kafka (streaming/kafka.py — durable per-partition
offset ranges behind the same Source interface; network brokers need a
client library, in-process brokers work out of the box).

The micro-batch loop runs on a thread of its own and enters its session's
`config.device_scope`, so a micro-batch binds and appends on the session's
device.  The socket pump only reads and parses lines: it touches no
device."""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.streaming.sink import SnappySink
from snappydata_tpu_torch.utils import locks


class Source:
    """One micro-batch source: next_batch(from_offset) → (columns, new
    offset) or None when no data is pending."""

    def next_batch(self, offset):
        raise NotImplementedError


class MemorySource(Source):
    """In-memory list of pending batches (tests / programmatic feeds)."""

    def __init__(self):
        self._batches: List[Dict[str, np.ndarray]] = []
        self._lock = locks.named_lock("streaming.query")

    def add_batch(self, columns: Dict[str, np.ndarray]) -> None:
        with self._lock:
            self._batches.append(columns)

    def next_batch(self, offset):
        with self._lock:
            if offset < len(self._batches):
                return self._batches[offset], offset + 1
        return None


class FileSource(Source):
    """Tails a directory of JSON-lines files (ref: file stream source).
    Each new file is one micro-batch; offset = count of consumed files."""

    def __init__(self, directory: str, schema_names: List[str]):
        self.directory = directory
        self.names = schema_names

    def next_batch(self, offset):
        files = sorted(f for f in os.listdir(self.directory)
                       if not f.startswith("."))
        if offset >= len(files):
            return None
        path = os.path.join(self.directory, files[offset])
        rows = []
        skipped = 0
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    # poison line: skip rather than wedging the stream on
                    # the same offset forever (log-tailing semantics)
                    skipped += 1
        if skipped:
            import sys

            print(f"warning: {path}: skipped {skipped} malformed line(s)",
                  file=sys.stderr)
        cols = {n: np.array([r.get(n) for r in rows]) for n in self.names}
        for extra in ("_eventType",):
            if rows and extra in rows[0]:
                cols[extra] = np.array([r[extra] for r in rows])
        return cols, offset + 1


class SocketSource(Source):
    """TCP line source (ref: socketTextStream demos — the reference's
    socket stream source is likewise at-most-once: a socket has no
    offsets to replay, so unconsumed lines buffered at crash time are
    lost; durable pipelines use kafka_stream)."""

    def __init__(self, host: str, port: int, schema_names):
        import socket
        import threading as _t

        self.names = list(schema_names)
        self._buf: List[dict] = []
        self._lock = locks.named_lock("streaming.socket_source")
        self._sock = socket.create_connection((host, port), timeout=10)
        # the 10s timeout covers CONNECT only: a blocking read timeout
        # would poison the pump on any >10s producer idle gap
        self._sock.settimeout(None)
        self._closed = False
        _t.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        import json as _json

        fh = self._sock.makefile("r")
        try:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = _json.loads(line)
                except ValueError:
                    continue  # poison line: skip, like FileSource
                with self._lock:
                    self._buf.append(rec)
        except OSError:
            pass
        finally:
            self._closed = True

    def next_batch(self, offset):
        with self._lock:
            if not self._buf:
                return None
            rows, self._buf = self._buf, []
        cols = {n: np.array([r.get(n) for r in rows])
                for n in self.names}
        return cols, offset + 1

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _batch_empty(columns) -> bool:
    return not columns or all(len(np.asarray(v)) == 0
                              for v in columns.values())


class StreamingQuery:
    """One running micro-batch pipeline: source → optional transform →
    exactly-once sink. Progress (batch id) restarts from the sink state
    table, so a restarted query resumes where it left off."""

    def __init__(self, session, name: str, source: Source, table: str,
                 transform: Optional[Callable] = None,
                 conflation: bool = False, interval_s: float = 0.05,
                 stamp_arrivals: bool = False):
        self.session = session
        self.name = name
        self.source = source
        self.sink = SnappySink(session, name, table, conflation=conflation)
        self.transform = transform
        self.interval_s = interval_s
        self.stamp_arrivals = stamp_arrivals
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.batches_processed = 0
        self.rows_processed = 0
        self.started_at = time.time()
        self.last_batch_ts: Optional[float] = None
        self.last_error: Optional[BaseException] = None

    # offset == batch id: deterministic replay after restart
    def start(self) -> "StreamingQuery":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        with config.device_scope(self.session.device):
            self._loop()

    def _loop(self) -> None:
        offset = self.sink.last_batch_id() + 1
        while not self._stop.is_set():
            try:
                got = self.source.next_batch(offset)
            except Exception as e:  # source hiccup: retry next tick
                logging.getLogger(__name__).warning(
                    "stream source fetch failed: %s", e)
                global_registry().inc("stream_source_errors")
                self.last_error = e
                got = None
            if got is None:
                time.sleep(self.interval_s)
                continue
            columns, new_offset = got
            if self.transform is not None:
                columns = self.transform(columns)
            if _batch_empty(columns):
                offset = new_offset  # nothing to apply; just advance
                continue
            columns = self._stamp(columns)
            try:
                applied = self.sink.process_batch(offset, columns)
                self._note_batch(columns if applied else None)
                self._prune_source_log(offset)
                offset = new_offset
            except Exception as e:
                # retried next tick at the same offset (exactly-once
                # sinks dedup) — but the stall must be visible
                logging.getLogger(__name__).warning(
                    "stream batch apply failed: %s", e)
                global_registry().inc("stream_apply_errors")
                self.last_error = e
                time.sleep(self.interval_s)

    def _stamp(self, columns):
        """Arrival timestamps for WINDOW (DURATION ...) queries."""
        if not self.stamp_arrivals or not columns:
            return columns
        n = len(np.asarray(next(iter(columns.values()))))
        out = dict(columns)
        out["__arrival_ts"] = np.full(n, int(time.time() * 1e6),
                                      dtype=np.int64)
        return out

    def process_available(self) -> int:
        """Synchronous drain (tests / backfills): consume until the source
        is empty. Returns number of batches applied."""
        offset = self.sink.last_batch_id() + 1
        applied = 0
        while True:
            got = self.source.next_batch(offset)
            if got is None:
                return applied
            columns, new_offset = got
            if self.transform is not None:
                columns = self.transform(columns)
            columns = self._stamp(columns)
            did_apply = not _batch_empty(columns) and \
                self.sink.process_batch(offset, columns)
            if did_apply:
                applied += 1
                self._prune_source_log(offset)
            # rows count only when APPLIED: a replayed batch the exactly-
            # once sink deduplicated must not inflate progress metrics
            self._note_batch(columns if did_apply else None)
            offset = new_offset

    def _prune_source_log(self, applied_batch_id: int) -> None:
        """Sources with a durable offset log (Kafka) drop entries the
        sink has durably recorded — everything strictly below the
        applied batch stays replayable until then."""
        prune = getattr(self.source, "prune_log", None)
        if prune is not None:
            try:
                prune(applied_batch_id)
            except Exception:
                pass  # pruning is advisory; replay handles leftovers

    def _note_batch(self, columns) -> None:
        """columns=None → the batch was seen but deduplicated (replay)."""
        self.batches_processed += 1
        if columns:
            self.rows_processed += int(
                len(np.asarray(next(iter(columns.values())))))
        self.last_batch_ts = time.time()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        close = getattr(self.source, "close", None)
        if close is not None:   # socket sources hold a live connection
            try:
                close()
            except Exception:
                pass

    @property
    def is_active(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def progress(self) -> dict:
        """Status snapshot (ref: StreamingQueryManager's query progress —
        the reference's structured-streaming UI tab reads the same
        fields: batches, input rows, processing rate, last error)."""
        elapsed = max(time.time() - self.started_at, 1e-9)
        return {
            "name": self.name,
            "table": self.sink.table,
            "active": self.is_active,
            "batches_processed": self.batches_processed,
            "rows_processed": self.rows_processed,
            "rows_per_s": round(self.rows_processed / elapsed, 1),
            "last_batch_id": self.sink.last_batch_id(),
            "last_batch_ts": self.last_batch_ts,
            "interval_s": self.interval_s,
            "last_error": str(self.last_error) if self.last_error else None,
        } | (self.source.extra_progress()
             if hasattr(self.source, "extra_progress") else {})
