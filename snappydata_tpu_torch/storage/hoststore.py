"""Host memory eviction: spill cold column batches to disk as memmaps.

Port of snappydata_tpu/storage/hoststore.py.  The reference evicts region
entries to disk when the heap crosses eviction-heap-percentage
(SnappyUnifiedMemoryManager.scala:379-401; SnappyStorageEvictor).  Here:
when a table's RESIDENT batch bytes exceed `host_store_bytes` (or the
table's own `OPTIONS (eviction_bytes 'N')`), the OLDEST batches' numeric
arrays are rewritten into a spill file and replaced by `np.memmap` views,
arrays with the same values whose residency the OS page cache manages, so
a later scan simply pages the bytes back in (and the device bind uploads
them straight from the mapping, `device_decode.upload`).  Dictionaries
and object-typed arrays stay resident (small, not memmappable).

Spilling republishes the manifest, which invalidates the table's device
plates for the spilled version: a device re-upload traded for host RAM,
as the reference trades on eviction.  `check_critical_memory` refuses
inserts once the process RSS crosses `critical_host_bytes`.  On the card
the RSS includes the CUDA context and the pinned staging buffers of the
prefetch stream, so set that knob with them in mind.
"""

from __future__ import annotations

import atexit
import dataclasses
import itertools
import os
import shutil
import tempfile
import weakref
from typing import Optional, Tuple

import numpy as np

from snappydata_tpu_torch.utils import locks

_spill_dir: Optional[str] = None
_spill_ids = itertools.count()  # unique filenames (id() values recycle)
_spill_lock = locks.named_lock("storage.spill")
_spill_bytes = 0                # live spill-file bytes (broker ledger)


def spill_file_bytes() -> int:
    """Total bytes currently held in live spill files — the spill side
    of the resource broker's unified host ledger."""
    with _spill_lock:
        return _spill_bytes


def _dir() -> str:
    global _spill_dir
    if _spill_dir is None:
        _spill_dir = tempfile.mkdtemp(prefix="snappy_hoststore_")
        atexit.register(shutil.rmtree, _spill_dir, ignore_errors=True)
    return _spill_dir


class CriticalMemoryError(MemoryError):
    """Raised when process RSS crosses critical_host_bytes: new writes
    are refused so the member stays alive to serve reads (ref:
    critical-heap-percentage LowMemoryException fail-fast)."""


def process_rss_bytes() -> int:
    """Resident set size of this process (Linux /proc, no psutil)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def check_critical_memory() -> None:
    from snappydata_tpu_torch import config

    crit = config.global_properties().critical_host_bytes
    if crit and process_rss_bytes() > crit:
        raise CriticalMemoryError(
            f"host memory critical: RSS {process_rss_bytes() >> 20}MiB "
            f"exceeds critical_host_bytes ({crit >> 20}MiB); insert "
            f"refused (reads still served — free memory or raise the "
            f"limit)")


def resident_bytes(arr: Optional[np.ndarray]) -> int:
    """SPILLABLE bytes an array keeps in host RAM. memmaps count 0 (the
    page cache owns them); object-dtype arrays count 0 too — they CANNOT
    spill, and counting them would make the budget unreachable (the
    spiller would rewrite the same batches on every insert forever)."""
    if arr is None or isinstance(arr, np.memmap) or arr.dtype == object:
        return 0
    return arr.nbytes


def batch_resident_bytes(batch) -> int:
    total = 0
    for col in batch.columns:
        for a in (col.data, col.runs, col.validity):
            total += resident_bytes(a)
    return total


def spill_batch(batch) -> Tuple[int, object]:
    """Write one batch's numeric arrays to disk; returns (bytes_freed,
    new ColumnBatch with memmap-backed columns). The spill file is
    unlinked when the new batch object is garbage-collected (Linux keeps
    the inode alive for any still-mapped views)."""
    path = os.path.join(_dir(),
                        f"batch_{next(_spill_ids)}_{batch.batch_id}.bin")
    freed = 0
    new_cols = []
    # file must exist and carry all bytes BEFORE memmaps are constructed
    with open(path, "wb") as fh:
        staged = []
        for col in batch.columns:
            offs = {}
            for name in ("data", "runs", "validity"):
                a = getattr(col, name)
                if a is None or isinstance(a, np.memmap) or \
                        a.dtype == object:
                    offs[name] = None
                    continue
                ac = np.ascontiguousarray(a)
                offs[name] = (fh.tell(), ac.dtype, ac.shape)
                fh.write(ac.tobytes())
                freed += ac.nbytes
            staged.append(offs)
        fh.flush()
        # locklint: blocking-under-lock spill runs on the degradation
        # ladder under the table lock by design: the manifest swap must
        # be atomic against mutation, and the write is the memory relief
        os.fsync(fh.fileno())
    if freed == 0:
        os.unlink(path)
        return 0, batch
    for col, offs in zip(batch.columns, staged):
        repl = {}
        for name, spec in offs.items():
            if spec is not None:
                off, dt, shape = spec
                repl[name] = np.memmap(path, dtype=dt, mode="r",
                                       offset=off, shape=shape)
        new_cols.append(dataclasses.replace(col, **repl) if repl else col)
    new_batch = dataclasses.replace(batch, columns=tuple(new_cols))
    global _spill_bytes
    with _spill_lock:
        _spill_bytes += freed
    weakref.finalize(new_batch, _unlink_quiet, path, freed)
    return freed, new_batch


def _unlink_quiet(path: str, nbytes: int = 0) -> None:
    global _spill_bytes
    if nbytes:
        with _spill_lock:
            _spill_bytes -= nbytes
    try:
        os.unlink(path)
    except OSError:
        pass


def spill_to_budget(data, budget: int) -> int:
    """Spill `data`'s oldest resident batches until the table fits the
    budget. Returns batches spilled."""
    from snappydata_tpu_torch.observability.metrics import global_registry

    spilled = 0
    # locklint: lock=storage.column_table (only column tables spill)
    with data._lock:
        m = data._manifest
        per_view = [batch_resident_bytes(v.batch) for v in m.views]
        total = sum(per_view)
        if total <= budget:
            return 0
        new_views = list(m.views)
        freed_total = 0
        for i, v in enumerate(new_views):  # oldest (lowest index) first
            if total - freed_total <= budget:
                break
            if per_view[i] == 0:
                continue
            freed, nb = spill_batch(v.batch)
            if freed == 0:
                continue
            freed_total += freed
            new_views[i] = dataclasses.replace(v, batch=nb)
            spilled += 1
        if spilled:
            data._publish(tuple(new_views))
    if spilled:
        reg = global_registry()
        reg.inc("host_batches_spilled", spilled)
    return spilled
