"""Double-buffered host -> device tile prefetch for the out-of-core scan.

Port of snappydata_tpu/storage/prefetch.py.  A tiled pass over a table
bigger than the device budget alternates upload and compute: bind window
k, aggregate window k, bind window k+1 ...  The prefetcher overlaps them:
while the partial program aggregates tile k on the device, a background
worker warms tile k+1's plates through the SAME bind path
(`device.build_device_table` under its own per-thread `scan_window`), so
the device cache already holds window k+1 when the consumer arrives.

On CUDA the worker uploads on its OWN stream, staging through pinned
host memory with non_blocking copies (`device_decode.upload_scope`).
After a window's build it records an event on that stream and marks
every plate of the window used on the consumer's stream
(`record_stream`), so the caching allocator cannot hand the memory to
the worker's next window while the consumer's kernels still read it.
The consumer's stream waits on the window's event before its first
launch over the window (`await_window`).  On the CPU the worker only
overlaps host decode with the consumer.

Coordination is one module lock, `storage.prefetch` — a LEAF: nothing is
acquired while it is held (metric increments and thread joins happen
outside; the build itself runs unlocked).  The keep-window registry it
guards tells the device cache's window prune which tile entries are live
look-ahead.  A worker death is counted (`prefetch_worker_deaths`) and the
worker restarts up to `tier_prefetch_max_restarts` times; past that the
pass carries on with inline binds.  The `prefetch.worker` failpoint sits
at the top of each window's build, inside that supervision
(`kill_worker` there is the uncaught-death shape); `worker_snapshot()`
reads the workers' health.

Mesh-aware: the worker enters the consumer's captured `MeshContext`, so
its cache keys carry the same mesh token and its plates land on the
mesh's home device, and its uploads run inside `parallel.mesh_dispatch`
(`mesh.prefetch_fence`) like every other multi-slot dispatch.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Set, Tuple

import torch

from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.reliability import failpoints as rfail
from snappydata_tpu_torch.utils import locks

# one lock for every prefetcher AND the keep-window registry: prefetch
# passes are per-statement and coordination is rare (one wait per tile)
_pf_lock = locks.named_lock("storage.prefetch")
_KEEP: Dict[int, Set[Tuple[int, int]]] = {}   # id(data) -> live windows

_COL_KINDS = ("col", "ccol")

# live worker threads; mutated only under _pf_lock
_LIVE_WORKERS: Set[int] = set()


def worker_snapshot() -> dict:
    """Point-in-time prefetch-worker health: live workers plus the
    lifetime death and restart counters (restarting through faults is
    told apart from silently degrading to inline binds)."""
    reg = global_registry()
    with _pf_lock:
        live = len(_LIVE_WORKERS)
    return {"live_workers": live,
            "worker_deaths": reg.counter("prefetch_worker_deaths"),
            "worker_restarts": reg.counter("prefetch_worker_restarts"),
            "errors": reg.counter("prefetch_errors"),
            "windows_warmed": reg.counter("prefetch_windows_warmed")}


def keep_windows(data) -> Set[Tuple[int, int]]:
    """Windows of `data` a live prefetch pass owns — the device cache's
    window prune must not evict these."""
    with _pf_lock:
        s = _KEEP.get(id(data))
        return set(s) if s else set()


def _tensors(obj):
    """Every tensor inside one device-cache value (plates, plate tuples,
    null masks)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for x in obj:
            yield from _tensors(x)


class TilePrefetcher:
    """Warms tile windows of one (data, manifest, columns) scan ahead of
    the consumer.  Protocol:

        pf = TilePrefetcher.maybe(data, manifest, units, tile_units, dev)
        try:
            for lo in range(0, units, tile_units):
                if pf: pf.await_window(lo)        # block until warm
                with scan_window(...): dispatch(lo)
                if pf: pf.advance(lo)             # release look-ahead
        finally:
            if pf: pf.close()                     # join + drop tiles

    Window 0 binds inline on the consumer (its cache entry names the
    columns the worker warms); the worker stays `tier_prefetch_depth`
    windows ahead of the last advance.
    """

    def __init__(self, data, manifest, units: int, tile_units: int,
                 depth: int, device: torch.device, mesh_ctx=None) -> None:
        self._mesh_ctx = mesh_ctx
        if mesh_ctx is not None:
            device = mesh_ctx.home
        # the device cache's placement component of this pass's keys
        self._placement = mesh_ctx.token if mesh_ctx is not None \
            else str(device)
        self._data = data
        self._manifest = manifest
        self._units = int(units)
        self._tile_units = int(tile_units)
        self._depth = max(1, int(depth))
        self._device = device
        self._cuda = device.type == "cuda"
        # the consumer's stream (the caller's current one) and the
        # worker's upload stream
        self._consumer = torch.cuda.current_stream(device) \
            if self._cuda else None
        self._stream = torch.cuda.Stream(device=device) \
            if self._cuda else None
        self._events: Dict[int, object] = {}   # lo -> upload-done event
        self._cols: Optional[Dict[bool, Tuple[int, ...]]] = None
        self._cond = locks.named_condition("storage.prefetch",
                                           lock=_pf_lock)
        self._done: Dict[int, float] = {}   # lo -> build ms
        self._consumed = 0                  # last advanced lo
        self._next = self._tile_units       # next lo the worker builds
        self._stop = False
        self._dead = False
        self._worker: Optional[threading.Thread] = None
        self._overlap_ms = 0.0
        self._overlapped = False

    @classmethod
    def maybe(cls, data, manifest, units: int, tile_units: int,
              device: torch.device, mesh_ctx=None
              ) -> Optional["TilePrefetcher"]:
        depth = int(config.global_properties().tier_prefetch_depth)
        if depth <= 0 or units <= tile_units or tile_units <= 0:
            return None
        return cls(data, manifest, units, tile_units, depth, device,
                   mesh_ctx)

    # -- consumer side ---------------------------------------------------

    def await_window(self, lo: int) -> None:
        """Block (bounded) until window `lo` is warm in the device cache,
        mark it the consumer's active window so neither side's prune
        evicts it, and order the consumer's stream after its uploads.
        Overlap won = the build time the consumer did NOT wait for."""
        self._keep((lo, min(lo + self._tile_units, self._units)))
        if lo < self._tile_units or self._worker is None:
            return
        reg = global_registry()
        t0 = time.perf_counter()
        waited = False
        deadline = t0 + 30.0
        with self._cond:
            while lo not in self._done and not self._dead:
                waited = True
                if time.perf_counter() >= deadline:
                    self._dead = True   # wedged worker: inline fallback
                    break
                self._cond.wait(0.25)
            build_ms = self._done.get(lo)
            ev = self._events.pop(lo, None)
        if ev is not None:
            self._consumer.wait_event(ev)
        if waited:
            reg.inc("prefetch_window_waits")
        if build_ms is not None:
            waited_ms = (time.perf_counter() - t0) * 1000.0
            won = max(0.0, build_ms - waited_ms)
            if won > 0:
                self._overlap_ms += won
                self._overlapped = True

    def advance(self, lo: int) -> None:
        """Consumer dispatched window `lo`: retire older look-ahead and let
        the worker run up to `lo + depth * tile_units`.  advance(0) also
        reads the column set off the inline-bound window-0 cache entry and
        starts the worker."""
        with self._cond:
            self._consumed = lo
            ids = _KEEP.get(id(self._data))
            if ids:
                for w in [w for w in ids if w[0] < lo]:
                    ids.discard(w)
            for k in [k for k in self._done if k < lo]:
                self._done.pop(k)
                self._events.pop(k, None)
            self._cond.notify_all()
        if lo == 0 and self._worker is None and not self._dead:
            self._start()

    def close(self) -> None:
        """End of pass: stop the worker, join OUTSIDE all locks, drop this
        pass's keep-windows and every orphaned tile entry, publish the
        overlap counter."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        w = self._worker
        if w is not None:
            w.join(timeout=30.0)
        with self._cond:
            _KEEP.pop(id(self._data), None)
        kept = keep_windows(self._data)   # concurrent passes, if any
        cache = self._data._device_cache
        from snappydata_tpu_torch.storage.device import _cache_budget

        for k in [k for k in list(cache)
                  if k[2] is not None and k[2] not in kept]:
            cache.pop(k, None)
            _cache_budget.forget(cache, k)
        if self._overlapped:
            global_registry().inc("prefetch_overlap_ms",
                                  max(1, int(self._overlap_ms)))

    def dead(self) -> bool:
        return self._dead

    # -- worker side -----------------------------------------------------

    def _keep(self, window: Tuple[int, int]) -> None:
        with self._cond:
            _KEEP.setdefault(id(self._data), set()).add(window)

    def _infer_cols(self) -> Optional[Dict[bool, Tuple[int, ...]]]:
        """Column sets of the pass, split by how the consumer bound them:
        code-resident ("ccol", built with code_ok) and decoded ("col").
        A join's probe relation binds decoded on purpose; warming it with
        code_ok would cache plates the consumer never reads."""
        for key, entry in list(self._data._device_cache.items()):
            if key[0] != self._manifest.version \
                    or key[1] != self._placement:
                continue
            if key[2] is None or key[2][0] != 0:
                continue
            kinds = [k for k in list(entry)
                     if isinstance(k, tuple) and k[0] in _COL_KINDS]
            if kinds:
                return {True: tuple(sorted(k[1] for k in kinds
                                           if k[0] == "ccol")),
                        False: tuple(sorted(k[1] for k in kinds
                                            if k[0] == "col"))}
        return None

    def _start(self) -> None:
        self._cols = self._infer_cols()
        if self._cols is None:
            self._dead = True   # nothing cached to mirror: stay inline
            return
        self._worker = threading.Thread(
            target=self._run, name="snappy-tile-prefetch", daemon=True)
        self._worker.start()

    def _run(self) -> None:
        """Worker body with supervision: an escaping exception restarts
        the loop with capped backoff up to `tier_prefetch_max_restarts`
        times; an exhausted budget sets `_dead` (the consumer then binds
        inline)."""
        max_restarts = int(config.global_properties()
                           .tier_prefetch_max_restarts)
        reg = global_registry()
        tid = threading.get_ident()
        with _pf_lock:
            _LIVE_WORKERS.add(tid)
        try:
            attempt = 0
            while True:
                try:
                    if self._mesh_ctx is not None:
                        with self._mesh_ctx:
                            self._loop()
                    else:
                        self._loop()
                    return                       # clean stop
                except BaseException:
                    reg.inc("prefetch_errors")
                    reg.inc("prefetch_worker_deaths")
                    with self._cond:
                        stopped = self._stop
                    if stopped or attempt >= max_restarts:
                        with self._cond:
                            self._dead = True
                            self._cond.notify_all()
                        return
                    attempt += 1
                    reg.inc("prefetch_worker_restarts")
                    time.sleep(min(0.25, 0.02 * (2 ** (attempt - 1))))
        finally:
            with _pf_lock:
                _LIVE_WORKERS.discard(tid)

    def _loop(self) -> None:
        from snappydata_tpu_torch.parallel import mesh
        from snappydata_tpu_torch.storage import device as device_mod
        from snappydata_tpu_torch.storage import device_decode

        reg = global_registry()
        with config.device_scope(self._device):
            while True:
                with self._cond:
                    while not self._stop and not (
                            self._next < self._units
                            and self._next <= self._consumed
                            + self._depth * self._tile_units):
                        self._cond.wait(0.25)
                    if self._stop:
                        return
                    lo = self._next
                    self._next += self._tile_units
                hi = min(lo + self._tile_units, self._units)
                self._keep((lo, hi))
                t0 = time.perf_counter()
                ev = None
                try:
                    # the worker-body seam: kill_worker here escapes into
                    # _run's supervision (restart with backoff)
                    rfail.hit("prefetch.worker")
                    # the worker's scan_window contextvar is PER-THREAD:
                    # the consumer's window never sees this restriction
                    with device_mod.scan_window(self._data, lo, hi,
                                                self._manifest,
                                                tile_units=self._tile_units), \
                            device_decode.upload_scope(self._stream), \
                            mesh.prefetch_fence():
                        for code_ok, cols in self._cols.items():
                            if cols:
                                device_mod.build_device_table(
                                    self._data, cols, self._device,
                                    code_ok=code_ok)
                        if self._cuda:
                            self._mark_used(lo, hi)
                            ev = torch.cuda.Event()
                            ev.record(self._stream)
                except BaseException:
                    with self._cond:
                        # the restarted loop must rebuild THIS window: the
                        # consumer is (or will be) blocked on it
                        self._next = min(self._next, lo)
                        self._cond.notify_all()
                    raise
                ms = (time.perf_counter() - t0) * 1000.0
                reg.inc("prefetch_windows_warmed")
                with self._cond:
                    self._done[lo] = ms
                    if ev is not None:
                        self._events[lo] = ev
                    self._cond.notify_all()

    def _mark_used(self, lo: int, hi: int) -> None:
        """record_stream every plate of window [lo, hi) on the consumer's
        stream: the plates were allocated on the worker's stream, and the
        caching allocator must not reuse their memory for the worker's
        later windows until the consumer's kernels over them are done."""
        key = (self._manifest.version, self._placement, (lo, hi))
        entry = self._data._device_cache.get(key, {})
        for v in list(entry.values()):
            for t in _tensors(v):
                t.record_stream(self._consumer)
