"""Process-wide counters.

The counter subset of snappydata_tpu/observability/metrics.py: the engine
counts plan-cache verdicts, host fallbacks, batch skipping, compressed-
domain fallbacks, the aggregate lanes a plan took, the tiled lane's
passes (TILE_COUNTERS) and the WAL's group commits, under the same names
as the reference so the two packages' evidence lines up, plus summed
timers (`record_time`) and pull gauges (`gauge`: the resource governor's
in-flight, queue and ledger readings).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, Tuple

# the tiled lane's evidence, under the reference's names:
#   scan_tiles                  tiles executed (work, not queries)
#   scan_tile_device_merges     tile partials folded on the device
#   scan_tile_host_merges       passes that merged through host pieces
#   scan_tile_prefetch_overlap  tiles launched while the previous tile's
#                               device work was still running
#   prefetch_windows_warmed     look-ahead windows the worker bound
#   prefetch_window_waits       windows the consumer had to wait for
#   prefetch_overlap_ms         build time the consumer did not wait for
#   prefetch_worker_deaths      worker loops that died (restarts follow)
#   device_upload_bytes         host-to-device plate bytes of every bind
TILE_COUNTERS = ("scan_tiles", "scan_tile_device_merges",
                 "scan_tile_host_merges", "scan_tile_prefetch_overlap",
                 "prefetch_windows_warmed", "prefetch_window_waits",
                 "prefetch_overlap_ms", "prefetch_worker_deaths",
                 "device_upload_bytes")


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._timers: Dict[str, Tuple[int, float]] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def record_time(self, name: str, seconds: float) -> None:
        """One timed event (count and total seconds; the reference keeps
        a histogram, the port only the sum so far)."""
        with self._lock:
            n, tot = self._timers.get(name, (0, 0.0))
            self._timers[name] = (n + 1, tot + float(seconds))

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register a pull gauge: `fn` is read when `gauges()` is."""
        with self._lock:
            self._gauges[name] = fn

    def gauges(self) -> Dict[str, float]:
        """Every gauge's current value.  The functions run outside the
        registry lock: they may walk ledgers that bump counters."""
        with self._lock:
            fns = dict(self._gauges)
        out = {}
        for name, fn in fns.items():
            try:
                out[name] = float(fn())
            except Exception:
                out[name] = float("nan")
        return out

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def timer(self, name: str) -> Tuple[int, float]:
        """(count, total seconds) of one timer, (0, 0.0) if never set."""
        with self._lock:
            return self._timers.get(name, (0, 0.0))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def counters(self, names: Iterable[str]) -> Dict[str, int]:
        """The current value of each named counter (0 if never set)."""
        with self._lock:
            return {n: self._counters.get(n, 0) for n in names}


_registry = Registry()


def global_registry() -> Registry:
    return _registry
