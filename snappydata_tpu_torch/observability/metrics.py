"""Metrics: counters, gauges, log-bucketed histogram timers with a JSON
snapshot surface and Prometheus text exposition.

Port of snappydata_tpu/observability/metrics.py.  The engine counts
plan-cache verdicts, host fallbacks, batch skipping, compressed-domain
lanes and fallbacks, the aggregate lanes a plan took, the tiled lane's
passes (TILE_COUNTERS), the WAL's group commits and the resource
governor, under the reference's names, so the two packages' evidence
lines up.  Timers are histograms: every recorded duration lands in a
log-spaced bucket (4 buckets per octave from 1 us), so every timer
reports p50 / p99 / p99.9 in snapshots and in the histogram exposition.
Gauges are pulled: their functions run when a snapshot is taken (the
governor's in-flight, queue and ledger readings).
"""

from __future__ import annotations

import json
import math
import time
import zlib
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from snappydata_tpu_torch.utils import locks

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

# log-bucket geometry: bucket 0 holds (0, 1 us]; bucket i > 0 holds
# (1 us * r^(i-1), 1 us * r^i] with r = 2^(1/4) (4 buckets an octave:
# worst-case quantile error ~19% before intra-bucket interpolation); 142
# buckets reach ~4.4e4 s, anything beyond clamps into the last bucket,
# whose upper edge is the observed max
_H_MIN = 1e-6
_H_RATIO = 2.0 ** 0.25
_H_LOG_R = math.log(_H_RATIO)
_H_BUCKETS = 142


def _bucket_index(seconds: float) -> int:
    if seconds <= _H_MIN:
        return 0
    return min(_H_BUCKETS - 1,
               1 + int(math.log(seconds / _H_MIN) / _H_LOG_R))


def _bucket_upper(i: int) -> float:
    return _H_MIN * (_H_RATIO ** i)


class Timer:
    """Log-bucketed latency histogram (plus exact count / sum / min /
    max)."""

    __slots__ = ("count", "total_s", "min_s", "max_s", "buckets")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0
        self.buckets: Optional[List[int]] = None   # lazy: many timers idle

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)
        if self.buckets is None:
            self.buckets = [0] * _H_BUCKETS
        self.buckets[_bucket_index(seconds)] += 1

    def quantile(self, q: float) -> float:
        """Histogram quantile with linear intra-bucket interpolation,
        clamped to the exact observed [min, max]."""
        if not self.count or self.buckets is None:
            return 0.0
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.buckets):
            if not c:
                continue
            if cum + c >= target:
                lo = 0.0 if i == 0 else _bucket_upper(i - 1)
                hi = min(_bucket_upper(i), self.max_s) \
                    if i < _H_BUCKETS - 1 else self.max_s
                hi = max(hi, lo)
                frac = (target - cum) / c
                v = lo + (hi - lo) * frac
                return min(max(v, self.min_s), self.max_s)
            cum += c
        return self.max_s

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "mean_s": round(self.total_s / self.count, 6) if self.count else 0,
            "min_s": round(self.min_s, 6) if self.count else 0,
            "max_s": round(self.max_s, 6),
            "p50_s": round(self.quantile(0.50), 6),
            "p99_s": round(self.quantile(0.99), 6),
            "p999_s": round(self.quantile(0.999), 6),
        }

    def prometheus_buckets(self) -> List:
        """(upper_bound_seconds, cumulative_count) pairs at per-octave
        boundaries (every 4th fine bucket), stopping at the first bound
        covering max_s: compact, still a valid cumulative histogram."""
        out = []
        if self.buckets is None:
            return out
        cum = 0
        for i in range(0, _H_BUCKETS, 4):
            cum += sum(self.buckets[i:i + 4])
            ub = _bucket_upper(i + 3)
            out.append((ub, cum))
            if ub >= self.max_s:
                break
        return out


class _TimeCtx:
    __slots__ = ("registry", "name", "t0")

    def __init__(self, registry, name):
        self.registry = registry
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        # locklint: metric-dynamic plumbing: the name was validated by
        # the lint at the .time(name) call site that built this ctx
        self.registry.record_time(self.name, time.time() - self.t0)
        return False


class MetricsRegistry:
    def __init__(self):
        self._lock = locks.named_lock("observability.metrics_registry")
        self._counters: Dict[str, int] = defaultdict(int)
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._timers: Dict[str, Timer] = defaultdict(Timer)

    def inc(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] += int(value)

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register a pull gauge: `fn` is read when a snapshot is."""
        with self._lock:
            self._gauges[name] = fn

    def time(self, name: str):
        # one prebuilt context class: defining one per call would cost
        # a class build on every timed query
        return _TimeCtx(self, name)

    def record_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timers[name].record(float(seconds))

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self, names: Iterable[str]) -> Dict[str, int]:
        """The current value of each named counter (0 if never set)."""
        with self._lock:
            return {n: self._counters.get(n, 0) for n in names}

    def counters_snapshot(self) -> Dict[str, int]:
        """Counters only: the cheap delta-capture surface EXPLAIN ANALYZE
        and the tests use (no gauge evaluation)."""
        with self._lock:
            return dict(self._counters)

    def timer(self, name: str) -> Tuple[int, float]:
        """(count, total seconds) of one timer, (0, 0.0) if never set."""
        with self._lock:
            t = self._timers.get(name)
            return (t.count, t.total_s) if t is not None else (0, 0.0)

    def _read_gauges(self, fns, missing):
        out = {}
        for name, fn in fns:
            try:
                out[name] = float(fn())
            except Exception:
                out[name] = missing
        return out

    def gauges(self) -> Dict[str, float]:
        """Every gauge's current value (NaN where its function raised).
        The functions run outside the registry lock: they may walk
        ledgers that bump counters."""
        with self._lock:
            fns = list(self._gauges.items())
        return self._read_gauges(fns, float("nan"))

    def snapshot(self) -> dict:
        # gauge callables run OUTSIDE the lock: a gauge that touches the
        # registry (a ledger walk bumping a counter) would self-deadlock
        # on this non-reentrant lock
        with self._lock:
            gauge_fns = list(self._gauges.items())
            counters = dict(self._counters)
            timers = {k: t.to_dict() for k, t in self._timers.items()}
        return {
            "counters": counters,
            "gauges": self._read_gauges(gauge_fns, None),
            "timers": timers,
            "ts": time.time(),
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot())

    def to_prometheus(self) -> str:
        """Prometheus text exposition: # HELP / # TYPE lines,
        collision-proof sanitized names, histogram buckets and quantile
        gauges for every timer."""
        with self._lock:
            counters = dict(self._counters)
            gauge_fns = list(self._gauges.items())
            timers = {k: (t.to_dict(), t.prometheus_buckets())
                      for k, t in self._timers.items()}
        gauges = self._read_gauges(gauge_fns, None)
        lines: List[str] = []
        used: Dict[str, str] = {}
        for k, v in sorted(counters.items()):
            base = f"snappy_tpu_{_prom_name(k, used)}_total"
            lines.append(f"# HELP {base} counter {k}")
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{base} {v}")
        for k, v in sorted(gauges.items()):
            if v is None:
                continue
            base = f"snappy_tpu_{_prom_name(k, used)}"
            lines.append(f"# HELP {base} gauge {k}")
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {v}")
        for k, (d, buckets) in sorted(timers.items()):
            base = f"snappy_tpu_{_prom_name(k, used)}_seconds"
            lines.append(f"# HELP {base} timer {k}")
            lines.append(f"# TYPE {base} histogram")
            for ub, cum in buckets:
                lines.append(f'{base}_bucket{{le="{ub:.9g}"}} {cum}')
            lines.append(f'{base}_bucket{{le="+Inf"}} {d["count"]}')
            lines.append(f"{base}_sum {d['total_s']}")
            lines.append(f"{base}_count {d['count']}")
            # quantiles as a sibling gauge family (quantile series inside
            # a histogram family are invalid exposition)
            qbase = f"{base}_q"
            lines.append(f"# TYPE {qbase} gauge")
            for label, key in (("0.5", "p50_s"), ("0.99", "p99_s"),
                               ("0.999", "p999_s")):
                lines.append(f'{qbase}{{quantile="{label}"}} {d[key]}')
        return "\n".join(lines) + "\n"


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def _prom_name(raw: str, used: Dict[str, str]) -> str:
    """Sanitized metric name, collision-proof: two distinct raw names
    that sanitize alike ("a.b" vs "a_b") must not overwrite each other,
    so the later one gets a deterministic crc suffix."""
    s = _sanitize(raw)
    owner = used.get(s)
    if owner is None or owner == raw:
        used[s] = raw
        return s
    s2 = f"{s}_{zlib.crc32(raw.encode('utf-8')) & 0xffff:04x}"
    used[s2] = raw
    return s2


_registry = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _registry
