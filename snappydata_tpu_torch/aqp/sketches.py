"""Probabilistic sketches: Count-Min and TopK (space-saving).

Re-provides the clearspring utilities the reference vendors for its AQP
TopK support (core/src/main/java/io/snappydata/util/com/clearspring —
CountMinSketch, StreamSummary; TopK trait core/.../execution/TopK.scala:23;
SnappyContextFunctions.createTopK/queryTopK :42-62). Vectorized numpy:
updates are O(rows × depth) array ops, so sketch maintenance keeps pace
with ingest.
"""

from __future__ import annotations

import math
import threading
from snappydata_tpu_torch.utils import locks
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from snappydata_tpu_torch.parallel.hashing import murmur3_hash_np


class CountMinSketch:
    """Count-Min with conservative point queries (min over rows)."""

    def __init__(self, depth: int = 5, width: int = 2048, seed: int = 7):
        self.depth = depth
        self.width = width
        self.seeds = np.arange(seed, seed + depth, dtype=np.uint32)
        self.table = np.zeros((depth, width), dtype=np.int64)
        self.total = 0

    def _indices(self, keys: np.ndarray) -> np.ndarray:
        """[depth, n] bucket indices."""
        out = np.empty((self.depth, len(keys)), dtype=np.int64)
        for d in range(self.depth):
            h = murmur3_hash_np(np.asarray(keys), seed=self.seeds[d])
            out[d] = (h.astype(np.int64) % self.width + self.width) \
                % self.width
        return out

    def add(self, keys: np.ndarray, counts: Optional[np.ndarray] = None
            ) -> None:
        keys = np.asarray(keys)
        counts = np.ones(len(keys), dtype=np.int64) if counts is None \
            else np.asarray(counts, dtype=np.int64)
        idx = self._indices(keys)
        for d in range(self.depth):
            np.add.at(self.table[d], idx[d], counts)
        self.total += int(counts.sum())

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        idx = self._indices(keys)
        ests = np.stack([self.table[d][idx[d]] for d in range(self.depth)])
        return ests.min(axis=0)

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        assert self.table.shape == other.table.shape
        out = CountMinSketch(self.depth, self.width)
        out.seeds = self.seeds
        out.table = self.table + other.table
        out.total = self.total + other.total
        return out


class TimeDecayedTopK:
    """Time-axis TopK (ref: the reference pairs TopK with Hokusai for its
    time dimension; TopK trait core/.../execution/TopK.scala:23 exposes
    start/end-time queries). One CMS + space-saving summary per time
    bucket; memory is bounded by evicting the oldest buckets past
    `max_buckets`. (Hokusai's width-halving ladder — degrading old
    buckets instead of dropping them — is a later refinement.)"""

    def __init__(self, k: int = 50, bucket_seconds: int = 60,
                 max_buckets: int = 64, cms_width: int = 2048):
        self.k = k
        self.bucket_seconds = bucket_seconds
        self.max_buckets = max_buckets
        self.cms_width = cms_width
        self._buckets: Dict[int, TopKSummary] = {}
        self._lock = locks.named_lock("aqp.decayed_topk")

    def _bucket_of(self, ts: float) -> int:
        return int(ts // self.bucket_seconds)

    def observe(self, keys: Sequence, timestamps: Sequence,
                counts: Optional[Sequence] = None) -> None:
        keys = np.asarray(keys)
        ts = np.asarray(timestamps, dtype=np.float64)
        cnt = np.ones(len(keys), dtype=np.int64) if counts is None \
            else np.asarray(counts, dtype=np.int64)
        buckets = (ts // self.bucket_seconds).astype(np.int64)
        with self._lock:
            for b in np.unique(buckets):
                mask = buckets == b
                summ = self._buckets.get(int(b))
                if summ is None:
                    summ = TopKSummary(k=self.k, cms_width=self.cms_width)
                    self._buckets[int(b)] = summ
                summ.observe(keys[mask], cnt[mask])
            # bound memory: drop buckets beyond max_buckets (oldest first)
            if len(self._buckets) > self.max_buckets:
                for b in sorted(self._buckets)[:-self.max_buckets]:
                    del self._buckets[b]

    def top(self, n: Optional[int] = None, start_time: Optional[float] = None,
            end_time: Optional[float] = None) -> List[Tuple[object, int]]:
        """TopK over a time range (ref queryTopK(name, start, end))."""
        n = n or self.k
        lo = self._bucket_of(start_time) if start_time is not None else None
        hi = self._bucket_of(end_time) if end_time is not None else None
        merged: Dict = {}
        with self._lock:
            for b, summ in self._buckets.items():
                if lo is not None and b < lo:
                    continue
                if hi is not None and b > hi:
                    continue
                for key, c in summ.top(summ.k * 4):
                    merged[key] = merged.get(key, 0) + c
        return sorted(merged.items(), key=lambda kv: -kv[1])[:n]


class TopKSummary:
    """Space-saving top-K over a key column, CMS-backed counts for keys
    evicted from the monitored set (the reference pairs StreamSummary with
    CountMinSketch the same way)."""

    def __init__(self, k: int = 50, cms_depth: int = 5, cms_width: int = 2048):
        self.k = k
        self.cms_width = cms_width
        self.cms = CountMinSketch(cms_depth, cms_width)
        self._counts: Dict = {}
        self._lock = locks.named_lock("aqp.topk")

    def observe(self, keys: Sequence, counts: Optional[Sequence] = None
                ) -> None:
        keys_arr = np.asarray(keys)
        cnt = np.ones(len(keys_arr), dtype=np.int64) if counts is None \
            else np.asarray(counts, dtype=np.int64)
        numeric = keys_arr if np.issubdtype(keys_arr.dtype, np.number) \
            else murmur3_hash_np(
                np.array([hash(x) & 0x7FFFFFFF for x in keys_arr.tolist()],
                         dtype=np.int32)).astype(np.int64)
        self.cms.add(np.asarray(numeric, dtype=np.int64), cnt)
        with self._lock:
            for key, c in zip(keys_arr.tolist(), cnt.tolist()):
                if key in self._counts:
                    self._counts[key] += c
                elif len(self._counts) < self.k * 4:
                    self._counts[key] = c
                else:
                    # space-saving eviction: displace the current minimum,
                    # inheriting its count (overestimate, never under)
                    mk = min(self._counts, key=self._counts.get)
                    mv = self._counts.pop(mk)
                    self._counts[key] = mv + c

    def top(self, n: Optional[int] = None) -> List[Tuple[object, int]]:
        n = n or self.k
        with self._lock:
            items = sorted(self._counts.items(), key=lambda kv: -kv[1])
        return items[:n]
