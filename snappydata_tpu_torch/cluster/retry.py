"""Retry policies for the cluster plane (port of
snappydata_tpu/cluster/retry.py): exponential backoff with (seeded)
jitter, and a per-peer circuit breaker.

The reference's driver retries failover with bounded attempts against the
locator's member view (jdbc failover, cluster/README-thrift.md:20-35);
its membership layer stops hammering a departed peer until the view says
it rejoined. Here the same two ideas as explicit, testable objects:

- ExponentialBackoff: delay(attempt) grows base * multiplier^attempt up
  to a cap, scaled down by up to `jitter` fraction with a SEEDED rng so
  chaos schedules replay deterministically (thundering-herd avoidance
  without losing reproducibility).
- CircuitBreaker: after `failure_threshold` consecutive failures the
  breaker OPENs and allow() answers False (callers skip the peer
  instead of eating a connect timeout); after `reset_timeout_s` it
  half-opens, letting exactly one probe through — success re-closes it,
  failure re-opens it. Transitions to open bump `breaker_open`.
"""

from __future__ import annotations

import random
import threading
from snappydata_tpu_torch.utils import locks
import time
from typing import Optional


class ExponentialBackoff:
    def __init__(self, base_s: float = 0.05, max_s: float = 2.0,
                 multiplier: float = 2.0, jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.base_s = base_s
        self.max_s = max_s
        self.multiplier = multiplier
        self.jitter = min(max(jitter, 0.0), 1.0)
        self._rng = rng or random.Random(0)
        self._lock = locks.named_lock("retry.backoff_rng")

    def delay(self, attempt: int) -> float:
        """Delay before retry number `attempt` (0-based), jittered
        downward so concurrent retriers de-synchronize."""
        d = min(self.max_s, self.base_s * (self.multiplier ** attempt))
        with self._lock:   # Random() is not thread-safe for our replay
            scale = 1.0 - self.jitter * self._rng.random()
        return d * scale

    def sleep(self, attempt: int, metric: Optional[str] = None) -> float:
        d = self.delay(attempt)
        if metric is not None:
            from snappydata_tpu_torch.observability.metrics import global_registry

            # locklint: metric-dynamic callers pass a declared timer
            # name ("failover_backoff"); the .time()-site lint covers
            # literals, this pass-through keeps the API generic
            global_registry().record_time(metric, d)
        time.sleep(d)
        return d


class CircuitBreaker:
    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 5.0, clock=time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = locks.named_lock("retry.breaker")
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller attempt the peer right now? OPEN answers False
        until the reset timeout elapses, then exactly one caller gets a
        half-open probe slot."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._state = self.HALF_OPEN
                    self._half_open_at = self._clock()
                    return True
                return False
            # HALF_OPEN: one probe is in flight — hold others off. But a
            # probe whose caller never recorded an outcome (an exception
            # path that re-raises, a crashed thread) must not wedge the
            # breaker shut forever: grant a fresh probe slot once the
            # outstanding one has aged past the reset timeout.
            if self._clock() - self._half_open_at >= self.reset_timeout_s:
                self._half_open_at = self._clock()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            trip = self._state == self.HALF_OPEN or \
                self._failures >= self.failure_threshold
            if trip and self._state != self.OPEN:
                self._state = self.OPEN
                self._opened_at = self._clock()
                opened = True
            elif trip:
                self._opened_at = self._clock()
                opened = False
            else:
                opened = False
        if opened:
            from snappydata_tpu_torch.observability.metrics import global_registry

            global_registry().inc("breaker_open")
