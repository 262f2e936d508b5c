"""Process-wide counters.

The counter subset of snappydata_tpu/observability/metrics.py: the engine
counts plan-cache verdicts, host fallbacks, batch skipping, compressed-
domain fallbacks and the aggregate lanes a plan took, under the same names
as the reference so the two packages' evidence lines up.
"""

from __future__ import annotations

import threading
from typing import Dict


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


_registry = Registry()


def global_registry() -> Registry:
    return _registry
