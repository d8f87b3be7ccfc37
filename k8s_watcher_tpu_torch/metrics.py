"""The metrics the probe agent records: counters, gauges and latency histograms.

A thread-safe subset of the JAX package's ``metrics.MetricsRegistry`` with the
same names and meanings: ``counter(name).inc``, ``gauge(name).set/clear`` and
``histogram(name).record`` on the same log-spaced buckets (40 per decade,
10 us .. 100 s). Labels, rates and exposition come with the slice that ports
the status server.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional


def _log_buckets(lo: float, hi: float, per_decade: int = 40) -> List[float]:
    n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
    return [lo * 10 ** (i / per_decade) for i in range(n)]


class Counter:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._count


class Gauge:
    """Last value wins; ``clear`` withdraws the reading."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._set = False

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._set = True

    def clear(self) -> None:
        with self._lock:
            self._value = 0.0
            self._set = False

    def read(self) -> Optional[float]:
        """Value, or None when cleared or never set."""
        with self._lock:
            return self._value if self._set else None


class Histogram:
    """Log-bucketed latency histogram (seconds)."""

    def __init__(self, name: str, lo: float = 1e-5, hi: float = 100.0):
        self.name = name
        self._bounds = _log_buckets(lo, hi)
        self._counts = [0] * (len(self._bounds) + 1)
        self._lock = threading.Lock()
        self._n = 0

    def record(self, seconds: float) -> None:
        idx = bisect.bisect_left(self._bounds, seconds)
        with self._lock:
            self._counts[idx] += 1
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name)
            return self._histograms[name]
