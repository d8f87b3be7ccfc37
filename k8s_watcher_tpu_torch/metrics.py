"""The metrics the probe agent, the dispatcher and the actuator record, and
their exposition.

The JAX package's ``metrics.MetricsRegistry`` with the same names, meanings
and output: counters with a one-minute rate, gauges
(``set``/``set_max``/``clear``), latency histograms on the same log-spaced
buckets (40 per decade, 10 us .. 100 s), the JSON ``dump()`` and the
Prometheus text exposition ``prometheus_text()``. Of the labelled series only
counter children are carried (``counter.labels(codec="json")``: the serving
plane's per-codec snapshot-cache counters), rendered as the JAX package
renders them.
"""

from __future__ import annotations

import bisect
import collections
import math
import re
import threading
import time
from typing import Dict, List, Optional, Tuple


def _log_buckets(lo: float, hi: float, per_decade: int = 40) -> List[float]:
    # a reported quantile is its bucket's upper edge: 40/decade overstates
    # the truth by at most 10^(1/40)-1 ~= 6%
    n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
    return [lo * 10 ** (i / per_decade) for i in range(n)]


#: per-family cap on distinct label sets: labels are for bounded dimensions
#: (codec names), never identifiers
MAX_LABEL_SETS = 64
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def render_labels(labelset: Tuple[Tuple[str, str], ...]) -> str:
    """``(("codec", "json"),)`` -> ``{codec="json"}`` (Prometheus escaping)."""
    def esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in labelset) + "}" if labelset else ""


class Counter:
    """Monotonic counter with a one-minute rate kept in per-second buckets
    (O(1) per ``inc``, O(window) memory). ``labels(codec="json")`` returns the
    child counter of that label set; the parent keeps the cross-label total."""

    _BUCKETS = 62  # 60 one-second buckets, +2 for edge churn

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        # (whole_second, count) per bucket, oldest first
        self._window: collections.deque = collections.deque(maxlen=self._BUCKETS)
        self.labelset: Tuple[Tuple[str, str], ...] = ()
        self._children: Dict[Tuple[Tuple[str, str], ...], "Counter"] = {}

    def labels(self, **labels) -> "Counter":
        if not labels:
            raise ValueError("labels() requires at least one label")
        key = []
        for name in sorted(labels):
            value = labels[name]
            if not _LABEL_NAME_RE.match(name):
                raise ValueError(f"invalid metric label name {name!r}")
            if not isinstance(value, (str, int, float, bool)) or len(str(value)) > 128:
                raise ValueError(f"metric label {name}={value!r}: want a short str/int/float/bool")
            key.append((name, str(value)))
        key = tuple(key)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.labelset:
                    raise ValueError(f"labels() on an already-labelled series {self.name}{render_labels(self.labelset)}")
                if len(self._children) >= MAX_LABEL_SETS:
                    raise ValueError(f"metric {self.name}: more than {MAX_LABEL_SETS} label sets")
                child = Counter(self.name)
                child.labelset = key
                self._children[key] = child
            return child

    def children(self) -> List["Counter"]:
        """Child series sorted by label set (the exposition order)."""
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]

    def inc(self, n: int = 1) -> None:
        sec = int(time.monotonic())
        with self._lock:
            self._count += n
            window = self._window
            if window and window[-1][0] == sec:
                window[-1] = (sec, window[-1][1] + n)
            else:
                window.append((sec, n))

    @property
    def value(self) -> int:
        with self._lock:
            return self._count

    def rate_per_minute(self) -> float:
        cutoff = int(time.monotonic()) - 60
        with self._lock:
            return float(sum(c for sec, c in self._window if sec > cutoff))


class Gauge:
    """A point-in-time reading: last value wins; ``clear`` withdraws it."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._set = False

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._set = True

    def set_max(self, value: float) -> None:
        """Raise the reading to ``value`` if it is a new high-water mark, in
        one lock hold, so concurrent reporters cannot regress the mark."""
        value = float(value)
        with self._lock:
            if not self._set or value > self._value:
                self._value = value
                self._set = True

    def clear(self) -> None:
        """Withdraw the reading: a gauge whose source failed must disappear
        from scrapes, not freeze at its last healthy value."""
        with self._lock:
            self._value = 0.0
            self._set = False

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def read(self) -> Optional[float]:
        """Value, or None when cleared or never set, in one lock hold."""
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
        self._sum = 0.0
        self._max = 0.0

    def record(self, seconds: float) -> None:
        idx = bisect.bisect_left(self._bounds, seconds)
        with self._lock:
            self._counts[idx] += 1
            self._n += 1
            self._sum += seconds
            if seconds > self._max:
                self._max = seconds

    def observe_since(self, t0: float) -> None:
        """Record ``now - t0`` (monotonic seconds)."""
        self.record(time.monotonic() - t0)

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def quantile(self, q: float) -> Optional[float]:
        """Approximate quantile in seconds (None if empty): its bucket's upper edge."""
        with self._lock:
            if self._n == 0:
                return None
            target = q * self._n
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target:
                    if i >= len(self._bounds):
                        return self._max
                    return self._bounds[i]
            return self._max

    def summary(self) -> Dict[str, object]:
        with self._lock:
            n, total, mx = self._n, self._sum, self._max
        if n == 0:
            return {"count": 0}
        return {
            "count": n,
            "mean_ms": 1e3 * total / n,
            "p50_ms": 1e3 * (self.quantile(0.5) or 0.0),
            "p90_ms": 1e3 * (self.quantile(0.9) or 0.0),
            "p99_ms": 1e3 * (self.quantile(0.99) or 0.0),
            "max_ms": 1e3 * mx,
            "buckets_le_s": [
                [bound if bound != float("inf") else "+Inf", cum]
                for bound, cum in self.downsampled_buckets()
            ],
        }

    def buckets(self) -> Tuple[List[Tuple[float, int]], int, float]:
        """``(pairs, total, sum)``: cumulative ``(upper_bound_seconds, count)``
        pairs, Prometheus-style, the last one ``(inf, total)``."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._n, self._sum
        out, cum = [], 0
        for bound, c in zip(self._bounds, counts):
            cum += c
            out.append((bound, cum))
        out.append((float("inf"), total))
        return out, total, s

    def downsampled_buckets(self, per_decade_factor: float = 3.16) -> List[Tuple[float, int]]:
        """Cumulative pairs thinned to ~2 bounds per decade (the exposition
        shape); the last pair is always ``(inf, total)``."""
        return self.downsampled_buckets_with_totals(per_decade_factor)[0]

    def downsampled_buckets_with_totals(self, per_decade_factor: float = 3.16):
        """``(pairs, total, sum)`` from one read of the counts, so a record
        landing meanwhile cannot make the count disagree with ``+Inf``."""
        buckets, total, s = self.buckets()
        out = []
        last_bound = 0.0
        for i, (bound, cum) in enumerate(buckets):
            is_last = i == len(buckets) - 1
            if not is_last and bound < last_bound * per_decade_factor:
                continue
            last_bound = bound
            out.append((bound, cum))
        return out, total, s


class MetricsRegistry:
    """Named counters, gauges and histograms of one process."""

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

    def _sorted_items(self):
        with self._lock:
            return (sorted(self._counters.items()), sorted(self._gauges.items()),
                    sorted(self._histograms.items()))

    def prometheus_text(self, prefix: str = "k8s_watcher_") -> str:
        """Prometheus text exposition (v0.0.4): counters as ``<name>_total``,
        gauges only while set, histograms as ``_bucket{le=...}``/``_sum``/
        ``_count`` in seconds, every family sorted by name."""
        counters, gauges, histograms = self._sorted_items()
        lines: List[str] = []
        for name, c in counters:
            metric = f"{prefix}{name}"
            lines.append(f"# TYPE {metric}_total counter")
            children = c.children()
            # a labelled family's parent renders only when it carries the
            # cross-label total, never as a misleading 0
            if not children or c.value > 0:
                lines.append(f"{metric}_total {c.value}")
            for child in children:
                lines.append(f"{metric}_total{render_labels(child.labelset)} {child.value}")
        for name, g in gauges:
            reading = g.read()
            if reading is None:
                continue  # a never-set or cleared gauge would scrape as a misleading 0
            metric = f"{prefix}{name}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {reading:g}")
        for name, h in histograms:
            metric = f"{prefix}{name}" if name.endswith("_seconds") else f"{prefix}{name}_seconds"
            lines.append(f"# TYPE {metric} histogram")
            pairs, total, total_sum = h.downsampled_buckets_with_totals()
            for bound, cum in pairs:
                le = "+Inf" if bound == float("inf") else f"{bound:.3g}"
                lines.append(f'{metric}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{metric}_sum {total_sum}")
            lines.append(f"{metric}_count {total}")
        return "\n".join(lines) + "\n"

    def dump(self) -> Dict[str, Dict]:
        """The JSON snapshot: counters with their one-minute rate, histogram
        summaries, and the gauges that are set."""
        counters, gauges, histograms = self._sorted_items()
        out: Dict[str, Dict] = {}
        for name, c in counters:
            out[name] = {"count": c.value, "per_minute": c.rate_per_minute()}
            children = c.children()
            if children:
                out[name]["series"] = [
                    {"labels": dict(ch.labelset), "count": ch.value, "per_minute": ch.rate_per_minute()}
                    for ch in children
                ]
        for name, h in histograms:
            out[name] = h.summary()
        for name, g in gauges:
            reading = g.read()
            if reading is not None:
                out[name] = {"value": reading}
        return out
