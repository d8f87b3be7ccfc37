"""The metrics every plane of the port records, and their exposition.

The JAX package's ``metrics.MetricsRegistry`` with the same names, meanings
and output: counters with a one-minute rate, gauges
(``set``/``set_max``/``clear``), latency histograms on the same log-spaced
buckets (40 per decade, 10 us .. 100 s), the JSON ``dump()``, the Prometheus
text exposition ``prometheus_text()`` and the raw ``sample()`` the SLO plane
keeps in its ring. Every metric is a label family: ``labels(node="a")``
returns the child series of that label set (the serving plane's per-codec
counters, the health plane's per-node gauges, the SLO plane's per-objective
burn rates), rendered as the JAX package renders them. ``fold_sample`` folds
a reader process's exported ``sample()`` under a ``process`` label, and
``hottest_series`` ranks what was folded for one process.
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
#: (codec, node and objective names), never identifiers; a family may raise
#: its own ``max_label_sets``
MAX_LABEL_SETS = 64
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    """One label set, validated: sorted ``(name, value)`` pairs (the child's
    identity and its render order)."""
    if not labels:
        raise ValueError("labels() requires at least one label")
    out = []
    for name in sorted(labels):
        if not _LABEL_NAME_RE.match(name):
            raise ValueError(f"invalid metric label name {name!r} (want [a-zA-Z_][a-zA-Z0-9_]*)")
        value = labels[name]
        if not isinstance(value, str):
            if not isinstance(value, (int, float, bool)):
                raise ValueError(f"metric label {name}={value!r}: values must be str/int/float/bool")
            value = str(value)
        if len(value) > 128:
            raise ValueError(f"metric label {name}: value longer than 128 chars (unbounded label value?)")
        out.append((name, value))
    return tuple(out)


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_labels(labelset: Tuple[Tuple[str, str], ...]) -> str:
    """``(("codec", "json"),)`` -> ``{codec="json"}`` (Prometheus escaping)."""
    if not labelset:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labelset) + "}"


class _LabelFamily:
    """Labels for a metric: the registered metric is the family and the
    unlabelled series (it keeps the cross-label total where one is kept);
    ``labels(...)`` gets or creates the child of one label set. The
    ``max_label_sets``-th new label set raises instead of growing."""

    max_label_sets = MAX_LABEL_SETS

    def _init_labels(self) -> None:
        self.labelset: Tuple[Tuple[str, str], ...] = ()
        self._children: Dict[Tuple, "_LabelFamily"] = {}
        self._labels_lock = threading.Lock()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **labels):
        key = _label_key(labels)
        with self._labels_lock:
            child = self._children.get(key)
            if child is None:
                if self.labelset:
                    raise ValueError(
                        f"labels() on an already-labeled series {self.name}{render_labels(self.labelset)}")
                if len(self._children) >= self.max_label_sets:
                    raise ValueError(
                        f"metric {self.name}: label-set cardinality bound ({self.max_label_sets}) exceeded "
                        f"registering {render_labels(key)} — label values must be bounded dimensions, "
                        f"not identifiers")
                child = self._make_child()
                child.labelset = key
                self._children[key] = child
            return child

    def children(self) -> List["_LabelFamily"]:
        """Child series sorted by label set (the exposition order)."""
        with self._labels_lock:
            return [self._children[k] for k in sorted(self._children)]


class Counter(_LabelFamily):
    """Monotonic counter with a one-minute rate kept in per-second buckets
    (O(1) per ``inc``, O(window) memory)."""

    _BUCKETS = 62  # 60 one-second buckets, +2 for edge churn

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        # (whole_second, count) per bucket, oldest first
        self._window: collections.deque = collections.deque(maxlen=self._BUCKETS)
        self._init_labels()

    def _make_child(self) -> "Counter":
        return Counter(self.name)

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


class Gauge(_LabelFamily):
    """A point-in-time reading: last value wins; ``clear`` withdraws it."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._set = False
        self._init_labels()

    def _make_child(self) -> "Gauge":
        return Gauge(self.name)

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


class Histogram(_LabelFamily):
    """Log-bucketed latency histogram (seconds); children share the
    parent's bucket layout."""

    def __init__(self, name: str, lo: float = 1e-5, hi: float = 100.0):
        self.name = name
        self._lo, self._hi = lo, hi
        self._bounds = _log_buckets(lo, hi)
        self._counts = [0] * (len(self._bounds) + 1)
        self._lock = threading.Lock()
        self._n = 0
        self._sum = 0.0
        self._max = 0.0
        self._init_labels()

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self._lo, self._hi)

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

    def ingest_bucket_deltas(self, items, n_delta: int, sum_delta: float) -> None:
        """Add per-bucket increments differenced from another histogram's
        cumulative sample (``_diff_cum_pairs``): ``(upper_bound_seconds,
        count)`` items, each landing in the bucket whose upper edge matches
        (both sides use the same bucket bounds)."""
        if not items and n_delta <= 0:
            return
        placed = []
        max_hint = 0.0
        for bound, count in items:
            if count <= 0:
                continue
            b = float(bound)
            idx = len(self._counts) - 1 if math.isinf(b) else bisect.bisect_left(self._bounds, b)
            placed.append((min(idx, len(self._counts) - 1), count))
            if not math.isinf(b) and b > max_hint:
                max_hint = b
        with self._lock:
            for idx, count in placed:
                self._counts[idx] += count
            self._n += max(0, n_delta)
            self._sum += sum_delta
            if max_hint > self._max:
                self._max = max_hint


def _diff_cum_pairs(pairs, total, sum_value, state):
    """Difference one cumulative bucket sample against the previous one
    (``state``, caller-owned, reset per worker spawn) into per-bucket
    increments: ``(items, n_delta, sum_delta)``, updating ``state``. A total
    below the previous one (a fresh incarnation reporting from zero) resets
    the baseline, so nothing is counted twice or folded backwards."""
    prev_cum = state.get("cum") or {}
    prev_total = int(state.get("total") or 0)
    prev_sum = float(state.get("sum") or 0.0)
    if total < prev_total:
        prev_cum, prev_total, prev_sum = {}, 0, 0.0
    items = []
    cum_now = {}
    last_new = 0
    for bound, cum in pairs:
        b = float(bound)
        cum_now[b] = cum
        new_below = cum - prev_cum.get(b, 0)
        inc = new_below - last_new
        last_new = new_below
        if inc > 0:
            items.append((b, inc))
    state["cum"] = cum_now
    state["total"] = int(total)
    state["sum"] = float(sum_value)
    return items, int(total) - prev_total, float(sum_value) - prev_sum


class MetricsRegistry:
    """Named counters, gauges and histograms of one process. Scrapes render
    from sorted item lists cached until the next new registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # None = stale: rebuilt on the next scrape
        self._sorted_counters: Optional[List[Tuple[str, Counter]]] = None
        self._sorted_gauges: Optional[List[Tuple[str, Gauge]]] = None
        self._sorted_histograms: Optional[List[Tuple[str, Histogram]]] = None

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
                self._sorted_counters = None
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
                self._sorted_gauges = None
            return self._gauges[name]

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name)
                self._sorted_histograms = None
            return self._histograms[name]

    def peek_histogram(self, name: str) -> Optional[Histogram]:
        """The histogram if it is registered, else None: read-only consumers
        (the health plane's stage sweep) must not mint empty series."""
        with self._lock:
            return self._histograms.get(name)

    def _sorted_items(self):
        with self._lock:
            if self._sorted_counters is None:
                self._sorted_counters = sorted(self._counters.items())
            if self._sorted_gauges is None:
                self._sorted_gauges = sorted(self._gauges.items())
            if self._sorted_histograms is None:
                self._sorted_histograms = sorted(self._histograms.items())
            return self._sorted_counters, self._sorted_gauges, self._sorted_histograms

    @staticmethod
    def _emit_histogram(lines: List[str], metric: str, h: Histogram, labelset) -> None:
        # ``le`` renders last in the label set
        pairs, total, total_sum = h.downsampled_buckets_with_totals()
        prefix_labels = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labelset)
        sep = "," if prefix_labels else ""
        for bound, cum in pairs:
            le = "+Inf" if bound == float("inf") else f"{bound:.3g}"
            lines.append(f'{metric}_bucket{{{prefix_labels}{sep}le="{le}"}} {cum}')
        labels = render_labels(labelset)
        lines.append(f"{metric}_sum{labels} {total_sum}")
        lines.append(f"{metric}_count{labels} {total}")

    def prometheus_text(self, prefix: str = "k8s_watcher_") -> str:
        """Prometheus text exposition (v0.0.4): counters as ``<name>_total``,
        gauges only while set, histograms as ``_bucket{le=...}``/``_sum``/
        ``_count`` in seconds, every family sorted by name and its children
        by label set. A labelled family's parent renders only when it
        carries data, never as a misleading 0."""
        counters, gauges, histograms = self._sorted_items()
        lines: List[str] = []
        for name, c in counters:
            metric = f"{prefix}{name}"
            lines.append(f"# TYPE {metric}_total counter")
            children = c.children()
            if not children or c.value > 0:
                lines.append(f"{metric}_total {c.value}")
            for child in children:
                lines.append(f"{metric}_total{render_labels(child.labelset)} {child.value}")
        for name, g in gauges:
            metric = f"{prefix}{name}"
            reading = g.read()
            child_lines = [(child.labelset, r) for child in g.children() if (r := child.read()) is not None]
            if reading is None and not child_lines:
                continue  # a never-set or cleared gauge would scrape as a misleading 0
            lines.append(f"# TYPE {metric} gauge")
            if reading is not None:
                lines.append(f"{metric} {reading:g}")
            for labelset, child_reading in child_lines:
                lines.append(f"{metric}{render_labels(labelset)} {child_reading:g}")
        for name, h in histograms:
            metric = f"{prefix}{name}" if name.endswith("_seconds") else f"{prefix}{name}_seconds"
            children = h.children()
            lines.append(f"# TYPE {metric} histogram")
            if not children or h.count > 0:
                self._emit_histogram(lines, metric, h, ())
            for child in children:
                self._emit_histogram(lines, metric, child, child.labelset)
        return "\n".join(lines) + "\n"

    def dump(self) -> Dict[str, Dict]:
        """The JSON snapshot: counters with their one-minute rate, histogram
        summaries, the gauges that are set, and each family's children under
        ``series`` with their labels as data."""
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
            entry = h.summary()
            children = h.children()
            if children:
                entry["series"] = [{"labels": dict(ch.labelset), **ch.summary()} for ch in children]
            out[name] = entry
        for name, g in gauges:
            reading = g.read()
            children = g.children()
            if reading is None and not children:
                continue
            entry: Dict = {}
            if reading is not None:
                entry["value"] = reading
            if children:
                entry["series"] = [{"labels": dict(ch.labelset), "value": r}
                                   for ch in children if (r := ch.read()) is not None]
            if entry:
                out[name] = entry
        return out

    def sample(self, *, include_series: bool = False) -> Dict[str, Dict]:
        """One raw sample of every registered metric (the SLO plane's ring
        entry): counters -> the unlabelled total; gauges -> the maximum over
        the parent and every set child (staleness objectives gate the worst
        member); histograms -> ``(cumulative_pairs, total, sum)`` for window
        differencing. ``include_series`` adds the counter and gauge children
        as ``[[[name, value], ...], reading]`` rows under ``series``."""
        counters, gauges, histograms = self._sorted_items()
        out: Dict[str, Dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, c in counters:
            out["counters"][name] = c.value
        for name, g in gauges:
            readings = [r for r in (g.read(), *(ch.read() for ch in g.children())) if r is not None]
            if readings:
                out["gauges"][name] = max(readings)
        for name, h in histograms:
            out["histograms"][name] = h.downsampled_buckets_with_totals()
        if include_series:
            c_series = {name: rows for name, c in counters
                        if (rows := [[[list(p) for p in ch.labelset], ch.value] for ch in c.children()])}
            g_series = {name: rows for name, g in gauges
                        if (rows := [[[list(p) for p in ch.labelset], r]
                                     for ch in g.children() if (r := ch.read()) is not None])}
            if c_series or g_series:
                out["series"] = {"counters": c_series, "gauges": g_series}
        return out

    def fold_sample(self, sample: Dict, *, process: str, watermarks: Dict, rollup_exclude=frozenset()) -> None:
        """Fold one worker registry ``sample(include_series=True)`` into this
        registry under a ``process`` label. ``watermarks`` is caller-owned
        per-spawn state (a fresh dict after each respawn), against which the
        counter and histogram totals are differenced.

        - counters: the delta goes to ``<name>{process=...}`` (registered
          even at zero) and to the unlabelled total, unless the name is in
          ``rollup_exclude`` (a total the parent already folds another way);
        - gauges: set on the process child; the unlabelled gauge is the
          parent's own;
        - histograms: bucket deltas into the process child and (same
          ``rollup_exclude`` rule) the unlabelled histogram;
        - label children (``sample()['series']``): their label set gains
          ``process``, with no unlabelled rollup.
        """
        wm_counters = watermarks.setdefault("counters", {})
        wm_series = watermarks.setdefault("series", {})
        wm_hist = watermarks.setdefault("histograms", {})
        for name, total in (sample.get("counters") or {}).items():
            family = self.counter(name)
            child = family.labels(process=process)
            delta = int(total) - wm_counters.get(name, 0)
            wm_counters[name] = int(total)
            if delta > 0:
                child.inc(delta)
                if name not in rollup_exclude:
                    family.inc(delta)
        for name, value in (sample.get("gauges") or {}).items():
            self.gauge(name).labels(process=process).set(value)
        for name, triple in (sample.get("histograms") or {}).items():
            pairs, total, sum_value = triple
            family = self.histogram(name)
            child = family.labels(process=process)
            items, n_delta, sum_delta = _diff_cum_pairs(pairs, total, sum_value, wm_hist.setdefault(name, {}))
            child.ingest_bucket_deltas(items, n_delta, sum_delta)
            if name not in rollup_exclude:
                family.ingest_bucket_deltas(items, n_delta, sum_delta)
        series = sample.get("series") or {}
        for name, rows in (series.get("counters") or {}).items():
            family = self.counter(name)
            for pairs, total in rows:
                labels = {str(k): v for k, v in pairs}
                labels["process"] = process
                key = (name,) + tuple(sorted((str(k), str(v)) for k, v in pairs))
                child = family.labels(**labels)
                delta = int(total) - wm_series.get(key, 0)
                wm_series[key] = int(total)
                if delta > 0:
                    child.inc(delta)
        for name, rows in (series.get("gauges") or {}).items():
            family = self.gauge(name)
            for pairs, value in rows:
                labels = {str(k): v for k, v in pairs}
                labels["process"] = process
                family.labels(**labels).set(value)

    def hottest_series(self, process: str, n: int = 5) -> List[Dict]:
        """The top ``n`` counter series folded for one ``process`` label
        value, by one-minute rate and then total (``/debug/processes``)."""
        counters, _gauges, _histograms = self._sorted_items()
        rows = []
        for name, c in counters:
            for child in c.children():
                labels = dict(child.labelset)
                if labels.get("process") != process:
                    continue
                rest = tuple(p for p in child.labelset if p[0] != "process")
                rows.append({
                    "series": name + render_labels(rest),
                    "total": child.value,
                    "per_minute": child.rate_per_minute(),
                })
        rows.sort(key=lambda r: (-r["per_minute"], -r["total"], r["series"]))
        return rows[:n]
