"""SLO engine: error budgets and burn rates over the metrics registry (the
JAX package's ``slo/engine.py``).

It turns the planes' telemetry into an operable verdict, in-process:

- A **timeseries ring** samples every registered metric on a tick
  (``MetricsRegistry.sample()``: counters as raw totals, gauges as the
  maximum over their label children, histograms as cumulative bucket
  pairs). Bounded: ``slo.ring_size`` ticks, sized by the schema to cover
  the slow window. Windowed evaluation is arithmetic over two ring entries
  (counters and histograms difference; gauges scan the window), with no
  instrumentation on any hot path.
- **Objectives** (``slo.objectives[]``, three kinds, see
  ``config.SloObjective``): request-based latency (the fraction of
  histogram observations over a threshold), state (the fraction of ticks a
  gauge exceeded a bound), and success ratio (a counter pair).
- **Two-window burn rate**: the error rate over a fast and a slow window,
  each divided by the error budget rate ``1 - target``. A breach needs
  both above ``slo.burn_threshold``: fast-only is a blip, slow-only is old
  news.
- **Exports**: ``slo_burn_rate{objective=,window=fast|slow}`` and
  ``slo_breaching{objective=}`` gauges, the detail at ``GET /debug/slo``,
  and a ``health()`` verdict folded into the /healthz body: degraded,
  never the liveness verdict (a restart refunds no error budget).

No data is no breach: a window with zero observations or ticks has error
rate 0 (the staleness objectives gate gauges that age, not counters).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


def _window_error_quantile(
    base_hist, cur_hist, max_seconds: float, quantile: float
) -> Tuple[float, Optional[float], int]:
    """``(error_rate, windowed_quantile_seconds, observations)`` for one
    histogram objective over a window: cumulative bucket pairs at the
    window's start and end, differenced per bound. The error rate is the
    fraction of the window's observations ABOVE the smallest bucket
    bound >= ``max_seconds`` — exact at bucket resolution (the bucket
    edge overstates an observation's latency by at most one bucket
    width, so the error rate can only under-read by observations inside
    that one bucket)."""
    pairs, total, _ = cur_hist
    base_pairs, base_total, _ = base_hist if base_hist is not None else ([], 0, 0.0)
    base_by_bound = {bound: cum for bound, cum in base_pairs}
    observations = total - base_total
    if observations <= 0:
        return 0.0, None, 0
    good = None  # window-cumulative count at the threshold bucket
    q_value: Optional[float] = None
    q_target = quantile * observations
    for bound, cum in pairs:
        delta_cum = max(0, cum - base_by_bound.get(bound, 0))
        if q_value is None and delta_cum >= q_target:
            # the windowed quantile is its bucket's upper edge (same
            # over-read bound as Histogram.quantile); +Inf reports the
            # largest finite edge — "off the scale", not "unknown"
            q_value = bound if bound != float("inf") else (
                pairs[-2][0] if len(pairs) > 1 else None
            )
        if good is None and bound >= max_seconds:
            good = delta_cum
    if good is None:
        good = observations  # threshold above the top bucket: all good
    error = max(0.0, 1.0 - good / observations)
    return error, q_value, observations


class _Ring:
    """Bounded (monotonic_t, sample) ring + windowed lookups."""

    def __init__(self, capacity: int):
        self._entries: Deque[Tuple[float, Dict]] = deque(maxlen=max(2, capacity))
        self._lock = threading.Lock()

    def append(self, t: float, sample: Dict) -> None:
        with self._lock:
            self._entries.append((t, sample))

    def latest(self) -> Optional[Tuple[float, Dict]]:
        with self._lock:
            return self._entries[-1] if self._entries else None

    def at_window_start(self, now: float, window: float) -> Optional[Tuple[float, Dict]]:
        """The newest sample at or before ``now - window`` (the window's
        base for counter/histogram differencing); the OLDEST sample when
        the ring doesn't reach back that far yet (the window then covers
        less history than it claims — ``covered`` in the eval says so)."""
        boundary = now - window
        with self._lock:
            if not self._entries:
                return None
            best = None
            for entry in self._entries:
                if entry[0] <= boundary:
                    best = entry
                else:
                    break
            return best if best is not None else self._entries[0]

    def window_entries(self, now: float, window: float) -> List[Tuple[float, Dict]]:
        boundary = now - window
        with self._lock:
            return [e for e in self._entries if e[0] >= boundary]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class SLOPlane:
    """Owns the sampling tick, the ring, and the per-objective verdicts."""

    def __init__(self, config, metrics):
        self.config = config
        self.metrics = metrics
        self.ring = _Ring(config.ring_size)
        self._results: Dict[str, Dict[str, Any]] = {}
        self._results_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._ticks = 0
        burn = metrics.gauge("slo_burn_rate")
        breaching = metrics.gauge("slo_breaching")
        self._gauges = {
            o.name: {
                "fast": burn.labels(objective=o.name, window="fast"),
                "slow": burn.labels(objective=o.name, window="slow"),
                "breaching": breaching.labels(objective=o.name),
            }
            for o in config.objectives
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SLOPlane":
        self._stop.clear()
        self._started = True
        self.tick()  # seed the ring so the first window eval has a base
        self._thread = threading.Thread(
            target=self._run, name="slo-engine", daemon=True
        )
        self._thread.start()
        logger.info(
            "SLO engine started: %d objective(s) [%s] (tick=%.1fs, windows %.0fs/%.0fs)",
            len(self.config.objectives),
            ", ".join(o.name for o in self.config.objectives),
            self.config.tick_seconds,
            self.config.fast_window_seconds,
            self.config.slow_window_seconds,
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._started = False

    def _run(self) -> None:
        while not self._stop.wait(self.config.tick_seconds):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a dead engine must be loud, not fatal
                logger.exception("SLO tick failed")

    # -- the tick ----------------------------------------------------------

    def tick(self) -> Dict[str, Dict[str, Any]]:
        """One sample + one evaluation pass (also the test seam)."""
        now = time.monotonic()
        # flat sample (no per-label series): objectives are declared
        # against parent totals, and the process-labeled fold keeps
        # those exact regardless of worker-export state
        self.ring.append(now, self.metrics.sample())
        self._ticks += 1
        results = {o.name: self._evaluate(o, now) for o in self.config.objectives}
        with self._results_lock:
            self._results = results
        for name, result in results.items():
            gauges = self._gauges.get(name)
            if gauges is not None:
                gauges["fast"].set(result["windows"]["fast"]["burn_rate"])
                gauges["slow"].set(result["windows"]["slow"]["burn_rate"])
                gauges["breaching"].set(1.0 if result["breaching"] else 0.0)
        return results

    def _evaluate(self, objective, now: float) -> Dict[str, Any]:
        windows = {
            "fast": self._window(objective, now, self.config.fast_window_seconds),
            "slow": self._window(objective, now, self.config.slow_window_seconds),
        }
        threshold = self.config.burn_threshold
        breaching = (
            windows["fast"]["burn_rate"] > threshold
            and windows["slow"]["burn_rate"] > threshold
        )
        out: Dict[str, Any] = {
            "name": objective.name,
            "kind": objective.kind,
            "target": objective.target,
            "burn_threshold": threshold,
            "windows": windows,
            "breaching": breaching,
        }
        if objective.kind == "quantile":
            out["metric"] = objective.metric
            out["max_seconds"] = objective.max_seconds
            out["quantile"] = objective.quantile
        elif objective.kind == "gauge":
            out["metric"] = objective.metric
            out["max"] = objective.max_value
            latest = self.ring.latest()
            if latest is not None:
                out["current"] = latest[1]["gauges"].get(objective.metric)
        else:
            out["good"] = objective.good
            out["total"] = objective.total
            out["min_ratio"] = objective.min_ratio
        return out

    def _window(self, objective, now: float, window: float) -> Dict[str, Any]:
        budget = max(1e-9, 1.0 - objective.target)
        latest = self.ring.latest()
        base = self.ring.at_window_start(now, window)
        result: Dict[str, Any] = {
            "window_seconds": window,
            "error_rate": 0.0,
            "burn_rate": 0.0,
            # False until the ring actually reaches back a full window —
            # early verdicts are over less history than they claim
            "covered": base is not None and now - base[0] >= window * 0.95,
        }
        if latest is None or base is None:
            return result
        if objective.kind == "quantile":
            error, q_value, observations = _window_error_quantile(
                base[1]["histograms"].get(objective.metric),
                latest[1]["histograms"].get(
                    objective.metric, ([], 0, 0.0)
                ),
                objective.max_seconds,
                objective.quantile,
            )
            result["error_rate"] = error
            result["observations"] = observations
            if q_value is not None:
                result["quantile_seconds"] = round(q_value, 6)
        elif objective.kind == "gauge":
            entries = self.ring.window_entries(now, window)
            present = 0
            violating = 0
            for _, sample in entries:
                value = sample["gauges"].get(objective.metric)
                if value is None:
                    continue
                present += 1
                if value > objective.max_value:
                    violating += 1
            result["error_rate"] = violating / present if present else 0.0
            result["ticks"] = present
        else:  # ratio
            cur_good = latest[1]["counters"].get(objective.good, 0)
            cur_total = latest[1]["counters"].get(objective.total, 0)
            base_good = base[1]["counters"].get(objective.good, 0)
            base_total = base[1]["counters"].get(objective.total, 0)
            delta_total = cur_total - base_total
            delta_good = cur_good - base_good
            if delta_total > 0:
                ratio = max(0.0, min(1.0, delta_good / delta_total))
                result["ratio"] = round(ratio, 6)
                result["error_rate"] = 1.0 - ratio
            result["observations"] = max(0, delta_total)
        result["burn_rate"] = round(result["error_rate"] / budget, 4)
        result["error_rate"] = round(result["error_rate"], 6)
        return result

    # -- surfaces ----------------------------------------------------------

    def results(self) -> Dict[str, Dict[str, Any]]:
        with self._results_lock:
            return dict(self._results)

    def snapshot(self) -> Dict[str, Any]:
        """The full /debug/slo body."""
        return {
            "enabled": True,
            "started": self._started,
            "ticks": self._ticks,
            "tick_seconds": self.config.tick_seconds,
            "fast_window_seconds": self.config.fast_window_seconds,
            "slow_window_seconds": self.config.slow_window_seconds,
            "burn_threshold": self.config.burn_threshold,
            "ring_entries": len(self.ring),
            "objectives": self.results(),
        }

    def health(self) -> Dict[str, Any]:
        """The /healthz BODY fold: unhealthy while any objective breaches
        both burn windows. Deliberately NOT the liveness verdict — a
        restart does not refund an error budget, and a 503 here would
        crash-loop the watcher into burning it faster. Alerts and
        readiness key off ``healthy``/``breaching`` in the body."""
        results = self.results()
        breaching = sorted(name for name, r in results.items() if r.get("breaching"))
        return {
            "healthy": not breaching,
            "breaching": breaching,
            "objectives": len(self.config.objectives),
            "thread_alive": self._thread.is_alive() if self._thread is not None else False,
        }
