"""Cross-cycle trend detection for probe readings.

A single probe cycle can only resolve degradation beyond its noise band
(ARCHITECTURE.md "minimum detectable degradation": ~15-35% on tunneled
links, ~2-10% locally). Slow decay — a chip throttling a few percent more
each hour — hides inside that band forever if each cycle is judged alone.

``TrendTracker`` learns a per-metric healthy **anchor** (the median of the
first ``window`` readings after startup, frozen once learned) and compares
the median of the last ``recent`` cycles against it. The anchor is frozen
deliberately: a *rolling* baseline decays along with the readings, so any
drift slower than the alert factor per window would never alert — the
exact slow-decay case this module exists for. Against a frozen anchor,
decay of any rate eventually crosses the factor and keeps alerting until
the part is fixed or drained.

Judging a recent-median vs a many-sample anchor means a single noisy cycle
can neither raise an alert nor poison the baseline — the same robustness
reasoning as the probes' own median-over-min discipline. (That guarantee
needs ``recent >= 3``: the median of 2 samples is their mean, which one
spike drags halfway. The default is 3.)

State is in-process: a restart re-learns its anchor within ``window``
cycles. That is deliberate and it is also the re-baselining story — after
an intentional operating-point change (downclocking, firmware update) or
a hardware swap (pod rescheduled onto a different chip), restart the agent
and the new normal becomes the anchor. Persisting anchors across restarts
would flag a replacement chip against its predecessor's characteristics.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import threading
from typing import Any, Deque, Dict, List, Optional


@dataclasses.dataclass
class TrendAlert:
    metric: str
    baseline: float  # the frozen (or still-forming) healthy anchor
    recent: float  # median of the last ``recent`` cycles
    ratio: float  # recent / baseline
    direction: str  # "drop" (throughput fell) | "rise" (latency grew)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class TrendTracker:
    """Per-metric frozen-anchor drift detection.

    ``observe(name, value, higher_is_better)`` folds one cycle's reading
    and returns a ``TrendAlert`` when the recent median has drifted beyond
    the factor for that direction:

    - throughput metrics (``higher_is_better=True``, e.g. TFLOP/s, GB/s):
      alert when ``recent < drop_factor * anchor``;
    - latency metrics (``higher_is_better=False``, e.g. psum RTT): alert
      when ``recent > rise_factor * anchor``.

    No verdict until ``min_history`` total samples exist; until ``window``
    samples exist the anchor is the median of everything before the recent
    cycles (still forming), after which it freezes. A degraded part keeps
    alerting every cycle until fixed, drained, or the agent is restarted
    (restart = re-baseline, see module docstring). Thread-safe: the agent
    loop and any debug endpoint may race.
    """

    def __init__(
        self,
        *,
        window: int = 16,
        recent: int = 3,
        drop_factor: float = 0.75,
        rise_factor: float = 2.5,
        min_history: int = 6,
    ):
        if recent < 1 or window <= recent:
            raise ValueError("need window > recent >= 1")
        if min_history < recent + 1:
            raise ValueError("min_history must exceed recent (the anchor needs samples)")
        if min_history > window:
            raise ValueError(
                "min_history must be <= window: the anchor freezes at window "
                "samples, so a larger min_history would disable detection forever"
            )
        if not 0.0 < drop_factor < 1.0:
            raise ValueError("drop_factor must be in (0, 1): >= 1 alerts on every healthy cycle")
        if rise_factor <= 1.0:
            raise ValueError("rise_factor must be > 1: <= 1 alerts on every healthy cycle")
        self.window = window
        self.recent = recent
        self.drop_factor = drop_factor
        self.rise_factor = rise_factor
        self.min_history = min_history
        self._lock = threading.Lock()
        # forming[name] accumulates the first ``window`` readings; once full
        # its median freezes into anchor[name] and only ``recent`` readings
        # are retained per metric — O(window) memory regardless of uptime
        self._forming: Dict[str, List[float]] = {}
        self._anchor: Dict[str, float] = {}
        self._recent: Dict[str, Deque[float]] = {}
        # per-metric flags mirroring the recent deque: did that observe
        # contribute to the forming buffer? The interim anchor must exclude
        # exactly the trailing forming entries still inside the recent
        # window, and with non-contributing cycles interleaved that count
        # is NOT always recent-1
        self._recent_contributed: Dict[str, Deque[bool]] = {}

    def observe(
        self,
        name: str,
        value: float,
        *,
        higher_is_better: bool,
        contribute_baseline: bool = True,
    ) -> Optional[TrendAlert]:
        """Fold one reading; ``contribute_baseline=False`` judges the
        reading against the anchor but keeps it out of the forming buffer —
        for cycles the caller already knows are unhealthy by per-cycle
        checks (RTT threshold breach, missing devices), whose readings must
        not freeze into the "healthy" anchor."""
        if value is None or value <= 0:
            return None  # errored/absent readings carry no trend signal
        value = float(value)
        with self._lock:
            recent = self._recent.setdefault(name, collections.deque(maxlen=self.recent))
            recent.append(value)
            anchor = self._anchor.get(name)
            forming = None
            contributed = None
            if anchor is None:
                # contributed mirrors the recent deque while forming only;
                # once the anchor freezes nothing reads it again
                contributed = self._recent_contributed.setdefault(
                    name, collections.deque(maxlen=self.recent)
                )
                contributed.append(False)  # flipped below if this sample forms
                # the current sample is judged BEFORE it may enter the
                # forming buffer (see below)
                forming = self._forming.setdefault(name, [])
                if len(forming) + 1 < self.min_history:
                    if contribute_baseline:
                        forming.append(value)
                        contributed[-1] = True
                    return None
                # judge against the forming samples NOT still inside the
                # recent window (the overlap is however many of the last
                # ``recent`` observes contributed — with non-contributing
                # cycles interleaved it is less than recent-1). All-overlap
                # (reachable right at min_history == recent+1) degrades to
                # judging recent against itself: ratio ~1, no alert — the
                # correct bootstrap behavior.
                overlap = sum(1 for c in contributed if c)
                baseline_samples = forming[: len(forming) - overlap] or forming
                anchor = statistics.median(baseline_samples)
            recent_samples = list(recent)

            alert = None
            if anchor > 0:
                recent_median = statistics.median(recent_samples)
                ratio = recent_median / anchor
                if higher_is_better and ratio < self.drop_factor:
                    alert = TrendAlert(name, anchor, recent_median, ratio, "drop")
                elif not higher_is_better and ratio > self.rise_factor:
                    alert = TrendAlert(name, anchor, recent_median, ratio, "rise")

            if forming is not None and alert is None and contribute_baseline:
                # only non-alerting samples from healthy cycles may shape
                # the anchor: degradation that starts mid-forming must not
                # freeze into the baseline (it would silence alerts that
                # were already firing and judge all future decay against a
                # poisoned anchor). If degradation persists, the anchor
                # simply never freezes and every cycle keeps alerting
                # against the early-healthy baseline.
                forming.append(value)
                contributed[-1] = True
                if len(forming) >= self.window:
                    self._anchor[name] = statistics.median(forming)
                    del self._forming[name]
                    del self._recent_contributed[name]
        return alert

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Current anchors + recent windows (debug endpoints)."""
        with self._lock:
            return {
                name: {
                    "anchor": self._anchor.get(name),
                    "forming_samples": len(self._forming.get(name, ())),
                    "recent": list(series),
                }
                for name, series in self._recent.items()
            }
