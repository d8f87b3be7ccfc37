"""AnalyticsPlane: the live fleet's columnar twin and the request surface of
``GET /serve/analytics`` (the JAX package's ``analytics/plane.py``).

It owns one :class:`FleetKernels` on the resolved backend (by default torch
on this rank's GPU) and keeps the columns current against the serving plane's
``FleetView``. On the columnar core the view's storage IS the columns: one
shared handle, built at most once per generation. On the dict core
(``serve.columnar: off``) the plane keeps a :class:`FleetEncoder`: per
request it folds the deltas ``> rv`` it last encoded (``read_since``); a
token behind the horizon (GONE) or a restarted view (INVALID) re-encodes
from ``FleetView.snapshot_tables()``.

Every request can cross-check the vectorized slice rollup against the
tracker's incremental counters (``analytics.crosscheck``); a mismatch counts
``analytics_crosscheck_failures`` and rides the response.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional

from k8s_watcher_tpu_torch.analytics.backend import resolve_backend
from k8s_watcher_tpu_torch.analytics.encode import POD_PHASES, FleetEncoder
from k8s_watcher_tpu_torch.analytics.kernels import FleetKernels, crosscheck
from k8s_watcher_tpu_torch.analytics.whatif import (
    SCENARIO_KINDS,
    Scenario,
    evaluate_scenarios,
    parse_scenarios,
)

logger = logging.getLogger(__name__)

#: per-refresh delta pull bound: more pending than this and the view
#: hands back a latest-wins compacted batch (keyed state — still exact)
REFRESH_MAX_DELTAS = 4096


class AnalyticsPlane:
    def __init__(self, config, view, *, metrics=None, device=None):
        """``device``: where the torch backend runs (default: this rank's GPU,
        raising without one; ``"cpu"`` on request)."""
        self.config = config
        self.view = view
        self.backend = resolve_backend(config.backend, device=device)
        self.kernels = FleetKernels(self.backend)
        self.encoder = FleetEncoder()
        self._rv: Optional[int] = None  # last view rv folded in
        self._instance: Optional[str] = None  # view incarnation the rv lives in
        # requests arrive on the serve HTTP threads; refresh and evaluate
        # run under one lock (the encoder is one mutable store)
        self._lock = threading.Lock()
        self.metrics = metrics
        self._requests = metrics.counter("analytics_requests") if metrics else None
        self._scenarios_evaluated = (
            metrics.counter("analytics_scenarios_evaluated") if metrics else None
        )
        self._encoder_deltas = (
            metrics.counter("analytics_encoder_deltas") if metrics else None
        )
        self._encoder_resets = (
            metrics.counter("analytics_encoder_resets") if metrics else None
        )
        self._crosscheck_failures = (
            metrics.counter("analytics_crosscheck_failures") if metrics else None
        )
        self._encode_seconds = (
            metrics.histogram("analytics_encode_seconds") if metrics else None
        )
        self._kernel_seconds = (
            metrics.histogram("analytics_kernel_seconds") if metrics else None
        )
        logger.info(
            "Analytics plane ready (backend=%s, max_scenarios=%d, crosscheck=%s)",
            self.backend.name, config.max_scenarios, config.crosscheck,
        )

    # -- keeping the columns current --------------------------------------

    def _refresh_locked(self):
        """Bring the columns current; returns ``(rv, cols)``."""
        t0 = time.perf_counter()
        view = self.view
        if view.columnar:
            rv, cols = view.fleet_columns()
            self._rv = rv
            self._instance = view.instance
            if self._encode_seconds is not None:
                self._encode_seconds.record(time.perf_counter() - t0)
            return rv, cols
        if self._rv is not None and self._instance == view.instance:
            result = view.read_since(self._rv, max_deltas=REFRESH_MAX_DELTAS)
            if result.status == "ok":
                for delta in result.deltas:
                    self.encoder.apply(
                        delta.kind, delta.key,
                        delta.object if delta.type == "UPSERT" else None,
                    )
                self._rv = result.to_rv
                if self._encoder_deltas is not None and result.deltas:
                    self._encoder_deltas.inc(len(result.deltas))
                if self._encode_seconds is not None:
                    self._encode_seconds.record(time.perf_counter() - t0)
                return self._rv, self.encoder.columns()
            # GONE (fell behind the horizon between requests) or INVALID
            # (view restarted under us): fall through to the full walk
        rv, tables = view.snapshot_tables()
        self.encoder.reset(tables)
        self._rv = rv
        self._instance = view.instance
        if self._encoder_resets is not None:
            self._encoder_resets.inc()
        if self._encode_seconds is not None:
            self._encode_seconds.record(time.perf_counter() - t0)
        return rv, self.encoder.columns()

    # -- the request surface ----------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """The no-scenario ``GET /serve/analytics`` body: fleet rollup +
        quorum/capacity stance + the declared scenario vocabulary."""
        with self._lock:
            rv, cols = self._refresh_locked()
            t0 = time.perf_counter()
            body = evaluate_scenarios(cols, [Scenario("baseline")], self.kernels)
            phase_counts = self.kernels.pod_phase_counts(cols)
            check = self._crosscheck_locked(cols)
            if self._kernel_seconds is not None:
                self._kernel_seconds.record(time.perf_counter() - t0)
        if self._requests is not None:
            self._requests.inc()
        out = {
            "rv": rv,
            "backend": self.backend.name,
            "scenario_kinds": list(SCENARIO_KINDS),
            "max_scenarios": self.config.max_scenarios,
            "fleet": body["baseline"],
            "pods_by_phase": {
                phase: int(phase_counts[:, code].sum())
                for code, phase in enumerate(POD_PHASES)
                if phase_counts[:, code].sum()
            },
            "clusters": {
                name or "<local>": {
                    "pods": int(phase_counts[code].sum()),
                }
                for name, code in (
                    (n, cols.clusters.lookup(n)) for n in cols.clusters.names
                )
                if code is not None and code < phase_counts.shape[0]
                and phase_counts[code].sum()
            },
        }
        if check is not None:
            out["crosscheck"] = check
        return out

    def evaluate(self, raw_scenarios: Any) -> Dict[str, Any]:
        """The scenario-shaped request: parse (``ScenarioError`` -> 400
        at the HTTP layer), refresh, one batched kernel pass."""
        scenarios = parse_scenarios(
            raw_scenarios, max_scenarios=self.config.max_scenarios
        )
        with self._lock:
            rv, cols = self._refresh_locked()
            t0 = time.perf_counter()
            body = evaluate_scenarios(cols, scenarios, self.kernels)
            check = self._crosscheck_locked(cols)
            if self._kernel_seconds is not None:
                self._kernel_seconds.record(time.perf_counter() - t0)
        if self._requests is not None:
            self._requests.inc()
        if self._scenarios_evaluated is not None:
            self._scenarios_evaluated.inc(len(scenarios))
        body["rv"] = rv
        body["backend"] = self.backend.name
        if check is not None:
            body["crosscheck"] = check
        return body

    def _crosscheck_locked(self, cols) -> Optional[Dict[str, Any]]:
        if not self.config.crosscheck:
            return None
        check = crosscheck(cols, self.kernels.slice_rollup(cols))
        if not check["ok"]:
            if self._crosscheck_failures is not None:
                self._crosscheck_failures.inc()
            logger.error(
                "Analytics cross-check FAILED: vectorized slice aggregates diverge "
                "from incremental counters on %s", check["mismatched"][:8],
            )
        return check
