"""HealthPlane: signal collection and the detector's tick loop (the JAX
package's ``health/plane.py``).

The detector (``health/detector.py``) is the fusion and verdict logic; this
plane feeds it from the planes the watcher already runs:

- **phase** (``serve/view.py``): per tick the plane scans the fleet view's
  pods and tracks their phase transitions. A node's reading is ``max(median
  of its last few Pending→Running latencies, age of its oldest still-Pending
  pod)``: the in-flight term catches the host whose pods never finish
  starting. Peer group = the node's slice, joined through the view's slice
  objects (``workers[].node``); nodes in no slice form one "unsliced" group.
- **probe** (``probe/``): completed probe reports are queued by
  ``observe_report`` (chained after the remediation policy's observer, on
  the probe's thread) and drained by the next tick. Suspect triangulation
  reuses ``remediate/policy.py``'s extraction, so a report implicates nodes
  through the port's rank join: a link endpoint is a rank, looked up in the
  report's ``hosts``. The implications become direct evidence; per-node
  link-RTT medians become a graded peer signal (all nodes of one report are
  slice peers). Each report is consumed by one tick, so hysteresis counts
  reports for this source.
- **freshness** (``federate/plane.py``, on a federator): each upstream's
  watermark age and its oldest unpropagated delta, from
  ``FederationPlane.freshness()``. Upstreams form one peer group, so one
  lagging cluster stands out against the others.
- **trace** (``trace/``): per-stage mean latency over the tick window
  (cumulative histogram differencing), trend-judged. Stage subjects surface
  pipeline pathology in /debug/health; they never reach the actuator.

The tick's own cost is recorded in ``health_tick_seconds``.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from k8s_watcher_tpu_torch.config import HealthConfig
from k8s_watcher_tpu_torch.health.detector import HealthDetector, Observation

logger = logging.getLogger(__name__)

#: per-metric absolute z-denominator floors (see Observation.floor)
PHASE_LATENCY_FLOOR_S = 0.25
WATERMARK_FLOOR_S = 0.5
UNPROPAGATED_FLOOR_S = 1.0
LINK_RTT_FLOOR_MS = 0.05

#: completed Pending->Running latencies remembered per node (median of
#: these is the "recent startup cost"; small so recovery is quick)
RECENT_LATENCIES = 3


class HealthPlane:
    """Runs the detector against the app's live planes."""

    def __init__(
        self,
        config: HealthConfig,
        *,
        metrics=None,
        view=None,  # serve.FleetView (phase source)
        federation=None,  # federate.FederationPlane (freshness source)
        sink=None,  # notification sink (TPU_HEALTH payloads)
        environment: str = "",
    ):
        self.config = config
        self.metrics = metrics
        self.view = view
        self.federation = federation
        self.environment = environment
        self.detector = HealthDetector(
            suspect_z=config.suspect_z,
            confirm_cycles=config.confirm_cycles,
            decay_cycles=config.decay_cycles,
            metrics=metrics,
            sink=sink,
        )
        self._tick_seconds = (
            metrics.histogram("health_tick_seconds") if metrics is not None else None
        )
        # phase-source state: pod key -> (phase, monotonic since)
        self._pods: Dict[str, Tuple[str, float]] = {}
        self._node_latency: Dict[str, collections.deque] = {}
        # probe-source state: reports pushed from the agent thread (or a
        # drill), drained once per tick
        self._report_lock = threading.Lock()
        self._pending_reports: collections.deque = collections.deque(maxlen=8)
        #: probe reports the ticks have drained into the detector
        self.reports_observed = 0
        # trace-source state: per-stage (count, sum) at the previous tick
        self._stage_prev: Dict[str, Tuple[int, float]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    def arm_actuator(self, actuator) -> None:
        """Attach the (shared or dedicated) budgeted NodeActuator —
        called post-campaign so standbys never multiply the fences."""
        self.detector.actuator = actuator

    def start(self) -> "HealthPlane":
        self._stop.clear()
        self._started = True
        self._thread = threading.Thread(
            target=self._loop, name="health-plane", daemon=True
        )
        self._thread.start()
        sources = [
            name for name, on in (
                ("probe", self.config.source_probe),
                ("phase", self.config.source_phase),
                ("freshness", self.config.source_freshness),
                ("trace", self.config.source_trace),
            ) if on
        ]
        logger.info(
            "Health plane started (tick=%.1fs, suspect_z=%.1f, confirm=%d, decay=%d, "
            "sources=%s, actuator=%s)",
            self.config.tick_seconds, self.config.suspect_z,
            self.config.confirm_cycles, self.config.decay_cycles,
            "+".join(sources), "armed" if self.detector.actuator else "none",
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._started = False

    def _loop(self) -> None:
        while not self._stop.wait(self.config.tick_seconds):
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — a bad tick must not kill the plane
                logger.error("Health tick failed: %s", exc)
                if self.metrics is not None:
                    self.metrics.counter("health_tick_errors").inc()

    # -- signal intake -----------------------------------------------------

    def observe_report(self, report) -> None:
        """Queue one completed probe report for the next tick. Called on the
        probe agent's thread inside its cycle, so it only queues: no device
        call, no detector work."""
        if not self.config.source_probe:
            return
        with self._report_lock:
            self._pending_reports.append(report)

    # -- the tick ----------------------------------------------------------

    def tick(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        observations: List[Observation] = []
        evidence: Dict[Tuple[str, str], List[str]] = {}
        if self.config.source_phase and self.view is not None:
            self._collect_phase(observations)
        if self.config.source_freshness and self.federation is not None:
            self._collect_freshness(observations)
        if self.config.source_probe:
            self._collect_probe(observations, evidence)
        if self.config.source_trace and self.metrics is not None:
            self._collect_trace(observations)
        summary = self.detector.tick(observations, evidence)
        if self._tick_seconds is not None:
            self._tick_seconds.record(time.perf_counter() - t0)
        if self._ticks_counter is not None:
            self._ticks_counter.inc()
        return summary

    @property
    def _ticks_counter(self):
        return self.detector._ticks_counter

    def _collect_phase(self, observations: List[Observation]) -> None:
        """Per-node phase-transition latencies off the view's fleet
        state. Columnar core: ``fleet_handle``, the per-pod key/phase/node
        sequences decoded from the int columns at most once per
        generation. Dict core: the per-kind ``snapshot_tables`` walk (one
        object walk per rv, cached on the view). The transition logic is
        the same either way."""
        now = time.monotonic()
        view = self.view
        if getattr(view, "columnar", False) and hasattr(view, "fleet_handle"):
            _rv, handle = view.fleet_handle()
            slice_objs = handle.slices
            live_keys = set(handle.keys)
            pod_triples = zip(handle.keys, handle.phases, handle.nodes)
        else:
            _rv, tables = view.snapshot_tables()
            slice_objs = tables.get("slice", ())
            pods = tables.get("pod", ())
            live_keys = {obj.get("key") for obj in pods}
            pod_triples = (
                (obj.get("key"), obj.get("phase") or "Unknown", obj.get("node"))
                for obj in pods
            )
        node_slice: Dict[str, str] = {}
        for obj in slice_objs:
            for worker in obj.get("workers") or ():
                node = worker.get("node")
                if node:
                    node_slice[node] = str(obj.get("key") or obj.get("slice") or "")
        pending_age: Dict[str, float] = {}
        live_nodes = set()
        for key, phase, node in pod_triples:
            if node:
                live_nodes.add(node)
            prev = self._pods.get(key)
            if prev is None:
                self._pods[key] = (phase, now)
            elif prev[0] != phase:
                if prev[0] == "Pending" and phase == "Running" and node:
                    self._node_latency.setdefault(
                        node, collections.deque(maxlen=RECENT_LATENCIES)
                    ).append(now - prev[1])
                self._pods[key] = (phase, now)
            if phase == "Pending" and node:
                since = self._pods[key][1]
                pending_age[node] = max(pending_age.get(node, 0.0), now - since)
        for key in list(self._pods):
            if key not in live_keys:
                del self._pods[key]
        # a node with no live pods has no phase signal: drop its latency
        # memory so a drained/autoscaled-away host stops emitting frozen
        # stale observations into its peer group forever (its detector
        # subject freezes, which is the no-signal contract; the memory
        # must not keep "observing" on its behalf)
        for node in list(self._node_latency):
            if node not in live_nodes:
                del self._node_latency[node]
        import statistics as _st

        for node in set(self._node_latency) | set(pending_age):
            recent = self._node_latency.get(node)
            completed = _st.median(recent) if recent else 0.0
            value = max(completed, pending_age.get(node, 0.0))
            observations.append(Observation(
                kind="node", name=node, metric="phase_latency_seconds",
                value=value,
                group=f"slice:{node_slice[node]}" if node in node_slice else "unsliced",
                floor=PHASE_LATENCY_FLOOR_S, source="phase",
            ))

    def _collect_freshness(self, observations: List[Observation]) -> None:
        upstreams = (self.federation.freshness() or {}).get("upstreams") or {}
        for name, u in upstreams.items():
            age = u.get("watermark_age_seconds")
            if age is None:
                age = u.get("last_delta_age_seconds")
            if age is not None:
                observations.append(Observation(
                    kind="upstream", name=name, metric="watermark_age_seconds", value=float(age),
                    group="upstreams", floor=WATERMARK_FLOOR_S, source="freshness",
                ))
            unpropagated = u.get("oldest_unpropagated_seconds")
            if unpropagated is not None:
                observations.append(Observation(
                    kind="upstream", name=name, metric="oldest_unpropagated_seconds", value=float(unpropagated),
                    group="upstreams_backlog", floor=UNPROPAGATED_FLOOR_S, source="freshness",
                ))

    def _collect_probe(
        self,
        observations: List[Observation],
        evidence: Dict[Tuple[str, str], List[str]],
    ) -> None:
        with self._report_lock:
            reports = list(self._pending_reports)
            self._pending_reports.clear()
        if not reports:
            return
        self.reports_observed += len(reports)
        from k8s_watcher_tpu_torch.remediate.policy import ProbeRemediationPolicy

        import statistics as _st

        for report_index, report in enumerate(reports):
            # the one implication algorithm (measured-defect-only
            # triangulation, ranks mapped to nodes through ``hosts``)
            scoped = ProbeRemediationPolicy._implicated(report)
            for node, entries in scoped.items():
                if node == "__unmapped__":
                    continue
                evidence.setdefault(("node", node), []).extend(
                    e[1] for e in entries
                )
            # graded peer signal: per-node median link RTT (each link's
            # reading attributed to both endpoint nodes). All nodes of one
            # report share a fabric == are slice peers.
            links = getattr(report, "links", None)
            if links is None or getattr(links, "error", None) is not None:
                continue
            hosts = report.hosts or {}

            def node_of(rank):
                # a link endpoint is a rank (probe/links.py): its node is in
                # ``hosts``; the ``devices`` inventory lists only this node's
                # GPUs by local index and cannot resolve it
                return (hosts.get(str(rank)) or {}).get("node_name")

            per_node: Dict[str, List[float]] = {}
            for link in getattr(links, "links", None) or ():
                rtt = link.get("rtt_ms") if isinstance(link, dict) else getattr(link, "rtt_ms", None)
                ids = link.get("device_ids") if isinstance(link, dict) else getattr(link, "device_ids", ())
                if rtt is None or rtt <= 0:
                    continue
                for rank in ids or ():
                    node = node_of(rank)
                    if node:
                        per_node.setdefault(node, []).append(float(rtt))
            # peer group = THIS report's nodes only (they share a fabric);
            # keyed by the drain index so two slices' reports landing in
            # the same tick never z-score against each other's RTT floor
            group = f"probe:{report_index}"
            for node, rtts in per_node.items():
                observations.append(Observation(
                    kind="node", name=node, metric="link_rtt_ms",
                    value=_st.median(rtts), group=group, floor=LINK_RTT_FLOOR_MS,
                    source="probe",
                ))

    def _collect_trace(self, observations: List[Observation]) -> None:
        """Per-stage mean latency over this tick's new samples (cumulative
        count/sum differencing — the cheap windowed reading; the SLO plane
        owns exact bucket math). Only stages that already exist in the
        registry are read: the health plane must not mint empty series."""
        from k8s_watcher_tpu_torch.trace import ALL_STAGES

        for stage in ALL_STAGES:
            hist = self.metrics.peek_histogram(f"trace_stage_{stage}")
            if hist is None:
                continue
            _pairs, count, total = hist.buckets()
            prev_count, prev_sum = self._stage_prev.get(stage, (0, 0.0))
            self._stage_prev[stage] = (count, total)
            new = count - prev_count
            if new <= 0:
                continue
            observations.append(Observation(
                kind="stage", name=stage, metric="stage_mean_seconds",
                value=max(0.0, (total - prev_sum) / new),
                group=None, floor=0.0, source="trace",
            ))

    # -- surfaces ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        body = self.detector.snapshot()
        body["enabled"] = True
        body["started"] = self._started
        body["tick_seconds"] = self.config.tick_seconds
        body["sources"] = {
            "probe": self.config.source_probe,
            "phase": self.config.source_phase,
            "freshness": self.config.source_freshness,
            "trace": self.config.source_trace,
        }
        return body

    def health(self) -> Dict[str, Any]:
        body = self.detector.health()
        body["thread_alive"] = self._thread.is_alive() if self._thread else False
        return body

    def release(self, node: str, reason: str = "operator release") -> Dict[str, Any]:
        return self.detector.release(node, reason)
