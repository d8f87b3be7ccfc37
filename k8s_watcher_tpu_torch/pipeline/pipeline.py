"""Pipeline composition.

The reference's per-event path (pod_watcher.py:214-241) was: production
critical gate → namespace filter → extract → (disabled) notify. This
pipeline keeps that order and adds the net-new stages the north star needs:
accelerator resource filter, phase-delta detection, and slice tracking.

The pipeline never blocks on the network: its sink is a callable (normally
``notify.Dispatcher.submit``) that enqueues and returns. One slow POST must
not stall the watch stream (SURVEY.md §3.1 flags the reference's synchronous
notify as the key <1 s p50 hazard).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.pipeline.extract import extract_pod_data
from k8s_watcher_tpu_torch.pipeline.filters import (
    CriticalEventGate,
    NamespaceFilter,
    TpuResourceFilter,
    pod_accelerator_chips,
)
from k8s_watcher_tpu_torch.pipeline.phase import PhaseTracker, _ready_tuple, pod_key
from k8s_watcher_tpu_torch.watch.source import EventType, WatchEvent

logger = logging.getLogger(__name__)

#: drop reasons meaning the event never entered the fleet-state view (not a
#: pod event, not a watched namespace, not an accelerator pod). Shared with
#: serve/view.py ``publish_batch``; these journeys do not ride the serve
#: publish, so their end stamp does not include it.
NEVER_IN_VIEW = frozenset({"bookmark", "error_event", "namespace_filter", "resource_filter"})


class Notification(NamedTuple):
    """A payload bound for the notifier, carrying the receive stamp so the
    event→notify latency (north-star metric) can be measured end to end.
    The one notification type: the pipeline, the probe agent, remediation
    and the dispatcher all pass it.

    NamedTuples, not dataclasses, for this and ``PipelineResult``: one of
    each is built per event on the ingest hot path, and dataclass __init__
    (object.__setattr__ per field when frozen) costs ~4x a tuple fill for
    the same immutable record."""

    payload: Dict[str, Any]
    received_monotonic: float
    kind: str = "pod"  # "pod" | "slice" | "probe" | "remediation"
    # trace.Trace riding the POD journey this payload came from (None for
    # unsampled events and for derived slice/probe payloads — the trace
    # follows the one watch event it was sampled on)
    trace: Optional[Any] = None


class PipelineResult(NamedTuple):
    notified: bool
    reason: str  # "notified" | drop reason
    payload: Optional[Dict[str, Any]] = None


Sink = Callable[[Notification], None]


class EventPipeline:
    def __init__(
        self,
        *,
        environment: str,
        sink: Sink,
        namespace_filter: Optional[NamespaceFilter] = None,
        resource_filter: Optional[TpuResourceFilter] = None,
        critical_gate: Optional[CriticalEventGate] = None,
        phase_tracker: Optional[PhaseTracker] = None,
        slice_tracker: Optional[Any] = None,  # slices.SliceTracker (optional stage)
        metrics: Optional[MetricsRegistry] = None,
        audit: Optional[Any] = None,  # metrics.audit.AuditRing
        tracer: Optional[Any] = None,  # trace.Tracer (stage spans + terminals)
        view: Optional[Any] = None,  # serve.FleetView (fleet-state serving plane)
        notify_all: bool = False,
        resource_key: str = "google.com/tpu",
        topology_label: str = "cloud.google.com/gke-tpu-topology",
        accelerator_label: str = "cloud.google.com/gke-tpu-accelerator",
    ):
        self.environment = environment
        self.sink = sink
        self.namespace_filter = namespace_filter or NamespaceFilter()
        self.resource_filter = resource_filter or TpuResourceFilter(resource_key)
        self.critical_gate = critical_gate or CriticalEventGate(environment, False)
        # `or` would discard an *empty* tracker (PhaseTracker defines __len__,
        # so a fresh one is falsy) and silently break checkpoint sharing
        self.phase_tracker = phase_tracker if phase_tracker is not None else PhaseTracker()
        self.slice_tracker = slice_tracker
        self.metrics = metrics or MetricsRegistry()
        self.audit = audit
        self.tracer = tracer
        self.view = view
        self.notify_all = notify_all
        self.resource_key = resource_key
        self.topology_label = topology_label
        self.accelerator_label = accelerator_label
        # batch-entry stamp shared with the hand-off site in _process_one
        # (the drain is single-threaded, so instance state is safe)
        self._batch_enter = 0.0

    def process(self, event: WatchEvent) -> PipelineResult:
        return self.process_batch((event,))[0]

    def process_batch(self, events) -> list:
        """Process a batch of events in arrival order; one PipelineResult
        per event, semantics identical to per-event ``process`` (which IS
        this method with a batch of one).

        What the batch amortizes — the reason sustained ingest scales with
        batch size while per-event behavior stays bit-identical:

        - metrics: counter deltas accumulate in a plain local dict and
          flush ONCE per counter per batch (the registry's lock + deque
          round was ~6% of the per-event budget at 14k events/s);
        - attribute lookups: the per-stage callables are bound once per
          batch, not re-resolved per event;
        - the caller checkpoints once per BATCH (app.py), not per event —
          the "one dirty-mark per batch" contract.

        Ordering: events are processed strictly in list order, so per-UID
        ordering is preserved whenever the producer preserved it (one
        shard stream per UID — watch/sharded.py)."""
        counts: Dict[str, int] = {"events_received": len(events)}
        audit = self.audit
        record = audit.record if audit is not None else None
        process_one = self._process_one
        tracer = self.tracer
        tracing = tracer is not None
        monotonic = time.monotonic
        # one stamp per BATCH: every sampled event in it waited in the
        # ingest queue until this drain. Events deeper in the batch bill
        # their in-batch wait to the pipeline stage — that wait IS
        # pipeline processing of their predecessors.
        batch_enter = monotonic() if tracing else 0.0
        self._batch_enter = batch_enter
        # per-event pipeline-span END stamps for journeys that die in
        # this batch: the span must close when ITS event's processing
        # returned, not after the whole batch + publish (an early
        # dead-end in a 128-event batch would otherwise bill ~100x its
        # real pipeline time and poison /debug/trace?slowest=pipeline)
        ends: Dict[int, float] = {}
        results = []
        append = results.append
        for i, event in enumerate(events):
            append(process_one(event, counts))
            if tracing:
                trace = event.trace
                if trace is not None and not trace.handed_off:
                    ends[i] = monotonic()
        if self.view is not None:
            # serving-plane publish hook: the batch's post-filter pod state
            # folds into the view under one lock hold, after the verdicts
            # exist (the drop reasons say what never enters) and before the
            # dead-end journeys below finish, so their serve_fanout span
            # lands while the trace is open
            self.view.publish_batch(events, results)
        publish_end = monotonic() if (tracing and self.view is not None) else 0.0
        for i, (event, result) in enumerate(zip(events, results)):
            if tracing:
                trace = event.trace
                if trace is not None and not trace.handed_off:
                    # handed-off journeys stamped their spans at the
                    # hand-off site (_process_one) — the dispatcher may
                    # finish() on a worker thread the instant it owns the
                    # Notification, and finish reads the spans once. A
                    # journey that ended HERE — filtered, insignificant,
                    # gate-suppressed — terminates with the drop reason. Its
                    # pipeline span closes at its OWN processing end; a
                    # journey that entered the view ends after the publish
                    # its serve_fanout span covers.
                    own_end = ends[i]
                    rode_publish = publish_end and result.reason not in NEVER_IN_VIEW
                    now = publish_end if rode_publish else own_end
                    trace.add_span("queue_wait", trace.queue_enter, batch_enter)
                    trace.add_span("pipeline", batch_enter, own_end)
                    outcome = (
                        result.reason if result.reason != "notified"
                        # slice siblings notified but the pod payload
                        # itself was suppressed (critical gate / no
                        # significant pod delta): the POD journey
                        # ended here
                        else "pod_suppressed"
                    )
                    tracer.finish(trace, outcome, end=now)
            if record is not None and event.type != EventType.BOOKMARK:
                pod_meta = (event.pod or {}).get("metadata") or {}
                record(
                    {
                        "event_type": event.type,
                        "namespace": pod_meta.get("namespace"),
                        "name": pod_meta.get("name"),
                        "uid": pod_meta.get("uid"),
                        "phase": ((event.pod or {}).get("status") or {}).get("phase"),
                        "notified": result.notified,
                        "outcome": result.reason,
                    }
                )
        counter = self.metrics.counter
        for name, n in counts.items():
            counter(name).inc(n)
        return results

    def _process_one(self, event: WatchEvent, counts: Dict[str, int]) -> PipelineResult:
        """One event through the stage chain. ``counts`` accumulates
        counter deltas (flushed to the registry by ``process_batch``)."""
        if event.type == EventType.BOOKMARK:
            return PipelineResult(False, "bookmark")
        if event.type == EventType.ERROR:
            counts["events_error"] = counts.get("events_error", 0) + 1
            return PipelineResult(False, "error_event")

        # derive the shared per-event values ONCE; the filters, phase
        # delta, slice tracking and payload extraction below all consume
        # them (uid/phase/readiness were each re-derived 2-3x per event on
        # the 10k+ events/s hot path). Stock filters run INLINE on their
        # own precomputed inputs; a subclassed/custom filter (or a
        # different resource key) keeps its own verdict via the call path.
        pod = event.pod
        meta = pod.get("metadata") or {}
        nsf = self.namespace_filter
        if type(nsf) is NamespaceFilter:
            ns_ok = not nsf.namespaces or meta.get("namespace", "") in nsf.namespaces
        else:
            ns_ok = nsf(event)
        if not ns_ok:
            counts["events_dropped_namespace"] = counts.get("events_dropped_namespace", 0) + 1
            return PipelineResult(False, "namespace_filter")
        uid = pod_key(meta)
        phase = (pod.get("status") or {}).get("phase", "Unknown")
        ready_tuple = _ready_tuple(pod)
        chips = pod_accelerator_chips(pod, self.resource_key)
        rf = self.resource_filter
        if type(rf) is TpuResourceFilter and rf.resource_key == self.resource_key:
            passed = (
                not rf.enabled
                or chips > 0
                or (event.type == EventType.DELETED and event.legacy_tombstone)
            )
        elif isinstance(rf, TpuResourceFilter) and rf.resource_key == self.resource_key:
            passed = rf(event, chips=chips)
        else:
            passed = rf(event)
        if not passed:
            counts["events_dropped_resource"] = counts.get("events_dropped_resource", 0) + 1
            return PipelineResult(False, "resource_filter")

        # State tracking sees every event; the critical gate (reference
        # pod_watcher.py:204-212) only suppresses *pod notifications* below.
        # Gating before tracking would starve the slice aggregate of
        # Pending/Running observations in exactly the production environment
        # that enables it — no slice could ever reach Ready.
        delta = self.phase_tracker.observe(
            event, uid=uid, new_phase=phase, ready_tuple=ready_tuple
        )

        slice_info = None
        slice_notifications = []
        if self.slice_tracker is not None:
            # same key-match guard as the filter handoff above: a tracker
            # configured with a DIFFERENT resource key must keep walking
            # with its own
            tracker_chips = (
                chips
                if getattr(self.slice_tracker, "resource_key", None) == self.resource_key
                else None
            )
            slice_info, slice_notifications = self.slice_tracker.observe(
                event, delta, chips=tracker_chips, uid=uid, phase=phase,
                ready_tuple=ready_tuple,
            )

        gate = self.critical_gate
        critical_ok = not getattr(gate, "enabled", True) or gate(event)
        if not critical_ok:
            counts["events_dropped_critical_gate"] = counts.get("events_dropped_critical_gate", 0) + 1
            if not slice_notifications:
                return PipelineResult(False, "critical_gate")

        if not (self.notify_all or delta.significant or slice_notifications):
            counts["events_dropped_insignificant"] = counts.get("events_dropped_insignificant", 0) + 1
            return PipelineResult(False, "no_significant_change")

        payload = extract_pod_data(
            event.pod,
            self.environment,
            resource_key=self.resource_key,
            topology_label=self.topology_label,
            accelerator_label=self.accelerator_label,
            delta=delta,
            slice_info=slice_info,
            chips=chips,
        )
        payload["event_type"] = event.type

        if critical_ok and (self.notify_all or delta.significant):
            trace = event.trace
            if trace is not None:
                # spans stamped + hand-off marked BEFORE submit: the
                # dispatcher owns the terminal outcome from here and may
                # finish() on a worker thread immediately — finish reads
                # the span list once, so anything added after the sink
                # call would miss the per-stage histograms. (finish() is
                # idempotent, so a synchronous reject inside submit stays
                # single-counted.) The pipeline span therefore ends at
                # hand-off for notified journeys; post-sink work (slice
                # fan-out, logging) bills to no stage.
                now = time.monotonic()
                trace.add_span("queue_wait", trace.queue_enter, self._batch_enter)
                trace.add_span("pipeline", self._batch_enter, now)
                trace.handed_off = True
            self.sink(Notification(payload, event.received_monotonic, kind="pod", trace=trace))
            counts["notifications_enqueued"] = counts.get("notifications_enqueued", 0) + 1
        for slice_payload in slice_notifications:
            self.sink(Notification(slice_payload, event.received_monotonic, kind="slice"))
            counts["slice_notifications_enqueued"] = counts.get("slice_notifications_enqueued", 0) + 1

        logger.debug(
            "Pod event %s %s/%s phase=%s->%s",
            event.type, event.namespace, event.name,
            delta.old_phase, delta.new_phase,
        )
        return PipelineResult(True, "notified", payload)
