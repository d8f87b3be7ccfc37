"""End-to-end event tracing plane.

The metrics registry says how many events moved, not where any ONE event
spent its time. This module
threads a lightweight span context through every hand-off an event
crosses, so a sampled event yields a span tree with per-stage durations:

    shard_receive  watch-stream read        -> ingest queue put
    queue_wait     ingest queue put         -> batch drain
    pipeline       batch drain              -> pipeline verdict (incl. submit)
    lane_wait      dispatcher submit        -> worker claim
    conn_borrow    pool acquire wait        (inside the POST, client-stamped)
    post           send start               -> POST completed

Design constraints (the hot-path budget is strict — the watcher moves
30k+ events/s):

- **Unsampled events pay only a timestamp-stamp.** ``WatchEvent`` already
  carries ``received_monotonic``; the head sampler's "no" costs one
  integer increment and a modulo — no allocation, no lock, no attribute
  write on the event.
- **Head-based sampling, deterministic.** The decision is made once, at
  the shard stream (the head); every later stage only checks "does this
  event carry a trace?". ``sample_rate: N`` keeps exactly every Nth
  pod event per sampler (modular counter, not RNG), so tests and
  incident replays are reproducible.
- **Anomalies always trace.** A dropped, abandoned or failed notification
  is precisely the event an operator will ask about; terminal-anomaly
  sites build a (minimal, after-the-fact) trace even when head sampling
  said no. The allocation happens on the anomaly path only.
- **Bounded memory.** Completed traces land in a ring (newest wins);
  span lists are short (≤ ~8 spans) and traces are dropped, never
  queued, when the ring wraps.

Correlation: every trace carries a process-unique ``trace_id`` which also
rides structured JSON log lines (``logging_setup.JsonFormatter``) and the
``/debug/trace`` route, so logs, traces and metrics triangulate.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

#: Stage names in hand-off order. A clean sent trace carries all six;
#: a trace that terminated early (filtered, coalesced, dropped) carries
#: the prefix it lived through.
STAGES = (
    "shard_receive",
    "queue_wait",
    "pipeline",
    "lane_wait",
    "conn_borrow",
    "post",
)

#: The serving plane's fan-out stage (serve/view.py ``publish_batch``):
#: stamped on sampled journeys that END at the view — suppressed or
#: insignificant events whose only egress IS the serving plane — while
#: the trace is still open (the pipeline publishes before finishing
#: them). Handed-off journeys belong to the dispatcher thread by then
#: (finish() reads spans once), so clean sent traces never carry it and
#: the six REQUIRED hand-off stages stay exactly ``STAGES``. Appears
#: only when ``serve.enabled``; ``ALL_STAGES`` is the query/validation
#: vocabulary (/debug/trace).
SERVE_STAGE = "serve_fanout"

#: The history plane's WAL hand-off (serve/view.py ``publish_batch``
#: with ``history.enabled``): stamped alongside ``serve_fanout`` on the
#: same still-open journeys, covering the O(1) enqueue to the WAL
#: writer. Disk write/fsync latency deliberately does NOT ride event
#: journeys (it happens on the dedicated writer thread, batched) — it
#: is attributed by the ``history_wal_write_seconds`` histogram instead.
WAL_STAGE = "wal_append"

#: Cross-cluster stages (federation tier): a sampled delta's journey no
#: longer ends at the process boundary — the serve wire forwards the
#: trace in-band (``?trace=1``, negotiated like ``?fresh=1``) and the
#: federator JOINS the upstream's local spans with the hops it can
#: measure itself:
#:
#:     serve_wire      upstream publish (frame ts[1]) -> federator receive
#:     federate_merge  federator receive -> the merged view's PUBLISH
#:                     STAMP (pub_wall is minted at apply_batch entry —
#:                     the same instant the merged Delta itself carries,
#:                     and the instant a second-tier serve_wire measures
#:                     from); covers the pre-fold merge-plane work:
#:                     trace rewrite + the fan-in drop-lock wait
#:     global_serve    merged publish stamp -> global fan-out hand-off
#:                     complete (the fold + journal + encode-once
#:                     wakeup — one apply_batch; subscriber delivery is
#:                     the consumer's own clock)
#:
#: Cross-host spans compare WALL clocks (monotonic stamps don't cross
#: machines) — the same skew caveat as the freshness plane, documented
#: in ARCHITECTURE.md "Fleet tracing". A two-tier federation repeats
#: ``serve_wire`` per hop (``stage_durations`` sums repeats, so
#: attribution stays total-time-per-stage); each tier's
#: ``federate_merge``/``global_serve`` are measured and attributed AT
#: that tier — the forwarded dict carries the upstream spans plus the
#: wire hops, never a mid-tier's own merge spans, so a slow mid-tier
#: merge shows in the MID tier's /debug/trace/diagnosis, not the top's.
SERVE_WIRE_STAGE = "serve_wire"
FEDERATE_MERGE_STAGE = "federate_merge"
GLOBAL_SERVE_STAGE = "global_serve"
FEDERATION_STAGES = (SERVE_WIRE_STAGE, FEDERATE_MERGE_STAGE, GLOBAL_SERVE_STAGE)
ALL_STAGES = STAGES + (SERVE_STAGE, WAL_STAGE) + FEDERATION_STAGES

#: Egress terminal outcomes that mark a trace anomalous (always recorded,
#: never head-sampled away): the notification's journey ended somewhere
#: other than a completed POST. Pipeline dead-ends (filtered, insignificant,
#: gate-suppressed) are routine decisions, not anomalies — they close a
#: head-sampled trace with their drop reason but never force capture.
ANOMALY_OUTCOMES = frozenset({"failed", "dropped_overflow", "abandoned"})


class Trace:
    """One event's journey through the watcher, as a flat span list.

    The journey is linear (one event, one path), so the "span tree" is a
    root span (``t0`` → ``end``, the watch→notify distance) with the
    stage spans as children — stored flat as ``(stage, start, end)``
    monotonic triples. Mutated from multiple threads (pipeline drain,
    dispatcher worker) but only ever APPENDED to, and ``list.append`` is
    GIL-atomic; readers copy before iterating (``to_dict``).
    """

    __slots__ = (
        "trace_id",
        "uid",
        "name",
        "namespace",
        "event_type",
        "kind",
        "cluster",
        "shard",
        "lane",
        "sampled_by",
        "t0",
        "end",
        "outcome",
        "anomaly",
        "attempts",
        "queue_enter",
        "lane_enter",
        "handed_off",
        "spans",
        "process",
    )

    def __init__(
        self,
        trace_id: str,
        *,
        uid: str = "",
        name: str = "",
        namespace: str = "",
        event_type: str = "",
        t0: float = 0.0,
        shard: Optional[int] = None,
        sampled_by: str = "head",
    ):
        self.trace_id = trace_id
        self.uid = uid
        self.name = name
        self.namespace = namespace
        self.event_type = event_type
        self.kind = "pod"
        self.cluster: Optional[str] = None  # the origin cluster of a joined trace
        self.shard = shard
        self.lane: Optional[int] = None
        self.sampled_by = sampled_by  # "head" | "anomaly"
        self.t0 = t0
        self.end: Optional[float] = None
        self.outcome: Optional[str] = None
        self.anomaly = False
        self.attempts = 0  # client-level send attempts (0 = never reached a send)
        self.queue_enter: float = t0  # stamped by the shard pump at queue put
        self.lane_enter: float = 0.0  # stamped by Dispatcher.submit
        self.handed_off = False  # True once a Notification carries this trace
        self.spans: List[tuple] = []
        self.process: Optional[str] = None  # origin worker (imported traces)

    def add_span(self, stage: str, start: float, end: float) -> None:
        self.spans.append((stage, start, end))

    # -- reading -----------------------------------------------------------

    def duration_seconds(self) -> Optional[float]:
        if self.end is None:
            return None
        return self.end - self.t0

    def stage_durations(self) -> Dict[str, float]:
        """Seconds per stage (summed across repeats — a retried POST adds
        a second ``post`` span)."""
        out: Dict[str, float] = {}
        for stage, start, end in list(self.spans):
            out[stage] = out.get(stage, 0.0) + (end - start)
        return out

    def slowest_stage(self) -> Optional[str]:
        durations = self.stage_durations()
        if not durations:
            return None
        return max(durations, key=durations.get)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready view: stage offsets/durations in ms relative to the
        watch-read stamp (``t0``), newest consumers first at /debug/trace."""
        spans = [
            {
                "stage": stage,
                "start_ms": round(1e3 * (start - self.t0), 3),
                "duration_ms": round(1e3 * (end - start), 3),
            }
            for stage, start, end in list(self.spans)
        ]
        total = self.duration_seconds()
        out = {
            "trace_id": self.trace_id,
            "uid": self.uid,
            "name": self.name,
            "namespace": self.namespace,
            "event_type": self.event_type,
            "kind": self.kind,
            "shard": self.shard,
            "lane": self.lane,
            "sampled_by": self.sampled_by,
            "outcome": self.outcome,
            "anomaly": self.anomaly,
            "attempts": self.attempts,
            "watch_to_notify_ms": round(1e3 * total, 3) if total is not None else None,
            "slowest_stage": self.slowest_stage(),
            "spans": spans,
        }
        if self.cluster is not None:
            # joined cross-cluster journeys only; a local entry keeps its shape
            out["cluster"] = self.cluster
        if self.process is not None:
            # only traces imported over the process pool's stats frame
            # carry their origin worker; local entries keep their shape
            out["process"] = self.process
        return out


def wire_trace(trace: "Trace") -> Dict[str, Any]:
    """The compact wire form of a sampled journey, the serve wire's
    negotiated per-frame ``trace`` field (``?trace=1``): its identity and the
    spans stamped so far, as ``[stage, start_s, end_s]`` offsets from the
    journey's origin (``t0``; same-host monotonic differences). Built at
    encode time, so a span stamped after the publish still rides the wire."""
    t0 = trace.t0
    return {
        "id": trace.trace_id,
        "uid": trace.uid,
        "spans": [[stage, round(start - t0, 6), round(end - t0, 6)] for stage, start, end in list(trace.spans)],
    }


def export_trace(trace: "Trace") -> Dict[str, Any]:
    """The process pool's stats-frame form of a completed worker trace: the
    compact ``wire_trace`` spans plus the terminal metadata the parent ring
    needs to answer ``/debug/trace`` (outcome, anomaly verdict, kind,
    duration). Span offsets stay worker-monotonic differences, never
    compared across the process boundary."""
    out = wire_trace(trace)
    duration = trace.duration_seconds()
    out.update(
        name=trace.name,
        event_type=trace.event_type,
        kind=trace.kind,
        shard=trace.shard,
        sampled_by=trace.sampled_by,
        outcome=trace.outcome,
        anomaly=trace.anomaly,
        duration=round(duration, 6) if duration is not None else None,
    )
    return out


def trace_from_wire(wire: Dict, *, process: Optional[str] = None) -> Trace:
    """Rebuild an ``export_trace`` dict (read off a worker's stats frame) as
    a parent-ring ``Trace`` at origin ``t0=0.0`` with the exported span
    offsets, carrying the origin worker in ``process``."""
    trace = Trace(
        str(wire.get("id") or new_trace_id()),
        uid=str(wire.get("uid") or ""),
        name=str(wire.get("name") or ""),
        event_type=str(wire.get("event_type") or ""),
        t0=0.0,
        shard=wire.get("shard"),
        sampled_by=str(wire.get("sampled_by") or "head"),
    )
    trace.kind = str(wire.get("kind") or "pod")
    trace.process = process
    for span in wire.get("spans") or ():
        try:
            stage, start, end = span
            trace.add_span(str(stage), float(start), float(end))
        except (TypeError, ValueError):
            continue
    trace.outcome = wire.get("outcome")
    trace.anomaly = bool(wire.get("anomaly"))
    duration = wire.get("duration")
    if duration is not None:
        trace.end = float(duration)
    elif trace.spans:
        trace.end = max(end for _stage, _start, end in trace.spans)
    return trace


class TraceSampler:
    """Head-based 1-in-N sampler, deterministic by arrival index.

    ``rate: N`` samples the 1st, (N+1)th, (2N+1)th… pod event this sampler
    sees; ``rate <= 1`` samples everything, ``rate == 0`` disables head
    sampling (anomaly traces still record). The counter bump is a plain
    int add under the GIL — shard pumps racing it can skew WHICH events
    are sampled, never crash or lock; per-thread determinism is exact when
    one thread feeds one sampler (each shard pump sees an ordered stream).
    """

    __slots__ = ("rate", "_n")

    def __init__(self, rate: int = 256):
        self.rate = max(0, int(rate))
        self._n = -1

    def sample(self) -> bool:
        if self.rate == 0:
            return False
        if self.rate <= 1:
            return True
        self._n += 1
        return self._n % self.rate == 0


class TraceRing:
    """Bounded ring of completed traces, newest-first on read.

    Stores ``Trace`` objects (not dicts): spans stamped AFTER finish —
    the pipeline span lands after the sink call it encloses returns —
    still show up at snapshot time.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def record(self, trace: Trace) -> None:
        with self._lock:
            self._ring.append(trace)

    def snapshot(
        self,
        n: Optional[int] = None,
        *,
        uid: Optional[str] = None,
        slowest: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """Newest-first dicts of the last ``n`` matching traces.

        ``uid`` filters to one pod's journeys; ``slowest`` filters to
        traces whose dominant stage is the named one (the "show me every
        event that spent its time waiting on a connection" query).
        """
        if n is not None and n <= 0:
            return []
        with self._lock:
            items = list(self._ring)
        items.reverse()
        out = []
        for trace in items:
            if uid is not None and trace.uid != uid:
                continue
            entry = trace.to_dict()
            if slowest is not None and entry["slowest_stage"] != slowest:
                continue
            out.append(entry)
            if n is not None and len(out) >= n:
                break
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# process-unique trace-id stream: an 8-hex process prefix (restart-safe
# correlation across log shippers) + a monotonic counter
_ID_PREFIX = f"{(os.getpid() & 0xFFFF):04x}{int(time.time()) & 0xFFFF:04x}"
_ID_COUNTER = itertools.count(1)


def new_trace_id() -> str:
    return f"{_ID_PREFIX}-{next(_ID_COUNTER):08x}"


class Tracer:
    """Facade the planes share: sampling decision, anomaly capture,
    completion accounting (ring + per-stage histograms + log line)."""

    def __init__(
        self,
        *,
        sample_rate: int = 256,
        ring_size: int = 256,
        metrics=None,  # metrics.MetricsRegistry, optional
        enabled: bool = True,
        export_buffer=None,  # bounded deque; a reader process's export
    ):
        self.enabled = enabled
        self.sample_rate = sample_rate
        self.sampler = TraceSampler(sample_rate)
        self.ring = TraceRing(ring_size)
        self.metrics = metrics
        # in a reader process every finished trace also lands here as its
        # export_trace() dict, drained onto the pipe by the stats loop; a
        # deque(maxlen=N) keeps the newest
        self.export_buffer = export_buffer

    # -- head sampling (ingest hot path) -----------------------------------

    def maybe_start(self, event, shard: Optional[int] = None) -> Optional[Trace]:
        """Sampling decision for one watch event, made ONCE at the head.

        The unsampled path is the 30k events/s steady state: one branch +
        one counter bump, no allocation, no lock, nothing written to the
        event. BOOKMARK/ERROR/PREFILTERED frames never sample — they are
        not pod journeys and would dilute the budget. (The production pump,
        watch/sharded.py, INLINES this check-and-count and calls ``start``
        only on the sampled 1/N — a call per event is already 2% of the
        event budget.)
        """
        if not self.enabled:
            return None
        if event.type not in ("ADDED", "MODIFIED", "DELETED"):
            return None
        if not self.sampler.sample():
            return None
        return self.start(event, shard)

    def start(self, event, shard: Optional[int] = None) -> Trace:
        """Build the trace for an event the CALLER already decided to
        sample (the pump's inlined head sampler, or rate<=1 paths)."""
        meta = (event.pod or {}).get("metadata") or {}
        return Trace(
            new_trace_id(),
            uid=meta.get("uid", ""),
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            event_type=event.type,
            t0=event.received_monotonic,
            shard=shard,
        )

    # -- anomaly capture (always-sample) -----------------------------------

    def start_anomaly(
        self,
        *,
        uid: str = "",
        name: str = "",
        kind: str = "pod",
        t0: float = 0.0,
    ) -> Optional[Trace]:
        """A trace for an event whose journey is ending anomalously and
        that head sampling skipped. Minimal by construction — stamped
        after the fact, it can carry only the receive stamp and the
        terminal site — but it guarantees /debug/trace answers for every
        drop/abort, not just the sampled 1/N."""
        if not self.enabled:
            return None
        trace = Trace(
            new_trace_id(), uid=uid, name=name, t0=t0, sampled_by="anomaly"
        )
        trace.kind = kind
        return trace

    # -- completion --------------------------------------------------------

    def finish(self, trace: Trace, outcome: str, *, end: Optional[float] = None) -> None:
        """Terminal accounting: close the root span, classify, ring it,
        feed per-stage histograms, and emit the correlation log line.
        Idempotent — the first terminal outcome wins (a pod notification
        and its slice sibling may both try to close the same trace)."""
        if trace.outcome is not None:
            return
        trace.outcome = outcome
        trace.end = end if end is not None else time.monotonic()
        trace.anomaly = outcome in ANOMALY_OUTCOMES or trace.sampled_by == "anomaly"
        self.ring.record(trace)
        if self.export_buffer is not None:
            self.export_buffer.append(export_trace(trace))
        metrics = self.metrics
        if metrics is not None:
            metrics.counter("trace_completed").inc()
            if trace.anomaly:
                metrics.counter("trace_anomalies").inc()
            # per-stage latency attribution (sampled population): the
            # registry answers "which stage grew" without a trace dump
            for stage, seconds in trace.stage_durations().items():
                metrics.histogram(f"trace_stage_{stage}").record(seconds)
            # the metric that actually matters for a pod-slice watcher:
            # watch-observed -> notify-delivered, over the sampled
            # population. Only clean sends with a real receive stamp —
            # an after-the-fact anomaly trace may carry t0=0.0, and a
            # drop's "latency" is not a delivery latency.
            if outcome == "sent" and trace.t0 > 0.0:
                metrics.histogram("watch_to_notify_seconds").record(
                    trace.end - trace.t0
                )
        # structured correlation line: trace_id rides the log record so
        # production JSON logs join against /debug/trace and /metrics.
        # DEBUG for clean sends (1/N of traffic is still a lot of lines),
        # INFO for anomalies (each one is an operator-relevant fact) —
        # EXCEPT overflow drops, which arrive at backlog rates under the
        # exact overload where per-drop INFO lines would make it worse
        # (the ring + trace_anomalies counter still record every one).
        anomaly_line = trace.anomaly and outcome != "dropped_overflow"
        # the %-args below build the full to_dict() payload + a second
        # stage_durations() pass — skip ALL of it unless the line will
        # actually emit (overflow-drop storms finish() at backlog rates)
        if anomaly_line or logger.isEnabledFor(logging.DEBUG):
            log = logger.info if anomaly_line else logger.debug
            log(
                "trace %s %s uid=%s outcome=%s watch_to_notify_ms=%s slowest=%s",
                trace.trace_id,
                trace.event_type or trace.kind,
                trace.uid or "-",
                outcome,
                trace.to_dict()["watch_to_notify_ms"],
                trace.slowest_stage(),
                extra={"trace_id": trace.trace_id},
            )


# -- cross-layer context (conn_borrow + attempt attribution) -----------------
#
# The HTTP client is deliberately trace-blind at the API level (its
# callers pass payload dicts, not Notifications). The dispatcher worker
# parks the in-flight traces in a thread-local around the send; the
# client's pool stamps conn_borrow spans / attempt counts into whatever
# is parked. No trace in flight -> one thread-local read, nothing else.
# A plain per-thread attempt counter rides alongside so the egress audit
# can report attempt counts for UNtraced sends too.

_current = threading.local()


def set_current_traces(traces) -> None:
    """Open a send window: park ``traces`` for the client's stamps and
    zero the attempt counter (one window per Dispatcher delivery)."""
    _current.traces = traces
    _current.attempts = 0


def clear_current_traces() -> None:
    _current.traces = ()


def current_traces():
    return getattr(_current, "traces", ())


def send_attempts() -> int:
    """POST attempts made inside the current send window (retries count)."""
    return getattr(_current, "attempts", 0)


def observe_conn_borrow(start: float, end: float) -> None:
    """Called by the notify client after a pool acquire; stamps the wait
    into every trace riding the current send (a batched POST carries
    many)."""
    for trace in current_traces():
        trace.add_span("conn_borrow", start, end)


def note_send_attempt() -> None:
    """Called by the notify client once per POST attempt (retries count)."""
    _current.attempts = getattr(_current, "attempts", 0) + 1
    for trace in current_traces():
        trace.attempts += 1
