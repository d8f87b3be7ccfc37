"""Fleet trace joining and diagnosis (the JAX package's
``trace/federation.py``): the federator's side of the tracing plane.

- **Joining.** Sampled deltas reach the federator carrying a compact
  ``trace`` field (negotiated with ``?trace=1``, ``serve/view.py``): the
  upstream journey's identity and its local spans as offsets from the
  origin. ``FleetTraceCollector`` adds the cross-cluster stages it can
  measure itself: ``serve_wire`` (upstream publish to federator receive,
  from the negotiated ``ts`` stamps), ``federate_merge`` (receive to the
  merged view's publish stamp) and ``global_serve`` (publish stamp to the
  fan-out hand-off), and records the joined journey under the upstream's
  trace id in the shared ``/debug/trace`` ring.
- **Attribution.** Every joined span also feeds the labelled
  ``trace_stage_seconds{stage=,upstream=}`` family; ``diagnosis()``
  (``GET /debug/trace/diagnosis``) rolls it into a per-upstream, per-stage
  report with the slowest stage named, plus a window since the previous
  read.
- **Stitching.** ``stitch(uid)`` returns one pod's fleet-wide journeys.
  With ``trace.federation.forward_spans`` off only the cross-cluster
  stages stay in memory (``max_joined``) and the upstream's local spans are
  fetched from its ``/debug/trace?uid=`` when asked; an unreachable
  upstream gives a partial answer (``partial: true``), never an error.

Cross-cluster spans compare wall clocks (skew shifts ``serve_wire``;
negative spans clamp at 0), and each upstream head-samples on its own, so
one pod's journeys are a per-upstream sample, not a ledger.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from k8s_watcher_tpu_torch.trace.trace import (
    ALL_STAGES,
    FEDERATE_MERGE_STAGE,
    FEDERATION_STAGES,
    GLOBAL_SERVE_STAGE,
    SERVE_WIRE_STAGE,
    Trace,
    new_trace_id,
)

logger = logging.getLogger(__name__)

#: the labeled-metric stage vocabulary — wire-supplied stage names
#: outside it never mint series (bounded cardinality)
_KNOWN_STAGES = frozenset(ALL_STAGES)


def _offset(origin: float, wall: float) -> float:
    """Wall stamp -> origin-relative offset, clamped at 0 (cross-host
    wall clocks may skew; a negative span would poison attribution)."""
    return round(max(0.0, wall - origin), 6)


class FleetTraceCollector:
    """Joins in-band upstream traces with the federator's own stamps.

    One instance per federator (built when ``trace.federation.enabled``),
    called from the per-upstream subscriber threads (federate/plane.py
    ``_on_batch``) — all mutation is lock-guarded or rides the thread-safe
    metrics/ring primitives.
    """

    def __init__(
        self,
        *,
        tracer,  # trace.Tracer — joined traces land in ITS ring
        metrics=None,  # metrics.MetricsRegistry, optional
        forward_spans: bool = True,
        max_joined: int = 256,
        max_label_sets: Optional[int] = None,
    ):
        self.tracer = tracer
        self.forward_spans = forward_spans
        self.max_joined = max(1, int(max_joined))
        self.metrics = metrics
        self._lock = threading.Lock()
        # newest-wins record of joined journeys for stitch()/diagnosis
        # examples — the SAME Trace objects the shared ring holds
        self._recent: deque = deque(maxlen=self.max_joined)
        # per-(upstream, stage) labeled histogram children, cached so the
        # fan-in hot path never re-enters the family's label lock
        self._children: Dict[tuple, Any] = {}
        # diagnosis window state: (upstream, stage) -> (count, sum) at
        # the previous diagnosis() read
        self._prev: Dict[tuple, tuple] = {}
        # lazy-stitch fetchers: upstream name -> callable(uid) -> traces
        # (FleetClient.debug_trace against the upstream serve plane)
        self._fetchers: Dict[str, Callable[[str], List[dict]]] = {}
        if metrics is not None:
            self._family = metrics.histogram("trace_stage_seconds")
            if max_label_sets is not None:
                # the (stage x upstream) dimension is bounded by CONFIG
                # (declared upstreams x the fixed stage vocabulary), so
                # widen the family's generic cardinality cap to fit it
                self._family.max_label_sets = max(
                    self._family.max_label_sets, max_label_sets
                )
            self._joined = metrics.counter("trace_joined")
            self._forwarded = metrics.counter("trace_spans_forwarded")
            # the unlabeled cross-cluster stage histograms (what the
            # health plane's trace collector and the SLO ring read),
            # resolved ONCE — the join path must not pay a registry
            # lock per stage per frame
            self._fed_stage_hist = {
                stage: metrics.histogram(f"trace_stage_{stage}")
                for stage in FEDERATION_STAGES
            }
        else:
            self._family = None
            self._joined = None
            self._forwarded = None
            self._fed_stage_hist = {}

    def register_fetcher(self, upstream: str, fetch: Callable[[str], List[dict]]) -> None:
        """Wire one upstream's lazy ``/debug/trace?uid=`` fetcher (the
        stitch fallback when spans are not kept in memory)."""
        self._fetchers[upstream] = fetch

    # -- the fan-in path (per-upstream subscriber threads) -----------------

    def note_receive(self, upstream: str, frames: List[dict], t_recv: float) -> None:
        """BEFORE the merge fold: rewrite each traced frame's ``trace``
        field into the form the MERGED delta republishes — the upstream's
        spans (dropped when ``forward_spans`` is off) plus this hop's
        ``serve_wire`` span and the origin cluster — so a second-tier
        federator joins the next hop without re-deriving anything. The
        dict is rebuilt, never mutated after, because the merged view
        journals it by reference.

        ``frames`` is the caller's PRE-FILTERED traced subset (one cheap
        ``"trace" in frame`` walk in federate/plane.py) — at 1/256
        sampling the fan-in hot path must pay per traced frame, never
        two extra full-batch walks."""
        for frame in frames:
            wt = frame.get("trace")
            ts = frame.get("ts")
            if not isinstance(wt, dict) or not ts:
                continue
            try:
                # EVERYTHING wire-derived parses inside the guard: a
                # malformed ts OR spans field (version skew, a hostile
                # peer — e.g. spans: 7, spans: [42]) skips this frame's
                # rewrite, never raises into the subscriber thread
                origin, pub = float(ts[0]), float(ts[1])
                spans: List[list] = []
                if self.forward_spans:
                    spans = [list(s) for s in (wt.get("spans") or ()) if len(s) == 3]
            except (TypeError, ValueError, IndexError):
                continue
            spans.append([
                SERVE_WIRE_STAGE,
                _offset(origin, pub),
                _offset(origin, t_recv),
            ])
            frame["trace"] = {
                "id": wt.get("id") or new_trace_id(),
                "uid": wt.get("uid") or "",
                # the ORIGIN cluster survives multi-hop federation: only
                # the first federator stamps it
                "cluster": wt.get("cluster") or upstream,
                "spans": spans,
            }

    def adopt(
        self,
        upstream: str,
        frames: List[dict],
        t_recv: float,
        t_pub: float,
        t_done: float,
    ) -> int:
        """AFTER the merge fold: close each traced frame's journey with
        ``federate_merge`` (receive → the merged view's publish stamp,
        ``t_pub`` ≈ the merged Delta's own ``pub_wall``) and
        ``global_serve`` (publish stamp → fan-out hand-off complete —
        the apply_batch fold + wakeup), record the JOINED trace into
        the shared /debug/trace ring, and feed the attribution
        histograms. ``frames`` is the same pre-filtered traced subset
        ``note_receive`` rewrote. Returns the number of journeys joined."""
        joined = 0
        forwarded = 0
        # hoisted out of the per-frame loop: the join path runs at the
        # sampled-delta rate and must stay tens of microseconds per frame
        metrics = self.metrics
        record_ring = self.tracer.ring.record
        fed_hist = self._fed_stage_hist
        debug = logger.isEnabledFor(logging.DEBUG)
        for frame in frames:
            wt = frame.get("trace")
            ts = frame.get("ts")
            if not isinstance(wt, dict) or not ts:
                continue
            try:
                # wire data is upstream-controlled: a malformed ts/span
                # (version skew, a hostile peer) must skip THIS journey,
                # never raise — an exception here would escape the
                # subscriber's handled error set and kill the upstream's
                # federation thread outright
                origin = float(ts[0])
                spans = [
                    (str(s[0]), float(s[1]), float(s[2]))
                    for s in (wt.get("spans") or ())
                    if len(s) == 3
                ]
            except (TypeError, ValueError, IndexError):
                continue
            spans.append((
                FEDERATE_MERGE_STAGE, _offset(origin, t_recv), _offset(origin, t_pub),
            ))
            spans.append((
                GLOBAL_SERVE_STAGE, _offset(origin, t_pub), _offset(origin, t_done),
            ))
            trace = Trace(wt.get("id") or new_trace_id(), uid=wt.get("uid") or "", t0=0.0)
            trace.cluster = wt.get("cluster") or upstream
            trace.event_type = frame.get("type") or ""
            trace.spans = list(spans)
            trace.outcome = "merged"
            trace.end = max(end for _, _, end in spans)
            record_ring(trace)
            with self._lock:
                self._recent.append(trace)
            joined += 1
            forwarded += max(0, len(spans) - 3)
            if metrics is not None:
                for stage, start, end in spans:
                    if stage not in _KNOWN_STAGES:
                        # stage names arrive verbatim off the wire: an
                        # unknown one (version skew / hostile upstream)
                        # must not mint labeled series — the family's
                        # cardinality bound is declared-upstreams x the
                        # FIXED vocabulary, and blowing it would raise
                        # into the fan-in path. The span still rides the
                        # joined trace in the ring.
                        continue
                    seconds = end - start
                    if seconds < 0.0:
                        seconds = 0.0
                    self._stage_child(upstream, stage).record(seconds)
                    # the unlabeled per-stage histograms the health
                    # plane's trace collector and the SLO plane read
                    # (cross-cluster stages only: the upstream-LOCAL
                    # stages were measured on another host and must
                    # not pollute this process's local stage series)
                    unlabeled = fed_hist.get(stage)
                    if unlabeled is not None:
                        unlabeled.record(seconds)
            # the federation-plane log↔trace correlation line: trace_id
            # rides the structured record (logging_setup.JsonFormatter)
            if debug:
                logger.debug(
                    "joined trace %s upstream=%s uid=%s stages=%d",
                    trace.trace_id, upstream, trace.uid or "-", len(spans),
                    extra={"trace_id": trace.trace_id},
                )
        if joined and self._joined is not None:
            self._joined.inc(joined)
            if self.forward_spans and forwarded:
                self._forwarded.inc(forwarded)
        return joined

    def _stage_child(self, upstream: str, stage: str):
        key = (upstream, stage)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._family.labels(stage=stage, upstream=upstream)
                    self._children[key] = child
        return child

    # -- query surfaces (status-server threads) ----------------------------

    def stitch(self, uid: str, *, n: int = 10) -> Dict[str, Any]:
        """The fleet-wide journeys for one pod, newest first.

        With ``forward_spans`` on, the joined ring entries already carry
        the upstream's local spans. With it off (or when an entry arrived
        spanless), the upstream's serve plane is queried lazily at
        ``/debug/trace?uid=`` and matching journeys (by trace id) are
        merged in. Any fetch failure degrades to a PARTIAL answer —
        ``partial: true`` plus the per-upstream error — never an
        exception (the route must never 500 on a dark upstream)."""
        with self._lock:
            recent = [t for t in reversed(self._recent) if t.uid == uid][:max(1, n)]
        journeys = [t.to_dict() for t in recent]
        out: Dict[str, Any] = {
            "uid": uid,
            "journeys": journeys,
            "forward_spans": self.forward_spans,
            "partial": False,
            "upstream_errors": {},
        }
        # journeys missing upstream-local spans (forward_spans off, or a
        # spanless upstream build) get the lazy fetch
        local_stages = set(ALL_STAGES) - set(FEDERATION_STAGES)
        needy = [
            j for j in journeys
            if not any(s["stage"] in local_stages for s in j["spans"])
        ]
        if not needy:
            return out
        fetched: Dict[str, Optional[Dict[str, list]]] = {}
        for journey in needy:
            cluster = journey.get("cluster")
            if not cluster or cluster not in self._fetchers:
                # no fetch path for this journey's ORIGIN cluster (e.g.
                # a two-tier topology where the origin sits behind a mid
                # federator that is our direct upstream): the answer is
                # incomplete and must SAY so — the degrade-to-partial
                # contract, not a silent truncation
                out["partial"] = True
                out["upstream_errors"][cluster or "<unknown>"] = (
                    "no fetcher registered (origin is not a direct upstream)"
                )
                continue
            if cluster not in fetched:
                try:
                    remote = self._fetchers[cluster](uid)
                    fetched[cluster] = {
                        t.get("trace_id"): t.get("spans") or [] for t in remote
                    }
                except Exception as exc:  # noqa: BLE001 — a dark upstream
                    # degrades the stitch, never the route
                    fetched[cluster] = None
                    out["partial"] = True
                    out["upstream_errors"][cluster] = f"{type(exc).__name__}: {exc}"
            remote_spans = fetched.get(cluster)
            if remote_spans is None:
                continue
            spans = remote_spans.get(journey["trace_id"])
            if spans:
                # upstream spans FIRST (they precede the wire hop); the
                # federation stages keep their measured offsets
                journey["spans"] = list(spans) + journey["spans"]
                journey["stitched_from"] = cluster
        return out

    def diagnosis(self) -> Dict[str, Any]:
        """``GET /debug/trace/diagnosis``: where is propagation time
        going, per upstream per stage — from the labeled cumulative
        histograms (totals) plus the delta window since the previous
        diagnosis read (cum count/sum differencing). ``slowest_stage``
        attributes by total accumulated seconds; ``share`` is that
        stage's fraction of the upstream's total."""
        with self._lock:
            children = dict(self._children)
            joined = len(self._recent)
        upstreams: Dict[str, Dict[str, Any]] = {}
        for (upstream, stage), child in children.items():
            _pairs, count, total = child.buckets()
            with self._lock:
                # two concurrent scrapes must not both claim the same
                # window delta (or interleave one's count with the
                # other's sum into a nonsense mean)
                prev_count, prev_sum = self._prev.get((upstream, stage), (0, 0.0))
                self._prev[(upstream, stage)] = (count, total)
            if count == 0:
                continue
            entry = upstreams.setdefault(upstream, {"stages": {}})
            window_count = count - prev_count
            entry["stages"][stage] = {
                "count": count,
                "total_ms": round(1e3 * total, 3),
                "mean_ms": round(1e3 * total / count, 3),
                "p99_ms": round(1e3 * (child.quantile(0.99) or 0.0), 3),
                "window": {
                    "count": window_count,
                    "mean_ms": (
                        round(1e3 * (total - prev_sum) / window_count, 3)
                        if window_count > 0 else None
                    ),
                },
            }
        for entry in upstreams.values():
            stages = entry["stages"]
            grand_total = sum(s["total_ms"] for s in stages.values())
            slowest = max(stages, key=lambda k: stages[k]["total_ms"])
            entry["slowest_stage"] = slowest
            entry["slowest_share"] = (
                round(stages[slowest]["total_ms"] / grand_total, 3)
                if grand_total > 0 else None
            )
            entry["total_ms"] = round(grand_total, 3)
        return {
            "upstreams": upstreams,
            "joined_traces": joined,
            "forward_spans": self.forward_spans,
            "stages": list(ALL_STAGES),
        }
