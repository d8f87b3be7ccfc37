"""Straggler & node-health detection: peer-relative signal fusion plus a
config-declared escalation state machine (the JAX package's
``health/detector.py``).

In a large training fleet the failure that silently eats goodput is the
slow-but-not-dead machine: an absolute threshold either misses it (set
loose for fabric jitter) or cordons healthy nodes during fleet-wide events
(set tight). So scoring is PEER-RELATIVE: a node is a straggler relative to
its slice peers right now, so a fleet-wide slowdown moves the whole peer
group together and implicates nobody, while one lagging host sticks out
however the baseline drifts. The signals are ones the platform already
collects, not new probes.

This module is the fusion + verdict core; ``health/plane.py`` owns signal
collection and the tick thread. Per tick the detector receives:

- ``Observation``\\ s — one numeric reading per (subject, metric), each
  carrying an optional *peer group* (nodes of one slice, the upstream
  set). Within a group the reading becomes a robust z-score: deviation
  from the group median in MAD units (median absolute deviation — one
  outlier cannot inflate its own denominator the way a stddev would).
  Groups smaller than three members score nothing: a single-node slice
  has no peers and is NEVER a straggler, and with two members the
  deviation *is* the scale, so neither side can be told from the other.
- direct **evidence** — already-attributed findings (the probe plane's
  suspect-link triangulation via ``remediate/policy.py``'s extraction),
  which are suspicious on their own.
- For subjects that legitimately lack a peer group (a two-upstream
  federation; trace stages), ``probe/trend.py``'s ``TrendTracker``
  provides the rolling self-baseline: a frozen healthy anchor vs the
  recent median. Node/slice subjects deliberately never use the trend
  fallback — a lone node judged against its own past re-creates exactly
  the absolute-threshold failure mode peers exist to avoid.

Verdicts walk ``healthy → suspect → confirmed → remediating`` with the
same hysteresis discipline as ``remediate/policy.py``: ``confirm_cycles``
CONSECUTIVE suspicious ticks escalate, ONE clean tick resets a suspect,
and ``decay_cycles`` consecutive clean ticks de-escalate a confirmed
subject. **Absence of signal is not cleanliness**: a subject nobody
measured this tick keeps its state frozen — silence from a dead signal
plane must never launder a confirmed straggler back to healthy.

Sources tick at different cadences (the probe reports every 30 s, the
phase scan every tick), so suspicion is **latched per source**: a
source's last verdict for a subject stands until that SAME source
observes the subject again. A latched-suspicious subject holds its state
(no decay — the probe's implication is not answered by a fast clean
phase reading) but also does not advance its streak (only a source
actually re-observing the fault counts toward confirmation, mirroring
the remediation policy's per-report counting). Clean observation from
the implicating source clears its latch.

Confirmed NODE verdicts feed the existing budgeted ``NodeActuator``
(dry-run by default; cooldown, hourly rate limit, quarantine budget all
apply). Other subject kinds (slice, upstream, stage) stop at ``confirmed``
— there is nothing to cordon — and surface via /debug/health, metrics and
the /healthz body fold.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import statistics
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from k8s_watcher_tpu_torch.probe.trend import TrendTracker

logger = logging.getLogger(__name__)

HEALTHY = "healthy"
SUSPECT = "suspect"
CONFIRMED = "confirmed"
REMEDIATING = "remediating"
HEALTH_STATES = (HEALTHY, SUSPECT, CONFIRMED, REMEDIATING)

#: subject kinds whose suspicion may come from the TrendTracker fallback
#: when no peer group of >= MIN_PEER_GROUP exists (see module docstring:
#: nodes/slices are peer-relative ONLY)
TREND_FALLBACK_KINDS = ("upstream", "stage")

#: smallest peer group that can score: below this there is no "peer
#: consensus" to deviate from (1 member: no peers at all; 2 members: the
#: deviation is the scale, so the z-score is a constant ~0.67 for both)
MIN_PEER_GROUP = 3


@dataclasses.dataclass
class Observation:
    """One numeric reading for one subject this tick."""

    kind: str  # "node" | "slice" | "upstream" | "stage"
    name: str
    metric: str  # e.g. "phase_latency_seconds"
    value: float
    # peer-group id; subjects sharing (group, metric) are scored against
    # each other. None = no peer group (trend fallback where allowed).
    group: Optional[str] = None
    # absolute floor on the z denominator: keeps trivial absolute spreads
    # (every peer within 50 ms) from minting huge z-scores out of noise
    floor: float = 0.0
    # which signal plane produced this reading — the per-source suspicion
    # latch keys off it (see module docstring)
    source: str = "default"

    @property
    def subject(self) -> Tuple[str, str]:
        return (self.kind, self.name)


def robust_peer_z(
    values: Dict[Any, float], *, floor: float = 0.0
) -> Dict[Any, float]:
    """Peer-relative robust z-scores: ``(x - median) / scale`` where scale
    is the MAD (scaled to stddev-equivalence by 1.4826), floored by 10% of
    the median magnitude and by ``floor`` so identical-peer groups (MAD 0)
    and trivially-small absolute spreads stay un-alarmable. Groups with
    fewer than ``MIN_PEER_GROUP`` members return ``{}`` (no peers, no
    straggler — see module docstring)."""
    if len(values) < MIN_PEER_GROUP:
        return {}
    vals = list(values.values())
    med = statistics.median(vals)
    mad = statistics.median([abs(v - med) for v in vals])
    scale = max(1.4826 * mad, 0.1 * abs(med), floor, 1e-9)
    return {name: (v - med) / scale for name, v in values.items()}


class _SubjectState:
    __slots__ = (
        "state", "streak", "clean", "severity", "score", "reasons",
        "signals", "last_observed_tick", "escalations", "latches",
    )

    def __init__(self):
        self.state = HEALTHY
        self.streak = 0  # consecutive suspicious ticks
        self.clean = 0  # consecutive clean ticks
        self.severity = 0.0
        self.score = 1.0
        self.reasons: List[str] = []
        self.signals: Dict[str, Dict[str, Any]] = {}
        self.last_observed_tick = 0
        self.escalations = 0
        # per-source suspicion latch: source -> last severity that source
        # reported for this subject (>= 1.0 = latched suspicious). Stands
        # until the SAME source observes the subject again.
        self.latches: Dict[str, float] = {}


class HealthDetector:
    """The fusion + escalation core (see module docstring).

    Thread-contract: ``tick`` is called from one thread (the plane's tick
    loop); ``snapshot``/``health`` may race it from HTTP handlers — the
    subject table is guarded by one lock.
    """

    #: default cap on distinct node label values emitted to the
    #: node_health_score / health_state gauge families — past it, new
    #: nodes still get verdicts but no labeled series (bounded
    #: cardinality; the snapshot carries everything)
    MAX_LABELED_NODES = 64

    #: HEALTHY subjects unobserved for this many ticks are forgotten —
    #: nodes leave fleets (drain, autoscale); without a TTL the subject
    #: table and /debug/health grow one ghost per departed machine
    #: forever. Non-healthy subjects are deliberately immortal: a
    #: confirmed straggler must never be garbage-collected to healthy.
    SUBJECT_TTL_TICKS = 720

    def __init__(
        self,
        *,
        suspect_z: float = 4.0,
        confirm_cycles: int = 3,
        decay_cycles: int = 2,
        actuator=None,  # remediate.NodeActuator (dry-run fences apply)
        metrics=None,
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        trend: Optional[TrendTracker] = None,
        max_labeled_nodes: Optional[int] = None,
    ):
        if suspect_z <= 0:
            raise ValueError("suspect_z must be > 0")
        if confirm_cycles < 1 or decay_cycles < 1:
            raise ValueError("confirm_cycles and decay_cycles must be >= 1")
        self.suspect_z = suspect_z
        self.confirm_cycles = confirm_cycles
        self.decay_cycles = decay_cycles
        self.actuator = actuator
        self.metrics = metrics
        self.sink = sink
        # the one rolling-baseline implementation (probe/trend.py): frozen
        # healthy anchor vs recent median, alert on sustained rise/drop
        self.trend = trend or TrendTracker(
            window=12, recent=3, drop_factor=0.6, rise_factor=2.5, min_history=5
        )
        self.max_labeled_nodes = (
            max_labeled_nodes if max_labeled_nodes is not None else self.MAX_LABELED_NODES
        )
        self._lock = threading.Lock()
        self._subjects: Dict[Tuple[str, str], _SubjectState] = {}
        self._ticks = 0
        self._actions: collections.deque = collections.deque(maxlen=32)
        self._labeled_nodes: set = set()
        self._label_overflow_logged = False
        if metrics is not None:
            from k8s_watcher_tpu_torch.metrics import MAX_LABEL_SETS

            self._score_gauge = metrics.gauge("node_health_score")
            self._score_gauge.max_label_sets = max(
                MAX_LABEL_SETS, self.max_labeled_nodes + 8
            )
            self._state_gauge = metrics.gauge("health_state")
            # one child per (node, state) pair
            self._state_gauge.max_label_sets = max(
                MAX_LABEL_SETS, (self.max_labeled_nodes + 8) * len(HEALTH_STATES)
            )
            self._suspect_gauge = metrics.gauge("health_suspect_subjects")
            self._confirmed_gauge = metrics.gauge("health_confirmed_subjects")
            self._ticks_counter = metrics.counter("health_ticks")
            self._escalations_counter = metrics.counter("health_escalations")
            self._deescalations_counter = metrics.counter("health_deescalations")
        else:
            self._score_gauge = self._state_gauge = None
            self._suspect_gauge = self._confirmed_gauge = None
            self._ticks_counter = self._escalations_counter = None
            self._deescalations_counter = None

    # -- scoring -----------------------------------------------------------

    def _fold_signals(
        self,
        observations: List[Observation],
        evidence: Dict[Tuple[str, str], List[str]],
        evidence_source: str,
    ) -> Tuple[Dict[Tuple[str, str], Dict[str, float]], Dict[Tuple[str, str], List[str]],
               Dict[Tuple[str, str], Dict[str, Dict[str, Any]]]]:
        """``(per-source severity, reasons, signals)`` per subject.
        Severity >= 1.0 means suspicious (z at/over suspect_z, a trend
        alert where the fallback applies, or direct evidence)."""
        groups: Dict[Tuple[Optional[str], str], Dict[Tuple[str, str], Observation]] = {}
        for obs in observations:
            if obs.group is not None:
                groups.setdefault((obs.group, obs.metric), {})[obs.subject] = obs
        z_scores: Dict[Tuple[Tuple[str, str], str], float] = {}
        peer_scored: set = set()  # (subject, metric) pairs with a real peer group
        for (_group, metric), members in groups.items():
            floor = max(m.floor for m in members.values())
            zs = robust_peer_z(
                {subj: m.value for subj, m in members.items()}, floor=floor
            )
            for subj, z in zs.items():
                z_scores[(subj, metric)] = z
                peer_scored.add((subj, metric))
        severity: Dict[Tuple[str, str], Dict[str, float]] = {}
        reasons: Dict[Tuple[str, str], List[str]] = {}
        signals: Dict[Tuple[str, str], Dict[str, Dict[str, Any]]] = {}

        def bump(subj, source, sev, reason=None):
            by_source = severity.setdefault(subj, {})
            by_source[source] = max(by_source.get(source, 0.0), sev)
            if reason is not None and sev >= 1.0:
                reasons.setdefault(subj, []).append(reason)

        for obs in observations:
            subj = obs.subject
            severity.setdefault(subj, {}).setdefault(obs.source, 0.0)
            detail: Dict[str, Any] = {"value": round(obs.value, 4)}
            z = z_scores.get((subj, obs.metric))
            if z is not None:
                detail["peer_z"] = round(z, 2)
                if z > 0:
                    bump(
                        subj, obs.source, z / self.suspect_z,
                        f"{obs.metric}: peer z={z:.1f} (suspect_z={self.suspect_z:g}, "
                        f"value={obs.value:.3g})",
                    )
            # trend fold: every reading shapes/judges the rolling baseline,
            # but suspicion from a trend alert is restricted to kinds with
            # no peer alternative — and a peer-suspicious reading must not
            # poison its own anchor (contribute only while clean)
            alert = self.trend.observe(
                f"{obs.kind}/{obs.name}/{obs.metric}", obs.value,
                higher_is_better=False,
                contribute_baseline=(z is None or z < self.suspect_z),
            )
            if alert is not None:
                detail["trend_ratio"] = round(alert.ratio, 2)
                if (
                    obs.kind in TREND_FALLBACK_KINDS
                    and (subj, obs.metric) not in peer_scored
                ):
                    bump(
                        subj, obs.source, alert.ratio / self.trend.rise_factor,
                        f"{obs.metric}: {alert.ratio:.1f}x its healthy baseline "
                        f"({alert.recent:.3g} vs anchor {alert.baseline:.3g})",
                    )
            signals.setdefault(subj, {})[obs.metric] = detail
        for subj, items in evidence.items():
            bump(subj, evidence_source, 1.0)
            reasons.setdefault(subj, []).extend(items)
            signals.setdefault(subj, {}).setdefault("evidence", {})["count"] = len(items)
        return severity, reasons, signals

    # -- the tick ----------------------------------------------------------

    def tick(
        self,
        observations: List[Observation],
        evidence: Optional[Dict[Tuple[str, str], List[str]]] = None,
        evidence_source: str = "probe",
    ) -> Dict[str, Any]:
        """Fold one tick's signals; advance every OBSERVED subject's state
        (unobserved subjects freeze — no signal is not healthy). Returns a
        summary of transitions and actions taken."""
        evidence = evidence or {}
        severity, reasons, signals = self._fold_signals(
            observations, evidence, evidence_source
        )
        escalated: List[Tuple[str, str]] = []
        deescalated: List[Tuple[str, str]] = []
        confirm_nodes: List[Tuple[str, str]] = []  # (node, reason)
        with self._lock:
            self._ticks += 1
            tick_no = self._ticks
            for subj, by_source in severity.items():
                rec = self._subjects.get(subj)
                if rec is None:
                    rec = self._subjects[subj] = _SubjectState()
                # refresh this tick's sources into the per-source latches;
                # sources NOT reporting this tick keep their last verdict
                rec.latches.update(by_source)
                fresh_suspicious = any(s >= 1.0 for s in by_source.values())
                latched = any(
                    s >= 1.0 for source, s in rec.latches.items()
                    if source not in by_source
                )
                rec.severity = max([*rec.latches.values(), 0.0])
                rec.score = round(1.0 / (1.0 + max(0.0, rec.severity)), 4)
                rec.signals = signals.get(subj, {})
                rec.last_observed_tick = tick_no
                if fresh_suspicious:
                    rec.reasons = reasons.get(subj, [])[:8]
                    rec.clean = 0
                    rec.streak += 1
                    if rec.state == HEALTHY:
                        rec.state = SUSPECT
                    if rec.state == SUSPECT and rec.streak >= self.confirm_cycles:
                        rec.state = CONFIRMED
                        rec.escalations += 1
                        escalated.append(subj)
                        if subj[0] == "node":
                            confirm_nodes.append(
                                (subj[1],
                                 f"health detector: suspicious in {rec.streak} "
                                 f"consecutive ticks: " + "; ".join(rec.reasons)[:400])
                            )
                    elif (
                        subj[0] == "node"
                        and rec.state == CONFIRMED
                        and rec.streak % self.confirm_cycles == 0
                    ):
                        # the first attempt was refused (cooldown/rate/
                        # budget fence) — a node that STAYS suspicious
                        # keeps asking at the confirmation cadence, like
                        # the remediation policy re-earns per report; a
                        # success moves it to remediating and stops this
                        confirm_nodes.append(
                            (subj[1],
                             f"health detector: still suspicious after "
                             f"{rec.streak} consecutive ticks (earlier "
                             f"quarantine refused): " + "; ".join(rec.reasons)[:400])
                        )
                elif latched:
                    # a silent source's suspicion stands: hold the state —
                    # neither a confirmation step (only the implicating
                    # source re-observing counts) nor a clean step (a fast
                    # clean phase reading does not answer a probe finding)
                    continue
                else:
                    rec.streak = 0
                    rec.clean += 1
                    if rec.state == SUSPECT:
                        # one clean cycle resets: a transient outlier that
                        # clears must not accumulate toward a cordon
                        rec.state = HEALTHY
                        rec.reasons = []
                    elif rec.state in (CONFIRMED, REMEDIATING) and rec.clean >= self.decay_cycles:
                        rec.state = HEALTHY
                        rec.reasons = []
                        deescalated.append(subj)
            # forget long-unobserved healthy subjects (departed nodes);
            # amortized: one sweep per 64 ticks
            if tick_no % 64 == 0:
                for subj in [
                    s for s, r in self._subjects.items()
                    if r.state == HEALTHY
                    and tick_no - r.last_observed_tick > self.SUBJECT_TTL_TICKS
                ]:
                    del self._subjects[subj]
        # actuate OUTSIDE the lock: a slow apiserver PATCH must not block
        # snapshot()/health() readers for its duration
        actions = []
        for node, reason in confirm_nodes:
            actions.append(self._actuate(node, reason))
        if escalated or deescalated:
            for subj in escalated:
                logger.warning(
                    "Health plane: %s/%s CONFIRMED unhealthy (%s)",
                    subj[0], subj[1], "; ".join(reasons.get(subj, []))[:300],
                )
            for subj in deescalated:
                logger.info(
                    "Health plane: %s/%s de-escalated to healthy after %d clean tick(s)",
                    subj[0], subj[1], self.decay_cycles,
                )
            if self._escalations_counter is not None:
                if escalated:
                    self._escalations_counter.inc(len(escalated))
                if deescalated:
                    self._deescalations_counter.inc(len(deescalated))
            self._notify(escalated, deescalated, reasons, actions)
        self._sync_metrics()
        return {
            "tick": tick_no,
            "observed": len(severity),
            "escalated": [f"{k}/{n}" for k, n in escalated],
            "deescalated": [f"{k}/{n}" for k, n in deescalated],
            "actions": [a.to_dict() for a in actions if a is not None],
        }

    def _actuate(self, node: str, reason: str):
        """Hand one confirmed node to the budgeted actuator (dry-run by
        default; its cooldown/rate/budget fences all apply). A successful
        (or would-be, in dry-run) quarantine moves the node to
        ``remediating``; a refusal leaves it ``confirmed`` — the fences
        exist precisely to stop a detector bug from mass-cordoning."""
        if self.actuator is None:
            return None
        record = self.actuator.quarantine(node, reason)
        with self._lock:
            self._actions.append(record.to_dict())
            rec = self._subjects.get(("node", node))
            if rec is not None and record.ok and rec.state == CONFIRMED:
                rec.state = REMEDIATING
        return record

    def release(self, node: str, reason: str = "operator release") -> Dict[str, Any]:
        """Manual de-escalation (an operator's release):
        reset the node's detector state AND drive the actuator's release
        (uncordon + untaint) when one is wired."""
        with self._lock:
            rec = self._subjects.get(("node", node))
            if rec is not None:
                rec.state = HEALTHY
                rec.streak = rec.clean = 0
                rec.reasons = []
                # clear the per-source latches too: a released node must
                # not stay severity-degraded (and state-frozen on the
                # latched hold path) behind a probe implication the
                # operator just overrode
                rec.latches = {}
                rec.severity = 0.0
                rec.score = 1.0
        if self.actuator is None:
            return {"node": node, "released": True, "actuator": None}
        record = self.actuator.release(node, reason)
        with self._lock:
            self._actions.append(record.to_dict())
        return {"node": node, "released": record.ok, "actuator": record.to_dict()}

    def _notify(self, escalated, deescalated, reasons, actions) -> None:
        if self.sink is None or not (escalated or deescalated):
            return
        from datetime import datetime, timezone

        payload = {
            "event_type": "TPU_HEALTH",
            "escalated": [
                {"kind": k, "name": n, "reasons": reasons.get((k, n), [])[:8]}
                for k, n in escalated
            ],
            "deescalated": [{"kind": k, "name": n} for k, n in deescalated],
            "actions": [a.to_dict() for a in actions if a is not None],
            "event_timestamp": datetime.now(timezone.utc).isoformat(),
        }
        try:
            self.sink(payload)
        except Exception as exc:  # noqa: BLE001 — reporting must not kill the tick
            logger.error("Health notification failed: %s", exc)

    # -- metrics / surfaces ------------------------------------------------

    def _sync_metrics(self) -> None:
        if self.metrics is None:
            return
        with self._lock:
            subjects = {s: (r.state, r.score) for s, r in self._subjects.items()}
        suspect = sum(1 for st, _ in subjects.values() if st == SUSPECT)
        confirmed = sum(
            1 for st, _ in subjects.values() if st in (CONFIRMED, REMEDIATING)
        )
        self._suspect_gauge.set(suspect)
        self._confirmed_gauge.set(confirmed)
        for (kind, name), (state, score) in subjects.items():
            if kind != "node":
                continue
            if name not in self._labeled_nodes:
                if len(self._labeled_nodes) >= self.max_labeled_nodes:
                    if not self._label_overflow_logged:
                        self._label_overflow_logged = True
                        logger.warning(
                            "Health plane: >%d distinct nodes — further nodes get "
                            "verdicts but no labeled node_health_score/health_state "
                            "series (bounded cardinality; /debug/health has all)",
                            self.max_labeled_nodes,
                        )
                    continue
                self._labeled_nodes.add(name)
            self._score_gauge.labels(node=name).set(score)
            for st in HEALTH_STATES:
                self._state_gauge.labels(node=name, state=st).set(
                    1.0 if st == state else 0.0
                )

    def snapshot(self) -> Dict[str, Any]:
        """The full ``/debug/health`` body."""
        with self._lock:
            subjects = {
                f"{kind}/{name}": {
                    "kind": kind,
                    "name": name,
                    "state": rec.state,
                    "score": rec.score,
                    "severity": round(rec.severity, 3),
                    "streak": rec.streak,
                    "clean": rec.clean,
                    "reasons": list(rec.reasons),
                    "signals": dict(rec.signals),
                    "last_observed_tick": rec.last_observed_tick,
                    "escalations": rec.escalations,
                }
                for (kind, name), rec in sorted(self._subjects.items())
            }
            actions = list(self._actions)
            ticks = self._ticks
        body: Dict[str, Any] = {
            "ticks": ticks,
            "suspect_z": self.suspect_z,
            "confirm_cycles": self.confirm_cycles,
            "decay_cycles": self.decay_cycles,
            "subjects": subjects,
            "actions": actions,
        }
        if self.actuator is not None:
            body["actuator"] = {
                "dry_run": self.actuator.dry_run,
                "quarantined_nodes": self.actuator.quarantined_nodes(),
            }
        return body

    def health(self) -> Dict[str, Any]:
        """The /healthz BODY fold: unhealthy while any subject is
        confirmed/remediating. Deliberately NOT the liveness verdict —
        restarting the watcher cannot fix a straggling machine, and a 503
        would crash-loop the very process holding the evidence."""
        with self._lock:
            by_state: Dict[str, List[str]] = {s: [] for s in HEALTH_STATES[1:]}
            for (kind, name), rec in sorted(self._subjects.items()):
                if rec.state != HEALTHY:
                    by_state[rec.state].append(f"{kind}/{name}")
        unhealthy = by_state[CONFIRMED] or by_state[REMEDIATING]
        return {
            "healthy": not unhealthy,
            "suspect": by_state[SUSPECT],
            "confirmed": by_state[CONFIRMED],
            "remediating": by_state[REMEDIATING],
        }
