"""Phase-delta detection.

The <1 s p50 north-star metric is about *phase changes* (BASELINE.md), so the
pipeline must know whether an event actually changed the pod's observable
state — raw MODIFIED events fire for every status write (heartbeats,
condition timestamps) and would both spam the notifier and poison the latency
metric. The reference had no delta detection at all (it forwarded every
event; SURVEY.md §7 step 2 calls this out as required capability).

State is tracked per pod UID (not name — names are reused across delete/
recreate churn, UIDs are not).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

from k8s_watcher_tpu_torch.state.dirty import DirtyKeys
from k8s_watcher_tpu_torch.watch.source import EventType, WatchEvent


def _ready_tuple(pod: Dict[str, Any]) -> Tuple[Tuple[str, bool, int], ...]:
    statuses = (pod.get("status") or {}).get("containerStatuses") or []
    return tuple(
        (cs.get("name", ""), bool(cs.get("ready", False)), int(cs.get("restartCount", 0) or 0))
        for cs in statuses
    )


def pod_key(meta: Dict[str, Any]) -> str:
    """The pod's tracking key: uid, falling back to ``namespace/name``
    for uid-less pods. ONE derivation shared by the pipeline's hot path,
    the phase tracker, and the serving plane's view — the view's DELETE
    must compute the same key its UPSERT did, and checkpointed phase keys
    must match across restarts, so this must never diverge per call site
    (a 'default' namespace placeholder in one copy would do exactly that)."""
    return meta.get("uid") or f"{meta.get('namespace', '')}/{meta.get('name', '')}"


def pod_ready(pod: Dict[str, Any]) -> bool:
    """Whole-pod readiness: every container ready; pods reporting no
    containerStatuses fall back to the ``Ready`` condition. Shared semantic
    for phase tracking and slice aggregation — keep the two in lockstep."""
    statuses = (pod.get("status") or {}).get("containerStatuses") or []
    if statuses:
        return all(bool(cs.get("ready")) for cs in statuses)
    conditions = (pod.get("status") or {}).get("conditions") or []
    return any(c.get("type") == "Ready" and c.get("status") == "True" for c in conditions)


def pod_restarts(pod: Dict[str, Any]) -> int:
    """Total container restarts for the pod."""
    statuses = (pod.get("status") or {}).get("containerStatuses") or []
    return sum(int(cs.get("restartCount", 0) or 0) for cs in statuses)


class PhaseDelta(NamedTuple):
    """What changed for a pod between consecutive observations.

    A NamedTuple, not a frozen dataclass: one is created per event on the
    ingest hot path, and a frozen dataclass pays object.__setattr__ per
    field (~4x the construction cost) for the same immutability."""

    old_phase: Optional[str]  # None = first sighting
    new_phase: str
    phase_changed: bool
    readiness_changed: bool
    deleted: bool = False

    @property
    def significant(self) -> bool:
        """Worth notifying: lifecycle edge, readiness flip, or deletion."""
        return self.phase_changed or self.readiness_changed or self.deleted


class PhaseTracker:
    """Last-seen state per pod UID; computes ``PhaseDelta`` per event."""

    def __init__(self):
        self._state: Dict[str, Tuple[str, Tuple]] = {}
        # uids whose PERSISTED value (the phase — snapshot() drops
        # readiness) changed since the last drain; the checkpoint's delta
        # hint, mirroring KubernetesWatchSource. Bounded: collapses to
        # "everything changed" instead of growing forever when no
        # checkpoint ever drains it (state/dirty.py)
        self._dirty = DirtyKeys()

    def __len__(self) -> int:
        return len(self._state)

    def drain_dirty_uids(self) -> Optional[set]:
        """Uids whose snapshot entry changed since the last drain (incl.
        deletes), or None for "unknown — persist everything"; clears the
        accumulator. Same drain-before-snapshot ordering contract as
        KubernetesWatchSource.drain_dirty_uids."""
        return self._dirty.drain()

    def observe(
        self,
        event: WatchEvent,
        *,
        uid: Optional[str] = None,
        new_phase: Optional[str] = None,
        ready_tuple: Optional[Tuple] = None,
    ) -> PhaseDelta:
        """``uid``/``new_phase``/``ready_tuple`` accept the pipeline's
        precomputed values (hot-path dedup — the same derivations otherwise
        re-run in slice tracking); omitted, they derive from the event."""
        if uid is None:
            uid = pod_key(event.pod.get("metadata") or {})
        if new_phase is None:
            new_phase = event.phase
        prev = self._state.get(uid)

        if event.type == EventType.DELETED:
            if prev is not None:
                self._state.pop(uid)
                self._dirty.mark(uid, len(self._state))
            return PhaseDelta(
                old_phase=prev[0] if prev else None,
                new_phase=new_phase,
                phase_changed=prev is not None and prev[0] != new_phase,
                readiness_changed=False,
                deleted=True,
            )

        ready = ready_tuple if ready_tuple is not None else _ready_tuple(event.pod)
        self._state[uid] = (new_phase, ready)
        if prev is None or prev[0] != new_phase:
            # readiness-only updates keep the persisted value identical —
            # journaling them would churn the checkpoint for nothing
            self._dirty.mark(uid, len(self._state))
        if prev is None:
            return PhaseDelta(None, new_phase, phase_changed=True, readiness_changed=False)
        old_phase, old_ready = prev
        return PhaseDelta(
            old_phase=old_phase,
            new_phase=new_phase,
            phase_changed=old_phase != new_phase,
            # old_ready None = restored from checkpoint with readiness unknown;
            # comparing unknown against real state would fire a spurious
            # readiness notification for every pod after every restart
            readiness_changed=old_ready is not None and old_ready != ready,
        )

    def snapshot(self) -> Dict[str, str]:
        """uid -> phase (used by the checkpoint subsystem)."""
        return {uid: phase for uid, (phase, _ready) in self._state.items()}

    def restore(self, snapshot: Dict[str, str]) -> None:
        """Restore from a checkpoint (readiness unknown -> None sentinel)."""
        self._state = {uid: (phase, None) for uid, phase in snapshot.items()}
