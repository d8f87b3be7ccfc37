"""Slice-state aggregation.

A slice's health is an aggregate over its member pods (SURVEY.md §7 step 5:
"a slice is Degraded if any member pod is"). The tracker folds pod-level
phase deltas into a slice phase machine and emits a slice-level notification
whenever the aggregate phase changes:

- FORMING     members still scheduling/pending (or not all seen yet)
- READY       every expected worker Running and ready
- DEGRADED    any member Failed/Unknown, restarting, or missing after READY
- COMPLETED   all members Succeeded
- TERMINATED  all members deleted

Pods are also attributed a ``slice_info`` block for their own notifications,
so a consumer can always join a pod event back to its slice.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from k8s_watcher_tpu_torch.pipeline.extract import extract_disruption
from k8s_watcher_tpu_torch.pipeline.phase import PhaseDelta, pod_ready, pod_restarts
from k8s_watcher_tpu_torch.slices.topology import SliceIdentity, infer_slice_identity
from k8s_watcher_tpu_torch.watch.source import EventType, WatchEvent

logger = logging.getLogger(__name__)


class SlicePhase:
    FORMING = "Forming"
    READY = "Ready"
    DEGRADED = "Degraded"
    COMPLETED = "Completed"
    TERMINATED = "Terminated"


@dataclasses.dataclass(slots=True)
class _Member:
    uid: str
    name: str
    worker_index: Optional[int]
    phase: str
    ready: bool
    restarts: int = 0
    node_name: Optional[str] = None
    # node-plane health (nodes/tracker.py): a member on a NotReady node is
    # degraded even while its pod still reads Running — eviction lags the
    # node drop by minutes
    node_ready: bool = True


def _member_contrib(m: "_Member") -> tuple:
    """One member's contribution to the aggregate counters:
    (bad, node_down, succeeded, running_ready)."""
    return (
        1 if m.phase in ("Failed", "Unknown") else 0,
        1 if (not m.node_ready and m.phase != "Succeeded") else 0,
        1 if m.phase == "Succeeded" else 0,
        1 if (m.phase == "Running" and m.ready and m.node_ready) else 0,
    )


@dataclasses.dataclass
class SliceState:
    identity: SliceIdentity
    members: Dict[str, _Member] = dataclasses.field(default_factory=dict)
    phase: str = SlicePhase.FORMING
    ever_ready: bool = False
    ever_had_members: bool = False
    # why the slice last lost a member involuntarily (preemption/eviction/
    # node shutdown — pipeline/extract.py:extract_disruption); a Degraded
    # slice whose worker was PREEMPTED reads differently from one whose
    # worker crashed
    last_disruption: Optional[Dict[str, Any]] = None
    # running aggregate counters [bad, node_down, succeeded, running_ready],
    # maintained by SliceTracker's member-mutation helpers so
    # aggregate_phase is O(1) on the 10k+ events/s hot path instead of an
    # O(members) walk per event. None = unmaintained (states built by hand,
    # e.g. property tests): aggregate_phase falls back to the full walk,
    # which stays the semantic definition the counters must match
    # (tests/test_ingest_shards.py pins the equivalence).
    counts: Optional[List[int]] = None

    def walk_counts(self) -> tuple:
        """The aggregate counters computed from scratch — the ground truth
        the maintained ``counts`` must always equal."""
        bad = node_down = succ = rr = 0
        for m in self.members.values():
            b, nd, s, r = _member_contrib(m)
            bad += b
            node_down += nd
            succ += s
            rr += r
        return bad, node_down, succ, rr

    def aggregate_phase(self) -> str:
        if not self.members:
            # all members gone: terminal whether or not the slice ever got
            # healthy (a quota-stuck JobSet deleted while Pending must still
            # terminate, or its state would leak forever)
            return SlicePhase.TERMINATED if self.ever_had_members else SlicePhase.FORMING
        bad, node_down, succ, running_ready = (
            self.counts if self.counts is not None else self.walk_counts()
        )
        if bad:
            return SlicePhase.DEGRADED
        # a dead node under a non-terminal member degrades the slice NOW,
        # not minutes later when the node controller evicts the pod
        if node_down:
            return SlicePhase.DEGRADED
        if succ == len(self.members):
            return SlicePhase.COMPLETED
        expected = self.identity.expected_workers
        if expected is not None:
            if len(self.members) < expected and self.ever_ready:
                return SlicePhase.DEGRADED  # lost workers after being whole
            if running_ready >= expected:
                return SlicePhase.READY
        elif running_ready == len(self.members) and running_ready > 0:
            return SlicePhase.READY
        return SlicePhase.DEGRADED if self.ever_ready else SlicePhase.FORMING

    def summary(self) -> Dict[str, Any]:
        ident = self.identity
        return {
            "slice": ident.key,
            "namespace": ident.namespace,
            "name": ident.name,
            "topology": ident.topology,
            "accelerator": ident.accelerator,
            "chips_per_worker": ident.chips_per_worker,
            "total_chips": ident.total_chips,
            "expected_workers": ident.expected_workers,
            "observed_workers": len(self.members),
            "ready_workers": sum(
                1 for m in self.members.values() if m.phase == "Running" and m.ready and m.node_ready
            ),
            "phase": self.phase,
            "last_disruption": self.last_disruption,
            "workers": [
                {
                    "name": m.name,
                    "worker_index": m.worker_index,
                    "phase": m.phase,
                    "ready": m.ready,
                    "restarts": m.restarts,
                    "node": m.node_name,
                    "node_ready": m.node_ready,
                }
                for m in sorted(self.members.values(), key=lambda m: (m.worker_index is None, m.worker_index, m.name))
            ],
        }


class SliceTracker:
    def __init__(
        self,
        environment: str,
        *,
        resource_key: str = "google.com/tpu",
        topology_label: str = "cloud.google.com/gke-tpu-topology",
        accelerator_label: str = "cloud.google.com/gke-tpu-accelerator",
    ):
        self.environment = environment
        self.resource_key = resource_key
        self.topology_label = topology_label
        self.accelerator_label = accelerator_label
        self._slices: Dict[str, SliceState] = {}
        # checkpointed {key: {"phase", "ever_ready"}} applied lazily when the
        # slice is first observed again after a restart
        self._restored: Dict[str, Any] = {}
        # observe() runs on the watch thread; note_node() on the node-watch
        # thread; debug_snapshot()/snapshot() on HTTP/checkpoint paths
        self._lock = threading.RLock()
        # name -> node still exists (False = observed deleted). Alive
        # NotReady entries persist (bounded by cluster size) so a pod
        # scheduled onto a known-down node starts node-down; deleted-node
        # entries are pruned once no slice member references them — GKE
        # repair/autoscale mints fresh names, so they'd otherwise
        # accumulate forever in a long-lived leader.
        self._down_nodes: Dict[str, bool] = {}
        # uid -> (labels, annotations, nodeSelector, chips, SliceIdentity):
        # identity inference re-derives the same frozen SliceIdentity from
        # the same metadata on every event of a pod's life — cache it per
        # uid, validated by value-equality of its actual inputs (pods are
        # rebuilt per event, so object identity never hits). Touched only
        # from observe() (the single ingest drain thread); evicted on
        # DELETED and size-bounded against uid-churn pathology.
        self._ident_cache: Dict[str, tuple] = {}
        # node_name -> number of live members scheduled on it, maintained at
        # the two member-mutation sites in _observe_locked. Makes the
        # "is this node still referenced?" pruning checks O(1) instead of a
        # full member walk under the watch thread's lock on every event.
        self._node_refs: Dict[str, int] = {}
        # node-plane existence provider (set_node_existence_provider)
        self._node_existence = None

    def _node_ref_delta_locked(self, name: Optional[str], delta: int) -> None:
        if not name:
            return
        new = self._node_refs.get(name, 0) + delta
        if new > 0:
            self._node_refs[name] = new
        else:
            self._node_refs.pop(name, None)

    # -- counted member mutation (every tracker-side member write goes
    # through these two, so SliceState.counts stays exact) -----------------

    @staticmethod
    def _member_set_locked(state: SliceState, uid: str, member: _Member) -> None:
        prev = state.members.get(uid)
        state.members[uid] = member
        counts = state.counts
        if counts is not None:
            new = _member_contrib(member)
            if prev is not None:
                old = _member_contrib(prev)
                for i in range(4):
                    counts[i] += new[i] - old[i]
            else:
                for i in range(4):
                    counts[i] += new[i]

    @staticmethod
    def _member_pop_locked(state: SliceState, uid: str) -> Optional[_Member]:
        removed = state.members.pop(uid, None)
        if removed is not None and state.counts is not None:
            old = _member_contrib(removed)
            for i in range(4):
                state.counts[i] -= old[i]
        return removed

    def __len__(self) -> int:
        return len(self._slices)

    def get(self, key: str) -> Optional[SliceState]:
        return self._slices.get(key)

    def states(self) -> Dict[str, SliceState]:
        return dict(self._slices)

    def observe(
        self,
        event: WatchEvent,
        delta: PhaseDelta,
        chips: Optional[int] = None,
        *,
        uid: Optional[str] = None,
        phase: Optional[str] = None,
        ready_tuple: Optional[Tuple] = None,
    ) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]]]:
        """Fold one pod event into slice state.

        Returns ``(slice_info for the pod payload, [slice notifications])``.
        ``chips``/``uid``/``phase``/``ready_tuple`` forward the pipeline's
        precomputed derivations (hot-path dedup); omitted, they derive
        from the event.
        """
        pod = event.pod
        if uid is None:
            uid = event.uid
        metadata = pod.get("metadata") or {}
        labels = metadata.get("labels") or {}
        annotations = metadata.get("annotations") or {}
        node_selector = (pod.get("spec") or {}).get("nodeSelector") or {}
        cached = self._ident_cache.get(uid) if uid else None
        if (
            cached is not None
            and cached[0] == labels
            and cached[1] == annotations
            and cached[2] == node_selector
            and cached[3] == chips
        ):
            identity = cached[4]
        else:
            identity = infer_slice_identity(
                pod,
                resource_key=self.resource_key,
                topology_label=self.topology_label,
                accelerator_label=self.accelerator_label,
                chips=chips,
            )
            if identity is not None and uid and chips is not None:
                if len(self._ident_cache) > 200_000:
                    self._ident_cache.clear()  # uid-churn pathology bound
                self._ident_cache[uid] = (labels, annotations, node_selector, chips, identity)
        if event.type == EventType.DELETED and uid:
            self._ident_cache.pop(uid, None)
        if identity is None:
            return None, []

        with self._lock:
            return self._observe_locked(
                event, identity, uid=uid, phase=phase, ready_tuple=ready_tuple
            )

    def _observe_locked(
        self,
        event: WatchEvent,
        identity,
        *,
        uid: Optional[str] = None,
        phase: Optional[str] = None,
        ready_tuple: Optional[Tuple] = None,
    ) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]]]:
        state = self._slices.get(identity.key)
        if state is None:
            state = SliceState(identity=identity, counts=[0, 0, 0, 0])
            restored = self._restored.pop(identity.key, None)
            if restored:
                # resume pre-restart aggregate so a slice that lost workers
                # during watcher downtime reads Degraded, not Forming
                state.phase = restored.get("phase", state.phase)
                state.ever_ready = bool(restored.get("ever_ready"))
                state.ever_had_members = True  # it existed before the restart
            self._slices[identity.key] = state
        elif identity.topology and not state.identity.topology:
            state.identity = identity  # later pods may carry richer metadata

        if uid is None:
            uid = event.uid
        removed = None
        if event.type == EventType.DELETED:
            removed = self._member_pop_locked(state, uid)
            if removed is not None:
                self._node_ref_delta_locked(removed.node_name, -1)
                disruption = extract_disruption(event.pod)
                if disruption is not None:
                    state.last_disruption = {"worker": removed.name, **disruption}
            if not state.ever_had_members:
                # DELETED for a slice we never saw alive: nothing to report
                self._slices.pop(identity.key, None)
                return None, []
        else:
            pod = event.pod
            node_name = (pod.get("spec") or {}).get("nodeName")
            if phase is None:
                phase = event.phase
            if ready_tuple:
                # (name, ready, restarts) triples — the SAME walk pod_ready/
                # pod_restarts would do, already done once in the pipeline
                ready = all(flag for _name, flag, _rc in ready_tuple)
                restarts = sum(rc for _name, _flag, rc in ready_tuple)
            else:
                # () = pod reports no containerStatuses (pod_ready then
                # falls back to the Ready condition); None = not precomputed
                ready = pod_ready(pod)
                restarts = 0 if ready_tuple == () else pod_restarts(pod)
            node_up = self._node_up_locked(node_name)
            prev = state.members.get(uid)
            if (
                prev is not None
                and prev.phase == phase
                and prev.ready == ready
                and prev.restarts == restarts
                and prev.node_name == node_name
                and prev.node_ready == node_up
            ):
                # status noise: nothing the aggregate depends on moved, so
                # skip the member replace AND the recompute — the dominant
                # event class at sustained churn (heartbeat-style MODIFIEDs)
                return {
                    "key": identity.key,
                    "worker_index": identity.worker_index,
                    "phase": state.phase,
                    "expected_workers": identity.expected_workers,
                    "observed_workers": len(state.members),
                }, []
            if prev is None or prev.node_name != node_name:
                # node_name changes at most once per pod (None -> scheduled)
                if prev is not None:
                    self._node_ref_delta_locked(prev.node_name, -1)
                self._node_ref_delta_locked(node_name, +1)
            self._member_set_locked(state, uid, _Member(
                uid=uid,
                name=event.name,
                worker_index=identity.worker_index,
                phase=phase,
                ready=ready,
                restarts=restarts,
                node_name=node_name,
                node_ready=node_up,
            ))

        if state.members:
            state.ever_had_members = True
        notifications = self._recompute_locked(state)
        if removed is not None and removed.node_name:
            # the pod may have held a deleted node's last reference — drop
            # the down-entry now instead of waiting for an unrelated
            # note_node() call. Two dict lookups: O(1) even under
            # mass-teardown churn
            name = removed.node_name
            if self._down_nodes.get(name) is False and self._node_refs.get(name, 0) == 0:
                del self._down_nodes[name]

        slice_info = {
            "key": identity.key,
            "worker_index": identity.worker_index,
            "phase": state.phase,
            "expected_workers": identity.expected_workers,
            "observed_workers": len(state.members),
        }
        return slice_info, notifications

    def _node_up_locked(self, node_name) -> bool:
        """Best current belief about a member's node when folding it in:
        not in the down-set, and — when a node plane with a full cluster
        view is wired — actually existing. The existence check closes the
        startup-order hole where the node plane lists (and reconciles) an
        empty slice tracker before pod events fold the members in: a member
        landing on a node the synced node plane has never seen starts
        node-down instead of silently READY."""
        if not node_name:
            return True  # unscheduled pod: no node verdict to apply
        if node_name in self._down_nodes:
            return False
        if self._node_existence is not None:
            return self._node_existence(node_name) is not False  # None = can't prove absence
        return True

    def set_node_existence_provider(self, provider) -> None:
        """Wire the node plane's existence answer (``name -> Optional[bool]``,
        None = view can't prove absence). Called under the slice lock; the
        provider must not call back into this tracker."""
        with self._lock:
            self._node_existence = provider

    def _recompute_locked(self, state: SliceState) -> List[Dict[str, Any]]:
        """Re-aggregate one slice's phase; emit the transition notification
        (and drop terminated slices). Caller holds the lock."""
        old_phase = state.phase
        new_phase = state.aggregate_phase()
        state.phase = new_phase
        if new_phase == SlicePhase.READY:
            state.ever_ready = True
        notifications: List[Dict[str, Any]] = []
        if new_phase != old_phase:
            logger.info("Slice %s: %s -> %s", state.identity.key, old_phase, new_phase)
            summary = state.summary()
            summary["environment"] = self.environment
            summary["event_type"] = "SLICE_PHASE_CHANGE"
            summary["phase_transition"] = {"from": old_phase, "to": new_phase}
            notifications.append(summary)
            if new_phase == SlicePhase.TERMINATED:
                del self._slices[state.identity.key]
        return notifications

    # -- node-plane integration (nodes/tracker.py) -------------------------

    def note_node(
        self, node_name: str, ready: bool, *, exists: bool = True
    ) -> List[Dict[str, Any]]:
        """Fold a node readiness change into every slice with a member on
        that node. Returns slice notifications (a NotReady node typically
        flips its slices to Degraded minutes before pod eviction would).

        ``exists=False`` records a node observed DELETED: its down-entry is
        pruned once no slice member references it, unlike an alive NotReady
        node whose entry persists until the node recovers."""
        if not node_name:
            return []
        notifications: List[Dict[str, Any]] = []
        with self._lock:
            if ready:
                self._down_nodes.pop(node_name, None)
            else:
                self._down_nodes[node_name] = exists
            for state in list(self._slices.values()):
                touched = False
                for uid, member in list(state.members.items()):
                    if member.node_name == node_name and member.node_ready != ready:
                        # replace, don't mutate: debug_snapshot() formats
                        # shallow-copied member dicts outside the lock
                        self._member_set_locked(
                            state, uid, dataclasses.replace(member, node_ready=ready)
                        )
                        touched = True
                if touched:
                    notifications.extend(self._recompute_locked(state))
            self._prune_down_nodes_locked()
        return notifications

    def _prune_down_nodes_locked(self) -> None:
        """Drop DELETED-node entries no slice member references; alive
        NotReady entries stay (see ``_down_nodes``)."""
        unreferenced = [
            n for n, exists in self._down_nodes.items()
            if not exists and self._node_refs.get(n, 0) == 0
        ]
        for name in unreferenced:
            del self._down_nodes[name]

    def reconcile_nodes(self, present_nodes) -> List[Dict[str, Any]]:
        """Mark members on nodes ABSENT from ``present_nodes`` (the full
        node-list result) node-down. Covers deletions the watch never saw:
        a node removed while the watcher was down/unstarted has no DELETED
        event to fold, but a fresh list proves it is gone."""
        present = set(present_nodes)
        notifications: List[Dict[str, Any]] = []
        with self._lock:
            for state in list(self._slices.values()):
                touched = False
                for uid, member in list(state.members.items()):
                    if member.node_name and member.node_name not in present and member.node_ready:
                        self._down_nodes[member.node_name] = False  # observed absent
                        self._member_set_locked(
                            state, uid, dataclasses.replace(member, node_ready=False)
                        )
                        touched = True
                if touched:
                    notifications.extend(self._recompute_locked(state))
            # sweep entries orphaned by paths with no inline prune (e.g. a
            # member's node_name changing on MODIFIED) — each reconcile is
            # already a full-list operation, so the O(down_nodes) walk is
            # noise here, unlike on the per-event observe() path
            self._prune_down_nodes_locked()
        return notifications

    # -- checkpoint integration -------------------------------------------

    def debug_snapshot(self) -> Dict[str, Any]:
        """Full live slice states for the /debug/slices endpoint (richer
        than the checkpoint ``snapshot``, which persists only resume state).

        Holds the lock only to shallow-copy each state (members are
        replaced, never mutated in place, so a dict copy suffices); the
        per-worker summary formatting happens outside so a large-fleet
        scrape can't stall the watch thread's observe()."""
        with self._lock:
            copies = [
                (key, dataclasses.replace(st, members=dict(st.members)))
                for key, st in self._slices.items()
                if st.ever_had_members
            ]
        return {key: st.summary() for key, st in copies}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                key: {"phase": st.phase, "ever_ready": st.ever_ready}
                for key, st in self._slices.items()
                if st.ever_had_members  # never-alive placeholder states aren't worth persisting
            }

    def restore(self, snapshot: Dict[str, Any]) -> None:
        """Stash a checkpoint snapshot; applied as slices are re-observed."""
        self._restored = dict(snapshot or {})
