"""Node actuator: the write half of remediation (the JAX package's
``remediate/actuator.py``).

The probe finds faults and maps them to nodes; this module quarantines a
suspect node by cordoning it (``spec.unschedulable``) and applying a
NoSchedule taint, so the scheduler stops placing new GPU workloads there
while an operator investigates. It never evicts running pods (no NoExecute
by default, no drain): killing a live training job is a human decision.

Every destructive capability is fenced:

- **dry-run by default**: it logs, records and notifies what it would do,
  without touching the cluster (``config/production.yaml`` ships so);
- **per-node cooldown**: one action per node per ``cooldown_seconds``;
- **global rate limit**: at most ``max_actions_per_hour`` real actions in
  any sliding hour, cordons and releases together;
- **quarantine budget**: never more than ``max_quarantined_nodes``
  quarantined by this actuator at once, so a policy bug or a fabric-wide
  event cannot cordon a whole pool. Nodes already carrying our taint count
  against it.

A transient GET/PATCH failure refunds the fences it consumed.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from k8s_watcher_tpu_torch.config import VALID_TAINT_EFFECTS
from k8s_watcher_tpu_torch.k8s.client import (
    K8sApiError,
    K8sClient,
    K8sConflictError,
    K8sNotFoundError,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ActionRecord:
    """One quarantine/release decision — applied, simulated, or refused."""

    node: str
    action: str  # "quarantine" | "release"
    ok: bool  # the action was applied (or would be, in dry-run)
    dry_run: bool
    reason: str  # why the policy asked for it / why the actuator refused
    applied: bool = False  # a real PATCH landed on the apiserver
    adopted: bool = False  # node was already quarantined; nothing written
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class NodeActuator:
    """Cordon + taint suspect nodes, inside hard safety fences."""

    def __init__(
        self,
        client,
        *,
        dry_run: bool = True,
        cordon: bool = True,
        taint_key: str = "k8s-watcher-tpu/ici-fault",
        taint_value: str = "suspect",
        taint_effect: str = "NoSchedule",
        cooldown_seconds: float = 3600.0,
        max_actions_per_hour: int = 4,
        max_quarantined_nodes: int = 2,
        metrics=None,
        clock=time.monotonic,
    ):
        if taint_effect not in VALID_TAINT_EFFECTS:
            raise ValueError(f"taint_effect must be one of {VALID_TAINT_EFFECTS}, got {taint_effect!r}")
        self.client = client
        self.dry_run = dry_run
        self.cordon = cordon
        self.taint_key = taint_key
        self.taint_value = taint_value
        self.taint_effect = taint_effect
        self.cooldown_seconds = cooldown_seconds
        self.max_actions_per_hour = max_actions_per_hour
        self.max_quarantined_nodes = max_quarantined_nodes
        self.metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._last_action: Dict[str, float] = {}  # node -> last action ts
        self._action_times: Deque[float] = collections.deque()
        self._quarantined: set = set()  # nodes quarantined by us (this process)

    # -- fences ------------------------------------------------------------

    def _refuse(self, node: str, action: str, reason: str) -> ActionRecord:
        logger.warning("Remediation refused for node %s (%s): %s", node, action, reason)
        if self.metrics is not None:
            self.metrics.counter("remediation_refusals").inc()
        return ActionRecord(node=node, action=action, ok=False, dry_run=self.dry_run, reason=reason)

    _BUDGET_REFUSAL = "quarantine budget exhausted"
    _ADOPT_PAGE_SIZE = 500  # adoption taint-scan LIST page size

    def _reconcile_quarantined(self) -> None:
        """Drop budget entries that no longer hold, so the budget reflects
        reality rather than this process's memory. Called only when the
        budget is about to refuse — the slow path.

        Real mode: an operator releasing a node out-of-band
        (``kubectl uncordon`` +
        ``kubectl taint ... -``) removes our taint on the apiserver; a GET
        per remembered node notices and frees the slot — otherwise external
        releases would never free budget and the actuator would refuse
        forever after ``max_quarantined_nodes`` lifetime quarantines.
        The GETs run OUTSIDE the lock (each can take a full request
        timeout; holding the lock through them would block every other
        decision, /debug snapshot, and notify path for their duration) —
        membership is snapshotted first and expirations re-intersected
        against the live set when applied.

        Dry-run mode: nothing was ever written, so there is no cluster
        state to consult; decisions age out after ``cooldown_seconds`` so a
        week of review-mode traffic keeps showing fresh would-quarantine
        decisions instead of degenerating into budget refusals.
        """
        with self._lock:
            members = list(self._quarantined)
            if self.dry_run:
                now = self._clock()
                expired = {
                    n for n in members
                    if now - self._last_action.get(n, now) >= self.cooldown_seconds
                }
                if expired:
                    logger.info(
                        "Remediation budget reconciled: %s aged out (dry-run)", sorted(expired)
                    )
                    self._quarantined -= expired
                return
        expired = set()
        for n in members:  # network I/O — deliberately outside the lock
            try:
                spec = (self.client.get_node(n) or {}).get("spec") or {}
            except K8sNotFoundError:
                expired.add(n)  # the node itself is gone
                continue
            except K8sApiError:
                continue  # can't verify: keep the conservative entry
            if not any(t.get("key") == self.taint_key for t in spec.get("taints") or []):
                expired.add(n)
        if expired:
            logger.info("Remediation budget reconciled: %s no longer quarantined", sorted(expired))
            with self._lock:
                self._quarantined -= expired

    def _fence_check(self, node: str, action: str) -> Optional[str]:
        """The refusal reason, or None when the action may proceed.
        Call with the lock held."""
        now = self._clock()
        last = self._last_action.get(node)
        if last is not None and now - last < self.cooldown_seconds:
            return (
                f"cooldown: last action on {node} was {now - last:.0f}s ago "
                f"(cooldown {self.cooldown_seconds:.0f}s)"
            )
        while self._action_times and self._action_times[0] <= now - 3600.0:
            self._action_times.popleft()
        if len(self._action_times) >= self.max_actions_per_hour:
            return f"rate limit: {len(self._action_times)} actions in the last hour (max {self.max_actions_per_hour})"
        if action == "quarantine" and node not in self._quarantined and len(self._quarantined) >= self.max_quarantined_nodes:
            return (
                f"{self._BUDGET_REFUSAL}: {sorted(self._quarantined)} already "
                f"quarantined (max {self.max_quarantined_nodes}) — a fleet-wide "
                "signal needs a human, not more cordons"
            )
        return None

    def _consume(self, node: str) -> float:
        """Record an allowed action against the fences (lock held);
        returns the timestamp recorded, for exact refund."""
        now = self._clock()
        self._last_action[node] = now
        self._action_times.append(now)
        return now

    def _drop_rate_slot_locked(self, consumed_ts: float) -> None:
        """Remove exactly the rate-window entry recorded by this call's
        `_consume` (lock held) — popping the tail instead could evict a
        DIFFERENT in-flight action's timestamp under concurrency, leaving
        the older one in the sliding-hour window and skewing accounting."""
        try:
            self._action_times.remove(consumed_ts)
        except ValueError:
            pass  # already expired out of the hour window

    def _refund_locked(self, node: str, prior_last_action: Optional[float], consumed_ts: float) -> None:
        """Undo one `_consume` (lock held): a transient GET/PATCH failure
        must not burn the fences — a consumed cooldown would lock a
        CONFIRMED-faulty node out of remediation for cooldown_seconds over
        an apiserver blip, and a burned rate slot would starve retries."""
        if prior_last_action is None:
            self._last_action.pop(node, None)
        else:
            self._last_action[node] = prior_last_action
        self._drop_rate_slot_locked(consumed_ts)

    # -- actions -----------------------------------------------------------

    def _our_taint(self) -> Dict[str, str]:
        return {"key": self.taint_key, "value": self.taint_value, "effect": self.taint_effect}

    def quarantine(self, node: str, reason: str) -> ActionRecord:
        """Cordon + taint ``node``; returns what happened and why.

        Idempotent: a node already carrying our taint (and cordoned, when
        cordoning is on) reports ok without a write — and is adopted into
        the budget set, so pre-restart quarantines still count against
        ``max_quarantined_nodes``.
        """
        def check_and_consume():
            """Atomically pass the fences and consume them; returns
            ``(refusal, prior_last_action, consumed_ts, was_quarantined)``."""
            with self._lock:
                refusal = self._fence_check(node, "quarantine")
                if refusal:
                    return refusal, None, 0.0, False
                # consume fences inside the lock; the PATCH itself runs
                # outside (a slow apiserver must not serialize every other
                # decision)
                prior = self._last_action.get(node)
                was = node in self._quarantined
                ts = self._consume(node)
                self._quarantined.add(node)
                return None, prior, ts, was

        refusal, prior_last_action, consumed_ts, was_quarantined = check_and_consume()
        if refusal is not None and refusal.startswith(self._BUDGET_REFUSAL):
            # the budget may be stale (out-of-band releases, aged dry-run
            # decisions): reconcile against reality — outside any lock —
            # and re-run the fences once
            self._reconcile_quarantined()
            refusal, prior_last_action, consumed_ts, was_quarantined = check_and_consume()
        if refusal is not None:
            return self._refuse(node, "quarantine", refusal)
        record = self._apply_quarantine(node, reason)
        with self._lock:
            if not record.ok:
                # Only evict the node from the budget if THIS call added it
                # — a failed re-quarantine of a node that is already
                # genuinely cordoned must keep occupying its slot
                if not was_quarantined:
                    self._quarantined.discard(node)
                self._refund_locked(node, prior_last_action, consumed_ts)
            elif record.adopted:
                # adoption wrote nothing: refund the hourly rate slot so
                # no-op confirmations can't starve real actions (the
                # per-node cooldown stays consumed — it is what stops the
                # policy re-GETting the node every probe cycle)
                self._drop_rate_slot_locked(consumed_ts)
            n_quarantined = len(self._quarantined)
        if self.metrics is not None and record.ok:
            if not record.adopted:  # adoption wrote nothing — not an action
                self.metrics.counter("remediation_actions").inc()
            self.metrics.gauge("remediation_quarantined_nodes").set(n_quarantined)
        return record

    # Taint edits are read-modify-write over the WHOLE spec.taints list (a
    # JSON merge-patch replaces the list wholesale), so every write carries
    # the read's metadata.resourceVersion — the apiserver rejects a stale
    # write with 409 instead of silently clobbering a taint another
    # controller added between our GET and PATCH — and the RMW retries on
    # conflict with a fresh read.
    _RMW_ATTEMPTS = 3

    def _apply_quarantine(self, node: str, reason: str) -> ActionRecord:
        for attempt in range(self._RMW_ATTEMPTS):
            try:
                current = self.client.get_node(node)
            except K8sNotFoundError:
                return ActionRecord(
                    node=node, action="quarantine", ok=False, dry_run=self.dry_run,
                    reason=reason, error=f"node {node} not found",
                )
            except K8sApiError as exc:
                return ActionRecord(
                    node=node, action="quarantine", ok=False, dry_run=self.dry_run,
                    reason=reason, error=f"get_node failed: {exc}",
                )
            spec = current.get("spec") or {}
            taints: List[Dict[str, Any]] = list(spec.get("taints") or [])
            have_taint = any(t.get("key") == self.taint_key for t in taints)
            cordoned = bool(spec.get("unschedulable"))
            if have_taint and (cordoned or not self.cordon):
                logger.info("Node %s already quarantined (adopting): %s", node, reason)
                return ActionRecord(
                    node=node, action="quarantine", ok=True, dry_run=self.dry_run,
                    reason=f"already quarantined; {reason}", adopted=True,
                )
            if not have_taint:
                taints.append(self._our_taint())
            patch: Dict[str, Any] = {"spec": {"taints": taints}}
            rv = (current.get("metadata") or {}).get("resourceVersion")
            if rv:
                patch["metadata"] = {"resourceVersion": rv}
            if self.cordon:
                patch["spec"]["unschedulable"] = True
            if self.dry_run:
                logger.warning(
                    "[DRY-RUN] would quarantine node %s (cordon=%s, taint %s=%s:%s): %s",
                    node, self.cordon, self.taint_key, self.taint_value, self.taint_effect, reason,
                )
                return ActionRecord(node=node, action="quarantine", ok=True, dry_run=True, reason=reason)
            try:
                self.client.patch_node(node, patch)
            except K8sConflictError:
                logger.info(
                    "Node %s changed between read and write (attempt %d/%d); re-reading",
                    node, attempt + 1, self._RMW_ATTEMPTS,
                )
                continue
            except K8sApiError as exc:
                return ActionRecord(
                    node=node, action="quarantine", ok=False, dry_run=False,
                    reason=reason, error=f"patch_node failed: {exc}",
                )
            logger.warning(
                "QUARANTINED node %s (cordon=%s, taint %s=%s:%s): %s",
                node, self.cordon, self.taint_key, self.taint_value, self.taint_effect, reason,
            )
            return ActionRecord(node=node, action="quarantine", ok=True, dry_run=False, reason=reason, applied=True)
        return ActionRecord(
            node=node, action="quarantine", ok=False, dry_run=False, reason=reason,
            error=f"patch_node conflicted {self._RMW_ATTEMPTS} times (node spec churning)",
        )

    def release(self, node: str, reason: str = "operator release") -> ActionRecord:
        """Uncordon + remove OUR taint (other taints are preserved).

        The inverse of ``quarantine``, for the operator path once
        the hardware is cleared or swapped. Subject to the rate limit but
        not the cooldown (releasing a node we just cordoned by mistake must
        not wait an hour).
        """
        with self._lock:
            now = self._clock()
            while self._action_times and self._action_times[0] <= now - 3600.0:
                self._action_times.popleft()
            if len(self._action_times) >= self.max_actions_per_hour:
                return self._refuse(
                    node, "release",
                    f"rate limit: {len(self._action_times)} actions in the last hour (max {self.max_actions_per_hour})",
                )
            prior_last_action = self._last_action.get(node)
            consumed_ts = self._consume(node)
            ours = node in self._quarantined
        record = self._apply_release(node, reason, quarantined_by_us=ours)
        with self._lock:
            if record.ok:
                self._quarantined.discard(node)
                if record.adopted:
                    # no-op release (nothing to untaint or uncordon) wrote
                    # nothing: refund the FULL consume — rate slot AND the
                    # per-node last-action stamp. Unlike quarantine
                    # adoption (where the kept cooldown stops the policy
                    # re-GETting a genuinely-quarantined node every
                    # cycle), a kept stamp here would make _fence_check
                    # refuse a REAL quarantine of this node for
                    # cooldown_seconds after an operator's harmless no-op
                    # release — locking a confirmed-faulty node in service
                    # over a write that never happened.
                    self._refund_locked(node, prior_last_action, consumed_ts)
            else:
                self._refund_locked(node, prior_last_action, consumed_ts)
            n_quarantined = len(self._quarantined)
        if record.ok and self.metrics is not None:
            if not record.adopted:  # a no-op release is not an action...
                self.metrics.counter("remediation_actions").inc()
            # ...but it can still shrink _quarantined (out-of-band cleanup
            # noticed here), so the gauge must always track the set
            self.metrics.gauge("remediation_quarantined_nodes").set(n_quarantined)
        return record

    def _apply_release(self, node: str, reason: str, *, quarantined_by_us: bool = False) -> ActionRecord:
        for attempt in range(self._RMW_ATTEMPTS):
            try:
                current = self.client.get_node(node)
            except (K8sNotFoundError, K8sApiError) as exc:
                return ActionRecord(
                    node=node, action="release", ok=False, dry_run=self.dry_run,
                    reason=reason, error=str(exc),
                )
            spec = current.get("spec") or {}
            all_taints = spec.get("taints") or []
            had_our_taint = any(t.get("key") == self.taint_key for t in all_taints)
            taints = [t for t in all_taints if t.get("key") != self.taint_key]
            # Only undo a cordon WE are responsible for (our taint present,
            # or the node is in this actuator's quarantined set). A node an
            # operator cordoned for unrelated maintenance — no remediation
            # taint — must stay cordoned: releasing it would silently undo
            # the operator's work.
            uncordon = (had_our_taint or quarantined_by_us) and bool(spec.get("unschedulable"))
            if not had_our_taint and not uncordon:
                # nothing to untaint, nothing to uncordon: a semantically
                # empty PATCH would still burn a rate slot, bump the node's
                # rv, and wake the node-plane watch — mirror quarantine's
                # adoption early-return instead (the caller refunds the slot)
                logger.info(
                    "Release of node %s: no %s taint and no cordon of ours; "
                    "nothing to do", node, self.taint_key,
                )
                return ActionRecord(
                    node=node, action="release", ok=True, dry_run=self.dry_run,
                    reason=f"nothing to release; {reason}", adopted=True,
                )
            patch: Dict[str, Any] = {"spec": {"taints": taints or None}}
            rv = (current.get("metadata") or {}).get("resourceVersion")
            if rv:
                patch["metadata"] = {"resourceVersion": rv}
            if uncordon:
                patch["spec"]["unschedulable"] = None
            if self.dry_run:
                logger.warning("[DRY-RUN] would release node %s (uncordon=%s): %s", node, uncordon, reason)
                return ActionRecord(node=node, action="release", ok=True, dry_run=True, reason=reason)
            try:
                self.client.patch_node(node, patch)
            except K8sConflictError:
                logger.info(
                    "Node %s changed between read and write (attempt %d/%d); re-reading",
                    node, attempt + 1, self._RMW_ATTEMPTS,
                )
                continue
            except K8sApiError as exc:
                return ActionRecord(
                    node=node, action="release", ok=False, dry_run=False,
                    reason=reason, error=f"patch_node failed: {exc}",
                )
            logger.warning(
                "RELEASED node %s (taint %s removed%s): %s",
                node, self.taint_key, ", uncordoned" if uncordon else ", cordon left alone", reason,
            )
            return ActionRecord(node=node, action="release", ok=True, dry_run=False, reason=reason, applied=True)
        return ActionRecord(
            node=node, action="release", ok=False, dry_run=False, reason=reason,
            error=f"patch_node conflicted {self._RMW_ATTEMPTS} times (node spec churning)",
        )

    def quarantined_nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._quarantined)

    def adopt_existing(self) -> List[str]:
        """Seed the budget set from the cluster: every node already carrying
        our taint counts as quarantined-by-us. Call once at arming time —
        a restarted actuator otherwise starts with empty memory, and the
        ``max_quarantined_nodes`` fence would not count pre-restart
        quarantines until each happened to be re-confirmed, letting the
        fleet exceed the budget across restarts. Dry-run mode writes
        nothing, so there is nothing to adopt. Best-effort: an unreachable
        apiserver leaves memory empty (the conservative reconcile path
        still adopts lazily on re-confirmation)."""
        if self.dry_run:
            return []
        adopted = []
        try:
            # paged scan (limit+continue) through the shared consumption
            # driver, so the adoption scan's cost (pages/restarts/duration)
            # lands in metrics under its own prefix — a slow or
            # restart-looping startup scan must be visible. Only
            # taint-carrying names are kept, so memory stays one page even
            # on multi-thousand-node pools. A mid-scan snapshot restart
            # (attempt_changed) resets nothing — the union across attempts
            # over-adopts at worst, and over-adoption only makes the
            # budget more conservative.
            for _rv, items, _attempt_changed in K8sClient.iter_list_pages(
                self.client.list_nodes_paged(page_size=self._ADOPT_PAGE_SIZE),
                metrics=self.metrics,
                metric_prefix="adopt_scan",
            ):
                for node in items:
                    name = (node.get("metadata") or {}).get("name", "")
                    if name and any(
                        t.get("key") == self.taint_key
                        for t in ((node.get("spec") or {}).get("taints") or [])
                    ):
                        adopted.append(name)
        except K8sApiError as exc:
            # keep the PARTIAL set: names already scanned are genuinely
            # quarantined, and discarding them would let the budget permit
            # a full complement of NEW cordons on top of unseen existing
            # ones — the exact cross-restart overrun adoption exists to
            # prevent. Under-counting is the only unsafe direction here.
            logger.warning(
                "Quarantine adoption scan failed mid-pagination (%s); adopting "
                "the %d node(s) scanned so far (the budget reconcile path "
                "adopts stragglers lazily on re-confirmation)", exc, len(adopted),
            )
        adopted = sorted(set(adopted))
        if adopted:
            logger.info("Adopting pre-existing quarantines into the budget: %s", adopted)
            with self._lock:
                self._quarantined.update(adopted)
            if self.metrics is not None:
                self.metrics.gauge("remediation_quarantined_nodes").set(len(self._quarantined))
        return adopted
