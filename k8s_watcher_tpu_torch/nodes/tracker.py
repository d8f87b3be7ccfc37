"""TPU node condition tracking.

The pod stream alone cannot see the failure mode that matters most for
slice health: a TPU node dropping out (kubelet dead, machine preempted,
ICI brick failure taking the VM down). Its pods can linger in ``Running``
for minutes until the node controller evicts them — long past the <1 s
notify target. Watching ``/api/v1/nodes`` closes that gap: a Ready→NotReady
flip is visible within a kubelet heartbeat, and the slice tracker can mark
every slice with a member on that node Degraded immediately.

The JAX package's ``nodes/tracker.py``: a node drop is the coarse-grained
fault signal the control plane offers.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def node_is_ready(node: Dict[str, Any]) -> Optional[bool]:
    """The Ready condition as a bool, or None if the condition is absent
    (a brand-new node that has not heartbeated yet)."""
    for condition in (node.get("status") or {}).get("conditions") or []:
        if condition.get("type") == "Ready":
            return condition.get("status") == "True"
    return None


def node_tpu_info(
    node: Dict[str, Any],
    *,
    resource_key: str = "google.com/tpu",
    accelerator_label: str = "cloud.google.com/gke-tpu-accelerator",
    topology_label: str = "cloud.google.com/gke-tpu-topology",
) -> Optional[Dict[str, Any]]:
    """TPU facts for a node, or None if it carries no accelerators."""
    status = node.get("status") or {}
    labels = (node.get("metadata") or {}).get("labels") or {}
    chips = 0
    for bucket in ("allocatable", "capacity"):
        value = (status.get(bucket) or {}).get(resource_key)
        if value is not None:
            try:
                chips = max(chips, int(str(value)))
            except ValueError:
                chips = max(chips, 1)
    accelerator = labels.get(accelerator_label)
    if chips <= 0 and not accelerator:
        return None
    return {
        "chips": chips,
        "accelerator": accelerator,
        "topology": labels.get(topology_label),
    }


class NodeTracker:
    """Folds node watch events into per-node readiness state and emits a
    notification payload on every Ready-condition transition.

    ``tpu_only`` (default) ignores non-accelerator nodes — a control-plane
    watcher for TPU slices has no business alerting on every generic node
    in a shared cluster (``tpu.backend: gpu`` swaps the resource key, so
    gpu-compat mode tracks GPU nodes the same way).
    """

    def __init__(
        self,
        environment: str,
        *,
        resource_key: str = "google.com/tpu",
        accelerator_label: str = "cloud.google.com/gke-tpu-accelerator",
        topology_label: str = "cloud.google.com/gke-tpu-topology",
        tpu_only: bool = True,
    ):
        self.environment = environment
        self.resource_key = resource_key
        self.accelerator_label = accelerator_label
        self.topology_label = topology_label
        self.tpu_only = tpu_only
        self._ready: Dict[str, Optional[bool]] = {}
        # EVERY node name in the cluster view, including non-accelerator
        # nodes `tpu_only` skips for readiness tracking: existence is what
        # lets the slice plane tell "node deleted" from "node not yet seen"
        # (a TPU pod can sit on a node whose device plugin hasn't reported
        # capacity yet, so the readiness map alone can't answer that)
        self._exists: set = set()
        self._lock = threading.Lock()

    def is_ready(self, name: str) -> Optional[bool]:
        """Last observed readiness, or None for an unknown node."""
        with self._lock:
            return self._ready.get(name)

    def is_tracked(self, name: str) -> bool:
        """O(1): has this node a readiness entry (TPU-tracked)?"""
        with self._lock:
            return name in self._ready

    def exists(self, name: str) -> bool:
        """O(1): is this node in the cluster view (any node, not just TPU)?"""
        with self._lock:
            return name in self._exists

    def reconcile_existence(self, listed) -> None:
        """Drop existence entries absent from a fresh full node list."""
        with self._lock:
            self._exists &= set(listed)

    def known_nodes(self) -> Dict[str, Optional[bool]]:
        with self._lock:
            return dict(self._ready)

    def observe(self, event_type: str, node: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Fold one node event; returns notification payloads (empty for
        steady-state heartbeats that do not change readiness)."""
        name = (node.get("metadata") or {}).get("name", "")
        if not name:
            return []
        with self._lock:
            if event_type == "DELETED":
                self._exists.discard(name)
            else:
                self._exists.add(name)
        tpu = node_tpu_info(
            node,
            resource_key=self.resource_key,
            accelerator_label=self.accelerator_label,
            topology_label=self.topology_label,
        )
        if self.tpu_only and tpu is None and event_type != "DELETED":
            return []

        if event_type == "DELETED":
            with self._lock:
                was = self._ready.pop(name, None)
            if was is None:
                return []  # never tracked (non-TPU or unseen)
            logger.warning("TPU node %s deleted", name)
            return [self._payload(name, node, "NODE_DELETED", ready=False, tpu=tpu)]

        ready = node_is_ready(node)
        with self._lock:
            previous = self._ready.get(name, _UNSEEN)
            self._ready[name] = ready
        if previous is _UNSEEN:
            # baseline observation: only a node arriving UNhealthy is news
            if ready is False:
                logger.warning("TPU node %s first seen NotReady", name)
                return [self._payload(name, node, "NODE_CONDITION_CHANGE", ready=False, tpu=tpu)]
            return []
        if previous == ready:
            return []  # heartbeat, no transition
        logger.log(
            logging.INFO if ready else logging.WARNING,
            "TPU node %s: Ready %s -> %s", name, previous, ready,
        )
        return [self._payload(name, node, "NODE_CONDITION_CHANGE", ready=bool(ready), tpu=tpu)]

    def _payload(
        self, name: str, node: Dict[str, Any], event_type: str, *, ready: bool, tpu
    ) -> Dict[str, Any]:
        from datetime import datetime, timezone

        conditions = [
            {
                "type": c.get("type"),
                "status": c.get("status"),
                "reason": c.get("reason"),
                "message": c.get("message"),
            }
            for c in (node.get("status") or {}).get("conditions") or []
        ]
        return {
            "event_type": event_type,
            "environment": self.environment,
            "node": name,
            "ready": ready,
            "tpu": tpu,
            "conditions": conditions,
            "unschedulable": bool((node.get("spec") or {}).get("unschedulable")),
            "event_timestamp": datetime.now(timezone.utc).isoformat(),
        }


class _Unseen:
    def __repr__(self):  # pragma: no cover - debug aid
        return "<unseen>"


_UNSEEN = _Unseen()
