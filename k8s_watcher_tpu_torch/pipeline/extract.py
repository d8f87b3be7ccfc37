"""Pod payload extraction — the notify schema.

Field-for-field parity with the reference extractor (pod_watcher.py:159-202):
name/namespace/uid/environment; status.phase + conditions[] (type/status/
reason/message) + container_statuses[] (name/ready/restart_count/state);
spec.node_name + containers (name/image); labels/annotations/
creation_timestamp; event_timestamp. ``event_type`` is stamped by the
pipeline, as the reference did at pod_watcher.py:233.

Net-new: a ``tpu`` block (chip count, accelerator/topology labels, slice
membership), a ``phase_transition`` block (the delta that triggered the
notification), and a ``disruption`` block classifying WHY a pod is going
away (preemption / eviction / node shutdown — from ``status.reason`` and
the ``DisruptionTarget`` condition), all required by the north star: a
v5p slice losing a worker to spot preemption must read differently from
one whose job completed.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Dict, Optional

from k8s_watcher_tpu_torch.pipeline.filters import pod_accelerator_chips
from k8s_watcher_tpu_torch.pipeline.phase import PhaseDelta


def _container_state_string(state: Optional[Dict[str, Any]]) -> Optional[str]:
    """Compact one-line rendering of a containerStatuses[].state dict.

    The reference stringified the SDK object (pod_watcher.py:181); for raw
    JSON we render ``waiting(reason=...)`` / ``running(started_at=...)`` /
    ``terminated(reason=..., exit_code=...)``.
    """
    if not state:
        return None
    for key in ("waiting", "running", "terminated"):
        if key in state and state[key] is not None:
            detail = state[key] or {}
            bits = []
            if detail.get("reason"):
                bits.append(f"reason={detail['reason']}")
            if key == "running" and detail.get("startedAt"):
                bits.append(f"started_at={detail['startedAt']}")
            if key == "terminated" and detail.get("exitCode") is not None:
                bits.append(f"exit_code={detail['exitCode']}")
            return f"{key}({', '.join(bits)})" if bits else key
    return None


# status.reason values that mean the pod was disrupted rather than ran to
# completion (kubelet/scheduler-stamped; GKE spot/preemptible TPU nodes
# produce Shutdown via graceful node shutdown and Preempted/Evicted via
# the scheduler and eviction API)
_DISRUPTION_STATUS_REASONS = ("Preempted", "Evicted", "Shutdown", "NodeShutdown", "Terminated")


def extract_disruption(pod: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Classify an involuntary disruption, or None for ordinary lifecycle.

    Two authoritative signals, both surfaced when present:
    - ``status.reason`` — kubelet/scheduler one-word cause;
    - the ``DisruptionTarget`` pod condition (k8s >= 1.26) — its ``reason``
      names the actor (``PreemptionByScheduler``,
      ``DeletionByTaintManager``, ``EvictionByEvictionAPI``,
      ``TerminationByKubelet``).
    """
    status = pod.get("status") or {}
    out: Dict[str, Any] = {}
    reason = status.get("reason")
    if reason in _DISRUPTION_STATUS_REASONS:
        out["reason"] = reason
        if status.get("message"):
            out["message"] = str(status["message"])[:300]
    for c in status.get("conditions") or []:
        if c.get("type") == "DisruptionTarget" and c.get("status") == "True":
            out["target_reason"] = c.get("reason")
            if c.get("message"):
                out.setdefault("message", str(c["message"])[:300])
            break
    if not out:
        return None
    out["kind"] = (
        "preemption" if "Preempt" in (out.get("reason") or "") + (out.get("target_reason") or "")
        else "eviction" if "Evict" in (out.get("reason") or "") + (out.get("target_reason") or "")
        else "node-shutdown" if "Shutdown" in (out.get("reason") or "")
        else "disruption"
    )
    return out


def extract_pod_data(
    pod: Dict[str, Any],
    environment: str,
    *,
    resource_key: str = "google.com/tpu",
    topology_label: str = "cloud.google.com/gke-tpu-topology",
    accelerator_label: str = "cloud.google.com/gke-tpu-accelerator",
    delta: Optional[PhaseDelta] = None,
    slice_info: Optional[Dict[str, Any]] = None,
    chips: Optional[int] = None,
) -> Dict[str, Any]:
    """Build the notify payload for one pod event. ``chips`` accepts a
    precomputed ``pod_accelerator_chips`` result (hot-path dedup)."""
    metadata = pod.get("metadata") or {}
    status = pod.get("status") or {}
    spec = pod.get("spec") or {}
    node_selector = spec.get("nodeSelector") or {}
    labels = metadata.get("labels") or {}

    data: Dict[str, Any] = {
        "name": metadata.get("name"),
        "namespace": metadata.get("namespace"),
        "uid": metadata.get("uid"),
        "environment": environment,
        "status": {
            "phase": status.get("phase", "Unknown"),
            "conditions": [
                {
                    "type": c.get("type"),
                    "status": c.get("status"),
                    "reason": c.get("reason"),
                    "message": c.get("message"),
                }
                for c in (status.get("conditions") or [])
            ],
            "container_statuses": [
                {
                    "name": cs.get("name"),
                    "ready": cs.get("ready"),
                    "restart_count": cs.get("restartCount", 0),
                    "state": _container_state_string(cs.get("state")),
                }
                for cs in (status.get("containerStatuses") or [])
            ],
        },
        "spec": {
            "node_name": spec.get("nodeName"),
            "containers": [
                {"name": c.get("name"), "image": c.get("image")}
                for c in (spec.get("containers") or [])
            ],
        },
        "metadata": {
            "labels": labels,
            "annotations": metadata.get("annotations") or {},
            "creation_timestamp": metadata.get("creationTimestamp"),
        },
        "event_timestamp": datetime.now(timezone.utc).isoformat(),
    }

    if chips is None:
        chips = pod_accelerator_chips(pod, resource_key)
    if chips > 0 or slice_info:
        data["tpu"] = {
            "resource_key": resource_key,
            "chips": chips,
            "accelerator": node_selector.get(accelerator_label) or labels.get(accelerator_label),
            "topology": node_selector.get(topology_label) or labels.get(topology_label),
        }
        if slice_info:
            data["tpu"]["slice"] = slice_info

    if delta is not None:
        data["phase_transition"] = {
            "from": delta.old_phase,
            "to": delta.new_phase,
            "phase_changed": delta.phase_changed,
            "readiness_changed": delta.readiness_changed,
            "deleted": delta.deleted,
        }
    disruption = extract_disruption(pod)
    if disruption is not None:
        data["disruption"] = disruption
    return data
