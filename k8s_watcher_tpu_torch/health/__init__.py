"""Straggler & node-health detection plane (the JAX package's ``health/``).

Peer-relative signal fusion over planes the watcher already runs (probe
RTTs and suspect links, fleet-view phase latencies, trace stage outliers)
into per-node / per-slice / per-stage verdicts, escalated ``healthy →
suspect → confirmed → remediating`` through config-declared hysteresis, with
confirmed node verdicts feeding the budgeted remediation actuator.
"""

from k8s_watcher_tpu_torch.health.detector import (  # noqa: F401
    CONFIRMED,
    HEALTH_STATES,
    HEALTHY,
    REMEDIATING,
    SUSPECT,
    HealthDetector,
    Observation,
    robust_peer_z,
)
from k8s_watcher_tpu_torch.health.plane import HealthPlane  # noqa: F401

__all__ = [
    "CONFIRMED",
    "HEALTHY",
    "HEALTH_STATES",
    "HealthDetector",
    "HealthPlane",
    "Observation",
    "REMEDIATING",
    "SUSPECT",
    "robust_peer_z",
]
