"""Remediation: act on confirmed probe findings (the JAX package's
``remediate/``)."""

import time
from typing import Any, Dict

from k8s_watcher_tpu_torch.notification import Notification
from k8s_watcher_tpu_torch.remediate.actuator import ActionRecord, NodeActuator
from k8s_watcher_tpu_torch.remediate.policy import ProbeRemediationPolicy

__all__ = [
    "ActionRecord",
    "NodeActuator",
    "ProbeRemediationPolicy",
    "build_actuator",
    "build_policy",
]


def build_actuator(client, tpu_config, *, metrics=None, adopt: bool = True, **overrides) -> NodeActuator:
    """The one place ``tpu.remediation.*`` maps onto NodeActuator arguments;
    ``overrides`` replace single fields.

    ``adopt`` seeds the budget from the nodes already carrying our taint
    (continuity across restarts, ``NodeActuator.adopt_existing``). Pass False
    when this actuator is not the cluster's only remediation actor (one per
    rank under ``torchrun``): adopting other actors' taints would fill its
    budget with foreign quarantines and refuse its own findings."""
    kwargs: Dict[str, Any] = dict(
        dry_run=tpu_config.remediation_dry_run,
        cordon=tpu_config.remediation_cordon,
        taint_key=tpu_config.remediation_taint_key,
        taint_value=tpu_config.remediation_taint_value,
        taint_effect=tpu_config.remediation_taint_effect,
        cooldown_seconds=tpu_config.remediation_cooldown_seconds,
        max_actions_per_hour=tpu_config.remediation_max_actions_per_hour,
        max_quarantined_nodes=tpu_config.remediation_max_quarantined_nodes,
    )
    kwargs.update(overrides)
    actuator = NodeActuator(client, metrics=metrics, **kwargs)
    if adopt:
        actuator.adopt_existing()
    return actuator


def build_policy(
    actuator: NodeActuator,
    tpu_config,
    *,
    dispatcher,
    metrics=None,
    environment: str = "",
) -> ProbeRemediationPolicy:
    """The policy of ``tpu_config``; its payloads go out through
    ``dispatcher`` as ``kind="remediation"`` notifications."""

    def sink(payload: Dict[str, Any]) -> None:
        dispatcher.submit(Notification(payload, time.monotonic(), kind="remediation"))

    return ProbeRemediationPolicy(
        actuator,
        confirm_cycles=tpu_config.remediation_confirm_cycles,
        sink=sink,
        metrics=metrics,
        environment=environment,
    )
