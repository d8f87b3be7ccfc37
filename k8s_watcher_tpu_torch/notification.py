"""The record handed to a notifier sink (the JAX package's ``pipeline.Notification``)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional


class Notification(NamedTuple):
    """A payload bound for the notifier, with its receive stamp (monotonic
    seconds) so event-to-notify latency can be measured end to end."""

    payload: Dict[str, Any]
    received_monotonic: float
    kind: str = "pod"  # "pod" | "slice" | "probe" | "remediation"
    trace: Optional[Any] = None
