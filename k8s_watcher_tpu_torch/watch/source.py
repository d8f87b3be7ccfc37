"""Watch-source protocol and the event model.

Pods are represented as plain dicts in Kubernetes REST JSON shape
(``metadata``/``spec``/``status``), exactly what the API server's watch
stream delivers — no SDK object layer (the reference depended on the
``kubernetes`` SDK's typed objects; see SURVEY.md §2.5-2.6).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, Optional, Protocol, runtime_checkable


class EventType:
    """k8s watch event types (plus the framework-internal ERROR)."""

    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"
    BOOKMARK = "BOOKMARK"
    ERROR = "ERROR"
    # framework-internal: a frame the native prefilter proved irrelevant
    # (no accelerator key) and dropped unparsed; carries only the
    # resourceVersion so the resume point still advances
    PREFILTERED = "PREFILTERED"

    ALL = (ADDED, MODIFIED, DELETED, BOOKMARK, ERROR, PREFILTERED)


@dataclasses.dataclass
class WatchEvent:
    """One pod watch event.

    ``received_monotonic`` is captured the moment the event is read off the
    wire; the event→notify latency metric (BASELINE.md north star, <1 s p50)
    is measured from this stamp.
    """

    type: str
    pod: Dict[str, Any]
    resource_version: Optional[str] = None
    received_monotonic: float = dataclasses.field(default_factory=time.monotonic)
    received_at: float = dataclasses.field(default_factory=time.time)
    # watcher-INTERNAL flag (never derived from pod content, so a pod
    # cannot spoof it): this DELETED was synthesized from a pre-skeleton
    # checkpoint entry that carries no resource spec, and the accelerator
    # filter must pass it rather than silently leak the deletion
    legacy_tombstone: bool = False
    # trace.Trace when the head sampler picked this event, else None
    # (the 1-in-N steady state). Set ONCE by the shard pump before the
    # queue put; downstream stages only read it.
    trace: Optional[Any] = None

    @property
    def name(self) -> str:
        return (self.pod.get("metadata") or {}).get("name", "")

    @property
    def namespace(self) -> str:
        return (self.pod.get("metadata") or {}).get("namespace", "")

    @property
    def uid(self) -> str:
        return (self.pod.get("metadata") or {}).get("uid", "")

    @property
    def phase(self) -> str:
        return (self.pod.get("status") or {}).get("phase", "Unknown")


@runtime_checkable
class WatchSource(Protocol):
    """A stream of pod watch events.

    Implementations must be stoppable from another thread: ``stop()`` causes
    ``events()`` to return promptly (parity with watch.stop() in the
    reference's finally block, pod_watcher.py:276-277).
    """

    def events(self) -> Iterator[WatchEvent]:  # pragma: no cover - protocol
        ...

    def stop(self) -> None:  # pragma: no cover - protocol
        ...
