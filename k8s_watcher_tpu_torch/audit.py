"""Recent-event audit ring.

SURVEY.md §5: the reference's only observability was per-event log lines
(pod_watcher.py:223). Metrics (metrics/metrics.py) aggregate; this ring
answers the operator's next question — "what did the watcher just DO with
my pod?" — by keeping the last N pipeline decisions (event, filter hit or
notify outcome, phase transition) queryable at ``/debug/events`` without
log access or a redeploy at DEBUG level.

Bounded memory, lock-guarded, wall-clock stamped; recording is O(1) and
allocation-light so it can sit on the hot path unconditionally.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class AuditRing:
    def __init__(self, capacity: int = 256):
        self.capacity = max(1, capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            entry["ts"] = time.time()
            self._ring.append(entry)

    def snapshot(
        self, n: Optional[int] = None, *, uid: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        """Newest-first copy of the last ``n`` matching entries (None =
        all, n<=0 = none — "last N" means what it says, not "dump
        everything"). ``uid`` follows one pod's full journey — its
        pipeline decisions AND its egress terminal outcomes ride the same
        ring, so the filter answers "what happened to my pod's
        notification" in one query."""
        if n is not None and n <= 0:
            return []
        with self._lock:
            items = list(self._ring)
        items.reverse()
        if uid is not None:
            items = [e for e in items if e.get("uid") == uid]
        return items[:n]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
