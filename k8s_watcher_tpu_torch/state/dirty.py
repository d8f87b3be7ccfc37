"""Bounded changed-key accumulator for journaled checkpoints.

The watch source and phase tracker feed ``JournaledMapStore`` a delta
hint: the keys whose persisted entry changed since the last checkpoint
sweep (state/checkpoint.py). When nothing ever drains the hint — a
watcher running without ``state.checkpoint_path``, or a standalone
pipeline — a plain set would grow one entry per pod UID that ever
churns, forever (delete/recreate mints fresh UIDs each cycle).

``DirtyKeys`` bounds that: past ``max(floor, live_size)`` marked keys
the set collapses to the "unknown delta" sentinel (``drain()`` returns
``None``), which checkpoint consumers already treat as "full
compaction" — exactly what the journaled store would do anyway for a
delta that big, so the collapse costs correctness nothing and caps
memory at O(live state).
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Set


class DirtyKeys:
    """Thread-safe: ``mark`` runs on the shard pump threads (the watch
    source tracks pods as it pumps — watch/sharded.py) while ``drain``
    runs on the ingest drain thread's checkpoint sweep. An unlocked
    mark racing the drain's swap could land in the drained set mid-
    iteration (RuntimeError) or be lost. The lock is uncontended in
    steady state (one mark per tracked change, one drain per throttle
    window), so the hot-path cost is a bare acquire."""

    def __init__(self, floor: int = 4096):
        self.floor = floor
        self._lock = threading.Lock()
        self._keys: Optional[Set[Any]] = set()

    def mark(self, key: Any, live_size: int) -> None:
        """Record a changed key; ``live_size`` is the current size of the
        tracked map, so the collapse threshold follows the state."""
        with self._lock:
            if self._keys is None:
                return  # already collapsed; the next drain says "everything"
            self._keys.add(key)
            if len(self._keys) > max(self.floor, live_size):
                self._keys = None

    def drain(self) -> Optional[Set[Any]]:
        """The changed keys since the last drain, or None for "unknown —
        treat everything as changed"; clears the accumulator."""
        with self._lock:
            drained, self._keys = self._keys, set()
            return drained
