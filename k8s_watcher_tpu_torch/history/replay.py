"""Deterministic WAL replay: any production capture becomes a fixture (the
JAX package's ``history/replay.py``).

``replay_wal`` feeds a captured WAL back through a **fresh FleetView**
— the real apply machinery, not a shortcut fold — asserting at every
step that the view re-mints exactly the recorded rv. Because the view's
rv space is dense (one delta, one increment, no-ops burn nothing) and
WAL records serialize canonically (sorted keys, compact separators),
the same capture always reduces to the same terminal snapshot, byte for
byte: replay it twice, compare the bytes, and any divergence is a real
nondeterminism bug in the view/WAL contract — which is what makes a
captured incident WAL a regression fixture.

What determinism does and does not guarantee:

- **Guaranteed**: identical WAL bytes -> identical terminal snapshot
  bytes (and identical snapshot at any ``--at`` rv), across processes,
  hosts and Python versions (no dict-order, timestamp or id leakage —
  wall stamps live in the WAL records but never in the canonical
  snapshot).
- **Not guaranteed**: that two *captures* of the same cluster churn are
  identical (thread interleaving legitimately orders concurrent deltas
  differently), or that the WAL is a complete k8s event log (it records
  view deltas — post-filter, post-dedup — and an overrun rebase leaves
  a documented hole bridged by a snapshot record).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple

from k8s_watcher_tpu_torch.history.wal import (
    DELTAS,
    OP_DELETE,
    SNAP,
    item_object,
    list_segments,
    read_frames,
    record_items,
)


class ReplayResult(NamedTuple):
    rv: int
    instance: Optional[str]
    objects: Dict[Tuple[str, str], Dict[str, Any]]
    deltas_applied: int
    snapshots_seen: int
    segments: int
    #: rv-mint mismatches between the recorded WAL and the fresh view
    #: (always 0 on a healthy capture; non-zero means the WAL and the
    #: view disagree about the delta algebra — a real bug)
    rv_mismatches: int


def canonical_snapshot(rv: int, objects: Dict[Tuple[str, str], Dict[str, Any]]) -> bytes:
    """The byte-comparable terminal form: sorted keys at every level,
    compact separators, no timestamps."""
    doc = {
        "rv": rv,
        "objects": [
            [kind, key, objects[(kind, key)]]
            for kind, key in sorted(objects)
        ],
    }
    return json.dumps(doc, separators=(",", ":"), sort_keys=True).encode()


def snapshot_sha256(snapshot: bytes) -> str:
    return hashlib.sha256(snapshot).hexdigest()


def replay_wal(directory: Path | str, *, at: Optional[int] = None) -> ReplayResult:
    """Feed the WAL through a fresh ``serve.view.FleetView``.

    Snapshot records seed (or re-seed, across a rebase hole) the view via
    ``restore``; delta records go through the REAL ``apply`` and the
    re-minted rv is checked against the recorded one. ``at`` stops the
    replay at that rv (inclusive) — the offline twin of ``?at=``.
    """
    from k8s_watcher_tpu_torch.serve.view import FleetView

    directory = Path(directory)
    view = FleetView(compact_horizon=1)
    instance: Optional[str] = None
    deltas_applied = 0
    snapshots_seen = 0
    mismatches = 0
    rv = 0
    segments = list_segments(directory)
    for _seq, path in segments:
        try:
            data = path.read_bytes()
        except OSError:
            continue
        records, _clean, _torn = read_frames(data)
        for record in records:
            rtype = record.get("t")
            if rtype == SNAP:
                snap_rv = int(record.get("rv", 0))
                if at is not None and snap_rv > at:
                    break
                snapshots_seen += 1
                instance = record.get("instance") or instance
                state = {}
                for entry in record.get("objects", ()):
                    try:
                        kind, key, obj = entry
                    except (TypeError, ValueError):
                        continue
                    state[(str(kind), str(key))] = obj
                view = FleetView(compact_horizon=1)
                view.restore(instance=instance or view.instance, rv=snap_rv, objects=state, journal=[])
                rv = snap_rv
            elif rtype == DELTAS:
                past_at = False
                for item in record_items(record):
                    try:
                        delta_rv, kind, key, op, obj = item
                        delta_rv = int(delta_rv)
                        obj = item_object(obj)
                    except (TypeError, ValueError):
                        continue
                    if delta_rv <= rv and rv:
                        continue  # rotation re-read; idempotent
                    if at is not None and delta_rv > at:
                        past_at = True
                        break
                    view.apply(str(kind), str(key), None if op == OP_DELETE else obj)
                    if view.rv != delta_rv:
                        mismatches += 1
                        # resync the line so one mismatch doesn't cascade
                        view.restore(
                            instance=view.instance, rv=delta_rv,
                            objects=dict(view.state_for_history()[1]), journal=[],
                        )
                    rv = delta_rv
                    deltas_applied += 1
                if past_at:
                    break
        else:
            continue
        break  # inner break (past --at) propagates out
    _final_rv, objects = view.state_for_history()
    return ReplayResult(
        rv=rv,
        instance=instance,
        objects=objects,
        deltas_applied=deltas_applied,
        snapshots_seen=snapshots_seen,
        segments=len(segments),
        rv_mismatches=mismatches,
    )


def replay_digest(directory: Path | str, *, at: Optional[int] = None) -> Dict[str, Any]:
    """One replay pass reduced to the comparable facts (two passes over the
    same WAL compare equal)."""
    result = replay_wal(directory, at=at)
    snapshot = canonical_snapshot(result.rv, result.objects)
    return {
        "rv": result.rv,
        "instance": result.instance,
        "objects": len(result.objects),
        "deltas_applied": result.deltas_applied,
        "snapshots_seen": result.snapshots_seen,
        "segments": result.segments,
        "rv_mismatches": result.rv_mismatches,
        "snapshot_bytes": len(snapshot),
        "sha256": snapshot_sha256(snapshot),
    }
