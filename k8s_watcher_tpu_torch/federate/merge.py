"""The merged global fleet view (the JAX package's ``federate/merge.py``):
N upstream clusters folded into one ``FleetView``.

- **Keys**: ``(cluster, kind, key) -> (kind, "cluster/key")``. A merged
  object carries ``cluster`` and ``origin_key``, and its ``key`` is the
  global key. Local producers never put ``/`` in a pod uid or slice name,
  so cluster names cannot collide with local objects.
- **The global rv line** is the local view's own: a total order of
  application and, since one subscriber applies one upstream in its rv
  order, per-(cluster, key) order; not cross-cluster happens-before.
- **Epochs**: an upstream's ``view`` instance id is its epoch. A new epoch
  or any 410 goes through ``reset_cluster``, a full reconcile (upsert what
  is current, delete what vanished); identical upserts cost no rv.
- **Stale or dropped** (``federation.drop_stale``): a dark upstream's
  objects are deleted from the global view when it is set, kept as
  last-known state (the default) otherwise, with the staleness reported
  per upstream in ``/healthz`` and ``federation_upstream_stale``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Set, Tuple

from k8s_watcher_tpu_torch.federate.client import DELETE

#: separator between the cluster name and the upstream key in a global key
CLUSTER_SEP = "/"


def global_key(cluster: str, key: str) -> str:
    return f"{cluster}{CLUSTER_SEP}{key}"


def split_global_key(gkey: str) -> Tuple[str, str]:
    """``(cluster, upstream_key)`` — inverse of ``global_key``."""
    cluster, _, key = gkey.partition(CLUSTER_SEP)
    return cluster, key


def merged_equals_union(merged_objects, upstream_objects: Dict[str, Any]) -> bool:
    """The federation's convergence check, in one place: the merged
    view's federated objects must
    equal the union of the upstream snapshots under cluster-prefixed
    keys, with the decoration the merge adds (the rewritten ``key``;
    ``cluster``/``origin_key`` are additive) excluded from the compare.

    ``merged_objects``: the federator snapshot's object list (non-
    federated local objects are ignored). ``upstream_objects``: mapping
    of cluster name -> that upstream snapshot's object list."""
    expected = {}
    for cluster, objects in upstream_objects.items():
        for obj in objects:
            expected[(obj["kind"], global_key(cluster, obj["key"]))] = obj
    merged = {
        (obj["kind"], obj["key"]): obj for obj in merged_objects if obj.get("cluster")
    }
    if merged.keys() != expected.keys():
        return False
    return all(
        all(merged[k].get(field) == v for field, v in exp.items() if field != "key")
        for k, exp in expected.items()
    )


class GlobalMerge:
    """Write-side fold of upstream events into the shared FleetView.

    One upstream subscriber thread per cluster calls in; the per-cluster
    key registry is lock-guarded so ``object_count``/health reads and the
    monitor thread's ``drop_cluster`` stay consistent with it. The
    FleetView does its own locking — per-key last-writer-wins is exactly
    the state-serving contract."""

    def __init__(self, view, *, drop_stale: bool = False, metrics=None):
        self.view = view
        self.drop_stale = drop_stale
        self._lock = threading.Lock()
        self._keys: Dict[str, Set[Tuple[str, str]]] = {}  # cluster -> {(kind, upstream key)}
        # running registry size, maintained incrementally on every
        # add/discard/reset/drop: the merged-object gauge used to
        # recompute sum(len(k)) per DELTA — O(clusters) work inside the
        # fan-in hot path for a number that only moves by what the
        # mutation itself changed
        self._count = 0
        self._merged_gauge = (
            metrics.gauge("federation_merged_objects") if metrics is not None else None
        )

    def _set_gauge_locked(self) -> None:
        if self._merged_gauge is not None:
            self._merged_gauge.set(self._count)

    def seed_from_view(self) -> int:
        """Adopt federated objects ALREADY in the view (a history-recovered
        federator restart): the per-cluster key registry must mirror the
        recovered view, or the first reconcile cannot delete objects that
        vanished upstream during the outage (ghost objects served forever),
        ``drop_cluster`` pops an empty set, and the merged-object gauge
        reads 0 against a populated view. Returns the seeded count.

        On a columnar view this reads ``federated_keys()`` — cluster
        membership answered off the int cluster column, no O(fleet)
        object reconstruction just to drop all but the ``cluster`` and
        ``key`` fields. The origin key is recovered from the global key
        (``_decorate`` mints ``origin_key == split_global_key(key)[1]``,
        so the derivation is exact for anything it decorated). The dict
        core walks objects as before."""
        seeded = 0
        if hasattr(self.view, "federated_keys"):
            with self._lock:
                for kind, gkey, cluster in self.view.federated_keys():
                    _, origin = split_global_key(gkey)
                    if not origin:
                        continue
                    keys = self._keys.setdefault(cluster, set())
                    entry = (kind or "pod", origin)
                    if entry not in keys:
                        keys.add(entry)
                        self._count += 1
                    seeded += 1
                self._set_gauge_locked()
            return seeded
        _, objects = self.view.snapshot()
        with self._lock:
            for obj in objects:
                cluster = obj.get("cluster")
                origin = obj.get("origin_key")
                if not cluster or not origin:
                    continue  # the local watcher's own (non-federated) objects
                keys = self._keys.setdefault(cluster, set())
                entry = (obj.get("kind") or "pod", origin)
                if entry not in keys:
                    keys.add(entry)
                    self._count += 1
                seeded += 1
            self._set_gauge_locked()
        return seeded

    @staticmethod
    def _decorate(cluster: str, kind: str, key: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        return {**obj, "kind": kind, "key": global_key(cluster, key),
                "cluster": cluster, "origin_key": key}

    def reset_cluster(self, cluster: str, objects) -> int:
        """Adopt a full upstream snapshot (initial connect, epoch change,
        every 410 resync): upsert all current objects, delete the global
        keys that vanished — ONE registry-lock acquisition and ONE view
        publish-lock hold for the whole reconcile. Returns the number of
        view deltas actually minted (identical upserts are free, so a
        clean reconcile after a blip costs exactly the real deltas)."""
        fresh: Set[Tuple[str, str]] = set()
        items: list = []
        for obj in objects:
            kind = obj.get("kind") or "pod"
            key = obj.get("key")
            if not key:
                continue
            fresh.add((kind, key))
            items.append((kind, global_key(cluster, key),
                          self._decorate(cluster, kind, key, obj)))
        with self._lock:
            stale = self._keys.get(cluster, set()) - fresh
            self._count += len(fresh) - len(self._keys.get(cluster, ()))
            self._keys[cluster] = fresh
            self._set_gauge_locked()
        items.extend((kind, global_key(cluster, key), None) for kind, key in stale)
        return self.view.apply_batch(items)

    @staticmethod
    def _origin_stamp(item: Dict[str, Any]):
        """The upstream frame's negotiated freshness stamp (origin wall
        time), propagated into the merged view's Delta so the global rv
        line — and any federator federating THIS one — keeps measuring
        true end-to-end age. None when the upstream didn't stamp."""
        ts = item.get("ts")
        return ts[0] if isinstance(ts, (list, tuple)) and ts else None

    @staticmethod
    def _wire_trace(item: Dict[str, Any]):
        """The upstream frame's negotiated ``trace`` field (the compact
        journey dict, already augmented by the trace collector with this
        hop's serve_wire span), propagated into the merged Delta so the
        GLOBAL view's republished frames keep the trace identity — a
        second-tier federator joins the next hop from it. None when the
        upstream didn't trace (the unsampled 255/256)."""
        trace = item.get("trace")
        return trace if isinstance(trace, dict) else None

    def apply_delta(self, cluster: str, item: Dict[str, Any]) -> bool:
        """Fold one wire delta (UPSERT/DELETE frame dict) from ``cluster``.
        Returns True when the global view actually changed. The per-delta
        shape — one publish-lock hold, one wakeup, one registry-lock
        acquisition per frame; ``apply_batch`` is the amortized path the
        subscriber loop feeds (this stays as the per-delta baseline and the
        one-off-mutation convenience)."""
        kind = item.get("kind") or "pod"
        key = item["key"]
        gkey = global_key(cluster, key)
        ts_wall = self._origin_stamp(item)
        trace = self._wire_trace(item)
        if item["type"] == DELETE:
            changed = self.view.apply(kind, gkey, None, ts_wall=ts_wall, trace=trace)
            with self._lock:
                keys = self._keys.setdefault(cluster, set())
                if (kind, key) in keys:
                    keys.discard((kind, key))
                    self._count -= 1
                self._set_gauge_locked()
            return changed
        changed = self.view.apply(
            kind, gkey, self._decorate(cluster, kind, key, item.get("object") or {}),
            ts_wall=ts_wall, trace=trace,
        )
        with self._lock:
            keys = self._keys.setdefault(cluster, set())
            if (kind, key) not in keys:
                keys.add((kind, key))
                self._count += 1
            self._set_gauge_locked()
        return changed

    def apply_batch(self, cluster: str, items) -> int:
        """Fold one decoded wire-frame batch (the subscriber loop hands
        over whatever one chunked read carried) under ONE registry-lock
        acquisition and ONE view publish-lock hold — the fan-in analogue
        of the pipeline's ``publish_batch``. Frames apply in wire order,
        so per-(cluster,key) last-writer-wins is preserved; the view
        dedups identical upserts exactly as the per-delta path does.
        Returns the number of global-view deltas minted."""
        view_items: list = []
        for item in items:
            kind = item.get("kind") or "pod"
            key = item["key"]
            ts_wall = self._origin_stamp(item)
            trace = self._wire_trace(item)
            if item["type"] == DELETE:
                view_items.append((kind, global_key(cluster, key), None, ts_wall, trace))
            else:
                view_items.append((kind, global_key(cluster, key),
                                   self._decorate(cluster, kind, key, item.get("object") or {}),
                                   ts_wall, trace))
        changed = self.view.apply_batch(view_items)
        with self._lock:
            keys = self._keys.setdefault(cluster, set())
            before = len(keys)
            for item, (kind, _gkey, obj, _ts, _tr) in zip(items, view_items):
                entry = (kind, item["key"])
                if obj is None:
                    keys.discard(entry)
                else:
                    keys.add(entry)
            self._count += len(keys) - before
            self._set_gauge_locked()
        return changed

    def apply_view_batch(self, cluster: str, view_items) -> int:
        """Fold a batch of ALREADY-PREPARED view items from ``cluster`` —
        the sharded fan-in's parent-side sequencer path. A merge worker
        did the per-frame work (decode, re-key, decorate, stamp/trace
        extraction, optional raw-frame passthrough) in its own process;
        items arrive as ``(kind, global_key, obj_or_None, ts_wall, trace,
        frame_bytes_or_None)`` and go straight into ONE view publish-lock
        hold. The parent keeps the ONLY key registry (it must survive
        worker respawns, or reconciles could never delete ghosts), so the
        registry fold happens here, from the global keys. Returns the
        number of global-view deltas minted."""
        changed = self.view.apply_batch(view_items)
        with self._lock:
            keys = self._keys.setdefault(cluster, set())
            before = len(keys)
            for item in view_items:
                kind, gkey, obj = item[0], item[1], item[2]
                entry = (kind, split_global_key(gkey)[1])
                if obj is None:
                    keys.discard(entry)
                else:
                    keys.add(entry)
            self._count += len(keys) - before
            self._set_gauge_locked()
        return changed

    def drop_cluster(self, cluster: str) -> int:
        """The ``drop_stale: true`` policy arm: remove a dark upstream's
        objects from the global view (one batched publish). Returns
        deltas minted."""
        with self._lock:
            keys = self._keys.pop(cluster, set())
            self._count -= len(keys)
            self._set_gauge_locked()
        return self.view.apply_batch(
            [(kind, global_key(cluster, key), None) for kind, key in keys]
        )

    def cluster_object_count(self, cluster: str) -> int:
        with self._lock:
            return len(self._keys.get(cluster, ()))

    def object_count(self) -> int:
        with self._lock:
            return self._count

    def snapshot_cluster(self, cluster: str) -> Optional[Set[Tuple[str, str]]]:
        with self._lock:
            keys = self._keys.get(cluster)
            return set(keys) if keys is not None else None
