"""Columnar fleet-state store: the core behind ``FleetView`` (the JAX
package's ``serve/columns.py``).

Pods live in append-only columnar rows:

- ``_parts[row]``: the pod's serialized JSON fragment, stored WITH its
  leading ``b", "`` element separator, so the ``GET /serve/fleet`` body is a
  header plus one ``b"".join`` over the parts, byte-identical to
  ``json.dumps`` of the dict core's body (default separators);
- int columns (``phase``/``ready``/``node``/``cluster``) in capacity-doubling
  numpy arrays, with codes from the fixed ``POD_PHASES`` vocabulary and the
  stable ``Interner``s the analytics encoder uses, so the analytics plane
  reads them without walking objects (``fleet_columns``);
- ``_rows``: key -> row. A delete TOMBSTONES the row (empty part, phase -1)
  instead of moving another row into it, because row order is the body's
  object order and must reproduce the dict core's insertion order; the
  tombstones are reclaimed by an order-preserving compaction once they
  outnumber half the table.

Slice aggregates, probe verdicts and any pod object that does not round-trip
through JSON stay object-shaped in a side table, each entry pinned to an
``anchor`` (the pod row index it was inserted before), so body assembly
interleaves the kinds in dict insertion order.

``upsert()`` is lazy: the object lands in a pending map and is serialized at
the next flush, which every reader runs first; a key overwritten many times
between reads is serialized once. Identical-upsert dedup matches the dict
core exactly: pending entries compare as dicts, flushed rows compare fragment
bytes, with a parse-and-compare fallback when the lengths match, so an equal
object with another key order still mints no rv.

Concurrency: the owning ``FleetView`` serializes every call under its publish
lock. Readers take a cheap structural snapshot (``snapshot_parts``) under the
lock and assemble outside it; parts are immutable bytes and side objects are
replaced, never mutated.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from k8s_watcher_tpu_torch.analytics.encode import (
    LOCAL_CLUSTER,
    POD_PHASE_CODE,
    POD_PHASES,
    FleetColumns,
    Interner,
    build_slice_tables,
)

#: the one kind the columnar table owns; every other kind (and the rare
#: pod that is not JSON-faithful) lives in the anchored side table
POD_KIND = "pod"

#: element separator baked into every stored fragment (``json.dumps``
#: default separators: the wire's byte contract)
SEP = b", "

#: CPython bytes-object overhead, for the resident-bytes estimate
_BYTES_OVERHEAD = 33
#: rough per-entry dict/str bookkeeping (hash table slot + str header)
_KEY_OVERHEAD = 130

_dumps = json.dumps
_loads = json.loads


def _fragment(obj: Dict[str, Any]) -> bytes:
    """``obj``'s body fragment (no separator): its slice of ``json.dumps``
    over the whole body."""
    return _dumps(obj).encode()


def _side_fragment(obj: Dict[str, Any]) -> Optional[bytes]:
    """``SEP + fragment`` for a side-table entry, or ``None`` when the object
    does not serialize: a structural snapshot never raises, only the JSON
    body assembly does, at build time (as the dict core's ``json.dumps``)."""
    try:
        return SEP + _fragment(obj)
    except (TypeError, ValueError):
        return None


class BodySnapshot(NamedTuple):
    """One consistent structural snapshot (taken under the publish lock,
    consumed outside it): the pod parts in row order (tombstones empty), the
    side entries as ``(anchor, fragment, kind, key, obj)`` in body order, and
    the live object count."""

    parts: List[bytes]
    sides: List[Tuple[int, bytes, str, str, Dict[str, Any]]]
    count: int
    keys: Optional[List[Optional[str]]]  # row -> pod key (when requested)


class PodHandle(NamedTuple):
    """The health plane's read handle: parallel per-pod sequences (live rows,
    then side-table pods) and the live slice objects, shared per generation.
    Phases are the fixed ``POD_PHASES`` vocabulary."""

    keys: List[str]
    phases: List[str]
    nodes: List[Optional[str]]
    slices: List[Dict[str, Any]]


class ColumnarStore:
    """Append/tombstone columnar fleet store with dict-of-dicts semantics
    (insertion order, identical-upsert dedup). Not thread-safe: the owning
    ``FleetView`` serializes calls under its publish lock."""

    def __init__(self) -> None:
        self.nodes = Interner()
        self.clusters = Interner()
        self.clusters.code(LOCAL_CLUSTER)  # code 0 = the local cluster
        # flushed pod rows
        self._rows: Dict[str, int] = {}  # live keys only
        self._parts: List[bytes] = []  # b", "+fragment; b"" = tombstone
        cap = 1024
        self._phase = np.full(cap, -1, dtype=np.int8)
        self._ready = np.zeros(cap, dtype=np.int8)
        self._node = np.zeros(cap, dtype=np.int32)
        self._cluster = np.zeros(cap, dtype=np.int32)
        self._arr_len = 0  # arrays are valid for rows [0, _arr_len)
        self._dead = 0  # tombstoned rows awaiting compaction
        # lazy write buffer: key -> obj (upserts only; deletes are eager)
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._pending_new = 0  # pending keys with no flushed row yet
        # anchored side table: (kind, key) -> (anchor, obj); anchor = the pod
        # row index this entry sorts before, non-decreasing in insertion order
        self._side: Dict[Tuple[str, str], Tuple[int, Dict[str, Any]]] = {}
        # generation: bumps on every logical mutation (not on flush) and
        # keys the column cache
        self._gen = 0
        self._cols: Optional[FleetColumns] = None
        self._cols_gen = -1
        self._handle: Optional[PodHandle] = None
        self._handle_gen = -1
        # incrementally maintained resident estimate (view_resident_bytes)
        self._parts_bytes = 0  # sum of len(part) over live and dead rows
        self._keys_bytes = 0  # key strings + per-entry bookkeeping

    # -- write path (owner-locked) ----------------------------------------

    def upsert(self, kind: str, key: str, obj: Dict[str, Any]) -> bool:
        """Insert or replace one object. False for the identical no-op (no
        rv is minted)."""
        if kind != POD_KIND:
            return self._side_upsert(kind, key, obj)
        sk = (POD_KIND, key)
        if sk in self._side:  # a pod that is not JSON-faithful, pinned object-shaped
            anchor, prev = self._side[sk]
            if prev == obj:
                return False
            self._side[sk] = (anchor, obj)
            self._gen += 1
            return True
        pend = self._pending.get(key)
        if pend is not None:
            if pend == obj:
                return False
            self._pending[key] = obj
            self._gen += 1
            return True
        row = self._rows.get(key)
        if row is None:
            self._pending[key] = obj
            self._pending_new += 1
            self._gen += 1
            return True
        # a flushed row: exact dedup against the stored fragment
        try:
            frag = _fragment(obj)
        except (TypeError, ValueError):
            # it cannot equal the (serialized) row: tombstone the row and pin
            # the object in the side table at the SAME position
            self._tombstone(key, row)
            self._side[sk] = (row, obj)
            self._gen += 1
            return True
        old = self._parts[row]
        if len(old) - len(SEP) == len(frag):
            if old[len(SEP):] == frag:
                return False
            # same length, other bytes: an equal dict in another key order
            # must not mint a delta either
            if _loads(old[len(SEP):]) == obj:
                return False
        self._set_row(row, SEP + frag, obj)
        self._gen += 1
        return True

    def delete(self, kind: str, key: str) -> bool:
        """Remove one object. False when absent (no rv is minted)."""
        if kind != POD_KIND:
            if self._side.pop((kind, key), None) is None:
                return False
            self._gen += 1
            return True
        if self._side.pop((POD_KIND, key), None) is not None:
            self._gen += 1
            return True
        if key in self._pending and key not in self._rows:
            # a never-flushed insert. When no side anchor counts a pending
            # position (anchors past len(parts) do), this is a plain pop, so
            # a churning pods-only stream stays on the pending buffer
            if all(anchor <= len(self._parts) for anchor, _obj in self._side.values()):
                self._pending.pop(key)
                self._pending_new -= 1
                self._gen += 1
                return True
            # a side anchor references a pending position: materialize the
            # pending set first so row order stays insertion order
            self._flush()
        elif key in self._pending:
            self._pending.pop(key)  # discard the pending overwrite
        row = self._rows.get(key)
        if row is None:
            return False
        self._tombstone(key, row)
        self._gen += 1
        if self._dead > 1024 and self._dead * 2 > len(self._parts):
            self._compact()
        return True

    def reseed(self, objects) -> None:
        """Adopt a whole ``{(kind, key): obj}`` state (the view's
        ``restore``). The interners keep their codes, and nothing is
        serialized here: the first body build flushes the pending pods."""
        self._rows.clear()
        self._parts.clear()
        self._phase[: self._arr_len] = -1
        self._arr_len = 0
        self._dead = 0
        self._pending.clear()
        self._pending_new = 0
        self._side.clear()
        self._parts_bytes = 0
        self._keys_bytes = 0
        for (kind, key), obj in objects.items():
            if kind == POD_KIND:
                self._pending[key] = obj
                self._pending_new += 1
            else:
                self._side[(kind, key)] = (self._anchor(), obj)
        self._gen += 1

    def _side_upsert(self, kind: str, key: str, obj: Dict[str, Any]) -> bool:
        sk = (kind, key)
        prev = self._side.get(sk)
        if prev is not None:
            if prev[1] == obj:
                return False
            self._side[sk] = (prev[0], obj)  # a replace keeps its position
        else:
            self._side[sk] = (self._anchor(), obj)
        self._gen += 1
        return True

    def _anchor(self) -> int:
        """The pod row index the next side entry sorts before: every pod
        inserted so far (dead rows keep their slot) plus pending inserts."""
        return len(self._parts) + self._pending_new

    def _tombstone(self, key: str, row: int) -> None:
        self._rows.pop(key, None)
        old = self._parts[row]
        self._parts[row] = b""
        if row < self._arr_len:
            self._phase[row] = -1
        self._parts_bytes -= len(old)
        self._keys_bytes -= _KEY_OVERHEAD + len(key)
        self._dead += 1

    def _set_row(self, row: int, part: bytes, obj: Dict[str, Any]) -> None:
        self._parts_bytes += len(part) - len(self._parts[row])
        self._parts[row] = part
        self._phase[row] = POD_PHASE_CODE.get(obj.get("phase") or "Unknown", 0)
        self._ready[row] = 1 if obj.get("ready") else 0
        node = obj.get("node")
        self._node[row] = self.nodes.code(str(node)) if node else -1
        self._cluster[row] = self.clusters.code(str(obj.get("cluster") or LOCAL_CLUSTER))

    # -- flush (pending -> columns; every reader's first step) -------------

    def _grow(self, need: int) -> None:
        cap = len(self._phase)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("_phase", "_ready", "_node", "_cluster"):
            old = getattr(self, name)
            fresh = np.full(cap, -1, dtype=old.dtype) if name == "_phase" else np.zeros(cap, dtype=old.dtype)
            fresh[: self._arr_len] = old[: self._arr_len]
            setattr(self, name, fresh)

    def _flush(self) -> None:
        """Serialize the pending buffer into rows: O(keys changed since the
        last reader), each paying the one dumps the body needed anyway."""
        if not self._pending:
            return
        pending, self._pending = self._pending, {}
        self._pending_new = 0
        new_phase: List[int] = []
        new_ready: List[int] = []
        new_node: List[int] = []
        new_cluster: List[int] = []
        nodes_code = self.nodes.code
        clusters_code = self.clusters.code
        for key, obj in pending.items():
            row = self._rows.get(key)
            try:
                part = SEP + _fragment(obj)
            except (TypeError, ValueError):
                # not JSON-faithful: pin it object-shaped at its position
                if row is not None:
                    self._tombstone(key, row)
                    self._side[(POD_KIND, key)] = (row, obj)
                else:
                    self._side[(POD_KIND, key)] = (len(self._parts), obj)
                continue
            if row is None:
                self._rows[key] = len(self._parts)
                self._parts.append(part)
                self._parts_bytes += len(part)
                self._keys_bytes += _KEY_OVERHEAD + len(key)
                new_phase.append(POD_PHASE_CODE.get(obj.get("phase") or "Unknown", 0))
                new_ready.append(1 if obj.get("ready") else 0)
                node = obj.get("node")
                new_node.append(nodes_code(str(node)) if node else -1)
                new_cluster.append(clusters_code(str(obj.get("cluster") or LOCAL_CLUSTER)))
            else:
                self._set_row(row, part, obj)
        if new_phase:
            n = self._arr_len
            m = len(new_phase)
            self._grow(n + m)
            self._phase[n : n + m] = new_phase
            self._ready[n : n + m] = new_ready
            self._node[n : n + m] = new_node
            self._cluster[n : n + m] = new_cluster
        self._arr_len = len(self._parts)

    def _compact(self) -> None:
        """Order-preserving tombstone reclaim: rewrite the rows in insertion
        order and remap the key index and the side anchors."""
        self._flush()
        n = len(self._parts)
        mask = self._phase[:n] >= 0
        idx = np.flatnonzero(mask)
        before = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(mask, out=before[1:])
        new_of_old = before[1:] - 1  # new row of each live old row
        self._parts = [self._parts[i] for i in idx.tolist()]
        m = len(self._parts)
        for name in ("_phase", "_ready", "_node", "_cluster"):
            old = getattr(self, name)
            size = max(1024, m)
            fresh = np.full(size, -1, dtype=old.dtype) if name == "_phase" else np.zeros(size, dtype=old.dtype)
            fresh[:m] = old[:n][mask]
            setattr(self, name, fresh)
        self._arr_len = m
        for key, row in self._rows.items():
            self._rows[key] = int(new_of_old[row])
        if self._side:
            self._side = {sk: (int(before[min(anchor, n)]), obj) for sk, (anchor, obj) in self._side.items()}
        self._dead = 0

    # -- structural snapshots (owner-locked; assembly happens outside) ----

    def snapshot_parts(self, *, with_keys: bool = False) -> BodySnapshot:
        """Flush and hand out a consistent body-order snapshot (list copies
        only). Sides sort on the anchor alone: the stable sort keeps equal
        anchors in side-table insertion order, the dict core's order."""
        self._flush()
        sides = sorted(
            ((anchor, _side_fragment(obj), kind, key, obj) for (kind, key), (anchor, obj) in self._side.items()),
            key=lambda entry: entry[0],
        ) if self._side else []
        keys: Optional[List[Optional[str]]] = None
        if with_keys:
            keys = [None] * len(self._parts)
            for key, row in self._rows.items():
                keys[row] = key
        return BodySnapshot(parts=self._parts.copy(), sides=sides, count=len(self._rows) + len(self._side), keys=keys)

    def fleet_columns(self) -> FleetColumns:
        """The analytics plane's arrays, built at most once per generation:
        live pod rows masked out of the columns, side-table pods appended,
        slice and worker tables from the live slice objects through the
        builder the analytics encoder uses."""
        self._flush()
        if self._cols is not None and self._cols_gen == self._gen:
            return self._cols
        n = self._arr_len
        mask = self._phase[:n] >= 0
        pod_phase = self._phase[:n][mask].astype(np.int32)
        pod_ready = self._ready[:n][mask].astype(np.int32)
        pod_node = self._node[:n][mask].copy()
        pod_cluster = self._cluster[:n][mask].copy()
        slices: Dict[str, Dict[str, Any]] = {}
        extra: List[Tuple[int, int, int, int]] = []
        for (kind, key), (_anchor, obj) in self._side.items():
            if kind == "slice":
                slices[key] = obj
            elif kind == POD_KIND:
                node = obj.get("node")
                extra.append((
                    POD_PHASE_CODE.get(obj.get("phase") or "Unknown", 0),
                    1 if obj.get("ready") else 0,
                    self.nodes.code(str(node)) if node else -1,
                    self.clusters.code(str(obj.get("cluster") or LOCAL_CLUSTER)),
                ))
        if extra:
            ex = np.asarray(extra, dtype=np.int32)
            pod_phase = np.concatenate([pod_phase, ex[:, 0]])
            pod_ready = np.concatenate([pod_ready, ex[:, 1]])
            pod_node = np.concatenate([pod_node, ex[:, 2]])
            pod_cluster = np.concatenate([pod_cluster, ex[:, 3]])
        self._cols = FleetColumns(
            pod_phase=pod_phase,
            pod_ready=pod_ready,
            pod_node=pod_node,
            pod_cluster=pod_cluster,
            **build_slice_tables(slices, self.nodes, self.clusters),
            nodes=self.nodes,
            clusters=self.clusters,
        )
        self._cols_gen = self._gen
        return self._cols

    def pod_handle(self) -> PodHandle:
        """The health plane's per-pod sequences (see ``PodHandle``), cached
        per generation beside the columns."""
        self._flush()
        if self._handle is not None and self._handle_gen == self._gen:
            return self._handle
        n = self._arr_len
        row_keys: List[Optional[str]] = [None] * n
        for key, row in self._rows.items():
            row_keys[row] = key
        mask = self._phase[:n] >= 0
        idx = np.flatnonzero(mask).tolist()
        node_names = self.nodes.names
        keys = [row_keys[i] for i in idx]
        phases = [POD_PHASES[c] for c in self._phase[:n][mask].tolist()]
        nodes = [node_names[c] if c >= 0 else None for c in self._node[:n][mask].tolist()]
        slices: List[Dict[str, Any]] = []
        for (kind, key), (_anchor, obj) in self._side.items():
            if kind == "slice":
                slices.append(obj)
            elif kind == POD_KIND:
                keys.append(key)
                phases.append(str(obj.get("phase") or "Unknown"))
                node = obj.get("node")
                nodes.append(str(node) if node else None)
        self._handle = PodHandle(keys=keys, phases=phases, nodes=nodes, slices=slices)
        self._handle_gen = self._gen
        return self._handle

    def federated_entries(self) -> List[Tuple[str, str, str]]:
        """``(kind, global_key, cluster)`` for every federated object, off
        the cluster column for pods and off the object for side entries (the
        merge registry's reseed; no object is rebuilt)."""
        self._flush()
        out: List[Tuple[str, str, str]] = []
        n = self._arr_len
        cluster_col = self._cluster
        names = self.clusters.names
        for key, row in self._rows.items():
            code = int(cluster_col[row]) if row < n else 0
            if code > 0:
                out.append((POD_KIND, key, names[code]))
        for (kind, key), (_anchor, obj) in self._side.items():
            cluster = obj.get("cluster")
            if cluster:
                out.append((kind, key, str(cluster)))
        return out

    def resident_bytes(self) -> int:
        """O(1) resident estimate for the ``view_resident_bytes`` gauge."""
        arrays = self._phase.nbytes + self._ready.nbytes + self._node.nbytes + self._cluster.nbytes
        parts_list = len(self._parts) * 8 + (len(self._parts) - self._dead) * _BYTES_OVERHEAD
        pending = len(self._pending) * 800  # unflushed objects, rough
        side = len(self._side) * 900
        return self._parts_bytes + parts_list + self._keys_bytes + arrays + pending + side

    # -- dict-of-dicts compatibility (a mapping over (kind, key)) ----------

    def __len__(self) -> int:
        return len(self._rows) + self._pending_new + len(self._side)

    def __contains__(self, map_key) -> bool:
        kind, key = map_key
        if kind == POD_KIND and (key in self._rows or key in self._pending):
            return True
        return map_key in self._side

    def get(self, map_key, default=None):
        kind, key = map_key
        if kind == POD_KIND:
            pend = self._pending.get(key)
            if pend is not None:
                return pend
            row = self._rows.get(key)
            if row is not None:
                return _loads(self._parts[row][len(SEP):])
        entry = self._side.get(map_key)
        return entry[1] if entry is not None else default

    def __getitem__(self, map_key):
        obj = self.get(map_key)
        if obj is None:
            raise KeyError(map_key)
        return obj

    def __setitem__(self, map_key, obj) -> None:
        self.upsert(map_key[0], map_key[1], obj)

    def pop(self, map_key, default=None):
        """O(1) removal without reconstructing the object (the relay's fold)."""
        existed = map_key in self
        self.delete(map_key[0], map_key[1])
        return True if existed and default is None else (default if not existed else True)

    def items(self) -> Iterator[Tuple[Tuple[str, str], Dict[str, Any]]]:
        """``((kind, key), obj)`` in insertion order: O(fleet)
        reconstruction; hot paths use the structural snapshot instead."""
        snap = self.snapshot_parts(with_keys=True)
        for kind, key, obj in iter_snapshot_objects(snap):
            yield (kind, key), obj

    def keys(self):
        for map_key, _obj in self.items():
            yield map_key

    def __iter__(self):
        return self.keys()

    def values(self):
        for _map_key, obj in self.items():
            yield obj


# -- body assembly and reconstruction (outside the publish lock) ----------


def assemble_json_body(rv: int, instance: str, snap: BodySnapshot) -> bytes:
    """The ``GET /serve/fleet`` JSON body from one structural snapshot,
    byte-identical to ``json.dumps({"rv": rv, "view": instance, "objects":
    [...]})`` over the dict core's objects, as one join over the parts."""
    header = ('{"rv": %d, "view": %s, "objects": [' % (rv, _dumps(instance))).encode()
    out = [header]
    it = iter(_body_chunks(snap))
    # the first non-empty chunk sheds its leading separator (tombstones are
    # empty and join away)
    for chunk in it:
        if chunk:
            out.append(chunk[len(SEP):])
            break
    out.extend(it)
    out.append(b"]}")
    return b"".join(out)


def _body_chunks(snap: BodySnapshot) -> List[bytes]:
    """Parts and side fragments interleaved into body order."""
    parts = snap.parts
    if not snap.sides:
        return parts
    chunks: List[bytes] = []
    prev = 0
    for anchor, frag, _kind, _key, obj in snap.sides:
        cut = min(anchor, len(parts))
        if cut > prev:
            chunks.extend(parts[prev:cut])
            prev = cut
        # a None fragment is a side object that does not serialize: raise
        # the dict core's error here, at JSON-body build time
        chunks.append(frag if frag is not None else SEP + _fragment(obj))
    chunks.extend(parts[prev:])
    return chunks


def assemble_msgpack_body(rv: int, instance: str, snap: BodySnapshot, packb) -> bytes:
    """The msgpack snapshot body, composed element by element: the map and
    array headers are written by hand and each element packed on its own,
    byte-identical to ``packb({"rv", "view", "objects"})`` because msgpack is
    compositional. Pods are parsed back from their JSON fragments."""
    count = snap.count
    if count < 16:
        array_header = bytes([0x90 | count])
    elif count < 1 << 16:
        array_header = b"\xdc" + count.to_bytes(2, "big")
    else:
        array_header = b"\xdd" + count.to_bytes(4, "big")
    out = [b"\x83", packb("rv"), packb(rv), packb("view"), packb(instance), packb("objects"), array_header]
    for _kind, _key, obj in iter_snapshot_objects(snap):
        out.append(packb(obj))
    return b"".join(out)


def iter_snapshot_objects(snap: BodySnapshot) -> Iterator[Tuple[str, str, Dict[str, Any]]]:
    """``(kind, key, obj)`` in body order. Pods parse back from their
    fragments (fresh dicts, equal to what was stored); side objects are the
    live references."""
    sep = len(SEP)
    parts = snap.parts
    keys = snap.keys
    prev = 0
    for anchor, _frag, kind, key, obj in snap.sides:
        cut = min(anchor, len(parts))
        for i in range(prev, cut):
            part = parts[i]
            if part:
                yield POD_KIND, (keys[i] if keys else ""), _loads(part[sep:])
        prev = cut
        yield kind, key, obj
    for i in range(prev, len(parts)):
        part = parts[i]
        if part:
            yield POD_KIND, (keys[i] if keys else ""), _loads(part[sep:])
