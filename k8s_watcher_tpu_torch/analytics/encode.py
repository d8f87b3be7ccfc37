"""Columnar encoding of fleet state: dict-of-dicts -> dense int arrays (the JAX
package's ``analytics/encode.py``, as it is).

The platform's state lives in ``FleetView`` as JSON-shaped objects —
right for serving, wrong for computing. This module turns a snapshot
(and keeps turning the delta stream) into the arrays the kernel layer
(``analytics/kernels.py``) runs on:

- **pods**: ``phase``, ``ready``, ``node``, ``cluster`` — one int row
  per pod object, strings replaced by codes from stable interning
  dictionaries.
- **slice workers**: the pod<->slice join the view already materializes
  (slice objects carry ``workers[]`` with node/phase/ready/node_ready) —
  ``slice``, ``node``, ``cluster``, ``up`` (counts toward readiness),
  ``chips`` per worker. This is the table every what-if masks.
- **slices**: the tracker's own incremental aggregates
  (``expected_workers``/``observed_workers``/``ready_workers``), carried
  so the vectorized recomputation can be cross-checked EXACTLY against
  them (``kernels.slice_rollup`` vs these columns — the analytics
  plane's standing self-test).

Interners are **stable**: a name keeps its code for the encoder's
lifetime, across incremental updates and full resets, so cached device
arrays, masks built from a previous materialization, and per-code
metrics never mean a different node after churn. Codes are dense and
only grow; the name tables are what verdicts decode back through.

Incremental maintenance: ``apply(kind, key, obj)`` folds one view delta
— the pod table is maintained columnar in place (append / overwrite /
swap-remove, O(1) per delta), while slice rows rebuild lazily from the
slice-object map on the next materialization (slice cardinality is
~workers_per_slice smaller than the pod table; rebuilding those rows is
noise next to re-walking 10k pods, which is exactly what this module
exists to stop doing). ``columns()`` materializes numpy arrays at most
once per dirty generation and hands back the same immutable-by-contract
``FleetColumns`` until the next delta.

Latest-wins compacted delta batches apply cleanly here: the encoder is
keyed state (like the view), so per-key-newest delivery reproduces the
same tables as the full stream.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

#: fixed pod-phase vocabulary (code 0 = the unknown fallback); fixed —
#: not interned — so phase codes are comparable across encoders,
#: captures and processes (replay verdicts vs live verdicts)
POD_PHASES = ("Unknown", "Pending", "Running", "Succeeded", "Failed")
POD_PHASE_CODE = {name: i for i, name in enumerate(POD_PHASES)}
PHASE_RUNNING = POD_PHASE_CODE["Running"]

#: slice aggregate phases (slices/tracker.py SlicePhase vocabulary)
SLICE_PHASES = ("Forming", "Ready", "Degraded", "Completed", "Terminated")
SLICE_PHASE_CODE = {name: i for i, name in enumerate(SLICE_PHASES)}

#: the local (un-federated) cluster's name in the cluster interner —
#: merged objects carry a ``cluster`` field (federate/merge.py), local
#: ones don't
LOCAL_CLUSTER = ""


def worker_up(worker: Mapping[str, Any]) -> bool:
    """THE worker-readiness predicate (Running & ready & node-up — the
    spelling of ``slices/tracker.py``'s ``ready_workers`` counting, over
    the serialized worker row). One definition shared by the columnar
    encoder AND the dict-walk reference fold: the whole plane's
    exactness contract hangs on these never diverging."""
    return (
        worker.get("phase") == "Running"
        and bool(worker.get("ready"))
        and worker.get("node_ready", True)
    )


class Interner:
    """Stable string <-> dense-int dictionary (append-only)."""

    __slots__ = ("_codes", "_names")

    def __init__(self) -> None:
        self._codes: Dict[str, int] = {}
        self._names: List[str] = []

    def code(self, name: str) -> int:
        code = self._codes.get(name)
        if code is None:
            code = len(self._names)
            self._codes[name] = code
            self._names.append(name)
        return code

    def lookup(self, name: str) -> Optional[int]:
        """Existing code or None — mask building must NOT mint codes for
        names the fleet has never seen (a typo'd node in a scenario
        matches nothing instead of growing the dictionary)."""
        return self._codes.get(name)

    def name(self, code: int) -> str:
        return self._names[code]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._names)

    def __len__(self) -> int:
        return len(self._names)


class FleetColumns(NamedTuple):
    """One materialized generation of the fleet, as dense arrays.

    All arrays are numpy on the host; kernels move them across the
    backend seam per call (``xp.asarray`` is free for numpy, a device
    put for jax). Treat every field as immutable — materializations are
    shared across consumers.
    """

    # pods
    pod_phase: np.ndarray  # int32 [Np] (POD_PHASES codes)
    pod_ready: np.ndarray  # int32 [Np] 0/1
    pod_node: np.ndarray  # int32 [Np] node interner codes (-1 unscheduled)
    pod_cluster: np.ndarray  # int32 [Np] cluster interner codes
    # slice workers (the what-if join table)
    w_slice: np.ndarray  # int32 [Nw] slice row index
    w_node: np.ndarray  # int32 [Nw] node code (-1 unscheduled)
    w_cluster: np.ndarray  # int32 [Nw] cluster code (the slice's)
    w_up: np.ndarray  # int32 [Nw] 1 = Running & ready & node_ready
    w_chips: np.ndarray  # int32 [Nw] chips this worker contributes
    # slices (tracker-maintained incremental aggregates, for cross-check
    # and quorum thresholds)
    s_expected: np.ndarray  # int32 [Ns] expected_workers (-1 unknown)
    s_observed: np.ndarray  # int32 [Ns] observed_workers (incremental)
    s_ready: np.ndarray  # int32 [Ns] ready_workers (incremental)
    s_phase: np.ndarray  # int32 [Ns] SLICE_PHASES codes
    s_cluster: np.ndarray  # int32 [Ns] cluster code
    s_chips_per_worker: np.ndarray  # int32 [Ns]
    # decode tables
    slice_names: Tuple[str, ...]  # row -> slice key (global key when merged)
    nodes: Interner
    clusters: Interner

    @property
    def n_pods(self) -> int:
        return len(self.pod_phase)

    @property
    def n_workers(self) -> int:
        return len(self.w_slice)

    @property
    def n_slices(self) -> int:
        return len(self.s_expected)


def _pod_row(obj: Mapping[str, Any], nodes: Interner, clusters: Interner) -> Tuple[int, int, int, int]:
    node = obj.get("node")
    return (
        POD_PHASE_CODE.get(obj.get("phase") or "Unknown", 0),
        1 if obj.get("ready") else 0,
        nodes.code(str(node)) if node else -1,
        clusters.code(str(obj.get("cluster") or LOCAL_CLUSTER)),
    )


def build_slice_tables(
    slices: Mapping[str, Mapping[str, Any]],
    nodes: Interner,
    clusters: Interner,
) -> Dict[str, Any]:
    """Build the slice + slice-worker columns from a keyed slice-object
    map: the ``w_*``/``s_*``/``slice_names`` kwargs of ``FleetColumns``.

    THE one spelling of the slice-table semantics (row order = sorted
    keys, ``worker_up`` readiness, cluster/node interning), shared by
    the analytics-edge ``FleetEncoder`` and the serve-core
    ``ColumnarStore`` — crosscheck exactness between those two paths
    holds by construction because they run this same function."""
    slice_names = tuple(sorted(slices))
    slice_row = {name: i for i, name in enumerate(slice_names)}
    s_expected = np.empty(len(slice_names), dtype=np.int32)
    s_observed = np.empty(len(slice_names), dtype=np.int32)
    s_ready = np.empty(len(slice_names), dtype=np.int32)
    s_phase = np.empty(len(slice_names), dtype=np.int32)
    s_cluster = np.empty(len(slice_names), dtype=np.int32)
    s_chips = np.empty(len(slice_names), dtype=np.int32)
    w_slice: List[int] = []
    w_node: List[int] = []
    w_cluster: List[int] = []
    w_up: List[int] = []
    w_chips: List[int] = []
    for name in slice_names:
        obj = slices[name]
        i = slice_row[name]
        expected = obj.get("expected_workers")
        chips_per_worker = int(obj.get("chips_per_worker") or 0)
        cluster = clusters.code(str(obj.get("cluster") or LOCAL_CLUSTER))
        s_expected[i] = -1 if expected is None else int(expected)
        s_observed[i] = int(obj.get("observed_workers") or 0)
        s_ready[i] = int(obj.get("ready_workers") or 0)
        s_phase[i] = SLICE_PHASE_CODE.get(obj.get("phase") or "Forming", 0)
        s_cluster[i] = cluster
        s_chips[i] = chips_per_worker
        for worker in obj.get("workers") or ():
            node = worker.get("node")
            up = worker_up(worker)
            w_slice.append(i)
            w_node.append(nodes.code(str(node)) if node else -1)
            w_cluster.append(cluster)
            w_up.append(1 if up else 0)
            w_chips.append(chips_per_worker)
    return {
        "w_slice": np.asarray(w_slice, dtype=np.int32),
        "w_node": np.asarray(w_node, dtype=np.int32),
        "w_cluster": np.asarray(w_cluster, dtype=np.int32),
        "w_up": np.asarray(w_up, dtype=np.int32),
        "w_chips": np.asarray(w_chips, dtype=np.int32),
        "s_expected": s_expected,
        "s_observed": s_observed,
        "s_ready": s_ready,
        "s_phase": s_phase,
        "s_cluster": s_cluster,
        "s_chips_per_worker": s_chips,
        "slice_names": slice_names,
    }


class FleetEncoder:
    """The incremental columnar store behind the analytics plane."""

    def __init__(self) -> None:
        self.nodes = Interner()
        self.clusters = Interner()
        self.clusters.code(LOCAL_CLUSTER)  # code 0 = the local cluster
        # pod table: truly columnar, O(1) per delta (swap-remove deletes)
        self._pod_rows: Dict[str, int] = {}
        self._pod_keys: List[str] = []
        self._pod_phase: List[int] = []
        self._pod_ready: List[int] = []
        self._pod_node: List[int] = []
        self._pod_cluster: List[int] = []
        # slice objects: keyed map; rows rebuild on materialization
        self._slices: Dict[str, Mapping[str, Any]] = {}
        self._dirty = True
        self._cols: Optional[FleetColumns] = None
        self.generation = 0  # bumps on every materialization rebuild

    # -- incremental maintenance ------------------------------------------

    def apply(self, kind: str, key: str, obj: Optional[Mapping[str, Any]]) -> None:
        """Fold one view delta (``obj is None`` = DELETE). Kinds outside
        the encoded tables (probe verdicts) are ignored — they carry no
        placement/quorum information."""
        if kind == "pod":
            if obj is None:
                self._pod_delete(key)
            else:
                self._pod_upsert(key, obj)
            self._dirty = True
        elif kind == "slice":
            if obj is None:
                self._slices.pop(key, None)
            else:
                self._slices[key] = obj
            self._dirty = True

    def _pod_upsert(self, key: str, obj: Mapping[str, Any]) -> None:
        phase, ready, node, cluster = _pod_row(obj, self.nodes, self.clusters)
        row = self._pod_rows.get(key)
        if row is None:
            self._pod_rows[key] = len(self._pod_keys)
            self._pod_keys.append(key)
            self._pod_phase.append(phase)
            self._pod_ready.append(ready)
            self._pod_node.append(node)
            self._pod_cluster.append(cluster)
        else:
            self._pod_phase[row] = phase
            self._pod_ready[row] = ready
            self._pod_node[row] = node
            self._pod_cluster[row] = cluster

    def _pod_delete(self, key: str) -> None:
        row = self._pod_rows.pop(key, None)
        if row is None:
            return
        last = len(self._pod_keys) - 1
        if row != last:
            moved = self._pod_keys[last]
            self._pod_keys[row] = moved
            self._pod_phase[row] = self._pod_phase[last]
            self._pod_ready[row] = self._pod_ready[last]
            self._pod_node[row] = self._pod_node[last]
            self._pod_cluster[row] = self._pod_cluster[last]
            self._pod_rows[moved] = row
        self._pod_keys.pop()
        self._pod_phase.pop()
        self._pod_ready.pop()
        self._pod_node.pop()
        self._pod_cluster.pop()

    def reset(self, tables: Mapping[str, Iterable[Mapping[str, Any]]]) -> None:
        """Re-encode from a full snapshot walk (``FleetView.
        snapshot_tables()`` shape: ``{kind: [objects]}``). Interners are
        KEPT — codes stay stable across resets; only row contents
        rebuild."""
        self._pod_rows.clear()
        self._pod_keys.clear()
        self._pod_phase.clear()
        self._pod_ready.clear()
        self._pod_node.clear()
        self._pod_cluster.clear()
        self._slices.clear()
        for obj in tables.get("pod", ()):
            key = str(obj.get("key") or "")
            if key:
                self._pod_upsert(key, obj)
        for obj in tables.get("slice", ()):
            key = str(obj.get("key") or obj.get("slice") or "")
            if key:
                self._slices[key] = obj
        self._dirty = True

    # -- materialization ---------------------------------------------------

    def columns(self) -> FleetColumns:
        """The current generation's arrays — rebuilt at most once per
        dirty generation, shared by reference afterwards."""
        if not self._dirty and self._cols is not None:
            return self._cols
        self._cols = FleetColumns(
            pod_phase=np.asarray(self._pod_phase, dtype=np.int32),
            pod_ready=np.asarray(self._pod_ready, dtype=np.int32),
            pod_node=np.asarray(self._pod_node, dtype=np.int32),
            pod_cluster=np.asarray(self._pod_cluster, dtype=np.int32),
            **build_slice_tables(self._slices, self.nodes, self.clusters),
            nodes=self.nodes,
            clusters=self.clusters,
        )
        self._dirty = False
        self.generation += 1
        return self._cols

    @property
    def n_pods(self) -> int:
        return len(self._pod_keys)

    @property
    def n_slices(self) -> int:
        return len(self._slices)


def tables_from_objects(objects: Mapping[Tuple[str, str], Mapping[str, Any]]) -> Dict[str, List[Mapping[str, Any]]]:
    """``{(kind, key): obj}`` (the WAL replay's terminal-state shape) ->
    the ``{kind: [objects]}`` tables ``FleetEncoder.reset`` consumes.
    The map key is authoritative for kind/key — replayed objects carry
    matching fields, but a capture is forensic input, not trusted."""
    tables: Dict[str, List[Mapping[str, Any]]] = {}
    for (kind, key), obj in objects.items():
        if not isinstance(obj, Mapping):
            continue
        if obj.get("key") != key:
            obj = {**obj, "key": key}
        tables.setdefault(kind, []).append(obj)
    return tables
