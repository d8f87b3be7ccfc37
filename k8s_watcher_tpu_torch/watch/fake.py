"""In-process fake watch source + pod builders.

This is the seed of the test pyramid the reference lacked (SURVEY.md §4):
its ``test_k8s_mock.py`` required an external mock API server binary that was
not even in the repo. ``FakeWatchSource`` replays a scripted event sequence
entirely in-process, which makes acceptance config #1 (single pod
ADDED→MODIFIED→DELETED on CPU, no cluster) a plain unit test.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

from k8s_watcher_tpu_torch.watch.sharded import shard_of
from k8s_watcher_tpu_torch.watch.source import EventType, WatchEvent

_UID_COUNTER = itertools.count(1)


def build_pod(
    name: str,
    namespace: str = "default",
    *,
    uid: Optional[str] = None,
    phase: str = "Pending",
    node_name: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    containers: Optional[Sequence[Dict[str, Any]]] = None,
    tpu_chips: int = 0,
    tpu_topology: Optional[str] = None,
    tpu_accelerator: Optional[str] = None,
    gke_slice_fields: Optional[Dict[str, Any]] = None,
    resource_version: str = "1",
    conditions: Optional[List[Dict[str, Any]]] = None,
    container_statuses: Optional[List[Dict[str, Any]]] = None,
    creation_timestamp: str = "2026-01-01T00:00:00Z",
    status_reason: Optional[str] = None,
) -> Dict[str, Any]:
    """Build a pod dict in k8s REST JSON shape.

    ``tpu_chips > 0`` adds a ``google.com/tpu`` request/limit to the first
    container and, with ``tpu_topology``/``gke_slice_fields``, the GKE
    node-selector labels a real TPU slice pod carries.
    """
    labels = dict(labels or {})
    annotations = dict(annotations or {})
    if containers is None:
        containers = [{"name": "main", "image": "busybox:latest", "resources": {}}]
    else:
        containers = [dict(c) for c in containers]

    node_selector: Dict[str, str] = {}
    if tpu_chips > 0:
        res = containers[0].setdefault("resources", {})
        res.setdefault("requests", {})["google.com/tpu"] = str(tpu_chips)
        res.setdefault("limits", {})["google.com/tpu"] = str(tpu_chips)
        if tpu_topology:
            node_selector["cloud.google.com/gke-tpu-topology"] = tpu_topology
        node_selector["cloud.google.com/gke-tpu-accelerator"] = tpu_accelerator or "tpu-v5p-slice"
    if gke_slice_fields:
        # e.g. jobset.sigs.k8s.io/jobset-name, batch.kubernetes.io/job-completion-index
        for k, v in gke_slice_fields.items():
            if k.startswith("annotation:"):
                annotations[k.split(":", 1)[1]] = str(v)
            else:
                labels[k] = str(v)

    pod: Dict[str, Any] = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "uid": uid or f"uid-{name}-{next(_UID_COUNTER)}",
            "resourceVersion": resource_version,
            "labels": labels,
            "annotations": annotations,
            "creationTimestamp": creation_timestamp,
        },
        "spec": {
            "nodeName": node_name,
            "containers": containers,
        },
        "status": {
            "phase": phase,
            "conditions": conditions or [],
            "containerStatuses": container_statuses or [],
        },
    }
    if status_reason:
        pod["status"]["reason"] = status_reason
    if node_selector:
        pod["spec"]["nodeSelector"] = node_selector
    return pod


def pod_lifecycle(
    name: str,
    namespace: str = "default",
    *,
    phases: Sequence[str] = ("Pending", "Running"),
    start_rv: int = 1,
    **pod_kwargs: Any,
) -> List[WatchEvent]:
    """Scripted ADDED→MODIFIED…→DELETED cycle for one pod (acceptance #1)."""
    uid = pod_kwargs.pop("uid", None) or f"uid-{name}-{next(_UID_COUNTER)}"
    events: List[WatchEvent] = []
    rv = start_rv
    for i, phase in enumerate(phases):
        pod = build_pod(name, namespace, uid=uid, phase=phase, resource_version=str(rv), **pod_kwargs)
        events.append(WatchEvent(type=EventType.ADDED if i == 0 else EventType.MODIFIED, pod=pod, resource_version=str(rv)))
        rv += 1
    final = build_pod(name, namespace, uid=uid, phase=phases[-1], resource_version=str(rv), **pod_kwargs)
    events.append(WatchEvent(type=EventType.DELETED, pod=final, resource_version=str(rv)))
    return events


def shard_streams(events: Iterable[WatchEvent], shards: int) -> List[List[WatchEvent]]:
    """Partition a scripted event sequence into per-shard streams by the
    SAME stable uid-hash partition production ingest uses (shard_of), with
    per-stream order preserved — so a sharded fake replay delivers each
    UID's events in script order on exactly one stream, exactly like N real
    shard watch streams would."""
    streams: List[List[WatchEvent]] = [[] for _ in range(max(1, shards))]
    for event in events:
        key = event.uid or f"{event.namespace}/{event.name}"
        streams[shard_of(key, max(1, shards))].append(event)
    return streams


def sharded_fake_sources(
    events: Iterable[WatchEvent], shards: int, **kwargs: Any
) -> List["FakeWatchSource"]:
    """One ``FakeWatchSource`` per shard stream (kwargs as for
    ``FakeWatchSource``). Feed these to ``ShardedWatchSource`` so tests and
    the mock tier exercise the exact sharded-ingest code path — shard
    count 1 included (one stream through the same queue + batch drain, not
    a special case)."""
    return [FakeWatchSource(stream, **kwargs) for stream in shard_streams(events, shards)]


class FakeWatchSource:
    """Replay a scripted sequence of events, optionally with a delay between
    them; then either stop (default) or block until ``stop()`` is called."""

    def __init__(
        self,
        events: Iterable[WatchEvent],
        *,
        delay_seconds: float = 0.0,
        hold_open: bool = False,
    ):
        self._events = list(events)
        self._delay = delay_seconds
        self._hold_open = hold_open
        self._stop = threading.Event()

    def events(self) -> Iterator[WatchEvent]:
        for ev in self._events:
            if self._stop.is_set():
                return
            if self._delay:
                time.sleep(self._delay)
            # restamp receive time at yield so latency measurements are honest
            ev.received_monotonic = time.monotonic()
            ev.received_at = time.time()
            yield ev
        while self._hold_open and not self._stop.wait(0.05):
            pass

    def stop(self) -> None:
        self._stop.set()


def build_node(
    name: str,
    *,
    ready: bool = True,
    tpu_chips: int = 4,
    tpu_accelerator: Optional[str] = "tpu-v5p-slice",
    tpu_topology: Optional[str] = "2x2x2",
    labels: Optional[Dict[str, str]] = None,
    unschedulable: bool = False,
    resource_key: str = "google.com/tpu",
    resource_version: str = "1",
) -> Dict[str, Any]:
    """Build a Node dict in k8s REST JSON shape (for node-plane tests).

    ``tpu_chips=0`` with no accelerator label makes a plain CPU node.
    """
    labels = dict(labels or {})
    if tpu_accelerator and tpu_chips > 0:
        labels.setdefault("cloud.google.com/gke-tpu-accelerator", tpu_accelerator)
        if tpu_topology:
            labels.setdefault("cloud.google.com/gke-tpu-topology", tpu_topology)
    allocatable: Dict[str, Any] = {"cpu": "8", "memory": "32Gi"}
    if tpu_chips > 0:
        allocatable[resource_key] = str(tpu_chips)
    node: Dict[str, Any] = {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": labels, "resourceVersion": resource_version},
        "spec": {},
        "status": {
            "allocatable": dict(allocatable),
            "capacity": dict(allocatable),
            "conditions": [
                {
                    "type": "Ready",
                    "status": "True" if ready else "False",
                    "reason": "KubeletReady" if ready else "KubeletNotReady",
                }
            ],
        },
    }
    if unschedulable:
        node["spec"]["unschedulable"] = True
    return node
