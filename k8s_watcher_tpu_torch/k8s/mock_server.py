"""In-process mock Kubernetes API server (the JAX package's
``k8s/mock_server.py``, with the same routes, pages, watch frames, status
codes and merge-patch semantics).

The bundled kubeconfig (``assets/config``) points at a mock apiserver on
http://localhost:9988; ``python -m k8s_watcher_tpu_torch.mock_apiserver``
serves this one there. It is a small threaded HTTP server implementing the
API subset ``K8sClient`` consumes:

- ``GET /version``
- ``GET /api/v1/namespaces``
- ``GET /api/v1/pods`` and ``GET /api/v1/namespaces/{ns}/pods``
  (list, and ``watch=true`` streaming with resourceVersion resume,
  equality-based ``labelSelector``, BOOKMARK frames on idle when
  ``allowWatchBookmarks`` is set, and 410-Gone on expired versions)

Test hooks: ``MockCluster.add/modify/delete_pod`` drive the event stream;
``compact()`` expires old resourceVersions to exercise the relist path;
``fail_next(n)`` injects transient HTTP 500s to exercise backoff.

The server also exposes the clusterapi NOTIFY surface (``GET /health``,
``POST /api/pods/update`` and the batched ``POST /api/pods/update_batch``
— payloads land in ``MockCluster.status_updates``), so egress-plane
integration tests drive the real ``ClusterApiClient`` against it without
a second server implementation.
"""

from __future__ import annotations

import base64
import bisect
import json
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from k8s_watcher_tpu_torch.status import QuietThreadingHTTPServer


def _decode_continue(token: Optional[str]) -> Tuple[Optional[str], Tuple[str, str]]:
    """``(snapshot_rv, after_key)`` from an opaque continue token; raises
    ValueError for any malformed shape (the caller maps it to 400)."""
    if not token:
        return None, ("", "")
    try:
        decoded = json.loads(base64.b64decode(token.encode()).decode())
        # validate the full shape HERE: a decodable token with a non-int
        # rv or non-string keys must 400, not 500 later
        snapshot_rv = str(int(decoded["rv"]))
        after = (decoded["ns"], decoded["name"])
        if not (isinstance(after[0], str) and isinstance(after[1], str)):
            raise TypeError("cursor keys must be strings")
    except (ValueError, KeyError, TypeError) as exc:
        raise ValueError(f"malformed continue token: {exc}") from exc
    return snapshot_rv, after


def _encode_continue(rv: int, ns: str, name: str) -> str:
    return base64.b64encode(
        json.dumps({"rv": rv, "ns": ns, "name": name}).encode()
    ).decode()


def _expired_continue_status() -> Tuple[int, Dict[str, Any]]:
    return 410, {
        "kind": "Status", "code": 410, "reason": "Expired",
        "message": "The provided continue parameter is too old",
    }


def _parse_label_selector(selector: Optional[str]) -> List[Tuple[str, Optional[str]]]:
    """Equality-based selector subset: ``k=v``, ``k==v``, bare ``k``."""
    out: List[Tuple[str, Optional[str]]] = []
    for part in (selector or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "==" in part:
            k, v = part.split("==", 1)
        elif "=" in part:
            k, v = part.split("=", 1)
        else:
            k, v = part, None
        out.append((k.strip(), v.strip() if v is not None else None))
    return out


def _matches_selector(pod: Dict[str, Any], selector: List[Tuple[str, Optional[str]]]) -> bool:
    labels = (pod.get("metadata") or {}).get("labels") or {}
    for key, value in selector:
        if key not in labels:
            return False
        if value is not None and labels[key] != value:
            return False
    return True


def _parse_shard(param: Optional[str]) -> Optional[Tuple[int, int]]:
    """``(shard, shards)`` from the ``shard=i/n`` query param the sharded
    ingest sends (watch/sharded.py wire format), or None. A malformed
    selector is IGNORED (None), matching a stock apiserver's treatment of
    unknown/garbage query params — the client's ownership filter keeps
    correctness either way."""
    if not param:
        return None
    from k8s_watcher_tpu_torch.watch.sharded import parse_shard_selector

    return parse_shard_selector(param)


def _matches_shard(obj: Dict[str, Any], shard: Optional[Tuple[int, int]]) -> bool:
    """Server-side shard push-down: uid-hash partition, the same
    ``shard_of`` the client uses (the whole point is that both sides
    compute the identical stable partition)."""
    if shard is None:
        return True
    from k8s_watcher_tpu_torch.watch.sharded import shard_of

    uid = (obj.get("metadata") or {}).get("uid") or ""
    return shard_of(uid, shard[1]) == shard[0]


class _PreserializedList(dict):
    """A list-response body whose items are already JSON text.

    ``_Handler._json`` splices ``items_json`` into the encoded body
    instead of re-serializing every object: the per-object JSON is built
    (and cached) once on the cluster side — the mock's analogue of the
    real apiserver's serialized watch cache. Without it a paged LIST
    deep-copied and double-encoded every pod per page, and at 10k+ pods
    the MOCK dominated the relist benches this server exists to serve.

    Direct in-process consumers (tests calling ``cluster.list_pods``
    without HTTP) still read ``body["items"]``: the list materializes
    lazily from the cached text on first access — same decoupled-copy
    guarantee the old per-object deep copy gave.
    """

    def __getitem__(self, key):
        if key == "items" and not dict.__contains__(self, "items"):
            dict.__setitem__(
                self, "items", [json.loads(t) for t in dict.__getitem__(self, "items_json")]
            )
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def encode(self) -> bytes:
        items_json = self.pop("items_json")
        self.pop("items", None)  # drop any lazily materialized copy
        head = json.dumps(self)
        return (head[:-1] + ',"items":[' + ",".join(items_json) + "]}").encode()


class MockCluster:
    """Shared cluster state + event journal."""

    def __init__(self):
        self._lock = threading.Condition()
        self._rv = 0
        self._pods: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._nodes: Dict[str, Dict[str, Any]] = {}
        # per-collection event journal as PARALLEL rv/event arrays; one
        # cluster-global rv space, like the real apiserver, so each
        # collection's rv list is strictly increasing and a watch poll
        # resumes by BISECT — O(log n + results) per poll, not the
        # O(whole-journal) list-comprehension rescan every long-poll
        # round used to pay (at 10k-pod churn each 0.25 s wakeup walked
        # every event ever journaled)
        self._journal_rvs: Dict[str, List[int]] = {}
        self._journal_events: Dict[str, List[Dict[str, Any]]] = {}
        self._oldest_rv = 0  # journal entries <= this are compacted away
        self._fail_next = 0
        self._fail_status = 500
        # hold_watch: events with rv above this stay invisible to
        # events_since until released (None = delivering normally)
        self._watch_hold_rv: Optional[int] = None
        self.namespaces = ["default", "kube-system"]
        self._leases: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # sorted-key cache per collection, keyed on the rv it was built
        # at: any mutation bumps _rv, invalidating it. Without this every
        # page re-sorted and re-filtered the WHOLE map — O(n^2/page_size)
        # across a paged list, 22 s for a 50k-pod relist
        self._sorted_keys: Dict[str, Tuple[int, list]] = {}
        # per-pod serialized-JSON cache (key -> (rv, json_text)), the
        # mock's analogue of the apiserver's serialized watch cache:
        # LIST pages splice cached text instead of deep-copy + re-encode
        # per pod per page. rv-validated, entries dropped on delete.
        self._pod_json: Dict[Tuple[str, str], Tuple[str, str]] = {}
        # per-shard sorted-key partition, keyed on (collection, shards)
        # and the rv it was built at. Without it every sharded LIST page
        # rescanned the WHOLE key space computing a crc32 per pod to find
        # its 1/n matches — O(shards x n_pods x pages) of GIL-bound work
        # that made a 4-shard concurrent relist SLOWER than one serial
        # page chain (bench r06: shard_speedup 0.6)
        self._shard_keys: Dict[Tuple[str, int], Tuple[int, List[list]]] = {}
        # clusterapi-surface test hook: status updates POSTed to
        # /api/pods/update[_batch] (the mock doubles as a notify target so
        # the egress plane can be integration-tested without a second
        # server implementation)
        self.status_updates: List[Dict[str, Any]] = []

    def _sorted_collection_keys(self, collection: str, mapping) -> list:
        """Sorted key list for ``mapping``, cached until the next
        mutation. Call under ``self._lock``."""
        cached = self._sorted_keys.get(collection)
        if cached is not None and cached[0] == self._rv:
            return cached[1]
        keys = sorted(mapping)
        self._sorted_keys[collection] = (self._rv, keys)
        return keys

    def _shard_partition_keys(
        self, collection: str, mapping, shard: int, shards: int
    ) -> list:
        """Shard ``shard``'s sorted key list under the uid-hash partition,
        cached until the next mutation — one O(n) crc32 sweep per (rv,
        shard count) instead of one per scanned key per page. Call under
        ``self._lock``."""
        cached = self._shard_keys.get((collection, shards))
        if cached is None or cached[0] != self._rv:
            from k8s_watcher_tpu_torch.watch.sharded import shard_of

            parts: List[list] = [[] for _ in range(shards)]
            for key in self._sorted_collection_keys(collection, mapping):
                obj = mapping.get(key)
                uid = ((obj or {}).get("metadata") or {}).get("uid") or ""
                parts[shard_of(uid, shards)].append(key)
            cached = (self._rv, parts)
            self._shard_keys[(collection, shards)] = cached
        return cached[1][shard]

    def _cursor_page(self, collection: str, mapping, after, limit, match, keys=None) -> list:
        """Cursor scan shared by the paged LISTs: up to ``limit+1``
        (key, obj) pairs with key > ``after`` satisfying ``match(key,
        obj)`` (limit+1 so _page_body can detect "more remain"). Call
        under ``self._lock``. ``keys``: pre-restricted sorted key list
        (shard partitions); defaults to the whole collection."""
        if keys is None:
            keys = self._sorted_collection_keys(collection, mapping)
        want = limit + 1 if limit else None
        matches = []
        for key in keys[bisect.bisect_right(keys, after):]:
            obj = mapping.get(key)
            if obj is None:
                # deleted since the cache was built: delete_* pops the map
                # and bumps _rv in two separate lock holds, so a list
                # landing between them sees a momentarily-stale cache
                continue
            if not match(key, obj):
                continue
            matches.append((key, obj))
            if want is not None and len(matches) >= want:
                break
        return matches

    # -- state mutation (test hooks) --------------------------------------

    def _record(self, event_type: str, obj: Dict[str, Any], collection: str = "pods") -> int:
        with self._lock:
            self._rv += 1
            obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
            self._journal_rvs.setdefault(collection, []).append(self._rv)
            self._journal_events.setdefault(collection, []).append(
                {"type": event_type, "object": json.loads(json.dumps(obj))}
            )
            self._lock.notify_all()
            return self._rv

    def add_pod(self, pod: Dict[str, Any]) -> int:
        meta = pod.get("metadata") or {}
        key = (meta.get("namespace", "default"), meta.get("name", ""))
        with self._lock:
            self._pods[key] = pod
        return self._record("ADDED", pod)

    def modify_pod(self, pod: Dict[str, Any]) -> int:
        meta = pod.get("metadata") or {}
        key = (meta.get("namespace", "default"), meta.get("name", ""))
        with self._lock:
            self._pods[key] = pod
        return self._record("MODIFIED", pod)

    def delete_pod(self, namespace: str, name: str) -> Optional[int]:
        key = (namespace, name)
        with self._lock:
            pod = self._pods.pop(key, None)
            self._pod_json.pop(key, None)
        if pod is None:
            return None
        return self._record("DELETED", pod)

    # -- REST write surface (K8sClient.create_pod/delete_pod/...) ----------
    # The test hooks above mutate state directly; these enforce the
    # apiserver's status contract (201/409/404) so the acceptance write
    # tier can drive REAL create/delete churn through HTTP on hosts
    # without Docker/kind.

    def create_pod(self, namespace: str, pod: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        meta = pod.setdefault("metadata", {})
        meta["namespace"] = namespace
        name = meta.get("name", "")
        if not name:
            return 400, {"kind": "Status", "code": 400, "message": "pod has no name"}
        pod.setdefault("status", {}).setdefault("phase", "Pending")
        # uniqueness check + insert + response snapshot under ONE lock hold
        # (the Condition's RLock is re-entrant, so the nested add_pod/_record
        # acquisitions are fine) — a check-then-insert window would let two
        # concurrent POSTs both 201 and journal a phantom duplicate ADDED,
        # and serializing the live stored dict outside the lock would race a
        # concurrent set_phase/modify_pod mutating it mid-iteration
        with self._lock:
            if namespace not in self.namespaces:
                # parity with the real apiserver: pods can't land in a
                # namespace that doesn't exist (or was just deleted)
                return 404, {"kind": "Status", "code": 404, "message": f"namespaces \"{namespace}\" not found"}
            if (namespace, name) in self._pods:
                return 409, {"kind": "Status", "code": 409, "message": f"pods \"{name}\" already exists"}
            self.add_pod(pod)
            return 201, json.loads(json.dumps(pod))

    def remove_pod(self, namespace: str, name: str) -> Tuple[int, Dict[str, Any]]:
        rv = self.delete_pod(namespace, name)
        if rv is None:
            return 404, {"kind": "Status", "code": 404, "message": f"pods \"{name}\" not found"}
        return 200, {"kind": "Status", "code": 200, "status": "Success"}

    def create_namespace(self, name: str) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            if name in self.namespaces:
                return 409, {"kind": "Status", "code": 409, "message": f"namespaces \"{name}\" already exists"}
            self.namespaces.append(name)
        return 201, {"kind": "Namespace", "metadata": {"name": name}}

    def delete_namespace(self, name: str) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            if name not in self.namespaces:
                return 404, {"kind": "Status", "code": 404, "message": f"namespaces \"{name}\" not found"}
            self.namespaces.remove(name)
            # evict under the SAME lock hold (re-entrant): a create racing
            # the delete must either land before the eviction sweep or be
            # rejected by create_pod's namespace check — never orphaned.
            # DELETED events flow to watchers, like the apiserver's cascade
            for ns, pod_name in [key for key in self._pods if key[0] == name]:
                self.delete_pod(ns, pod_name)
        return 200, {"kind": "Status", "code": 200, "status": "Success"}

    def set_phase(self, namespace: str, name: str, phase: str) -> Optional[int]:
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                return None
            pod.setdefault("status", {})["phase"] = phase
        return self._record("MODIFIED", pod)

    # -- node state (the nodes collection mirrors the pods hooks) ----------

    def add_node(self, node: Dict[str, Any]) -> int:
        name = (node.get("metadata") or {}).get("name", "")
        with self._lock:
            self._nodes[name] = node
        return self._record("ADDED", node, collection="nodes")

    def modify_node(self, node: Dict[str, Any]) -> int:
        name = (node.get("metadata") or {}).get("name", "")
        with self._lock:
            self._nodes[name] = node
        return self._record("MODIFIED", node, collection="nodes")

    def delete_node(self, name: str) -> Optional[int]:
        with self._lock:
            node = self._nodes.pop(name, None)
            self._pod_json.pop(("", name), None)  # node cache key (ns "")
        if node is None:
            return None
        return self._record("DELETED", node, collection="nodes")

    def set_node_ready(self, name: str, ready: bool, reason: str = "") -> Optional[int]:
        """Flip the node's Ready condition (the kubelet-heartbeat signal)."""
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                return None
            conditions = node.setdefault("status", {}).setdefault("conditions", [])
            for c in conditions:
                if c.get("type") == "Ready":
                    c["status"] = "True" if ready else "False"
                    c["reason"] = reason or ("KubeletReady" if ready else "KubeletNotReady")
                    break
            else:
                conditions.append({
                    "type": "Ready",
                    "status": "True" if ready else "False",
                    "reason": reason or ("KubeletReady" if ready else "KubeletNotReady"),
                })
        return self._record("MODIFIED", node, collection="nodes")

    def get_node(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            node = self._nodes.get(name)
            return json.loads(json.dumps(node)) if node else None

    @staticmethod
    def _merge_patch(target: Dict[str, Any], patch: Dict[str, Any]) -> Dict[str, Any]:
        """RFC 7386 JSON merge patch: dicts merge recursively, ``null``
        deletes a key, everything else (including lists) replaces."""
        for key, value in patch.items():
            if value is None:
                target.pop(key, None)
            elif isinstance(value, dict) and isinstance(target.get(key), dict):
                MockCluster._merge_patch(target[key], value)
            else:
                target[key] = json.loads(json.dumps(value))
        return target

    def patch_node(self, name: str, patch: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """(status, body) for ``PATCH /api/v1/nodes/{name}`` with
        merge-patch semantics; journals a MODIFIED node event, so the
        node-plane watch observes cordons the remediation plane applies.

        A patch carrying ``metadata.resourceVersion`` is an optimistic-
        concurrency write (same apiserver contract the lease path honors):
        stale rv -> 409 Conflict, so read-modify-write callers (the
        remediation actuator's taint edits) can detect a concurrent editor
        instead of clobbering it."""
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                return 404, {"kind": "Status", "code": 404, "message": f"nodes \"{name}\" not found"}
            sent_rv = (patch.get("metadata") or {}).get("resourceVersion")
            if sent_rv is not None and sent_rv != node["metadata"]["resourceVersion"]:
                return 409, {
                    "kind": "Status", "code": 409,
                    "message": f"Operation cannot be fulfilled on nodes \"{name}\": "
                               "the object has been modified",
                }
            # the server owns resourceVersion: never merge a client-sent one
            patch = json.loads(json.dumps(patch))
            if "metadata" in patch and isinstance(patch["metadata"], dict):
                patch["metadata"].pop("resourceVersion", None)
            self._merge_patch(node, patch)
            self.modify_node(node)
            return 200, json.loads(json.dumps(node))

    def list_nodes(
        self,
        label_selector: Optional[str] = None,
        limit: Optional[int] = None,
        continue_token: Optional[str] = None,
    ) -> Tuple[int, Dict[str, Any]]:
        """(status, body) for ``GET /api/v1/nodes`` with the same
        limit+continue contract as ``list_pods`` (node keys have no
        namespace; the cursor's ns field stays "")."""
        selector = _parse_label_selector(label_selector)
        try:
            snapshot_rv, after = _decode_continue(continue_token)
        except ValueError:
            return 400, {"kind": "Status", "code": 400, "message": "malformed continue token"}
        with self._lock:
            if snapshot_rv is not None and int(snapshot_rv) < self._oldest_rv:
                return _expired_continue_status()
            if after[0]:
                # node tokens encode ns "" — a foreign-namespace cursor
                # sorts above every ("", name) key, i.e. no results
                # (tuple-compare behavior of the pre-cache implementation)
                return 200, self._page_body("NodeList", [], limit, snapshot_rv)
            matches = [
                (("", name), node)
                for name, node in self._cursor_page(
                    "nodes", self._nodes, after[1], limit,
                    lambda _name, node: _matches_selector(node, selector),
                )
            ]
            return 200, self._page_body("NodeList", matches, limit, snapshot_rv)

    def _serialized(self, key: Tuple[str, str], obj: Dict[str, Any]) -> str:
        """Cached JSON text for one object (the dumps IS the under-lock
        snapshot a deep copy used to provide). Call under ``self._lock``."""
        rv = str((obj.get("metadata") or {}).get("resourceVersion", ""))
        cached = self._pod_json.get(key)
        if cached is not None and cached[0] == rv:
            return cached[1]
        text = json.dumps(obj)
        self._pod_json[key] = (rv, text)
        return text

    def _page_body(
        self,
        kind: str,
        matches: list,
        limit: Optional[int],
        snapshot_rv: Optional[str],
    ) -> Dict[str, Any]:
        """One page + metadata (rv pinned to the list's snapshot, continue
        token when more remain). Call under ``self._lock``. The returned
        body carries pre-serialized items (see ``_PreserializedList``)."""
        rv = snapshot_rv if snapshot_rv is not None else str(self._rv)
        next_token = None
        if limit and len(matches) > limit:
            matches = matches[:limit]
            last_ns, last_name = matches[-1][0]
            next_token = _encode_continue(int(rv), last_ns, last_name)
        metadata: Dict[str, Any] = {"resourceVersion": rv}
        if next_token:
            metadata["continue"] = next_token
        return _PreserializedList(
            kind=kind,
            apiVersion="v1",
            metadata=metadata,
            items_json=[self._serialized(key, obj) for key, obj in matches],
        )

    def compact(self) -> None:
        """Forget journal history: any watch resuming below the current rv
        gets 410 Gone (simulates apiserver etcd compaction)."""
        with self._lock:
            self._oldest_rv = self._rv
            self._journal_rvs.clear()
            self._journal_events.clear()

    def fail_next(self, n: int = 1, status: int = 500) -> None:
        """Make the next ``n`` HTTP requests fail with ``status``
        (backoff and auth-retry tests)."""
        with self._lock:
            self._fail_next = n
            self._fail_status = status

    def hold_watch(self, hold: bool = True) -> None:
        """Freeze watch delivery at the CURRENT rv: state keeps mutating
        (rv advances, LISTs serve fresh pages) but ``events_since`` stops
        returning anything newer until released — the "lagging apiserver"
        fault (a wedged/backed-up watch cache) the health-plane chaos
        drill scripts. Releasing notifies every parked watcher, so the
        held window floods out at once, exactly like a real cache
        catching up."""
        with self._lock:
            self._watch_hold_rv = self._rv if hold else None
            if not hold:
                self._lock.notify_all()

    def consume_failure(self) -> int:
        """The injected failure status for this request, or 0 for none."""
        with self._lock:
            if self._fail_next > 0:
                self._fail_next -= 1
                return self._fail_status
            return 0

    # -- reads -------------------------------------------------------------

    def list_pods(
        self,
        namespace: Optional[str],
        limit: Optional[int],
        label_selector: Optional[str] = None,
        continue_token: Optional[str] = None,
        shard: Optional[str] = None,
    ) -> Tuple[int, Dict[str, Any]]:
        """(status, body) for ``GET .../pods`` with ``limit``+``continue``
        pagination (the apiserver contract the paged client consumes):

        - every page of one list reports the resourceVersion of the
          snapshot the list STARTED at (the client's watch-resume point),
          not the rv at page-serve time;
        - ``metadata.continue`` is an opaque cursor (snapshot rv + last
          key served); compaction past that rv expires it -> 410 Gone,
          exactly how etcd compaction expires real continue tokens.

        Pages after the first are served from the CURRENT pod map at the
        cursor key — the mock doesn't retain historical snapshots — which
        matches the observable client contract: anything that changes
        between pages is journaled at rv > snapshot and arrives via the
        resumed watch."""
        selector = _parse_label_selector(label_selector)
        shard_sel = _parse_shard(shard)
        try:
            snapshot_rv, after = _decode_continue(continue_token)
        except ValueError:
            return 400, {"kind": "Status", "code": 400, "message": "malformed continue token"}
        with self._lock:
            if snapshot_rv is not None and int(snapshot_rv) < self._oldest_rv:
                return _expired_continue_status()
            shard_keys = None
            if shard_sel is not None:
                # pre-partitioned key list: the scan touches only this
                # shard's pods, no per-key hash (see _shard_partition_keys)
                shard_keys = self._shard_partition_keys(
                    "pods", self._pods, shard_sel[0], shard_sel[1]
                )
            matches = self._cursor_page(
                "pods", self._pods, after, limit,
                lambda key, pod: (namespace is None or key[0] == namespace)
                and _matches_selector(pod, selector),
                keys=shard_keys,
            )
            return 200, self._page_body("PodList", matches, limit, snapshot_rv)

    # -- clusterapi notify surface (egress-plane integration target) -------

    def record_status_update(self, payload: Dict[str, Any]) -> bool:
        """Accept one ``update_pod_status`` POST (clusterapi contract).
        Always succeeds; the payload lands in ``status_updates`` for
        assertions."""
        with self._lock:
            self.status_updates.append(payload)
        return True

    def record_status_updates(self, payloads: List[Any]) -> List[bool]:
        """Accept one ``update_pod_statuses`` batch POST; per-item results
        (a non-dict item is rejected, the rest of the batch still lands —
        the per-item result list is the point of the batch wire shape)."""
        results = []
        with self._lock:
            for payload in payloads:
                if isinstance(payload, dict):
                    self.status_updates.append(payload)
                    results.append(True)
                else:
                    results.append(False)
        return results

    def events_since(self, rv: int, deadline: float, collection: str = "pods") -> Optional[List[Dict[str, Any]]]:
        """Block until there are journal events > rv in ``collection`` or the
        deadline passes. Returns None if rv has been compacted away (client
        must relist)."""
        with self._lock:
            while True:
                if rv < self._oldest_rv:
                    return None  # compacted (possibly while we were waiting)
                rvs = self._journal_rvs.get(collection)
                if rvs:
                    # the collection's rv list is strictly increasing
                    # (appends under the cluster-global rv), so the resume
                    # point is a bisect and the batch is one tail slice
                    idx = bisect.bisect_right(rvs, rv)
                    end = len(rvs)
                    if self._watch_hold_rv is not None:
                        # lagging-apiserver fault: deliver nothing past
                        # the hold point (see hold_watch)
                        end = bisect.bisect_right(rvs, self._watch_hold_rv)
                    if idx < end:
                        return self._journal_events[collection][idx:end]
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._lock.wait(timeout=min(remaining, 0.25))

    def latest_rv(self) -> int:
        with self._lock:
            return self._rv

    # -- coordination.k8s.io/v1 Leases (leader election) -------------------

    def get_lease(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            lease = self._leases.get((namespace, name))
            return json.loads(json.dumps(lease)) if lease else None

    def create_lease(self, namespace: str, name: str, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """(status, body): 201 on create, 409 if the Lease already exists."""
        with self._lock:
            if (namespace, name) in self._leases:
                return 409, {"kind": "Status", "code": 409, "message": f"leases \"{name}\" already exists"}
            self._rv += 1
            lease = json.loads(json.dumps(body))
            lease.setdefault("metadata", {}).update(
                {"name": name, "namespace": namespace, "resourceVersion": str(self._rv)}
            )
            self._leases[(namespace, name)] = lease
            return 201, json.loads(json.dumps(lease))

    def replace_lease(self, namespace: str, name: str, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """(status, body): 200 on replace, 404 if missing, 409 on a stale
        metadata.resourceVersion (optimistic-concurrency contract — this is
        what makes leader-election takeover a compare-and-swap)."""
        with self._lock:
            current = self._leases.get((namespace, name))
            if current is None:
                return 404, {"kind": "Status", "code": 404, "message": f"leases \"{name}\" not found"}
            sent_rv = (body.get("metadata") or {}).get("resourceVersion")
            if sent_rv != current["metadata"]["resourceVersion"]:
                return 409, {"kind": "Status", "code": 409, "message": "the object has been modified"}
            self._rv += 1
            lease = json.loads(json.dumps(body))
            lease.setdefault("metadata", {}).update(
                {"name": name, "namespace": namespace, "resourceVersion": str(self._rv)}
            )
            self._leases[(namespace, name)] = lease
            return 200, json.loads(json.dumps(lease))


def _parse_lease_path(path: str) -> Optional[Tuple[str, Optional[str]]]:
    """``(namespace, name-or-None)`` for coordination/v1 lease routes."""
    prefix = "/apis/coordination.k8s.io/v1/namespaces/"
    if not path.startswith(prefix):
        return None
    rest = path[len(prefix):].split("/")
    if len(rest) == 2 and rest[1] == "leases":
        return rest[0], None
    if len(rest) == 3 and rest[1] == "leases" and rest[2]:
        return rest[0], rest[2]
    return None


# sentinel distinguishing "limit was malformed, 400 already sent" from a
# legitimately absent limit (None)
_BAD_LIMIT = object()


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 with Transfer-Encoding: chunked on the watch stream — the
    # real kube-apiserver's framing, which is also what lets clients see
    # each event the moment its chunk arrives (a close-delimited body would
    # make fixed-size reads block until the buffer fills or the watch ends).
    protocol_version = "HTTP/1.1"
    # Nagle + delayed-ACK would add ~40 ms to every streamed watch frame
    disable_nagle_algorithm = True
    cluster: MockCluster  # injected by MockApiServer
    server_ref = None  # the owning MockApiServer, for header recording

    def log_message(self, fmt, *args):  # silence default stderr spam
        pass

    def parse_request(self):
        ok = super().parse_request()
        if ok and self.server_ref is not None:
            self.server_ref.request_headers.append(
                {"Authorization": self.headers.get("Authorization"), "path": self.path}
            )
        return ok

    def _parse_limit(self, params: Dict[str, str]):
        """``limit`` as int, None when absent, or ``_BAD_LIMIT`` after
        responding 400 — a non-integer limit gets the same Status body a
        malformed continue token does, not a 500 traceback."""
        if "limit" not in params:
            return None
        try:
            limit = int(params["limit"])
        except ValueError:
            self._json(400, {"kind": "Status", "code": 400, "message": "malformed limit"})
            return _BAD_LIMIT
        if limit < 0:
            # a negative limit would slice matches[:limit] empty and then
            # IndexError building the continue token — same 400 contract
            self._json(400, {"kind": "Status", "code": 400, "message": "malformed limit"})
            return _BAD_LIMIT
        return limit

    def _json(self, status: int, body: Dict[str, Any]) -> None:
        data = body.encode() if isinstance(body, _PreserializedList) else json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (stdlib naming)
        fail = self.cluster.consume_failure()
        if fail:
            self._json(fail, {"kind": "Status", "code": fail, "message": "injected failure"})
            return

        parsed = urlparse(self.path)
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        path = parsed.path

        if path == "/version":
            self._json(200, {"major": "1", "minor": "31", "gitVersion": "v1.31.0-mock"})
            return
        if path == "/health":
            # clusterapi-surface health endpoint (ClusterApiClient.health_check)
            self._json(200, {"ok": True})
            return
        if path == "/api/v1/namespaces":
            items = [{"metadata": {"name": ns}} for ns in self.cluster.namespaces]
            self._json(200, {"kind": "NamespaceList", "items": items})
            return

        lease = _parse_lease_path(path)
        if lease is not None:
            namespace, name = lease
            if name is None:
                self._json(400, {"kind": "Status", "code": 400, "message": "lease collection GET not supported"})
                return
            found = self.cluster.get_lease(namespace, name)
            if found is None:
                self._json(404, {"kind": "Status", "code": 404, "message": f"leases \"{name}\" not found"})
            else:
                self._json(200, found)
            return

        if path == "/api/v1/nodes":
            if params.get("watch") == "true":
                self._serve_watch(None, params, collection="nodes")
            else:
                limit = self._parse_limit(params)
                if limit is _BAD_LIMIT:
                    return
                status, body = self.cluster.list_nodes(
                    params.get("labelSelector"), limit, params.get("continue")
                )
                self._json(status, body)
            return
        if path.startswith("/api/v1/nodes/"):
            name = path[len("/api/v1/nodes/"):]
            node = self.cluster.get_node(name)
            if node is None:
                self._json(404, {"kind": "Status", "code": 404, "message": f"nodes \"{name}\" not found"})
            else:
                self._json(200, node)
            return

        namespace: Optional[str] = None
        if path == "/api/v1/pods":
            pass
        elif path.startswith("/api/v1/namespaces/") and path.endswith("/pods"):
            namespace = path[len("/api/v1/namespaces/"):-len("/pods")]
        else:
            self._json(404, {"kind": "Status", "code": 404, "message": f"no route {path}"})
            return

        if params.get("watch") == "true":
            self._serve_watch(namespace, params)
        else:
            limit = self._parse_limit(params)
            if limit is _BAD_LIMIT:
                return
            status, body = self.cluster.list_pods(
                namespace, limit, params.get("labelSelector"), params.get("continue"),
                shard=params.get("shard"),
            )
            self._json(status, body)

    def _read_body(self) -> Optional[Dict[str, Any]]:
        try:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._json(400, {"kind": "Status", "code": 400, "message": "malformed request body"})
            return None

    def do_POST(self):  # noqa: N802 (stdlib naming)
        # read the body BEFORE any early response: unread body bytes would
        # be parsed as the next request line on this keep-alive connection
        body = self._read_body()
        if body is None:
            return
        fail = self.cluster.consume_failure()
        if fail:
            self._json(fail, {"kind": "Status", "code": fail, "message": "injected failure"})
            return
        path = urlparse(self.path).path
        if path == "/api/pods/update":
            # clusterapi notify surface: one status-update payload
            self.cluster.record_status_update(body)
            self._json(200, {"ok": True})
            return
        if path == "/api/pods/update_batch":
            # batched notify (ClusterApiClient.update_pod_statuses wire
            # shape); malformed batch envelope (non-dict body included)
            # -> 400, per-item verdicts ride back in "results"
            updates = body.get("updates") if isinstance(body, dict) else None
            if not isinstance(updates, list):
                self._json(400, {"kind": "Status", "code": 400, "message": "updates must be a list"})
                return
            self._json(200, {"results": self.cluster.record_status_updates(updates)})
            return
        lease = _parse_lease_path(path)
        if lease is not None and lease[1] is None:  # POST to the collection creates
            namespace = lease[0]
            name = (body.get("metadata") or {}).get("name", "")
            status, out = self.cluster.create_lease(namespace, name, body)
            self._json(status, out)
            return
        if path == "/api/v1/namespaces":
            status, out = self.cluster.create_namespace((body.get("metadata") or {}).get("name", ""))
            self._json(status, out)
            return
        if path.startswith("/api/v1/namespaces/") and path.endswith("/pods"):
            namespace = path[len("/api/v1/namespaces/"):-len("/pods")]
            status, out = self.cluster.create_pod(namespace, body)
            self._json(status, out)
            return
        self._json(404, {"kind": "Status", "code": 404, "message": f"no route {self.path}"})

    def do_DELETE(self):  # noqa: N802 (stdlib naming)
        fail = self.cluster.consume_failure()
        if fail:
            self._json(fail, {"kind": "Status", "code": fail, "message": "injected failure"})
            return
        path = urlparse(self.path).path
        parts = path.strip("/").split("/")
        # /api/v1/namespaces/{ns}/pods/{name}
        if len(parts) == 6 and parts[:2] == ["api", "v1"] and parts[2] == "namespaces" and parts[4] == "pods":
            status, out = self.cluster.remove_pod(parts[3], parts[5])
            self._json(status, out)
            return
        # /api/v1/namespaces/{name}
        if len(parts) == 4 and parts[:3] == ["api", "v1", "namespaces"]:
            status, out = self.cluster.delete_namespace(parts[3])
            self._json(status, out)
            return
        self._json(404, {"kind": "Status", "code": 404, "message": f"no route {self.path}"})

    def do_PATCH(self):  # noqa: N802 (stdlib naming)
        body = self._read_body()
        if body is None:
            return
        fail = self.cluster.consume_failure()
        if fail:
            self._json(fail, {"kind": "Status", "code": fail, "message": "injected failure"})
            return
        path = urlparse(self.path).path
        if path.startswith("/api/v1/nodes/"):
            status, out = self.cluster.patch_node(path[len("/api/v1/nodes/"):], body)
            self._json(status, out)
            return
        self._json(404, {"kind": "Status", "code": 404, "message": f"no route {self.path}"})

    def do_PUT(self):  # noqa: N802 (stdlib naming)
        body = self._read_body()
        if body is None:
            return
        fail = self.cluster.consume_failure()
        if fail:
            self._json(fail, {"kind": "Status", "code": fail, "message": "injected failure"})
            return
        lease = _parse_lease_path(urlparse(self.path).path)
        if lease is not None and lease[1] is not None:
            namespace, name = lease
            status, out = self.cluster.replace_lease(namespace, name, body)
            self._json(status, out)
            return
        self._json(404, {"kind": "Status", "code": 404, "message": f"no route {self.path}"})

    def _serve_watch(self, namespace: Optional[str], params: Dict[str, str], collection: str = "pods") -> None:
        try:
            rv = int(params.get("resourceVersion", "0") or "0")
        except ValueError:
            rv = 0
        timeout_s = min(int(params.get("timeoutSeconds", "30") or "30"), 300)
        deadline = time.monotonic() + timeout_s
        selector = _parse_label_selector(params.get("labelSelector"))
        shard_sel = _parse_shard(params.get("shard")) if collection == "pods" else None
        send_bookmarks = params.get("allowWatchBookmarks") == "true"
        last_frame = time.monotonic()

        first = self.cluster.events_since(rv, time.monotonic(), collection)  # non-blocking compaction check
        if first is None:
            self._json(410, {"kind": "Status", "code": 410, "message": "too old resource version"})
            return

        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_frame(payload: Dict[str, Any]) -> None:
            data = (json.dumps(payload) + "\n").encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        try:
            while time.monotonic() < deadline:
                batch = self.cluster.events_since(rv, min(deadline, time.monotonic() + 0.5), collection)
                if batch is None:
                    # compacted mid-stream: emit the in-band 410 ERROR event
                    write_frame({"type": "ERROR", "object": {"kind": "Status", "code": 410, "message": "too old resource version"}})
                    break
                if not batch and send_bookmarks and time.monotonic() - last_frame >= 1.0:
                    # idle stream: k8s sends BOOKMARK frames so clients can
                    # advance their resume version without real events. Use
                    # the handler-local rv (not latest_rv()): an event
                    # recorded in the race window must not be marked seen
                    # before it is delivered.
                    write_frame({
                        "type": "BOOKMARK",
                        "object": {"kind": "Pod", "metadata": {"resourceVersion": str(rv)}},
                    })
                    last_frame = time.monotonic()
                for event in batch:
                    obj = event.get("object") or {}
                    obj_ns = (obj.get("metadata") or {}).get("namespace")
                    erv = int((obj.get("metadata") or {}).get("resourceVersion", "0"))
                    rv = max(rv, erv)
                    if namespace is not None and obj_ns != namespace:
                        continue
                    if selector and not _matches_selector(obj, selector):
                        continue
                    if not _matches_shard(obj, shard_sel):
                        continue
                    write_frame(event)
                    last_frame = time.monotonic()
            # terminal chunk: clean end of the bounded watch window
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass


class MockApiServer:
    """Owns the HTTP server thread; use as a context manager in tests."""

    def __init__(self, cluster: Optional[MockCluster] = None, host: str = "127.0.0.1", port: int = 0):
        self.cluster = cluster or MockCluster()
        # auth-relevant headers per request, for credential-plumbing tests
        self.request_headers: List[Dict[str, Optional[str]]] = []
        handler = type(
            "BoundHandler", (_Handler,), {"cluster": self.cluster, "server_ref": self}
        )
        self._server = QuietThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MockApiServer":
        self._thread = threading.Thread(target=self._server.serve_forever, name="mock-k8s-api", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=2.0)

    def __enter__(self) -> "MockApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
