"""Kubernetes REST client on the standard library (the JAX package's
``k8s/client.py``, which rides ``requests``): the pod surface the watcher
uses and the node surface remediation uses.

- ``get_api_version``            GET /version (a connection smoke test)
- ``list_pods``                  GET /api/v1[/namespaces/{ns}]/pods, one page
- ``list_pods_paged``            the same in ``limit``+``continue`` pages
- ``watch_pods``                 the same with ``watch=true``: JSON lines over
                                 a chunked HTTP body, read as they land
- ``list_nodes``                 GET /api/v1/nodes, one page
- ``list_nodes_paged``           the same in ``limit``+``continue`` pages
- ``get_node``                   GET /api/v1/nodes/{name}
- ``patch_node``                 PATCH /api/v1/nodes/{name}, JSON merge-patch
- ``watch_nodes``                GET /api/v1/nodes with ``watch=true``
- ``get_lease``/``create_lease``/``replace_lease``
                                 coordination.k8s.io/v1 Leases (leader election)

Each request opens its own connection; a watch holds its connection for the
server-side window (``timeoutSeconds``), and ``abort_watch`` shuts its socket
down from another thread so a blocked read returns at once. Watch semantics
follow the Kubernetes API contract: events resume from ``resourceVersion``,
bookmarks are requested, and a 410 Gone (HTTP status or in-stream ERROR
event) raises ``K8sGoneError`` so the caller relists. Under dynamic
credentials (an exec plugin or a rotating token file) a 401 drops the cached
token and the request is retried once with a fresh one.
``HTTP(S)_PROXY``/``NO_PROXY`` are honoured as the notifier honours them.
"""

from __future__ import annotations

import http.client
import json
import logging
import queue
import socket
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple
from urllib.parse import urlencode, urlsplit

from k8s_watcher_tpu_torch.http import new_connection, proxy_for
from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
from k8s_watcher_tpu_torch.watch.sharded import parse_shard_selector

logger = logging.getLogger(__name__)


class K8sApiError(Exception):
    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


class K8sGoneError(K8sApiError):
    """resourceVersion too old (HTTP 410): the caller must relist.

    ``token_expiry`` is True only when a paged LIST exhausted its restarts
    on expired continue tokens."""

    token_expiry: bool = False


class K8sConflictError(K8sApiError):
    """HTTP 409: a create raced another writer, or an update carried a stale
    resourceVersion. Leader election treats it as "lost the race"."""


class K8sNotFoundError(K8sApiError):
    """HTTP 404: the object does not exist."""


def decode_watch_chunks(chunks: Iterator[bytes], scanner, shard=None) -> Iterator[Dict[str, Any]]:
    """The watch decode hot path: raw body chunks -> watch-event dicts, with
    ``scanner.scan_chunk`` running BEFORE any ``json.loads`` so frames that
    cannot matter (no accelerator key; foreign-shard uids when ``shard=(i,
    n)``) skip the parse and surface as coalesced rv-only PREFILTERED
    markers. Frame boundaries do not align with chunks: the unconsumed tail
    of each chunk is prepended to the next, and a non-empty tail at the end
    of the stream is the final (unterminated) frame."""
    scan_chunk = scanner.scan_chunk
    tail = b""
    for chunk in chunks:
        if not chunk:
            continue
        buf = tail + chunk if tail else chunk
        records, consumed = scan_chunk(buf, shard=shard)
        tail = buf[consumed:]
        # skip-runs arrive coalesced from the scanner; runs that continue
        # across chunk boundaries merge, so a non-accelerator event storm
        # costs one marker per chunk at most
        skip_rv, skipped = None, 0
        for start, length, rv, count in records:
            if rv is not None:
                skip_rv, skipped = rv, skipped + count
                continue
            if skipped:
                yield K8sClient._prefiltered_marker(skip_rv, skipped)
                skip_rv, skipped = None, 0
            yield K8sClient._parse_frame(buf[start : start + length])
        if skipped:
            yield K8sClient._prefiltered_marker(skip_rv, skipped)
    if tail.strip():
        scan = scanner.scan(tail)
        if scan.skippable or (shard is not None and scan.foreign_shard(*shard)):
            yield K8sClient._prefiltered_marker(scan.resource_version)
        else:
            yield K8sClient._parse_frame(tail)


class K8sClient:
    def __init__(self, connection: K8sConnection, *, request_timeout: float = 30.0):
        self.connection = connection
        self.request_timeout = request_timeout
        parts = urlsplit(connection.server)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"apiserver URL must be http(s)://, got {connection.server!r}")
        self._scheme = parts.scheme
        self._host = parts.hostname or "localhost"
        self._port = parts.port or (443 if self._scheme == "https" else 80)
        self._path_prefix = parts.path.rstrip("/")
        self._ssl_context = connection.ssl_context() if self._scheme == "https" else None
        self._proxy = proxy_for(self._scheme, self._host, self._port)
        # static tokens install once; dynamic ones resolve per request
        self._auth: Optional[str] = None
        if connection.token and not connection.dynamic_auth:
            self._auth = f"Bearer {connection.token}"
        self._watch_socket: Optional[socket.socket] = None  # the live watch's, for abort_watch()
        self._watch_aborted = False  # sticky: this client is shutting down

    def abort_watch(self) -> None:
        """End the in-flight watch from another thread: its socket is shut
        down, so the blocked read returns at once instead of waiting out the
        server-side window (what makes a stop prompt on a quiet cluster).
        Sticky: a watch still connecting when this runs ends right after
        its connect, and no later watch starts."""
        self._watch_aborted = True
        sock = self._watch_socket
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed

    # -- plumbing ----------------------------------------------------------

    def _refresh_auth(self) -> None:
        """(Re)install the bearer token of dynamic credentials; a plugin
        failure surfaces as K8sApiError, like any transient API failure."""
        if not self.connection.dynamic_auth:
            return
        try:
            token = self.connection.auth_token()
        except Exception as exc:
            raise K8sApiError(f"credential refresh failed: {exc}") from exc
        if token:
            self._auth = f"Bearer {token}"

    def _handle_401(self, status: int) -> bool:
        """A 401 under dynamic auth: drop the cached token so the retry
        re-derives it. True when a retry is worth it."""
        if status != 401 or not self.connection.dynamic_auth:
            return False
        logger.warning("API server returned 401; re-deriving credentials")
        self.connection.invalidate_token()
        return True

    def _target(self, path: str, params: Optional[Dict[str, Any]] = None) -> str:
        """Origin-form, or absolute-form through a plain-http forward proxy."""
        rel = f"{self._path_prefix}{path}"
        if params:
            rel = f"{rel}?{urlencode(params)}"
        if self._proxy is not None and self._scheme == "http":
            return f"{self._scheme}://{self._host}:{self._port}{rel}"
        return rel

    def _headers(self, content_type: Optional[str] = None) -> Dict[str, str]:
        headers = {"Accept": "application/json"}
        if content_type is not None:
            headers["Content-Type"] = content_type
        if self._auth:
            headers["Authorization"] = self._auth
        if self._proxy is not None and self._scheme == "http" and self._proxy[2]:
            headers["Proxy-Authorization"] = self._proxy[2]
        return headers

    def _send(self, method: str, target: str, body: Optional[bytes], headers: Dict[str, str]) -> Tuple[int, bytes]:
        conn = new_connection(
            self._scheme, self._host, self._port, self.request_timeout, self._proxy, self._ssl_context
        )
        try:
            conn.request(method, target, body=body, headers=headers)
            response = conn.getresponse()
            return response.status, response.read()
        finally:
            conn.close()

    def _request(
        self,
        method: str,
        path: str,
        params: Optional[Dict[str, Any]] = None,
        json_body: Optional[Dict[str, Any]] = None,
        content_type: str = "application/json",
    ) -> Any:
        """One request; the decoded JSON body, or a K8sApiError subclass by status."""
        target = self._target(path, params)
        body = json.dumps(json_body).encode("utf-8") if json_body is not None else None
        for retry_401 in (True, False):
            self._refresh_auth()
            headers = self._headers(content_type if body is not None else None)
            try:
                status, data = self._send(method, target, body, headers)
            except (OSError, http.client.HTTPException) as exc:
                raise K8sApiError(f"{method} {path} failed: {exc}") from exc
            if retry_401 and self._handle_401(status):
                continue  # token re-minted; one retry
            break
        text = data.decode("utf-8", errors="replace")
        if status == 404:
            raise K8sNotFoundError(f"{method} {path}: not found", status=404)
        if status == 409:
            raise K8sConflictError(f"{method} {path}: conflict: {text[:300]}", status=409)
        if status == 410:
            raise K8sGoneError(f"{method} {path}: resourceVersion expired (410 Gone)", status=410)
        if status >= 400:
            raise K8sApiError(f"{method} {path}: HTTP {status}: {text[:300]}", status=status)
        try:
            return json.loads(data) if data else {}
        except ValueError as exc:
            raise K8sApiError(f"{method} {path}: malformed JSON response: {text[:200]!r}", status=status) from exc

    # -- API surface -------------------------------------------------------

    def get_api_version(self) -> str:
        """Server version string, e.g. ``v1.31``."""
        info = self._request("GET", "/version")
        major, minor = info.get("major", "?"), info.get("minor", "?")
        return f"v{major}.{minor}"

    @staticmethod
    def _pods_path(namespace: Optional[str]) -> str:
        return f"/api/v1/namespaces/{namespace}/pods" if namespace else "/api/v1/pods"

    def list_pods(
        self,
        namespace: Optional[str] = None,
        *,
        limit: Optional[int] = None,
        label_selector: Optional[str] = None,
        continue_token: Optional[str] = None,
        shard_selector: Optional[str] = None,
    ) -> Dict[str, Any]:
        """One page of pods: the raw PodList body (items, the resourceVersion
        a following watch resumes from, and ``metadata.continue`` while pages
        remain; an expired token raises K8sGoneError). ``shard_selector``
        ("i/n") asks the server for shard i's pods only; a stock apiserver
        ignores it and the caller's ownership filter keeps correctness."""
        params: Dict[str, Any] = {}
        if limit:
            params["limit"] = limit
        if label_selector:
            params["labelSelector"] = label_selector
        if continue_token:
            params["continue"] = continue_token
        if shard_selector:
            params["shard"] = shard_selector
        return self._request("GET", self._pods_path(namespace), params)

    def list_pods_paged(
        self,
        namespace: Optional[str] = None,
        *,
        page_size: int = 500,
        label_selector: Optional[str] = None,
        max_restarts: int = 2,
        shard_selector: Optional[str] = None,
    ):
        """A pod LIST in bounded pages (contract: ``_list_paged``)."""
        return self._list_paged(
            lambda token: self.list_pods(
                namespace, limit=page_size, label_selector=label_selector,
                continue_token=token, shard_selector=shard_selector,
            ),
            max_restarts,
        )

    @staticmethod
    def _list_paged(fetch_page, max_restarts: int):
        """Pagination driver: ``fetch_page(continue_token) -> body``; yields
        ``(attempt, page_body)``. ``attempt`` grows when an expired continue
        token (410 mid-pagination) restarts the list from scratch, and the
        consumer must then reset what it gathered from the aborted attempt.
        Raises K8sGoneError after ``max_restarts`` restarts."""
        attempt = 0
        while True:
            token: Optional[str] = None
            try:
                while True:
                    page = fetch_page(token)
                    yield attempt, page
                    token = (page.get("metadata") or {}).get("continue")
                    if not token:
                        return
            except K8sGoneError as exc:
                if token is None:
                    # the first page 410'd: no continue token was in play
                    exc.token_expiry = False
                    raise
                attempt += 1
                if attempt > max_restarts:
                    exc.token_expiry = True
                    raise
                logger.warning(
                    "LIST continue token expired (410) mid-pagination; restarting the list (attempt %d/%d)",
                    attempt, max_restarts,
                )

    @staticmethod
    def _prefetch_iter(source):
        """One-ahead prefetch: a helper thread fetches the NEXT page while the
        consumer processes this one, so a paged list takes max(fetch,
        process) per page instead of their sum. Exceptions (410 token
        expiry included) re-raise in the consumer, in order; a consumer that
        stops early releases the helper at its next hand-off."""
        out: queue.Queue = queue.Queue(maxsize=1)
        done = object()
        cancel = threading.Event()

        def put_cancellable(item) -> bool:
            # every put, the sentinels included, gives up once the consumer
            # has gone, or the helper would block forever on a full page
            while not cancel.is_set():
                try:
                    out.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def pump() -> None:
            try:
                for item in source:
                    if not put_cancellable(item):
                        return
                put_cancellable(done)
            except BaseException as exc:  # noqa: BLE001 — forwarded, not handled
                put_cancellable(("__exc__", exc))

        threading.Thread(target=pump, name="list-page-prefetch", daemon=True).start()
        try:
            while True:
                item = out.get()
                if item is done:
                    return
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "__exc__":
                    raise item[1]
                yield item
        finally:
            cancel.set()

    @staticmethod
    def iter_list_pages(
        pages, *, metrics=None, metric_prefix: str = "relist", prefetch: bool = False,
    ) -> Iterator[Tuple[Any, list, bool]]:
        """Consume a ``_list_paged`` stream, yielding ``(rv, items,
        attempt_changed)`` and recording ``<prefix>s``, ``<prefix>_pages``,
        ``<prefix>_restarts`` and the ``<prefix>_duration`` histogram (in
        ``finally``: an aborted list is the costliest and must show).
        ``prefetch`` overlaps the next page's fetch with this page's
        processing (``_prefetch_iter``)."""
        if prefetch:
            pages = K8sClient._prefetch_iter(pages)
        t0 = time.monotonic()
        if metrics is not None:
            metrics.counter(f"{metric_prefix}s").inc()
        last_attempt = 0
        try:
            for attempt, body in pages:
                changed = attempt != last_attempt
                if changed:
                    last_attempt = attempt
                    if metrics is not None:
                        metrics.counter(f"{metric_prefix}_restarts").inc()
                if metrics is not None:
                    metrics.counter(f"{metric_prefix}_pages").inc()
                yield (body.get("metadata") or {}).get("resourceVersion"), body.get("items", []), changed
        finally:
            if metrics is not None:
                metrics.histogram(f"{metric_prefix}_duration").observe_since(t0)

    def list_nodes(
        self,
        *,
        label_selector: Optional[str] = None,
        limit: Optional[int] = None,
        continue_token: Optional[str] = None,
    ) -> Dict[str, Any]:
        """One page of nodes: the raw NodeList body (items, resourceVersion,
        and ``metadata.continue`` while pages remain)."""
        params: Dict[str, Any] = {}
        if label_selector:
            params["labelSelector"] = label_selector
        if limit:
            params["limit"] = limit
        if continue_token:
            params["continue"] = continue_token
        return self._request("GET", "/api/v1/nodes", params)

    def list_nodes_paged(self, *, page_size: int = 500, label_selector: Optional[str] = None, max_restarts: int = 2):
        """A node LIST in bounded pages (contract: ``_list_paged``)."""
        return self._list_paged(
            lambda token: self.list_nodes(limit=page_size, label_selector=label_selector, continue_token=token),
            max_restarts,
        )

    def get_node(self, name: str) -> Dict[str, Any]:
        """One Node object (raises K8sNotFoundError if absent)."""
        return self._request("GET", f"/api/v1/nodes/{name}")

    def patch_node(self, name: str, patch: Dict[str, Any]) -> Dict[str, Any]:
        """JSON merge-patch (RFC 7386) a Node: cordon (``spec.unschedulable``)
        and taint (``spec.taints``). Merge-patch replaces lists wholesale, so
        taint edits are read-modify-write on the caller's side."""
        return self._request(
            "PATCH", f"/api/v1/nodes/{name}", json_body=patch, content_type="application/merge-patch+json",
        )

    def list_namespaces(self, limit: Optional[int] = None) -> List[str]:
        params: Dict[str, Any] = {}
        if limit:
            params["limit"] = limit
        body = self._request("GET", "/api/v1/namespaces", params)
        return [(item.get("metadata") or {}).get("name", "") for item in body.get("items", [])]

    # -- writes (the integration tier's create/delete primitives) ----------

    def create_pod(self, namespace: str, pod: Dict[str, Any]) -> Dict[str, Any]:
        """POST a Pod manifest; raises K8sConflictError if it exists."""
        return self._request("POST", self._pods_path(namespace), json_body=pod)

    def delete_pod(self, namespace: str, name: str) -> Dict[str, Any]:
        """DELETE a pod (raises K8sNotFoundError if absent)."""
        return self._request("DELETE", f"{self._pods_path(namespace)}/{name}")

    def create_namespace(self, name: str) -> Dict[str, Any]:
        body = {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": name}}
        return self._request("POST", "/api/v1/namespaces", json_body=body)

    def delete_namespace(self, name: str) -> Dict[str, Any]:
        return self._request("DELETE", f"/api/v1/namespaces/{name}")

    # -- coordination.k8s.io/v1 Leases (leader election) -------------------

    @staticmethod
    def _leases_path(namespace: str, name: Optional[str] = None) -> str:
        base = f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases"
        return f"{base}/{name}" if name else base

    def get_lease(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        """The Lease object, or None if it does not exist."""
        try:
            return self._request("GET", self._leases_path(namespace, name))
        except K8sNotFoundError:
            return None

    def create_lease(self, namespace: str, name: str, spec: Dict[str, Any]) -> Dict[str, Any]:
        """POST a new Lease; raises K8sConflictError if it already exists
        (another candidate won the creation race)."""
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": name, "namespace": namespace},
            "spec": spec,
        }
        return self._request("POST", self._leases_path(namespace), json_body=body)

    def replace_lease(self, namespace: str, name: str, lease: Dict[str, Any]) -> Dict[str, Any]:
        """PUT a full Lease object; the server enforces optimistic concurrency
        on ``metadata.resourceVersion`` (a stale write -> K8sConflictError)."""
        return self._request("PUT", self._leases_path(namespace, name), json_body=lease)

    # -- watch -------------------------------------------------------------

    def watch_pods(
        self,
        namespace: Optional[str] = None,
        *,
        resource_version: Optional[str] = None,
        timeout_seconds: int = 300,
        allow_bookmarks: bool = True,
        label_selector: Optional[str] = None,
        scanner=None,  # native.scanner.PythonFrameScanner: skip-parse prefilter
        shard_selector: Optional[str] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Stream raw pod watch events (``{"type": ..., "object": ...}``)
        until the server closes the bounded watch or an error occurs.

        With a ``scanner``, frames that cannot request the accelerator
        resource skip the JSON parse and surface as ``{"type":
        "PREFILTERED"}`` markers carrying only the resourceVersion.
        ``shard_selector`` ("i/n") asks the server for shard i's pods only;
        against a server that ignores it, frames whose uid hashes to another
        shard become the same markers before any parse."""
        params: Dict[str, Any] = {"watch": "true", "timeoutSeconds": timeout_seconds}
        if resource_version:
            params["resourceVersion"] = resource_version
        if allow_bookmarks:
            params["allowWatchBookmarks"] = "true"
        if label_selector:
            params["labelSelector"] = label_selector
        if shard_selector:
            params["shard"] = shard_selector
        return self._watch(self._target(self._pods_path(namespace), params), timeout_seconds, scanner,
                           parse_shard_selector(shard_selector) if shard_selector else None)

    def watch_nodes(
        self,
        *,
        resource_version: Optional[str] = None,
        timeout_seconds: int = 300,
        allow_bookmarks: bool = True,
        label_selector: Optional[str] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Stream raw node watch events (the ``watch_pods`` contract, with no
        prefilter: node streams are tiny next to pod streams). One client
        carries at most one live watch: run the node watch on its own
        ``K8sClient``."""
        params: Dict[str, Any] = {"watch": "true", "timeoutSeconds": timeout_seconds}
        if resource_version:
            params["resourceVersion"] = resource_version
        if allow_bookmarks:
            params["allowWatchBookmarks"] = "true"
        if label_selector:
            params["labelSelector"] = label_selector
        return self._watch(self._target("/api/v1/nodes", params), timeout_seconds, None, None)

    def _watch(self, target: str, timeout_seconds: int, scanner, shard) -> Iterator[Dict[str, Any]]:
        self._refresh_auth()
        conn = new_connection(
            self._scheme, self._host, self._port, self.request_timeout, self._proxy, self._ssl_context
        )
        try:
            try:
                conn.connect()
                # the read timeout must outlast the server-side window, or a
                # healthy idle watch would be cut: +30 s of slack
                conn.sock.settimeout(timeout_seconds + 30)
                # registered BEFORE any read, so abort_watch() can always
                # reach a read that blocks
                self._watch_socket = conn.sock
                if self._watch_aborted:
                    raise K8sApiError("watch aborted during connect")
                conn.request("GET", target, headers=self._headers())
                response = conn.getresponse()
            except (OSError, http.client.HTTPException) as exc:
                raise K8sApiError(f"watch connect failed: {exc}") from exc
            if response.status == 410:
                raise K8sGoneError("watch: resourceVersion expired (410 Gone)", status=410)
            if response.status >= 400:
                # a 401 under dynamic credentials: invalidate, so the watch
                # loop's backoff-reconnect re-derives them
                self._handle_401(response.status)
                text = response.read(300).decode("utf-8", errors="replace")
                raise K8sApiError(f"watch: HTTP {response.status}: {text}", status=response.status)
            yield from self._decode_watch_stream(response, scanner, shard)
        except (OSError, http.client.HTTPException) as exc:
            raise K8sApiError(f"watch stream broken: {exc}") from exc
        except (AttributeError, ValueError) as exc:
            # a read racing abort_watch() can meet a torn-down response;
            # translated only when an abort was asked for, so real bugs are
            # never laundered into silent reconnects
            if self._watch_aborted:
                raise K8sApiError(f"watch stream closed by abort: {exc}") from exc
            raise
        finally:
            self._watch_socket = None
            conn.close()

    # -- watch-stream decoding ---------------------------------------------

    @staticmethod
    def _parse_frame(line: bytes) -> Dict[str, Any]:
        try:
            event = json.loads(line)
        except json.JSONDecodeError as exc:
            raise K8sApiError(f"watch: malformed event frame: {line[:200]!r}") from exc
        if event.get("type") == "ERROR":
            obj = event.get("object") or {}
            if obj.get("code") == 410:
                raise K8sGoneError(f"watch: {obj.get('message', '410 Gone')}", status=410)
            raise K8sApiError(f"watch: server error event: {obj}", status=obj.get("code"))
        return event

    @staticmethod
    def _prefiltered_marker(resource_version: Optional[str], count: int = 1) -> Dict[str, Any]:
        """rv-only stand-in for ``count`` consecutive skipped frames (only
        the last resume version of a run matters: rv is monotonic)."""
        return {
            "type": "PREFILTERED",
            "count": count,
            "object": {"metadata": {"resourceVersion": resource_version}},
        }

    def _decode_watch_stream(self, response, scanner, shard=None) -> Iterator[Dict[str, Any]]:
        """The HTTP body as watch events: without a scanner one JSON frame
        per line; with one, the body is read as it lands (``read1``: one
        transfer chunk at a time) and frame-split and scanned before any
        parse (``decode_watch_chunks``)."""
        if scanner is None:
            while True:
                line = response.readline()
                if not line:
                    return
                line = line.strip()
                if line:
                    yield self._parse_frame(line)
        yield from decode_watch_chunks(iter(lambda: response.read1(64 * 1024), b""), scanner, shard)
