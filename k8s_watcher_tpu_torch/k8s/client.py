"""Kubernetes REST client: the node surface remediation uses, on the standard
library (the JAX package's ``k8s/client.py``, which rides ``requests``).

- ``get_api_version``            GET /version (a connection smoke test)
- ``list_nodes``                 GET /api/v1/nodes, one page
- ``list_nodes_paged``           the same in ``limit``+``continue`` pages
- ``get_node``                   GET /api/v1/nodes/{name}
- ``patch_node``                 PATCH /api/v1/nodes/{name}, JSON merge-patch

Each request opens its own connection (remediation makes a handful per
confirmed finding). Under dynamic credentials (an exec plugin or a rotating
token file) a 401 drops the cached token and the request is retried once
with a fresh one. ``HTTP(S)_PROXY``/``NO_PROXY`` are honoured as the
notifier honours them.
"""

from __future__ import annotations

import http.client
import json
import logging
import time
from typing import Any, Dict, Iterator, Optional, Tuple
from urllib.parse import urlencode, urlsplit

from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
from k8s_watcher_tpu_torch.http import new_connection, proxy_for

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
    """HTTP 409: a write carried a stale resourceVersion."""


class K8sNotFoundError(K8sApiError):
    """HTTP 404: the object does not exist."""


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
        rel = f"{self._path_prefix}{path}"
        if params:
            rel = f"{rel}?{urlencode(params)}"
        target = f"{self._scheme}://{self._host}:{self._port}{rel}" if (
            self._proxy is not None and self._scheme == "http") else rel
        body = json.dumps(json_body).encode("utf-8") if json_body is not None else None
        for retry_401 in (True, False):
            self._refresh_auth()
            headers = {"Accept": "application/json"}
            if body is not None:
                headers["Content-Type"] = content_type
            if self._auth:
                headers["Authorization"] = self._auth
            if self._proxy is not None and self._scheme == "http" and self._proxy[2]:
                headers["Proxy-Authorization"] = self._proxy[2]
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
    def iter_list_pages(pages, *, metrics=None, metric_prefix: str = "relist") -> Iterator[Tuple[Any, list, bool]]:
        """Consume a ``_list_paged`` stream, yielding ``(rv, items,
        attempt_changed)`` and recording ``<prefix>s``, ``<prefix>_pages``,
        ``<prefix>_restarts`` and the ``<prefix>_duration`` histogram (in
        ``finally``: an aborted list is the costliest and must show)."""
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
