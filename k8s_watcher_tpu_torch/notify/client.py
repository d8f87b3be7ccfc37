"""The cluster API client: POSTs probe and remediation payloads (the JAX
package's ``notify/client.py``, the per-payload path).

``update_pod_status(payload) -> bool`` POSTs JSON with ``Authorization:
Bearer <api_key>``; ``health_check() -> bool`` GETs the health endpoint with
a 5 s timeout. Neither raises. Connection errors, timeouts, 5xx, 408 and 429
are retried with exponential backoff per the configured ``RetryPolicy``;
other 4xx are not (retrying cannot help a client error).

Requests ride a pool of persistent ``http.client`` connections (standard
library only): any worker borrows any warm connection (LIFO), up to
``pool_size`` live ones. Payloads are idempotent state snapshots, so a
request that dies on a *reused* keep-alive connection (the server idled it
out) is resent once on a fresh connection before the retry policy is
consulted. ``abort()`` cuts every in-flight send for a bounded shutdown.

``HTTP_PROXY``/``HTTPS_PROXY``/``NO_PROXY`` are honoured
(:func:`k8s_watcher_tpu_torch.http.proxy_for`).
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import ssl
import threading
import time
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlsplit

from k8s_watcher_tpu_torch.config import RetryPolicy
from k8s_watcher_tpu_torch.http import new_connection, proxy_for

logger = logging.getLogger(__name__)


class ClusterApiClient:
    def __init__(
        self,
        base_url: str,
        api_key: Optional[str] = None,
        timeout: float = 30.0,
        *,
        pod_update_endpoint: str = "/api/pods/update",
        health_endpoint: str = "/health",
        retry: Optional[RetryPolicy] = None,
        verify_tls: bool = True,
        pool_size: int = 8,
    ):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout
        self.pod_update_endpoint = pod_update_endpoint
        self.health_endpoint = health_endpoint
        self.retry = retry or RetryPolicy(max_attempts=1, delay_seconds=0.0)
        self.pool_size = max(1, pool_size)

        parts = urlsplit(self.base_url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"clusterapi base_url must be http(s)://, got {base_url!r}")
        self._scheme = parts.scheme
        self._host = parts.hostname or "localhost"
        self._port = parts.port or (443 if self._scheme == "https" else 80)
        self._path_prefix = parts.path.rstrip("/")
        self._ssl_context = None
        if self._scheme == "https":
            self._ssl_context = ssl.create_default_context()
            if not verify_tls:
                self._ssl_context.check_hostname = False
                self._ssl_context.verify_mode = ssl.CERT_NONE
        self._headers = {"Content-Type": "application/json", "Connection": "keep-alive"}
        if self.api_key:
            self._headers["Authorization"] = f"Bearer {self.api_key}"
        # resolved once: a notify target does not move at run time
        self._proxy = proxy_for(self._scheme, self._host, self._port)
        if self._proxy:
            logger.info(
                "clusterapi requests will use %s proxy %s:%d", self._scheme.upper(), self._proxy[0], self._proxy[1],
            )
        self._abort = threading.Event()
        # pool state under one condition: idle connections (LIFO), the live
        # count the pool_size cap bounds, and every live connection (borrowed
        # ones too) so abort() can cut a send another thread owns
        self._pool_cond = threading.Condition()
        self._free: list = []
        self._live = 0
        self._conns: set = set()

    def abort(self) -> None:
        """Cut every in-flight send and refuse further attempts: retry sleeps
        wake, pool waiters wake, live sockets close. One-way; bounds shutdown
        when the notify target is dead or hung."""
        self._abort.set()
        with self._pool_cond:
            conns = list(self._conns)
            self._conns.clear()
            self._free.clear()
            self._pool_cond.notify_all()
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass

    # -- connection pool -----------------------------------------------------

    def _new_connection(self, timeout: float) -> http.client.HTTPConnection:
        return new_connection(self._scheme, self._host, self._port, timeout, self._proxy, self._ssl_context)

    def _request_target(self, path: str) -> str:
        """Origin-form, or absolute-form when plain http rides a forward
        proxy (RFC 9112 §3.2.2)."""
        rel = f"{self._path_prefix}{path}" or "/"
        if self._proxy is not None and self._scheme == "http":
            return f"http://{self._host}:{self._port}{rel}"
        return rel

    def _request_headers(self) -> Dict[str, str]:
        if self._proxy is not None and self._scheme == "http" and self._proxy[2]:
            # https carries the credentials on the CONNECT instead
            return {**self._headers, "Proxy-Authorization": self._proxy[2]}
        return self._headers

    def _acquire(self, fresh_only: bool = False) -> http.client.HTTPConnection:
        """Borrow a pooled connection (mint one under the cap, else wait for
        a return). Raises ConnectionError on abort or on a pool-exhaustion
        timeout. ``fresh_only``: a reused connection just died on teardown,
        so its idle siblings (same idle window) are closed and a fresh one
        is minted."""
        deadline = time.monotonic() + self.timeout
        with self._pool_cond:
            if fresh_only:
                while self._free:
                    stale = self._free.pop()
                    self._conns.discard(stale)
                    self._live -= 1
                    try:
                        stale.close()
                    except Exception:
                        pass
            while True:
                if self._abort.is_set():
                    raise ConnectionError("client aborted (shutting down)")
                if self._free:
                    return self._free.pop()
                if self._live < self.pool_size:
                    conn = self._new_connection(self.timeout)  # no I/O until the request
                    conn._kw_fresh = True  # no request has succeeded on it yet
                    self._live += 1
                    self._conns.add(conn)
                    return conn
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._pool_cond.wait(remaining):
                    raise ConnectionError(f"connection pool exhausted ({self.pool_size} in flight)")

    def _release(self, conn: http.client.HTTPConnection, *, discard: bool) -> None:
        close = False
        with self._pool_cond:
            if discard or conn not in self._conns:
                self._conns.discard(conn)
                self._live -= 1
                close = True
            else:
                self._free.append(conn)
            self._pool_cond.notify()
        if close:
            try:
                conn.close()
            except Exception:
                pass

    # a reused keep-alive connection the server closed fails fast with one of
    # these; anything else (timeouts especially) goes to the retry policy
    _STALE_CONN_ERRORS = (
        http.client.RemoteDisconnected,
        http.client.BadStatusLine,
        ConnectionResetError,
        ConnectionAbortedError,
        BrokenPipeError,
        ssl.SSLEOFError,
    )

    def _request(self, method: str, path: str, body: Optional[bytes]) -> Tuple[int, bytes]:
        """One request on a pooled connection, resent once on a fresh one when
        a reused connection was idle-closed by the server."""
        full_path = self._request_target(path)
        headers = self._request_headers()
        for attempt in range(2):
            conn = self._acquire(fresh_only=attempt > 0)
            fresh = getattr(conn, "_kw_fresh", True)
            try:
                conn.request(method, full_path, body=body, headers=headers)
                response = conn.getresponse()
                data = response.read()  # drain so the connection is reusable
                conn._kw_fresh = False
                self._release(conn, discard=False)
                return response.status, data
            except self._STALE_CONN_ERRORS:
                self._release(conn, discard=True)
                if fresh:
                    raise
            except Exception:
                self._release(conn, discard=True)
                raise
        raise ConnectionError("unreachable")  # pragma: no cover

    # -- public API ---------------------------------------------------------

    @staticmethod
    def _retriable(status: int) -> bool:
        """5xx, 408 (request timeout) and 429 (rate limited)."""
        return status >= 500 or status in (408, 429)

    def _post_retrying(self, path: str, body: bytes) -> Tuple[int, bytes]:
        """POST with the retry policy; the final ``(status, body)``, or
        ``(0, b"")`` when every attempt died at the connection level or the
        client was aborted. Never raises."""
        endpoint = f"{self.base_url}{path}"
        attempts = max(1, self.retry.max_attempts)
        delay = self.retry.delay_seconds
        for attempt in range(1, attempts + 1):
            if self._abort.is_set():
                return 0, b""
            try:
                logger.debug("POST %s (attempt %d/%d)", endpoint, attempt, attempts)
                status, text = self._request("POST", path, body)
                if status == 200:
                    return status, text
                if not self._retriable(status):
                    return status, text
                logger.error(
                    "Failed to update pod data. Status: %s, Response: %s",
                    status, text.decode("utf-8", errors="replace")[:500],
                )
            except socket.timeout:
                logger.error("Timeout: request to %s exceeded %.1fs", endpoint, self.timeout)
            except (ConnectionError, OSError, http.client.HTTPException):
                logger.error("Connection error: unable to connect to clusterapi at %s", endpoint)
            except Exception as exc:  # never raise out of the send path
                logger.error("Unexpected error calling clusterapi: %s", exc)
                return 0, b""
            if attempt < attempts and delay > 0:
                if self._abort.wait(min(delay, self.retry.max_delay_seconds)):
                    return 0, b""
                delay *= self.retry.backoff_multiplier
        return 0, b""

    def update_pod_status(self, pod_data: Dict[str, Any]) -> bool:
        """POST one payload; True iff the server returned 200."""
        try:
            body = json.dumps(pod_data).encode("utf-8")
        except (TypeError, ValueError) as exc:
            logger.error("Unserializable pod payload (%s); dropping", exc)
            return False
        status, text = self._post_retrying(self.pod_update_endpoint, body)
        if status == 200:
            logger.debug("Updated pod data for %s", pod_data.get("name", "unknown"))
            return True
        if status and not self._retriable(status):
            # retriable statuses were already logged per attempt
            logger.error(
                "Failed to update pod data. Status: %s, Response: %s",
                status, text.decode("utf-8", errors="replace")[:500],
            )
        return False

    def health_check(self) -> bool:
        """GET the health endpoint; True iff 200 (5 s timeout). Runs on its
        own connection outside the pool, registered so abort() can cut it."""
        if self._abort.is_set():
            return False
        try:
            with self._pool_cond:
                if self._abort.is_set():
                    return False
                conn = self._new_connection(5)
                self._conns.add(conn)
            try:
                conn.request("GET", self._request_target(self.health_endpoint), headers=self._request_headers())
                return conn.getresponse().status == 200
            finally:
                with self._pool_cond:
                    self._conns.discard(conn)
                conn.close()
        except Exception:
            return False
