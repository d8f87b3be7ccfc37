"""The probe agent's status server: ``/metrics``, ``/healthz`` and the agent's
``/debug`` routes over HTTP (the JAX package's ``metrics/server.py``, with the
agent's routes only).

- ``/metrics``: the registry as JSON, or Prometheus text when the client asks
  for it (``Accept: text/plain`` or ``openmetrics``, or ``?format=prometheus``);
- ``/healthz``: 200 while the probe loop's heartbeat is fresh, 503 once it is
  stale (the DaemonSet's liveness target);
- ``/debug/trend``: the trend tracker's anchors and windows;
- ``/debug/probes?n=``: the last ``n`` cycle summaries (400 on a bad ``n``);
- ``/debug/remediation``: the remediation policy's state.

With a bearer token every route but ``/healthz`` needs ``Authorization:
Bearer <token>`` and answers 401 with ``WWW-Authenticate: Bearer`` without
it; ``/healthz`` stays open so kubelet probes need no header, and it shows
only aliveness and the heartbeat's age.
"""

from __future__ import annotations

import hmac
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from k8s_watcher_tpu_torch.metrics import MetricsRegistry


class QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that treats a client dropping its keep-alive
    connection as the normal end of a conversation, not a server error
    worth a stderr traceback."""

    # socketserver's default listen backlog is 5; the kernel clamps this
    # to somaxconn
    request_queue_size = 1024

    def handle_error(self, request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError, TimeoutError)):
            return
        super().handle_error(request, client_address)


def send_json(handler: BaseHTTPRequestHandler, status: int, body: dict) -> None:
    """One JSON response, Content-Length framed (keep-alive safe)."""
    data = json.dumps(body).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


def bearer_authorized(header: Optional[str], token: Optional[str]) -> bool:
    """Constant-time bearer check; ``token is None`` means the server runs open.

    ``http.server`` decodes header bytes as latin-1, so re-encoding with
    latin-1 recovers the wire bytes. Clients put a non-ASCII token on the
    wire as UTF-8 or as latin-1, so both encodings of the token are accepted;
    the non-short-circuiting ``|`` runs both compares every time."""
    if token is None:
        return True
    scheme, _, presented = (header or "").partition(" ")
    if scheme.lower() != "bearer":  # auth schemes are case-insensitive (RFC 9110 §11.1)
        return False
    try:
        # ASCII whitespace only: bare strip() would also remove U+00A0/U+0085,
        # which are legitimate latin-1-decoded token bytes
        presented_bytes = presented.strip(" \t").encode("latin-1")
    except UnicodeEncodeError:
        return False  # cannot have come off the wire
    token_utf8 = token.encode("utf-8")
    try:
        token_latin1 = token.encode("latin-1")
    except UnicodeEncodeError:
        token_latin1 = token_utf8
    return bool(
        hmac.compare_digest(presented_bytes, token_utf8)
        | hmac.compare_digest(presented_bytes, token_latin1)
    )


class Liveness:
    """Heartbeat stamped by the probe loop once per completed cycle, read by
    ``/healthz``.

    ``first_beat_grace_seconds`` widens the staleness threshold until the
    first beat lands: the first cycle pays every set-up (NCCL, cuBLAS, the
    kernel build, a multi-node rendezvous), and a 503 then would restart a
    healthy agent mid-set-up."""

    def __init__(self, stale_after_seconds: float = 900.0, *, first_beat_grace_seconds: Optional[float] = None):
        self.stale_after_seconds = stale_after_seconds
        self.first_beat_grace_seconds = (
            first_beat_grace_seconds if first_beat_grace_seconds is not None else stale_after_seconds
        )
        self._last_beat = time.monotonic()
        self._beaten = False
        self._lock = threading.Lock()

    def beat(self) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self._beaten = True

    def _threshold(self) -> float:
        return self.stale_after_seconds if self._beaten else self.first_beat_grace_seconds

    def alive(self) -> bool:
        with self._lock:
            return time.monotonic() - self._last_beat < self._threshold()

    def age_seconds(self) -> float:
        with self._lock:
            return time.monotonic() - self._last_beat


class _StatusHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    metrics: MetricsRegistry
    liveness: Liveness
    trend = None  # Callable[[], dict]: trend anchors and windows
    remediation = None  # Callable[[], dict]: remediation policy state
    probes = None  # Callable[[int], list]: last-N cycle summaries
    auth_token: Optional[str] = None

    def log_message(self, *a):
        pass

    def _authorized(self, path: str) -> bool:
        if path == "/healthz":
            return True
        return bearer_authorized(self.headers.get("Authorization"), self.auth_token)

    def _text(self, status: int, body: str) -> None:
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, status: int, body: dict) -> None:
        send_json(self, status, body)

    def do_GET(self):  # noqa: N802
        parsed = urlparse(self.path)
        if not self._authorized(parsed.path):
            self.send_response(401)
            self.send_header("WWW-Authenticate", "Bearer")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        if parsed.path == "/metrics":
            accept = self.headers.get("Accept", "")
            if params.get("format") == "prometheus" or "text/plain" in accept or "openmetrics" in accept:
                self._text(200, self.metrics.prometheus_text())
            else:
                self._json(200, self.metrics.dump())
        elif parsed.path == "/healthz":
            alive = self.liveness.alive()
            self._json(200 if alive else 503, {
                "alive": alive,
                "watch_alive": alive,
                "last_heartbeat_age_seconds": round(self.liveness.age_seconds(), 1),
            })
        elif parsed.path == "/debug/trend":
            if self.trend is None:
                self._json(404, {"error": "trend tracking not wired (tpu.probe.trend_enabled)"})
                return
            self._json(200, {"trend": self.trend()})
        elif parsed.path == "/debug/probes":
            if self.probes is None:
                self._json(404, {"error": "probe agent not wired (tpu.probe.enabled)"})
                return
            try:
                n = int(params.get("n", "20"))
            except ValueError:
                self._json(400, {"error": f"bad n={params.get('n')!r}"})
                return
            self._json(200, {"probes": self.probes(n)})
        elif parsed.path == "/debug/remediation":
            if self.remediation is None:
                self._json(404, {"error": "remediation not wired (tpu.remediation.enabled)"})
                return
            self._json(200, {"remediation": self.remediation()})
        else:
            self._json(404, {"error": f"no route {self.path}"})


class StatusServer:
    """The status routes on ``port`` of every interface (port 0: a free one),
    served from a daemon thread after :meth:`start`."""

    def __init__(
        self,
        metrics: MetricsRegistry,
        liveness: Liveness,
        *,
        port: int = 0,
        trend: Optional[Callable[[], dict]] = None,
        remediation: Optional[Callable[[], dict]] = None,
        probes: Optional[Callable[[int], list]] = None,
        auth_token: Optional[str] = None,
    ):
        handler = type(
            "BoundStatusHandler",
            (_StatusHandler,),
            {
                "metrics": metrics,
                "liveness": liveness,
                "trend": staticmethod(trend) if trend else None,
                "remediation": staticmethod(remediation) if remediation else None,
                "probes": staticmethod(probes) if probes else None,
                "auth_token": auth_token,
            },
        )
        self._server = QuietThreadingHTTPServer(("0.0.0.0", port), handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "StatusServer":
        self._thread = threading.Thread(target=self._server.serve_forever, name="status-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=2.0)
