"""The status server of the watcher and of the probe agent: ``/metrics``,
``/healthz`` and the ``/debug`` routes over HTTP (the JAX package's
``metrics/server.py``, with the routes of the planes the port carries).

- ``/metrics``: the registry as JSON, or Prometheus text when the client asks
  for it (``Accept: text/plain`` or ``openmetrics``, or ``?format=prometheus``);
- ``/healthz``: 200 while the heartbeat (the watch loop's, or the probe
  loop's) is fresh and, when wired, the dispatcher's egress side is moving
  and the serving plane's HTTP thread and broadcast loops are alive; 503
  otherwise (the liveness target). The SLO verdict (``slo``) and the health
  plane's fold (``health``) ride the body only: a breached budget or a
  confirmed straggler is no local fault a restart fixes;
- ``/debug/events?n=&uid=``: the audit ring's last pipeline decisions and
  egress outcomes;
- ``/debug/trace?n=&uid=&slowest=``: the tracing plane's sampled journeys;
- ``/debug/slices``: the slice tracker's live slices;
- ``/debug/checkpoint``: the checkpoint store's stats;
- ``/debug/trend``: the trend tracker's anchors and windows;
- ``/debug/probes?n=``: the last ``n`` cycle summaries (400 on a bad ``n``);
- ``/debug/remediation``: the remediation policy's state;
- ``/debug/freshness``: the serving plane's freshness watermark and the
  watch-to-view histogram;
- ``/debug/history``: the history WAL's segment inventory;
- ``/debug/health``: the health plane's subjects, verdicts and actions;
- ``/debug/slo``: the SLO engine's objectives and burn rates;
- ``/debug/processes``: the ingest reader processes' supervision rows, each
  with its hottest process-labelled counter series.

A route whose plane is not wired answers 404 naming the config key.

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
from k8s_watcher_tpu_torch.trace import ALL_STAGES


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


def trace_ring_response(ring, params: dict) -> tuple:
    """``(status, body)`` of a ``/debug/trace`` query. Junk answers 400, never
    an empty 200: ``n`` must be a non-negative int and ``slowest`` a stage of
    ``ALL_STAGES``."""
    if ring is None:
        return 404, {"error": "tracing disabled (trace.enabled: false)"}
    try:
        n = int(params.get("n", "50"))
    except ValueError:
        return 400, {"error": f"bad n={params.get('n')!r} (must be an integer)"}
    if n < 0:
        return 400, {"error": f"bad n={n} (must be >= 0)"}
    slowest = params.get("slowest")
    if slowest is not None and slowest not in ALL_STAGES:
        return 400, {"error": f"bad slowest={slowest!r} (stages: {', '.join(ALL_STAGES)})"}
    return 200, {
        "traces": ring.snapshot(n, uid=params.get("uid"), slowest=slowest),
        "ring_size": len(ring),
        "stages": list(ALL_STAGES),
    }


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
    audit = None  # audit.AuditRing: pipeline decisions and egress outcomes
    trace = None  # trace.TraceRing: sampled journeys
    egress = None  # Callable[[], dict]: the dispatcher's egress verdict, folded into /healthz
    serve = None  # Callable[[], dict]: the serving plane's verdict, folded into /healthz
    freshness = None  # Callable[[], dict]: the serving plane's freshness watermark
    slices = None  # Callable[[], dict]: live slice states
    checkpoint = None  # Callable[[], dict]: checkpoint store stats
    trend = None  # Callable[[], dict]: trend anchors and windows
    # Callable[[], Optional[dict]]: remediation policy state; None while the
    # plane is configured but not armed
    remediation = None
    probes = None  # Callable[[int], list]: last-N cycle summaries
    history = None  # Callable[[], dict]: the WAL's segment inventory
    slo = None  # Callable[[], dict]: the SLO engine's detail
    slo_health = None  # Callable[[], dict]: the SLO verdict, folded into the /healthz body
    node_health = None  # Callable[[], dict]: the health plane's detail
    node_health_fold = None  # Callable[[], dict]: its verdict, folded into the /healthz body
    processes = None  # Callable[[], dict]: reader-process supervision rows
    # Callable[[], dict]: the reader processes' verdict, folded into the
    # /healthz body (stale stats degrade it, never liveness: the supervisor
    # already respawns a dead reader)
    processes_fold = None
    # Callable[[str, int], list]: the federator's joined journeys of one uid,
    # added to a /debug/trace?uid= answer
    trace_stitch = None
    trace_diagnosis = None  # Callable[[], dict]: per-upstream slowest-stage report
    # Callable[[], dict]: the federation plane's verdict, folded into the
    # /healthz body (a stale upstream degrades it, never liveness)
    federation = None
    relay = None  # Callable[[], dict]: the relay plane's detail
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
            watch_alive = self.liveness.alive()
            egress = self.egress() if self.egress is not None else None
            serve = self.serve() if self.serve is not None else None
            federation = self.federation() if self.federation is not None else None
            # a watcher whose egress workers are all dead, whose lane is
            # wedged past the stall threshold, or whose serving plane stopped
            # answering its subscribers is as blind as one that lost its
            # watch, and a restart can fix each
            alive = (
                watch_alive
                and (egress is None or bool(egress.get("healthy", True)))
                and (serve is None or bool(serve.get("healthy", True)))
            )
            body = {
                "alive": alive,
                "watch_alive": watch_alive,
                "last_heartbeat_age_seconds": round(self.liveness.age_seconds(), 1),
            }
            if egress is not None:
                body["egress"] = egress
            if serve is not None:
                body["serve"] = serve
            if federation is not None:
                # folded only: a dark upstream is not this process's fault,
                # and restarting the federator cannot revive it
                body["federation"] = federation
            if self.slo_health is not None:
                body["slo"] = self.slo_health()
            if self.node_health_fold is not None:
                body["health"] = self.node_health_fold()
            if self.processes_fold is not None:
                body["processes"] = self.processes_fold()
            self._json(200 if alive else 503, body)
        elif parsed.path == "/debug/events":
            if self.audit is None:
                self._json(404, {"error": "audit ring disabled (watcher.audit_ring_size: 0)"})
                return
            try:
                n = int(params.get("n", "50"))
            except ValueError:
                self._json(400, {"error": f"bad n={params.get('n')!r}"})
                return
            self._json(200, {"events": self.audit.snapshot(n, uid=params.get("uid")), "ring_size": len(self.audit)})
        elif parsed.path == "/debug/trace":
            status, body = trace_ring_response(self.trace, params)
            if status == 200 and params.get("uid") and self.trace_stitch is not None:
                body["stitched"] = self.trace_stitch(params["uid"], n=int(params.get("n", "50")))
            self._json(status, body)
        elif parsed.path == "/debug/trace/diagnosis":
            if self.trace_diagnosis is None:
                self._json(404, {"error": "fleet trace diagnosis not wired "
                                          "(trace.federation.enabled + federation.enabled)"})
                return
            self._json(200, {"diagnosis": self.trace_diagnosis()})
        elif parsed.path == "/debug/slices":
            if self.slices is None:
                self._json(404, {"error": "slice tracking not wired"})
                return
            self._json(200, {"slices": self.slices()})
        elif parsed.path == "/debug/checkpoint":
            if self.checkpoint is None:
                self._json(404, {"error": "checkpointing not enabled (state.checkpoint_path)"})
                return
            self._json(200, {"checkpoint": self.checkpoint()})
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
            state = self.remediation()
            if state is None:
                self._json(200, {"remediation": None, "note": "configured but not armed (not leading yet)"})
                return
            self._json(200, {"remediation": state})
        elif parsed.path == "/debug/freshness":
            if self.freshness is None:
                self._json(404, {"error": "freshness plane not wired (serve.enabled)"})
                return
            self._json(200, {"freshness": self.freshness()})
        elif parsed.path == "/debug/history":
            if self.history is None:
                self._json(404, {"error": "history plane not enabled (history.enabled)"})
                return
            self._json(200, {"history": self.history()})
        elif parsed.path == "/debug/federation":
            if self.federation is None:
                self._json(404, {"error": "federation plane not enabled (federation.enabled)"})
                return
            self._json(200, {"federation": self.federation()})
        elif parsed.path == "/debug/relay":
            if self.relay is None:
                self._json(404, {"error": "relay plane not enabled (relay.enabled)"})
                return
            self._json(200, {"relay": self.relay()})
        elif parsed.path == "/debug/slo":
            if self.slo is None:
                self._json(404, {"error": "SLO engine not enabled (slo.enabled)"})
                return
            self._json(200, {"slo": self.slo()})
        elif parsed.path == "/debug/health":
            if self.node_health is None:
                self._json(404, {"error": "health plane not enabled (health.enabled)"})
                return
            self._json(200, {"health": self.node_health()})
        elif parsed.path == "/debug/processes":
            if self.processes is None:
                self._json(404, {"error": "no worker processes (ingest.processes / federation.processes: 0)"})
                return
            self._json(200, {"processes": self.processes()})
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
        audit=None,
        trace=None,
        egress: Optional[Callable[[], dict]] = None,
        serve: Optional[Callable[[], dict]] = None,
        freshness: Optional[Callable[[], dict]] = None,
        slices: Optional[Callable[[], dict]] = None,
        checkpoint: Optional[Callable[[], dict]] = None,
        trend: Optional[Callable[[], dict]] = None,
        remediation: Optional[Callable[[], Optional[dict]]] = None,
        probes: Optional[Callable[[int], list]] = None,
        history: Optional[Callable[[], dict]] = None,
        slo: Optional[Callable[[], dict]] = None,
        slo_health: Optional[Callable[[], dict]] = None,
        node_health: Optional[Callable[[], dict]] = None,
        node_health_fold: Optional[Callable[[], dict]] = None,
        processes: Optional[Callable[[], dict]] = None,
        processes_fold: Optional[Callable[[], dict]] = None,
        trace_stitch: Optional[Callable[..., list]] = None,
        trace_diagnosis: Optional[Callable[[], dict]] = None,
        federation: Optional[Callable[[], dict]] = None,
        relay: Optional[Callable[[], dict]] = None,
        auth_token: Optional[str] = None,
    ):
        handler = type(
            "BoundStatusHandler",
            (_StatusHandler,),
            {
                "metrics": metrics,
                "liveness": liveness,
                "audit": audit,
                "trace": trace,
                "egress": staticmethod(egress) if egress else None,
                "serve": staticmethod(serve) if serve else None,
                "trace_stitch": staticmethod(trace_stitch) if trace_stitch else None,
                "trace_diagnosis": staticmethod(trace_diagnosis) if trace_diagnosis else None,
                "federation": staticmethod(federation) if federation else None,
                "relay": staticmethod(relay) if relay else None,
                "freshness": staticmethod(freshness) if freshness else None,
                "slices": staticmethod(slices) if slices else None,
                "checkpoint": staticmethod(checkpoint) if checkpoint else None,
                "trend": staticmethod(trend) if trend else None,
                "remediation": staticmethod(remediation) if remediation else None,
                "probes": staticmethod(probes) if probes else None,
                "history": staticmethod(history) if history else None,
                "slo": staticmethod(slo) if slo else None,
                "slo_health": staticmethod(slo_health) if slo_health else None,
                "node_health": staticmethod(node_health) if node_health else None,
                "node_health_fold": staticmethod(node_health_fold) if node_health_fold else None,
                "processes": staticmethod(processes) if processes else None,
                "processes_fold": staticmethod(processes_fold) if processes_fold else None,
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
