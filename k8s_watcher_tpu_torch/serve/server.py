"""HTTP surface of the serving plane: snapshot + resumable delta watch (the
JAX package's ``serve/server.py``).

One resource, ``/serve/fleet``, with the apiserver's contract:

- ``GET /serve/fleet`` -> ``{"rv": N, "view": "<id>", "objects": [...]}``,
  the snapshot; ``view`` names this incarnation of the rv space.
- ``GET /serve/fleet?watch=1&rv=N`` -> a chunked stream of delta frames
  ``> N`` (UPSERT/DELETE, SYNC heartbeats that advance the resume token on
  idle streams, COMPACTED when lag shedding collapsed a range). The stream
  closes after ``timeout`` seconds (default 30) with a final SYNC; the client
  reconnects with ``rv=<last SYNC/delta rv>``: that is the resume protocol.
- ``&once=1`` -> long-poll: one body ``{"from_rv", "to_rv", "compacted",
  "items"}``. ``&limit=K`` pages (never lossy); lag shedding follows only the
  server's ``serve.queue_depth``.
- A resume token behind the horizon answers **410 Gone** (pre-stream) or an
  in-band ``GONE`` frame; so does a token minted by another incarnation
  (``&view=<id>``) or one ahead of the view. The consumer re-snapshots.
- ``?at=N`` (time travel): the fleet snapshot as of rv N, rebuilt from the
  history WAL (400 while the history plane is off or past the durable rv,
  410 behind the retention horizon); recent reconstructions sit in an LRU.
- ``GET /serve/analytics``: the analytics plane's summary or batched what-if
  (404 when the plane is off); ``GET /debug/trace``: the trace ring (404 when
  tracing is off).
- ``GET /serve/healthz`` is open; every other route needs the status plane's
  bearer token when one is set.
- ``Accept: application/x-msgpack`` selects msgpack on every shape (errors
  included) when this process can encode it; anything else gets JSON.

The HTTP threads are a front: a ``?watch=1`` handshake runs on the
per-connection thread, then the socket is handed off to the broadcast loop
(serve/broadcast.py). ``serve.io_threads: 0`` keeps the thread-per-connection
streamer (``_stream``), the reference the equivalence tests compare against.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler
from typing import Optional
from urllib.parse import parse_qs, urlparse

from k8s_watcher_tpu_torch.serve.broadcast import BroadcastLoop
from k8s_watcher_tpu_torch.serve.view import (
    CODEC_CONTENT_TYPES,
    CODEC_JSON,
    CODEC_MSGPACK,
    GONE,
    INVALID,
    MSGPACK_CONTENT_TYPE,
    FleetView,
    SubscriptionHub,
    frame_body,
    msgpack_available,
)
from k8s_watcher_tpu_torch.status import QuietThreadingHTTPServer, bearer_authorized, send_json, trace_ring_response

logger = logging.getLogger(__name__)

#: server-side cap on one watch window; clients reconnect (resume) past it
MAX_WATCH_SECONDS = 300.0
#: tighter cap for once= long-polls: a dead long-poll socket is undetectable
#: until written to, and each orphaned window pins a subscriber slot
MAX_LONG_POLL_SECONDS = 30.0
#: idle heartbeat cadence of the threaded streamer
SYNC_INTERVAL_SECONDS = 2.0


class _HandoffHTTPServer(QuietThreadingHTTPServer):
    """A threading HTTP server that can release a connection to the broadcast
    loop: the per-request teardown skips a handed-off socket, which the loop
    owns from then on."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._handed_off = set()
        self._handoff_lock = threading.Lock()

    def hand_off(self, request) -> None:
        with self._handoff_lock:
            self._handed_off.add(request)

    def shutdown_request(self, request) -> None:
        with self._handoff_lock:
            if request in self._handed_off:
                self._handed_off.discard(request)
                return
        super().shutdown_request(request)


class _AtCache:
    """A small LRU of ``?at=`` bodies. Keys carry the view's instance and
    the WAL's ``cache_epoch`` (bumped on a rebase and on retention), so a
    change to what an rv rebuilds to makes old keys stop matching."""

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()

    def get(self, key):
        with self._lock:
            body = self._entries.get(key)
            if body is not None:
                self._entries.move_to_end(key)
            return body

    def put(self, key, body: bytes) -> None:
        with self._lock:
            self._entries[key] = body
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)


class _ServeHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    # socket timeout (reads and writes): a stalled-but-connected consumer
    # must not block a threaded stream's write forever
    timeout = 30.0
    view: FleetView
    hub: SubscriptionHub
    plane = None  # the owning ServePlane (health payload)
    history = None  # history.HistoryStore -> ?at= reads
    at_cache: Optional[_AtCache] = None  # the ?at= LRU
    at_hits = None  # serve_at_cache_hits / _misses, when metrics are wired
    at_misses = None
    analytics = None  # analytics.AnalyticsPlane -> /serve/analytics
    trace = None  # trace.TraceRing -> GET /debug/trace on the serve port
    loop: Optional[BroadcastLoop] = None  # the epoll core; None = threaded streams
    auth_token: Optional[str] = None

    def log_message(self, *a):
        pass

    def _body_bytes(self, status: int, data: bytes, content_type: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_obj(self, status: int, body: dict, codec: str) -> None:
        """One bounded body in the negotiated codec (errors included)."""
        if codec == CODEC_MSGPACK:
            self._body_bytes(status, frame_body(body, CODEC_MSGPACK), MSGPACK_CONTENT_TYPE)
        else:
            send_json(self, status, body)

    def _codec(self) -> str:
        """``Accept: application/x-msgpack`` selects msgpack when this process
        can encode it; everything else is JSON."""
        accept = (self.headers.get("Accept") or "").lower()
        if msgpack_available() and MSGPACK_CONTENT_TYPE in accept:
            return CODEC_MSGPACK
        return CODEC_JSON

    def do_GET(self):  # noqa: N802
        parsed = urlparse(self.path)
        path = parsed.path
        if path == "/serve/healthz":
            health = self.plane.health() if self.plane is not None else {"healthy": True}
            send_json(self, 200 if health.get("healthy", True) else 503, health)
            return
        if not bearer_authorized(self.headers.get("Authorization"), self.auth_token):
            self.send_response(401)
            self.send_header("WWW-Authenticate", "Bearer")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if path == "/serve/analytics":
            # keep_blank_values: ?drain_cluster= (empty) names the local cluster
            self._serve_analytics(
                {k: v[0] for k, v in parse_qs(parsed.query, keep_blank_values=True).items()}, self._codec())
            return
        if path == "/debug/trace":
            send_json(self, *trace_ring_response(self.trace, {k: v[0] for k, v in parse_qs(parsed.query).items()}))
            return
        if path != "/serve/fleet":
            send_json(self, 404, {"error": f"no route {path}"})
            return
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        codec = self._codec()
        if params.get("watch") in ("1", "true"):
            self._serve_watch(params, codec)
        elif "at" in params:
            self._serve_at(params, codec)
        else:
            self._body_bytes(200, self.view.snapshot_bytes(codec=codec), CODEC_CONTENT_TYPES[codec])

    def _serve_at(self, params: dict, codec: str) -> None:
        """``GET /serve/fleet?at=N``: the snapshot as of rv N, rebuilt from
        the WAL's snapshot records and deltas; 410 behind the retention
        horizon, as a compacted resume token."""
        if self.history is None:
            self._send_obj(400, {"error": "time-travel reads need the history plane (history.enabled)"}, codec)
            return
        try:
            at_rv = int(params["at"])
        except ValueError:
            self._send_obj(400, {"error": "at= must be an integer rv"}, codec)
            return
        if at_rv < 0:
            self._send_obj(400, {"error": "at= must be >= 0"}, codec)
            return
        cache_key = (self.view.instance, self.history.cache_epoch, at_rv, codec)
        cached = self.at_cache.get(cache_key)
        if cached is not None:
            if self.at_hits is not None:
                self.at_hits.inc()
            self._body_bytes(200, cached, CODEC_CONTENT_TYPES[codec])
            return
        if self.at_misses is not None:
            self.at_misses.inc()
        status, rv, objects = self.history.reconstruct(at_rv)
        if status == "gone":
            self._send_obj(410, {"error": "rv is not reconstructible from retained history "
                                          "(behind the retention horizon, or inside a rebase/tear hole)",
                                 "rv": at_rv, "retention_floor_rv": rv}, codec)
            return
        if status == "future":
            self._send_obj(400, {"error": "rv is past the durable history (not yet written, or never minted)",
                                 "rv": at_rv, "durable_rv": rv}, codec)
            return
        # sorted (kind, key): reconstructions compare byte for byte
        reconstruction = {"rv": at_rv, "view": self.view.instance, "historical": True,
                          "objects": [objects[k] for k in sorted(objects)]}
        body = frame_body(reconstruction, CODEC_MSGPACK) if codec == CODEC_MSGPACK else json.dumps(
            reconstruction).encode()
        self.at_cache.put(cache_key, body)
        self._body_bytes(200, body, CODEC_CONTENT_TYPES[codec])

    def _serve_analytics(self, params: dict, codec: str) -> None:
        """``GET /serve/analytics``: no parameters -> the summary;
        ``?scenarios=<json array>`` -> a batched evaluation (at most
        ``analytics.max_scenarios``, 400 past it); ``?drain_cluster=<name>`` /
        ``?cordon_nodes=a,b`` -> one scenario each."""
        if self.analytics is None:
            self._send_obj(404, {"error": "analytics plane disabled (analytics.enabled)"}, codec)
            return
        from k8s_watcher_tpu_torch.analytics import ScenarioError

        raw_scenarios = None
        if "scenarios" in params:
            try:
                raw_scenarios = json.loads(params["scenarios"])
            except ValueError:
                self._send_obj(400, {"error": "scenarios= must be a JSON array"}, codec)
                return
        elif "drain_cluster" in params:
            raw_scenarios = [{"kind": "drain_cluster", "cluster": params["drain_cluster"]}]
        elif "cordon_nodes" in params:
            raw_scenarios = [{"kind": "cordon_nodes", "nodes": [n for n in params["cordon_nodes"].split(",") if n]}]
        try:
            body = self.analytics.summary() if raw_scenarios is None else self.analytics.evaluate(raw_scenarios)
        except ScenarioError as exc:
            self._send_obj(400, {"error": str(exc)}, codec)
            return
        self._send_obj(200, body, codec)

    def _serve_watch(self, params: dict, codec: str) -> None:
        try:
            rv = int(params["rv"])
        except (KeyError, ValueError):
            self._send_obj(400, {"error": "watch requires an integer rv= (from a snapshot or a prior to_rv/SYNC)"},
                           codec)
            return
        try:
            timeout = min(float(params.get("timeout", "30") or "30"), MAX_WATCH_SECONDS)
            limit = int(params.get("limit", "0") or "0") or None
        except ValueError:
            self._send_obj(400, {"error": "bad timeout=/limit="}, codec)
            return
        if limit is not None and limit < 0:
            self._send_obj(400, {"error": "limit= must be >= 0 (0 = unpaged)"}, codec)
            return
        # ?fresh=1: delta frames carry ts=[origin_wall, publish_wall];
        # ?trace=1: sampled deltas carry their journey (implies fresh)
        traced = params.get("trace") in ("1", "true")
        fresh = traced or params.get("fresh") in ("1", "true")
        client_view = params.get("view")
        if client_view and client_view != self.view.instance:
            self._send_obj(410, {"error": "view instance changed (watcher restarted); re-snapshot",
                                 "view": self.view.instance}, codec)
            return
        sub = self.hub.subscribe(rv=rv)
        if sub is None:
            self._send_obj(503, {"error": "max_subscribers reached", "max_subscribers": self.hub.max_subscribers},
                           codec)
            return
        handed_off = False
        try:
            if params.get("once") in ("1", "true"):
                self._long_poll(sub, min(timeout, MAX_LONG_POLL_SECONDS), limit, codec, fresh, traced)
            elif self.loop is not None:
                handed_off = self._stream_handoff(sub, timeout, limit, codec, fresh, traced)
            else:
                self._stream(sub, timeout, limit, codec, fresh, traced)
        finally:
            if not handed_off:
                self.hub.unsubscribe(sub)

    def _send_410(self, rv: int, status: str, codec: str) -> None:
        """The 410 of a dead resume token: behind the horizon, or ahead of the
        view (almost always a restarted watcher)."""
        if status == GONE:
            body = {"error": "resume token compacted away; re-snapshot", "rv": rv, "oldest_rv": self.view.oldest_rv}
        else:
            body = {"error": "rv is ahead of this view (watcher restarted?); re-snapshot",
                    "rv": rv, "view_rv": self.view.rv, "view": self.view.instance}
        self._send_obj(410, body, codec)

    def _long_poll(self, sub, timeout: float, limit, codec: str, fresh: bool, traced: bool) -> None:
        result = sub.pull(timeout=timeout, limit=limit)
        if result.status in (GONE, INVALID):
            self._send_410(result.from_rv, result.status, codec)
            return
        self._send_obj(200, {
            "from_rv": result.from_rv,
            "to_rv": result.to_rv,
            "view": self.view.instance,
            "compacted": result.compacted,
            "items": [d.to_wire(fresh=fresh, trace=traced) for d in result.deltas],
        }, codec)

    def _pre_stream_410(self, sub, codec: str) -> bool:
        """A dead resume token fails the request before the stream starts.
        True when a 410 was answered."""
        status = self.view.token_status(sub.rv)
        if status in (GONE, INVALID):
            self._send_410(sub.rv, status, codec)
            return True
        return False

    def _stream_handoff(self, sub, timeout: float, limit, codec: str, fresh: bool, traced: bool) -> bool:
        """The epoll path: write the response headers, then release the socket
        to the broadcast loop. True once the loop owns socket and
        subscription (the caller must not unsubscribe)."""
        if self._pre_stream_410(sub, codec):
            return False
        if not self.loop.accepting:
            # no live loop worker: serve this stream threaded (degraded but
            # correct; /healthz already reports the loop)
            self._stream(sub, timeout, limit, codec, fresh, traced)
            return False
        self.send_response(200)
        self.send_header("Content-Type", CODEC_CONTENT_TYPES[codec])
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.wfile.flush()
        self.close_connection = True
        try:
            # submit before hand_off: a raise leaves the socket to the server
            self.loop.submit(self.connection, sub, timeout=timeout, limit=limit, view_id=self.view.instance,
                             codec=codec, fresh=fresh, traced=traced)
        except RuntimeError:
            return False
        self.server.hand_off(self.connection)
        return True

    def _stream(self, sub, timeout: float, limit, codec: str, fresh: bool, traced: bool) -> None:
        """The thread-per-connection streamer (``serve.io_threads: 0``)."""
        if self._pre_stream_410(sub, codec):
            return
        self.send_response(200)
        self.send_header("Content-Type", CODEC_CONTENT_TYPES[codec])
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_frames(frames: list) -> None:
            data = b"".join(frame_body(f, codec) for f in frames)
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        deadline = time.monotonic() + timeout
        last_frame = time.monotonic()
        stream_view = self.view.instance
        try:
            write_frames([{"type": "SYNC", "rv": sub.rv, "view": stream_view}])
            while time.monotonic() < deadline:
                if self.view.instance != stream_view:
                    # a relay re-adopted its upstream mid-stream: end with
                    # GONE rather than graft two rv lines together
                    write_frames([{"type": "GONE", "rv": sub.rv, "view": self.view.instance}])
                    break
                result = sub.pull(timeout=min(0.5, max(0.0, deadline - time.monotonic())), limit=limit)
                if result.status == GONE:
                    # fell behind the horizon while writing to a slow client
                    write_frames([{"type": "GONE", "rv": result.from_rv, "oldest_rv": self.view.oldest_rv}])
                    break
                if result.deltas:
                    frames = []
                    if result.compacted:
                        frames.append({"type": "COMPACTED", "from_rv": result.from_rv, "to_rv": result.to_rv})
                    frames.extend(d.to_wire(fresh=fresh, trace=traced) for d in result.deltas)
                    write_frames(frames)
                    last_frame = time.monotonic()
                elif result.compacted:
                    # a sparse relay journal: sanction the skipped range and
                    # move the resume token past it with a SYNC
                    write_frames([{"type": "COMPACTED", "from_rv": result.from_rv, "to_rv": result.to_rv},
                                  {"type": "SYNC", "rv": sub.rv, "view": self.view.instance}])
                    last_frame = time.monotonic()
                elif time.monotonic() - last_frame >= SYNC_INTERVAL_SECONDS:
                    write_frames([{"type": "SYNC", "rv": sub.rv, "view": self.view.instance}])
                    last_frame = time.monotonic()
            else:
                # clean window end: the final SYNC carries the resume token
                write_frames([{"type": "SYNC", "rv": sub.rv, "view": self.view.instance}])
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            pass  # the subscriber went away; the caller unsubscribes


class ServeServer:
    """The serving plane's HTTP thread and, with ``io_threads > 0``, its
    broadcast loops."""

    def __init__(
        self,
        view: FleetView,
        hub: SubscriptionHub,
        *,
        host: str = "0.0.0.0",
        port: int = 0,
        auth_token: Optional[str] = None,
        plane=None,
        history=None,
        analytics=None,
        trace=None,  # trace.TraceRing -> GET /debug/trace
        io_threads: int = 1,
        sub_buffer_bytes: int = 1 << 20,
        metrics=None,
    ):
        self.loop: Optional[BroadcastLoop] = (
            BroadcastLoop(view, hub, threads=io_threads, sub_buffer_bytes=sub_buffer_bytes, metrics=metrics)
            if io_threads > 0 else None
        )
        handler = type("BoundServeHandler", (_ServeHandler,), {
            "view": view, "hub": hub, "auth_token": auth_token, "plane": plane, "analytics": analytics,
            "trace": trace, "loop": self.loop, "history": history,
            "at_cache": _AtCache() if history is not None else None,
            "at_hits": metrics.counter("serve_at_cache_hits") if metrics is not None and history is not None else None,
            "at_misses": (metrics.counter("serve_at_cache_misses")
                          if metrics is not None and history is not None else None),
        })
        self._server = _HandoffHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ServeServer":
        if self.loop is not None:
            self.loop.start()
        self._thread = threading.Thread(target=self._server.serve_forever, name="serve-plane", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=2.0)
        if self.loop is not None:
            self.loop.stop()


class ServePlane:
    """What the app wires: view + hub + HTTP server + the health verdict. The
    view exists from construction (the pipeline publishes into it at once);
    the server starts with the app's other servers.

    With a recovered ``history`` store the view continues the previous
    incarnation: after a clean stop it adopts its instance, rv line, objects
    and journal tail (resume tokens minted before the stop read on); after
    an unclean end it keeps the durable state and rv line under a fresh
    instance, so tokens minted before the crash re-snapshot (410) instead of
    grafting onto an rv line that may re-mint lost rvs."""

    def __init__(self, config, *, metrics=None, auth_token: Optional[str] = None, history=None):
        self.config = config
        self.metrics = metrics
        self.view = FleetView(
            compact_horizon=config.compact_horizon,
            metrics=metrics,
            # serve.columnar: auto/on = the columnar core, off = the dict core
            columnar=config.columnar != "off",
        )
        self.history = history
        if history is not None:
            recovered = history.recovered
            if recovered is not None and recovered.instance:
                from k8s_watcher_tpu_torch.history.recovery import journal_deltas

                if recovered.clean:
                    self.view.restore(instance=recovered.instance, rv=recovered.rv, objects=recovered.objects,
                                      journal=journal_deltas(recovered.journal))
                else:
                    logger.warning(
                        "History WAL ends uncleanly (crash?): resuming rv line at %d under a fresh view "
                        "instance — pre-crash resume tokens will re-snapshot (410)", recovered.rv)
                    self.view.restore(instance=self.view.instance, rv=recovered.rv, objects=recovered.objects,
                                      journal=[])
            history.open(self.view.instance)
            self.view.attach_history(history)
        self.hub = SubscriptionHub(self.view, max_subscribers=config.max_subscribers,
                                   queue_depth=config.queue_depth, metrics=metrics)
        self.server: Optional[ServeServer] = None
        self._auth_token = auth_token
        self.analytics = None  # analytics.AnalyticsPlane, attached before start()
        self.trace_ring = None  # trace.TraceRing, attached before start()
        self.relay = None  # relay.RelayPlane, attached before start()

    def attach_analytics(self, analytics) -> None:
        """Wire the analytics plane; call before ``start()``."""
        self.analytics = analytics

    def attach_relay(self, relay) -> None:
        """Wire the relay plane: its verdict and its ``depth`` (which a
        downstream relay stamps its own from) fold into ``/serve/healthz``."""
        self.relay = relay

    def attach_trace(self, ring) -> None:
        """Wire the tracing ring (``/debug/trace`` on the serve port); call
        before ``start()``."""
        self.trace_ring = ring

    def wrap_sink(self, sink):
        """Tap a notification sink: every notification folds into the view
        (slices, probes; pods ride ``publish_batch``) before the real sink."""
        observe = self.view.observe_notification

        def serving_sink(notification):
            observe(notification)
            sink(notification)

        return serving_sink

    def start(self) -> "ServePlane":
        self.server = ServeServer(
            self.view,
            self.hub,
            port=self.config.port,
            auth_token=self._auth_token,
            plane=self,
            history=self.history,
            analytics=self.analytics,
            trace=self.trace_ring,
            io_threads=self.config.io_threads,
            sub_buffer_bytes=self.config.sub_buffer_bytes,
            metrics=self.metrics,
        ).start()
        logger.info(
            "Serving plane on :%d (/serve/fleet snapshot+watch%s, max_subscribers=%d, queue_depth=%d, "
            "compact_horizon=%d, io_threads=%d)",
            self.server.port, ", /serve/analytics" if self.analytics is not None else "",
            self.config.max_subscribers, self.config.queue_depth, self.config.compact_horizon,
            self.config.io_threads,
        )
        return self

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None

    @property
    def port(self) -> int:
        return self.server.port if self.server is not None else 0

    def health(self) -> dict:
        """Serving-plane liveness, folded into ``/healthz``: unhealthy once
        the HTTP thread or a broadcast loop has died (subscribers would get
        nothing)."""
        server = self.server  # racing stop(); read once
        body = {
            "healthy": server is None or server.alive,
            "started": server is not None,
            "subscribers": self.hub.active_count,
            "max_subscribers": self.hub.max_subscribers,
            "view_rv": self.view.rv,
            "oldest_rv": self.view.oldest_rv,
            "objects": self.view.object_count(),
        }
        if server is not None and server.loop is not None:
            loop_alive = server.loop.alive
            body["io_loop"] = {"healthy": loop_alive, "threads": server.loop.threads,
                               "streams": server.loop.client_count}
            if not loop_alive:
                body["healthy"] = False
        if self.history is not None:
            # a dead WAL writer stops persisting deltas; folded only while
            # the plane runs (a writer closed after stop() is no fault)
            history_health = self.history.health()
            body["history"] = history_health
            if server is not None and not history_health["healthy"]:
                body["healthy"] = False
        if self.relay is not None:
            # depth and upstream connectivity. Only a dead subscriber thread
            # (a local fault) flips the verdict; a dark upstream degrades
            # this section alone, since restarting the relay cannot revive it
            relay_health = self.relay.health()
            body["relay"] = relay_health
            if relay_health.get("started") and not relay_health.get("thread_alive", True):
                body["healthy"] = False
        return body
