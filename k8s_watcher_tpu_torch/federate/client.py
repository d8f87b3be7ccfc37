"""The consumer side of the serve wire protocol (the JAX package's
``federate/client.py``).

The serving plane's contract (``serve/server.py``): a snapshot at ``GET
/serve/fleet``; resumable deltas over ``?watch=1`` chunked frames or
``&once=1`` long-polls; SYNC heartbeats; COMPACTED markers where a lagging
reader was given the latest-wins summary; 410 or an in-band GONE meaning
"re-snapshot"; and a ``view`` instance id that fences resume tokens to one
incarnation of the rv space. This module is the one implementation of that
contract every consumer shares, the federation plane N times over.

Three layers, lowest first:

- ``FleetClient``: one upstream's HTTP surface, a stdlib ``http.client``
  connection per request. ``snapshot()``, ``long_poll()`` and ``watch()``
  (a generator of decoded frames off the chunked stream). 410 raises
  ``ResyncRequired``, 401 ``AuthRejected``; transient faults raise the
  ``OSError`` family for the caller's backoff. The codec is negotiated:
  ``auto`` asks for msgpack and falls back to JSON (logged once), ``json``
  and ``msgpack`` pin it.
- ``ResumeLoop``: the long-poll consumer (poll, sequence-check, apply,
  carry ``to_rv``; a 410 re-snapshots and goes on).
- ``FleetSubscriber``: the streaming consumer the federation plane runs per
  upstream: snapshot, ``?watch=1`` windows, reconnects with jittered
  exponential backoff, a stream that stops heartbeating treated as dead,
  GONE or a pre-stream 410 answered with a re-snapshot, and the resume
  token persisted (``TokenStore``) so the consumer survives its own
  restarts; against an upstream with a history WAL the token also resumes
  gapless through the upstream's restart.

``SequenceChecker`` is the shared gap and duplicate accountant: the view's
rv space is dense (one rv per applied delta), so an uncompacted batch
carries exactly ``to_rv - from_rv`` deltas with strictly ascending rvs;
COMPACTED sanctions a jump, never a repeat.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import random
import select
import socket
import ssl
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple
from urllib.parse import urlencode, urlsplit

logger = logging.getLogger(__name__)

# msgpack: the compact wire codec (the image bakes it in; a stripped
# environment downgrades to JSON — the serve protocol is negotiated, so
# a codec mismatch can never fail a request, only widen it)
try:
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - the image bakes msgpack in
    _msgpack = None

#: wire frame / delta types (mirrors serve.view — kept literal here so the
#: client stays importable without dragging the serve plane in)
UPSERT = "UPSERT"
DELETE = "DELETE"
SYNC = "SYNC"
COMPACTED = "COMPACTED"
GONE = "GONE"

#: wire codec names + content types (mirrors serve.view, same reason)
CODEC_JSON = "json"
CODEC_MSGPACK = "msgpack"
CODEC_AUTO = "auto"
JSON_CONTENT_TYPE = "application/json"
MSGPACK_CONTENT_TYPE = "application/x-msgpack"
#: bytes per chunked read off a watch stream: one read's decoded frames
#: form ONE delivery batch downstream (the fan-in batching unit)
WATCH_READ_BYTES = 1 << 16


class ServeProtocolError(RuntimeError):
    """A non-transient serve-protocol answer (carries status + body)."""

    def __init__(self, message: str, *, status: int = 0, body: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.body = body or {}


class ResyncRequired(ServeProtocolError):
    """410 (token compacted / ahead-of-view / stale view instance) or an
    in-band GONE frame: the documented recovery is re-snapshot."""


class AuthRejected(ServeProtocolError):
    """401: bearer token missing or wrong — retrying cannot help."""


class Snapshot(NamedTuple):
    rv: int
    view: str
    objects: List[Dict[str, Any]]


class Batch(NamedTuple):
    """One long-poll answer (``?watch=1&once=1``)."""

    from_rv: int
    to_rv: int
    view: str
    compacted: bool
    items: List[Dict[str, Any]]


class SequenceChecker:
    """Gap/dup accounting over one subscriber's resume stream.

    The rv space is dense, so the checks are exact, not heuristic:

    - a raw batch covering ``(from_rv, to_rv]`` with fewer than
      ``to_rv - from_rv`` items LOST a delta (gap);
    - any rv <= its predecessor is a repeat (dup) — compaction may skip
      rvs, never repeat them.
    """

    __slots__ = ("gaps", "dups", "delivered", "batches", "compacted_batches")

    def __init__(self):
        self.gaps = 0
        self.dups = 0
        self.delivered = 0
        self.batches = 0
        self.compacted_batches = 0

    @property
    def clean(self) -> bool:
        return self.gaps == 0 and self.dups == 0

    def observe(self, from_rv: int, to_rv: int, compacted: bool, rvs: Iterable[int]) -> bool:
        """Full per-delta scan of one batch. Returns True when clean."""
        bad = False
        n = 0
        prev = from_rv
        for rv in rvs:
            n += 1
            if rv <= prev:
                self.dups += 1
                bad = True
            prev = rv
        if not compacted and n != to_rv - from_rv:
            self.gaps += 1
            bad = True
        self.delivered += n
        self.batches += 1
        if compacted:
            self.compacted_batches += 1
        return not bad

    def observe_bounds(
        self,
        from_rv: int,
        to_rv: int,
        compacted: bool,
        count: int,
        first_rv: int,
        last_rv: int,
    ) -> bool:
        """O(1) endpoints-only variant for hot paths that cannot afford a
        per-delta walk (thousands of unchecked subscribers): the first
        rv must be past the resume token, the last must land on ``to_rv``
        (the cursor's next token), and a raw batch must be exactly the
        dense range."""
        bad = False
        if count:
            if first_rv <= from_rv or last_rv != to_rv:
                self.dups += 1
                bad = True
            if not compacted and count != to_rv - from_rv:
                self.gaps += 1
                bad = True
        self.delivered += count
        self.batches += 1
        if compacted:
            self.compacted_batches += 1
        return not bad

    def observe_stream_rv(self, prev_rv: int, rv: int, sanctioned: bool) -> bool:
        """One streamed delta frame: ``sanctioned`` means a COMPACTED
        marker covers this range, so a skip is legal (a repeat never is)."""
        self.delivered += 1
        if rv <= prev_rv:
            self.dups += 1
            return False
        if rv != prev_rv + 1 and not sanctioned:
            self.gaps += 1
            return False
        return True

    def to_dict(self) -> Dict[str, int]:
        return {
            "gaps": self.gaps,
            "dups": self.dups,
            "delivered": self.delivered,
            "batches": self.batches,
            "compacted_batches": self.compacted_batches,
        }


def apply_wire_delta(model: Dict[Tuple[str, str], Dict[str, Any]], item: Dict[str, Any]) -> None:
    """Fold one wire delta (UPSERT/DELETE dict) into a ``(kind, key)``-
    keyed model map — the replay every sequence-checked consumer runs."""
    key = (item["kind"], item["key"])
    if item["type"] == DELETE:
        model.pop(key, None)
    else:
        model[key] = item["object"]


def apply_wire_deltas(model: Dict[Tuple[str, str], Dict[str, Any]], items: Iterable[Dict[str, Any]]) -> None:
    for item in items:
        apply_wire_delta(model, item)


def model_from_objects(objects: Iterable[Dict[str, Any]]) -> Dict[Tuple[str, str], Dict[str, Any]]:
    """A snapshot's objects as the same ``(kind, key)``-keyed map shape
    ``apply_wire_delta`` maintains — so ``model == model_from_objects(
    snapshot)`` is the end-to-end replay check."""
    return {(o["kind"], o["key"]): o for o in objects}


class FleetClient:
    """HTTP client for ONE serving plane (``/serve/fleet``).

    Stdlib ``http.client`` only (the package's hand-rolled-HTTP idiom —
    notify/client.py): one connection per request for snapshot/long-poll
    (they are rare and bounded), one connection per ``watch()`` window
    (held open for the whole chunked stream). ``retarget()`` repoints an
    existing client (an upstream that restarted onto a new address).

    Wire codec: ``codec`` is the *preference* — ``auto`` (the default)
    offers ``application/x-msgpack`` and falls back transparently to
    JSON when the peer (or this process's import) lacks it; ``msgpack``
    is the same offer with a louder posture (the downgrade is WARNING,
    not DEBUG); ``json`` never offers msgpack. The peer's Content-Type
    decides what actually rides the wire (``active_codec``); a downgrade
    is logged ONCE per client, not once per reconnect."""

    def __init__(
        self,
        base_url: str,
        *,
        token: Optional[str] = None,
        timeout: float = 10.0,
        verify_tls: bool = True,
        codec: str = CODEC_AUTO,
        fresh: bool = False,
        trace: bool = False,
    ):
        self.token = token
        self.timeout = timeout
        self.verify_tls = verify_tls
        # freshness negotiation (?fresh=1): delta frames additionally
        # carry ts=[origin_wall, publish_wall]. Negotiated like the
        # codec: an upstream that predates the field simply ignores the
        # param and serves plain frames — the decoded dicts just lack
        # "ts", so propagation metrics degrade to absent, never wrong.
        self.fresh = fresh
        # trace negotiation (?trace=1): sampled deltas additionally
        # carry their journey's compact "trace" field (implies fresh on
        # the server side). Same degradation contract: an upstream that
        # predates the field serves plain frames and the joined-trace
        # plane simply sees nothing to join.
        self.trace = trace
        if codec not in (CODEC_AUTO, CODEC_JSON, CODEC_MSGPACK):
            raise ValueError(f"unknown serve wire codec {codec!r}")
        self.codec_preference = codec
        #: what the LAST response actually used (observability and checks)
        self.active_codec = CODEC_JSON
        self._downgrade_logged = False
        if codec == CODEC_MSGPACK and _msgpack is None:
            # the local import, not the peer, is the limiting side: say so
            # now, once, instead of per request
            logger.warning(
                "msgpack wire codec requested but msgpack is not importable; "
                "downgrading to JSON for %s", base_url,
            )
            self._downgrade_logged = True
        self.base_url = ""
        self._scheme = "http"
        self._host = ""
        self._port = 80
        self.retarget(base_url)

    def retarget(self, base_url: str) -> None:
        parts = urlsplit(base_url if "//" in base_url else f"http://{base_url}")
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported scheme {parts.scheme!r} in {base_url!r}")
        self.base_url = base_url.rstrip("/")
        self._scheme = parts.scheme
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or (443 if parts.scheme == "https" else 80)
        # a path component is a reverse-proxy prefix: every request rides
        # under it ("http://gw/cluster-a" -> GET /cluster-a/serve/fleet);
        # silently dropping it would 404 the upstream with no hint why
        self._prefix = parts.path.rstrip("/")

    # -- plumbing ----------------------------------------------------------

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        if self._scheme == "https":
            ctx = ssl.create_default_context()
            if not self.verify_tls:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            return http.client.HTTPSConnection(self._host, self._port, timeout=timeout, context=ctx)
        return http.client.HTTPConnection(self._host, self._port, timeout=timeout)

    def _wants_msgpack(self) -> bool:
        return (
            self.codec_preference in (CODEC_AUTO, CODEC_MSGPACK)
            and _msgpack is not None
        )

    def _headers(self) -> Dict[str, str]:
        accept = JSON_CONTENT_TYPE
        if self._wants_msgpack():
            # preference order left to right; the server picks the first
            # content type it can actually encode
            accept = f"{MSGPACK_CONTENT_TYPE}, {JSON_CONTENT_TYPE}"
        headers = {"Accept": accept, "Connection": "close"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    def _note_codec(self, served: str) -> None:
        """Record what the peer actually served; log the msgpack->JSON
        downgrade ONCE per client (a reconnecting subscriber must not
        repeat it every backoff cycle)."""
        self.active_codec = served
        if (
            served == CODEC_JSON
            and self._wants_msgpack()
            and not self._downgrade_logged
        ):
            self._downgrade_logged = True
            log = logger.warning if self.codec_preference == CODEC_MSGPACK else logger.info
            log(
                "Upstream %s does not speak msgpack; serving JSON instead "
                "(logged once per client)", self.base_url,
            )

    @staticmethod
    def _response_codec(resp: http.client.HTTPResponse) -> str:
        ctype = (resp.getheader("Content-Type") or "").lower()
        return CODEC_MSGPACK if MSGPACK_CONTENT_TYPE in ctype else CODEC_JSON

    def _decode_body(self, resp: http.client.HTTPResponse) -> dict:
        """Decode one bounded response body by its Content-Type (the
        negotiation's answer), tracking the active codec."""
        data = resp.read()
        codec = self._response_codec(resp)
        self._note_codec(codec)
        if codec == CODEC_MSGPACK:
            return _msgpack.unpackb(data, raw=False, strict_map_key=False)
        return json.loads(data)

    def _body_json(self, resp: http.client.HTTPResponse) -> dict:
        """Best-effort body decode for error paths (either codec; a
        non-body answer decodes to {})."""
        try:
            data = resp.read() or b"{}"
        except OSError:
            return {}
        if self._response_codec(resp) == CODEC_MSGPACK:
            try:
                body = _msgpack.unpackb(data, raw=False, strict_map_key=False)
                return body if isinstance(body, dict) else {}
            except Exception:  # noqa: BLE001 - error bodies are advisory
                return {}
        try:
            return json.loads(data)
        except ValueError:
            return {}

    def _raise_for_status(self, resp: http.client.HTTPResponse) -> None:
        if resp.status == 200:
            return
        body = self._body_json(resp)
        message = body.get("error") or f"HTTP {resp.status}"
        if resp.status == 410:
            raise ResyncRequired(message, status=410, body=body)
        if resp.status == 401:
            raise AuthRejected(message, status=401, body=body)
        # 503 (admission full) and everything else transient: OSError so
        # callers' one except-arm handles "back off and retry"
        raise ConnectionError(f"{self.base_url}: {message} (HTTP {resp.status})")

    def _get_json(self, path: str, timeout: float) -> dict:
        conn = self._connect(timeout)
        try:
            conn.request("GET", self._prefix + path, headers=self._headers())
            resp = conn.getresponse()
            self._raise_for_status(resp)
            return self._decode_body(resp)
        finally:
            conn.close()

    # -- protocol ----------------------------------------------------------

    def snapshot(self) -> Snapshot:
        body = self._get_json("/serve/fleet", self.timeout)
        return Snapshot(body["rv"], body.get("view", ""), body.get("objects", []))

    def snapshot_at(self, rv: int) -> Snapshot:
        """Time-travel read (``?at=rv``; needs the upstream's history plane)."""
        body = self._get_json(f"/serve/fleet?at={int(rv)}", self.timeout)
        return Snapshot(body["rv"], body.get("view", ""), body.get("objects", []))

    def debug_trace(self, uid: str, *, n: int = 50) -> List[Dict[str, Any]]:
        """One upstream's local traces for a pod — ``GET /debug/trace``
        on the SERVE port (serve/server.py routes it when tracing is on).
        The federation plane's lazy-stitch path: called only on a
        stitched query that needs spans not forwarded in-band. Raises the
        client's usual error family; the collector degrades any failure
        to a partial answer."""
        query = urlencode({"uid": uid, "n": int(n)})
        body = self._get_json(f"/debug/trace?{query}", self.timeout)
        return body.get("traces", [])

    def healthz(self) -> dict:
        """``/serve/healthz`` (open route; also tolerates non-200 — the
        body is the point)."""
        conn = self._connect(self.timeout)
        try:
            conn.request("GET", self._prefix + "/serve/healthz", headers={"Accept": "application/json"})
            return self._body_json(conn.getresponse())
        finally:
            conn.close()

    def long_poll(
        self,
        rv: int,
        *,
        view: Optional[str] = None,
        timeout: float = 1.0,
        limit: Optional[int] = None,
    ) -> Batch:
        """One ``?watch=1&once=1`` long-poll. Raises ``ResyncRequired``
        on 410 (token expired / view instance changed / rv ahead)."""
        params = {"watch": "1", "once": "1", "rv": rv, "timeout": timeout}
        if view:
            params["view"] = view
        if limit:
            params["limit"] = limit
        if self.fresh:
            params["fresh"] = "1"
        if self.trace:
            params["trace"] = "1"
        body = self._get_json(
            f"/serve/fleet?{urlencode(params)}",
            # the HTTP read must outlive the server-side poll window
            timeout + self.timeout,
        )
        return Batch(
            body["from_rv"], body["to_rv"], body.get("view", ""),
            bool(body.get("compacted")), body.get("items", []),
        )

    def watch_batches(
        self,
        rv: int,
        *,
        view: Optional[str] = None,
        window_seconds: float = 30.0,
        read_timeout: Optional[float] = None,
        limit: Optional[int] = None,
        on_conn: Optional[Callable[[http.client.HTTPConnection], None]] = None,
        raw: bool = False,
    ) -> Iterator[List[Any]]:
        """One ``?watch=1`` stream window, yielding frame BATCHES: every
        chunked read off the socket (``read1``, up to ``WATCH_READ_BYTES``)
        decodes into one list of frames (SYNC / UPSERT / DELETE /
        COMPACTED / GONE dicts) — the fan-in batching unit. A publisher
        batch the server wrote in one pass arrives in one read and is
        handed downstream in one call, so the consumer amortizes its own
        apply cost the same way the server amortized its encode cost.

        The serve wire frames each delta as its own chunked-transfer
        chunk (the encode-once frame bytes INCLUDE the chunk framing, so
        the server cannot coalesce them without re-encoding), and
        ``http.client``'s ``read1`` returns at most ONE chunk — so one
        blocking read is followed by a zero-timeout drain of every chunk
        already queued on the socket (up to ``WATCH_READ_BYTES``). Under
        a trickle each batch is ~1 frame; when the consumer falls behind
        a churn storm the backlog arrives queued and batches grow to
        exactly the size the amortization needs.

        ``read_timeout`` bounds the wait for EACH blocking read — the
        SYNC heartbeat cadence is 2 s, so a read that outwaits
        ``read_timeout`` means the upstream stalled (socket.timeout
        propagates; the caller reconnects). Pre-stream 410 raises
        ``ResyncRequired`` before any frame is yielded. ``on_conn``
        receives the live connection before the request is sent — a
        stopper can close it to abort a blocked read immediately.

        Codec: negotiated per the client preference; msgpack frames are
        self-delimiting (fed through a streaming unpacker), JSON frames
        are newline-delimited lines — either way one read yields one
        batch, and the decoded dicts are identical across codecs.

        ``raw=True`` is the relay tier's zero-re-encode passthrough:
        each batch item becomes a ``(frame, raw_bytes)`` pair, where
        ``raw_bytes`` is the frame's codec payload EXACTLY as the
        upstream encoded it (the JSON line including its trailing
        newline; the msgpack ``packb`` span) — the decoded dict carries
        the control metadata (type/rv/ts/...) while the untouched bytes
        ride beside it, so a relay can re-broadcast the same bytes
        without ever re-serializing. Spans are exact under partial-tail
        carry too: a frame split across reads is delivered once,
        complete, with its original bytes."""
        params = {"watch": "1", "rv": rv, "timeout": window_seconds}
        if view:
            params["view"] = view
        if limit:
            params["limit"] = limit
        if self.fresh:
            params["fresh"] = "1"
        if self.trace:
            params["trace"] = "1"
        conn = self._connect(read_timeout if read_timeout is not None else self.timeout)
        if on_conn is not None:
            on_conn(conn)
        try:
            conn.request("GET", f"{self._prefix}/serve/fleet?{urlencode(params)}", headers=self._headers())
            resp = conn.getresponse()
            self._raise_for_status(resp)
            # http.client strips the chunked-transfer framing; what is
            # left is the codec's raw frame stream
            codec = self._response_codec(resp)
            self._note_codec(codec)
            if codec == CODEC_MSGPACK:
                unpacker = _msgpack.Unpacker(raw=False, strict_map_key=False)
                # raw mode keeps a sliding copy of the fed bytes; each
                # unpacked frame's span is cut by Unpacker.tell() (the
                # cumulative stream position), so the raw bytes are the
                # upstream's packb output verbatim — a partial tail just
                # stays in `fed` until the next read completes the frame
                fed = bytearray()
                consumed = 0  # stream offset of fed[0]
                pos = 0  # stream position of the last unpacked frame end
                while True:
                    chunks, eof = self._drain_chunks(resp, conn.sock)
                    for data in chunks:
                        unpacker.feed(data)
                        if raw:
                            fed += data
                    if raw:
                        batch = []
                        for frame in unpacker:
                            end = unpacker.tell()
                            batch.append(
                                (frame, bytes(fed[pos - consumed:end - consumed]))
                            )
                            pos = end
                        del fed[: pos - consumed]
                        consumed = pos
                    else:
                        batch = [frame for frame in unpacker]
                    if batch:
                        yield batch
                    if eof:
                        return  # clean window end (terminal chunk)
            else:
                buf = b""
                while True:
                    chunks, eof = self._drain_chunks(resp, conn.sock)
                    data = b"".join(chunks)
                    buf += data
                    if b"\n" in data:
                        lines = buf.split(b"\n")
                        buf = lines.pop()  # partial tail carries over
                        if raw:
                            # the upstream frames one JSON line + "\n"
                            # per delta: line + b"\n" IS the original
                            # payload byte-for-byte
                            batch = [
                                (json.loads(line), line + b"\n")
                                for line in lines
                                if line.strip()
                            ]
                        else:
                            batch = [json.loads(line) for line in lines if line.strip()]
                        if batch:
                            yield batch
                    if eof:
                        # leftover partial line = the peer died mid-frame;
                        # there is nothing decodable left to deliver
                        return
        finally:
            conn.close()

    @staticmethod
    def _drain_chunks(resp, sock) -> Tuple[List[bytes], bool]:
        """One blocking ``read1`` (bounded by the socket timeout), then a
        zero-timeout drain of every further chunk the kernel already has
        — up to ``WATCH_READ_BYTES`` total, so a deep backlog paces into
        bounded batches instead of one giant buffer. Returns
        ``(chunks, eof)``. A chunk sitting in the response's own buffered
        reader when the socket shows nothing new just lands at the head
        of the NEXT batch (the following blocking read returns it without
        waiting) — fragmentation, never a stall."""
        data = resp.read1(WATCH_READ_BYTES)
        if not data:
            return [], True
        chunks = [data]
        total = len(data)
        while total < WATCH_READ_BYTES:
            if sock is None:
                break
            try:
                if not select.select([sock], [], [], 0)[0]:
                    break
            except (OSError, ValueError):
                break  # racing close (stop()); the next read raises
            more = resp.read1(WATCH_READ_BYTES - total)
            if not more:
                return chunks, True
            chunks.append(more)
            total += len(more)
        return chunks, False

    def watch(
        self,
        rv: int,
        *,
        view: Optional[str] = None,
        window_seconds: float = 30.0,
        read_timeout: Optional[float] = None,
        limit: Optional[int] = None,
        on_conn: Optional[Callable[[http.client.HTTPConnection], None]] = None,
    ) -> Iterator[Dict[str, Any]]:
        """``watch_batches`` flattened to one frame per yield — the
        per-frame shape for consumers that don't batch."""
        for batch in self.watch_batches(
            rv,
            view=view,
            window_seconds=window_seconds,
            read_timeout=read_timeout,
            limit=limit,
            on_conn=on_conn,
        ):
            yield from batch


class TokenStore:
    """Durable resume token: ``{rv, view}``, written atomically (tmp +
    rename) so a crash never leaves a torn token. This is the consumer's
    half of the restart story: the upstream's WAL keeps the rv
    line alive across ITS restarts; this file keeps the cursor alive
    across OURS."""

    def __init__(self, path: str):
        self.path = str(path)

    def load(self) -> Optional[Tuple[int, str]]:
        try:
            with open(self.path) as f:
                body = json.load(f)
            return int(body["rv"]), str(body["view"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def save(self, rv: int, view: str) -> None:
        tmp = f"{self.path}.tmp"
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"rv": int(rv), "view": view}, f)
        os.replace(tmp, self.path)

    def clear(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class ResumeLoop:
    """The long-poll resume-protocol consumer: snapshot -> poll ->
    sequence-check -> apply -> carry ``to_rv``; a 410 runs the documented
    recovery (re-snapshot) and keeps going."""

    def __init__(self, client: FleetClient, *, checker: Optional[SequenceChecker] = None):
        self.client = client
        self.checker = checker or SequenceChecker()
        self.model: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.rv = 0
        self.view = ""
        self.polls = 0
        self.resyncs = 0

    def start(self) -> Snapshot:
        snap = self.client.snapshot()
        self.rv, self.view = snap.rv, snap.view
        self.model = model_from_objects(snap.objects)
        return snap

    def poll(self, *, timeout: float = 1.0, limit: Optional[int] = None) -> bool:
        """One long-poll; False when a 410 forced a re-snapshot."""
        self.polls += 1
        try:
            batch = self.client.long_poll(self.rv, view=self.view, timeout=timeout, limit=limit)
        except ResyncRequired:
            self.start()
            self.resyncs += 1
            return False
        self.checker.observe(
            batch.from_rv, batch.to_rv, batch.compacted, (i["rv"] for i in batch.items)
        )
        apply_wire_deltas(self.model, batch.items)
        self.rv = batch.to_rv
        return True

    def drain(self, *, polls: int = 30, timeout: float = 0.3) -> None:
        """Poll with short windows until a poll delivers nothing (or the
        budget runs out) — the catch-up tail after churn stops."""
        for _ in range(polls):
            before = self.rv
            self.poll(timeout=timeout)
            if self.rv == before:
                break


class FleetSubscriber:
    """The streaming consumer loop one federation upstream runs.

    ``run()`` blocks until ``stop()``: it snapshots (or resumes from the
    persisted token), streams ``?watch=1`` windows, and survives every
    documented failure mode —

    - transient errors / refused connections / heartbeat stalls (no
      frame within ``stale_after_seconds``): reconnect with jittered
      exponential backoff, resume from the carried token;
    - pre-stream 410 or in-band GONE: re-snapshot (``on_snapshot`` gets
      the full state; the resync counter ticks);
    - a clean window end: reconnect immediately (the resume protocol).

    Callbacks run on the subscriber's thread: ``on_snapshot(Snapshot)``
    replaces downstream state wholesale; ``on_batch(frames)`` folds one
    wire-read's worth of UPSERT/DELETE frames in one call (the fan-in
    batching unit — the federation plane folds it under one lock), or
    ``on_delta(frame)`` folds them one at a time when no batch handler
    is given. ``on_raw_batch(pairs)`` is the relay tier's handler: the
    stream runs in raw-passthrough mode and each delivered run is a list
    of ``(frame, raw_bytes)`` pairs — decoded control metadata beside
    the upstream's untouched frame bytes (see ``watch_batches(raw=)``).
    The ``SequenceChecker`` rides every delivery either way."""

    def __init__(
        self,
        client: FleetClient,
        *,
        on_snapshot: Optional[Callable[[Snapshot], None]] = None,
        on_delta: Optional[Callable[[Dict[str, Any]], None]] = None,
        on_batch: Optional[Callable[[List[Dict[str, Any]]], None]] = None,
        on_raw_batch: Optional[Callable[[List[Tuple[Dict[str, Any], bytes]]], None]] = None,
        token_store: Optional[TokenStore] = None,
        stale_after_seconds: float = 10.0,
        backoff_seconds: float = 1.0,
        max_backoff_seconds: float = 30.0,
        window_seconds: float = 30.0,
        checker: Optional[SequenceChecker] = None,
        rng: Optional[random.Random] = None,
        name: str = "",
    ):
        self.client = client
        self.on_snapshot = on_snapshot
        self.on_delta = on_delta
        self.on_batch = on_batch
        self.on_raw_batch = on_raw_batch
        self.token_store = token_store
        # the stream heartbeats every 2 s when idle; anything sub-3s
        # would call a healthy idle stream dead
        self.stale_after_seconds = max(3.0, stale_after_seconds)
        self.backoff_seconds = max(0.05, backoff_seconds)
        self.max_backoff_seconds = max(self.backoff_seconds, max_backoff_seconds)
        self.window_seconds = window_seconds
        self.checker = checker or SequenceChecker()
        self.rng = rng or random.Random()
        self.name = name
        self.rv: Optional[int] = None
        self.view: Optional[str] = None
        # wire_rv: the newest rv SEEN on the wire (SYNC included) even if
        # not yet folded downstream — feeds the per-upstream lag-rv gauge
        self.wire_rv = 0
        self.reconnects = 0
        self.resyncs = 0
        self.snapshots = 0
        self.stalls = 0
        self.frames = 0
        self.batches = 0  # wire-read batches delivered (frames/batches = fan-in batch size)
        self.connected = False
        self.last_error: Optional[str] = None
        self._last_frame_t = 0.0  # 0 = never
        # freshness watermark: the origin wall stamp of the NEWEST delta
        # applied downstream (frame ts when the upstream stamps, local
        # receive wall otherwise; a snapshot reconcile resets it to now —
        # a full state hand-off is by definition fresh). Advances under
        # churn, ages while the upstream is paused or dark.
        self.watermark_wall: Optional[float] = None
        self._last_delta_mono = 0.0  # local monotonic of the last applied delta
        self._saved_token: Optional[Tuple[int, str]] = None  # last persisted (rv, view)
        self._stop = threading.Event()
        self._invalidate = threading.Event()
        # the live watch connection, so stop() can abort a read blocked
        # up to stale_after_seconds instead of outwaiting it — the
        # plane's join must reliably finish BEFORE the history WAL
        # writes its terminal snapshot
        self._conn_lock = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None

    # -- external surface --------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        # abort an in-flight blocked read NOW: without this the run loop
        # can sit in readline() up to stale_after_seconds, outliving the
        # caller's join and racing whatever shutdown step follows it
        with self._conn_lock:
            conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def invalidate(self) -> None:
        """Force a re-snapshot on the next (re)connect — the drop-stale
        policy uses this after it deleted a dark upstream's objects, so a
        later token-resume can't skip re-materializing them."""
        self._invalidate.set()

    def last_frame_age(self) -> Optional[float]:
        """Seconds since the last frame (None before the first)."""
        t = self._last_frame_t
        return None if t == 0.0 else time.monotonic() - t

    def last_delta_age(self) -> Optional[float]:
        """Seconds since the last DELTA applied downstream (SYNC
        heartbeats don't count — an idle-but-alive upstream ages here
        while staying fresh on ``last_frame_age``)."""
        t = self._last_delta_mono
        return None if t == 0.0 else time.monotonic() - t

    def watermark_age(self) -> Optional[float]:
        """Age of the freshness watermark: wall-now minus the origin
        stamp of the newest applied delta. Wall clocks (the origin is a
        REMOTE host) — subject to cross-host skew, clamped at 0."""
        w = self.watermark_wall
        return None if w is None else max(0.0, time.time() - w)

    # -- the loop ----------------------------------------------------------

    def _save_token(self, rv: int, view: str) -> None:
        """Persist (rv, view) iff it changed — an idle upstream's SYNC
        heartbeats must not rewrite the token file every 2 s forever."""
        if self.token_store is None or self._saved_token == (rv, view):
            return
        self.token_store.save(rv, view)
        self._saved_token = (rv, view)

    def run(self) -> None:
        if self.rv is None and self.token_store is not None:
            token = self.token_store.load()
            if token is not None:
                self.rv, self.view = token
                self._saved_token = token
        try:
            self._run_loop()
        finally:
            # persist the EXACT live position on the way out: the periodic
            # save cadence (SYNC / every 256 deltas / window end) can leave
            # the durable token up to a window behind, which a stopped-and-
            # respawned consumer (a drained merge worker) would replay —
            # harmless but not free. Never on an invalidated line (that
            # must re-snapshot) and never let a disk error mask the exit.
            if (
                self.rv is not None
                and self.view is not None
                and not self._invalidate.is_set()
            ):
                try:
                    self._save_token(self.rv, self.view)
                except OSError:
                    pass

    def _run_loop(self) -> None:
        backoff = self.backoff_seconds
        while not self._stop.is_set():
            try:
                if self._invalidate.is_set():
                    self._invalidate.clear()
                    self.rv = None
                if self.rv is None or self.view is None:
                    self._resnapshot()
                self._watch_window()
                self.connected = False
                backoff = self.backoff_seconds  # a completed window resets it
            except ResyncRequired as exc:
                self.connected = False
                self.resyncs += 1
                self.last_error = str(exc)
                self.rv = None  # next iteration re-snapshots
                # the documented resync backoff (jittered, escalating): a
                # GONE storm — this consumer slower than the upstream's
                # churn — must not hot-loop O(fleet) snapshot reads
                # against an already-overloaded upstream, and N federators
                # losing the same horizon must not herd their re-snapshots
                if self._sleep(backoff):
                    return
                backoff = min(backoff * 2, self.max_backoff_seconds)
            except AuthRejected as exc:
                # wrong credentials never fix themselves by retrying fast:
                # surface via health (connected=False + last_error) and
                # retry at the MAX backoff in case the token gets rotated
                self.connected = False
                self.last_error = f"auth rejected: {exc}"
                if self._sleep(self.max_backoff_seconds):
                    return
            except (socket.timeout, TimeoutError) as exc:
                self.connected = False
                self.stalls += 1
                self.reconnects += 1
                self.last_error = f"heartbeat stall: {exc!r}"
                # a stall is not a refused connection: retry promptly
                if self._sleep(self.backoff_seconds):
                    return
            except (OSError, http.client.HTTPException, ValueError) as exc:
                self.connected = False
                if self._stop.is_set():
                    return  # stop()'s connection abort, not a real fault
                self.reconnects += 1
                self.last_error = f"{type(exc).__name__}: {exc}"
                if self._sleep(backoff):
                    return
                backoff = min(backoff * 2, self.max_backoff_seconds)
            except Exception:
                # stop() closes the live connection from another thread;
                # http.client then fails at whatever it was doing (e.g.
                # AttributeError reading a None fp) — exit quietly when
                # stopping, re-raise genuine bugs
                self.connected = False
                if self._stop.is_set():
                    return
                raise

    def _sleep(self, seconds: float) -> bool:
        """Jittered wait (0.5x..1.5x) — N federation subscribers losing
        the same upstream must not reconnect in lockstep. True = stopped."""
        return self._stop.wait(seconds * (0.5 + self.rng.random()))

    def _resnapshot(self) -> None:
        snap = self.client.snapshot()
        self.rv, self.view = snap.rv, snap.view
        self.wire_rv = max(self.wire_rv, snap.rv)
        self.snapshots += 1
        self._last_frame_t = time.monotonic()
        # a full state hand-off is by definition fresh as of now
        self.watermark_wall = time.time()
        self._last_delta_mono = time.monotonic()
        self._save_token(snap.rv, snap.view)
        if self.on_snapshot is not None:
            self.on_snapshot(snap)

    def _register_conn(self, conn) -> None:
        with self._conn_lock:
            self._conn = conn
        if self._stop.is_set():
            # stop() may have read a stale None just before we registered:
            # close here so the abort can never be missed
            try:
                conn.close()
            except OSError:
                pass

    def _deliver(self, run: List[Any]) -> None:
        """Hand one contiguous UPSERT/DELETE run downstream: one
        ``on_raw_batch`` call (raw-passthrough mode — items are
        ``(frame, raw_bytes)`` pairs), one ``on_batch`` call (the
        batched fan-in path), or per-frame ``on_delta`` fallback.
        Sequence checking and cursor advance already happened —
        delivery is pure application."""
        if not run:
            return
        if self.on_raw_batch is not None:
            self.on_raw_batch(run)
        elif self.on_batch is not None:
            self.on_batch(run)
        elif self.on_delta is not None:
            for frame in run:
                self.on_delta(frame)

    def _watch_window(self) -> None:
        assert self.rv is not None
        compacted_until = -1  # COMPACTED sanctions skips up to this rv
        deltas_since_save = 0
        raw_mode = self.on_raw_batch is not None
        for batch in self.client.watch_batches(
            self.rv,
            view=self.view,
            window_seconds=self.window_seconds,
            read_timeout=self.stale_after_seconds,
            on_conn=self._register_conn,
            raw=raw_mode,
        ):
            if self._stop.is_set():
                # BEFORE applying: a batch racing stop() must not reach
                # the downstream view after the caller's join returned
                # (e.g. after the history WAL's terminal snapshot)
                return
            self._last_frame_t = time.monotonic()
            self.connected = True
            self.frames += len(batch)
            self.batches += 1
            # one wire read = one delivery batch; control frames split a
            # batch into contiguous delta runs so apply order matches
            # wire order exactly. The resume cursor (self.rv) advances
            # only AFTER a run is delivered: if a downstream callback
            # raises a retried exception class mid-apply, the reconnect
            # resumes from the last delivered rv and the run is simply
            # redelivered — never silently skipped.
            run: List[Any] = []
            run_watermark: Optional[float] = None
            prev_rv = self.rv or 0

            def commit_run() -> None:
                nonlocal run, run_watermark
                if run:
                    self._deliver(run)
                    # watermark semantics: the newest APPLIED delta's
                    # origin stamp — advanced only AFTER the run reached
                    # downstream, so a slow apply never reads as fresh
                    if run_watermark is not None:
                        self.watermark_wall = run_watermark
                    self._last_delta_mono = time.monotonic()
                    run = []
                    run_watermark = None
                self.rv = max(self.rv, prev_rv)

            for item in batch:
                # raw mode delivers (frame, raw_bytes) pairs; the decoded
                # dict drives all control/sequence logic either way
                frame = item[0] if raw_mode else item
                ftype = frame.get("type")
                if ftype in (UPSERT, DELETE):
                    rv = frame["rv"]
                    self.checker.observe_stream_rv(prev_rv, rv, rv <= compacted_until)
                    self.wire_rv = max(self.wire_rv, rv)
                    run.append(item)
                    prev_rv = max(prev_rv, rv)
                    deltas_since_save += 1
                    # watermark candidate: the negotiated origin stamp
                    # when the upstream sent one, local receive wall
                    # otherwise (adopted by commit_run AFTER delivery)
                    ts = frame.get("ts")
                    run_watermark = ts[0] if ts else time.time()
                    continue
                commit_run()
                if ftype == SYNC:
                    rv = frame.get("rv", self.rv)
                    self.wire_rv = max(self.wire_rv, rv)
                    if rv > self.rv:
                        self.rv = rv  # idle SYNC advances the resume token
                    prev_rv = max(prev_rv, self.rv)
                    self._save_token(self.rv, frame.get("view") or self.view or "")
                    deltas_since_save = 0
                elif ftype == COMPACTED:
                    compacted_until = max(compacted_until, frame.get("to_rv", -1))
                    self.checker.compacted_batches += 1
                elif ftype == GONE:
                    raise ResyncRequired(
                        "in-band GONE (fell behind the horizon mid-stream)",
                        status=410, body=frame,
                    )
            commit_run()
            if deltas_since_save >= 256:
                # periodic persistence bounds replay-after-crash; the
                # per-SYNC save above covers the idle/stream-end cases
                self._save_token(self.rv, self.view or "")
                deltas_since_save = 0
        if deltas_since_save:
            self._save_token(self.rv, self.view or "")

    def status(self) -> Dict[str, Any]:
        age = self.last_frame_age()
        delta_age = self.last_delta_age()
        watermark = self.watermark_age()
        return {
            "name": self.name,
            "connected": self.connected,
            "rv": self.rv,
            "wire_rv": self.wire_rv,
            "view": self.view,
            "last_frame_age_seconds": round(age, 3) if age is not None else None,
            "last_delta_age_seconds": round(delta_age, 3) if delta_age is not None else None,
            "watermark_age_seconds": round(watermark, 3) if watermark is not None else None,
            "frames": self.frames,
            "batches": self.batches,
            "codec": self.client.active_codec,
            "snapshots": self.snapshots,
            "reconnects": self.reconnects,
            "resyncs": self.resyncs,
            "stalls": self.stalls,
            "gaps": self.checker.gaps,
            "dups": self.checker.dups,
            "delivered": self.checker.delivered,
            "last_error": self.last_error,
        }
