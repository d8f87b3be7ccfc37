"""Fleet-state materialized view: the serve-side watch cache (the JAX
package's ``serve/view.py``).

It lets schedulers, dashboards and remediation controllers read fleet state
without each holding a watch against the apiserver:

- ``FleetView`` is a materialized map of the pipeline's output (pod phases,
  slice aggregates, probe verdicts) keyed by ``(kind, key)`` with one
  monotonic **view resourceVersion**: every applied delta bumps ``rv`` by
  exactly 1, so the rv space is dense and a delta range ``(from_rv, to_rv]``
  holds ``to_rv - from_rv`` deltas (what subscribers' gap checkers count on).
- A bounded **delta journal** (the last ``compact_horizon`` deltas) backs
  resumable subscriptions: a consumer takes a snapshot at ``rv``, then reads
  deltas ``> rv``; its resume token is the last rv it applied.
- A token behind the horizon gets ``GONE`` (HTTP 410) and the consumer
  re-snapshots, as the apiserver answers a compacted watch.
- A subscriber whose backlog exceeds its ``queue_depth`` gets the pending
  range compacted **latest-wins per key**, flagged ``compacted``; per-key
  final state stays exact.

Concurrency: the pipeline thread (``publish_batch``) and the sink taps
(slices, probes) write under one lock; readers share it and long-polls wait
on its condition. Deltas and objects are replaced, never mutated.

Durable history: with a ``history.HistoryStore`` attached, every applied
delta is handed to the WAL under the same lock (O(1)), so the WAL is in rv
order; ``restore`` adopts a recovered incarnation (instance, rv line,
objects, journal tail), so resume tokens survive a restart.

Encode-once fan-out: every delta's **wire frame** (its payload, already in
HTTP chunked framing) is serialized at most once per frame variant into
arrays parallel to the journal, and every subscriber streaming it appends the
same ``bytes`` object. JSON frames are encoded eagerly at publish on the local
paths; msgpack and the freshness/trace-stamped variants are filled lazily on
first read and memoized. ``GET /serve/fleet`` serializes the snapshot at most
once per ``(rv, codec)``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from bisect import bisect_left, bisect_right
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

from k8s_watcher_tpu_torch.pipeline.phase import pod_key, pod_ready
from k8s_watcher_tpu_torch.pipeline.pipeline import NEVER_IN_VIEW
from k8s_watcher_tpu_torch.serve.columns import (
    ColumnarStore,
    assemble_json_body,
    assemble_msgpack_body,
    iter_snapshot_objects,
)
from k8s_watcher_tpu_torch.trace import wire_trace
from k8s_watcher_tpu_torch.watch.source import EventType

# msgpack is optional: without it the server negotiates JSON only
try:
    import msgpack as _msgpack
except ImportError:
    _msgpack = None

#: delivery record types on the wire (and in Delta.type)
UPSERT = "UPSERT"
DELETE = "DELETE"

#: wire codecs (the ``Accept`` negotiation vocabulary)
CODEC_JSON = "json"
CODEC_MSGPACK = "msgpack"
CODECS = (CODEC_JSON, CODEC_MSGPACK)

#: frame-variant suffix for freshness-stamped frames (``?fresh=1``): each
#: (codec, fresh) pair is its own parallel frame array, so the plain JSON
#: frames stay byte-identical for peers that did not ask for stamps
FRESH_SUFFIX = "+ts"
#: frame-variant suffix for trace-forwarding frames (``?trace=1``); trace
#: implies fresh, so the traced variants always stack on ``+ts``
TRACE_SUFFIX = "+tr"
FRAME_VARIANTS = (
    CODEC_JSON,
    CODEC_MSGPACK,
    CODEC_JSON + FRESH_SUFFIX,
    CODEC_MSGPACK + FRESH_SUFFIX,
    CODEC_JSON + FRESH_SUFFIX + TRACE_SUFFIX,
    CODEC_MSGPACK + FRESH_SUFFIX + TRACE_SUFFIX,
)


def frame_variant(codec: str, fresh: bool, traced: bool = False) -> str:
    """The frame-array key of one negotiated (codec, fresh, trace) triple."""
    if traced:
        return codec + FRESH_SUFFIX + TRACE_SUFFIX
    return codec + FRESH_SUFFIX if fresh else codec


JSON_CONTENT_TYPE = "application/json"
MSGPACK_CONTENT_TYPE = "application/x-msgpack"
CODEC_CONTENT_TYPES = {CODEC_JSON: JSON_CONTENT_TYPE, CODEC_MSGPACK: MSGPACK_CONTENT_TYPE}


def msgpack_available() -> bool:
    """Whether this process can encode the msgpack wire codec."""
    return _msgpack is not None


#: read_since verdicts
OK = "ok"
GONE = "gone"  # the resume token fell behind the compaction horizon -> 410
INVALID = "invalid"  # the token is ahead of the view; HTTP answers 410 too


class Delta(NamedTuple):
    """One journaled view mutation. ``object`` is None for DELETE.

    ``ts_wall`` is the origin wall stamp (the watch event's receive stamp
    for pods, the apply time for sink taps); ``pub_wall`` is when this view
    published it. ``trace`` is the sampled journey the ``?trace=1`` wire
    forwards (a live ``trace.Trace``, or its compact wire dict); None for
    unsampled deltas."""

    rv: int
    kind: str  # "pod" | "slice" | "probe"
    key: str
    type: str  # UPSERT | DELETE
    object: Optional[Dict[str, Any]]
    t: float  # monotonic append stamp (feeds the delta-lag histogram)
    ts_wall: Optional[float] = None
    pub_wall: float = 0.0
    trace: Optional[Any] = None

    def to_wire(self, fresh: bool = False, trace: bool = False) -> Dict[str, Any]:
        out = {"type": self.type, "rv": self.rv, "kind": self.kind, "key": self.key}
        if self.object is not None:
            out["object"] = self.object
        if fresh and self.ts_wall is not None:
            # [origin_wall, publish_wall], only for peers that asked
            out["ts"] = [self.ts_wall, self.pub_wall]
        if trace and self.trace is not None:
            # a compact dict (an ``apply_batch`` item's fifth element) is
            # already the wire form and passes through as it is
            out["trace"] = self.trace if isinstance(self.trace, dict) else wire_trace(self.trace)
        return out


def frame_body(obj: Mapping[str, Any], codec: str = CODEC_JSON) -> bytes:
    """One frame's payload before chunk framing. JSON: the line with the
    default ``json.dumps`` separators and a trailing newline. msgpack:
    ``packb`` of the same dict (self-delimiting)."""
    if codec == CODEC_MSGPACK:
        if _msgpack is None:
            raise RuntimeError("msgpack codec requested but msgpack is not importable")
        return _msgpack.packb(obj, use_bin_type=True)
    return (json.dumps(obj) + "\n").encode()


def chunk_frame(obj: Mapping[str, Any], codec: str = CODEC_JSON) -> bytes:
    """One wire frame: the codec payload in HTTP chunked-transfer framing
    (``<hex len>\\r\\n<payload>\\r\\n``). Every frame of a watch stream is
    one: the per-delta frames and the SYNC/COMPACTED/GONE control frames."""
    return chunk_wrap(frame_body(obj, codec))


def chunk_wrap(payload: bytes) -> bytes:
    """Wrap already-encoded payload bytes in the per-frame chunked framing.
    The relay's passthrough calls it directly: the upstream's payload gets a
    length prefix and is never serialized again."""
    return b"%x\r\n" % len(payload) + payload + b"\r\n"


def frame_payload(frame: bytes) -> bytes:
    """The payload of one ``chunk_frame`` result (the inverse a dechunking
    client applies)."""
    head, _, rest = frame.partition(b"\r\n")
    return rest[: int(head, 16)]


_RV_MARK = b'"rv": '


def splice_frame_rv(payload: bytes, rv: int) -> Optional[bytes]:
    """``payload`` (one JSON frame line, before chunk framing) with its
    frame-level ``rv`` number replaced by ``rv``: the only byte change the
    sharded fan-in makes to a frame a merge worker forwarded. The first
    ``"rv": `` of a delta line is the frame's own (the line opens with
    ``type`` and then ``rv``). None when the shape is not recognized, so
    the caller journals a hole to re-encode instead of a corrupt frame."""
    i = payload.find(_RV_MARK)
    if i < 0:
        return None
    j = k = i + len(_RV_MARK)
    n = len(payload)
    while k < n and payload[k] in b"-0123456789":
        k += 1
    if k == j or k >= n or payload[k] not in b",}":
        return None
    return b"%s%d%s" % (payload[:j], rv, payload[k:])


class ReadResult(NamedTuple):
    """One ``read_since`` pull. ``status == OK``: ``deltas`` cover exactly
    ``(from_rv, to_rv]``, the contiguous journal range when ``compacted`` is
    False (``len(deltas) == to_rv - from_rv``), else its latest-wins per-key
    summary."""

    status: str
    from_rv: int
    to_rv: int
    compacted: bool
    deltas: List[Delta]


class FrameReadResult(NamedTuple):
    """``read_since`` plus the wire frames parallel to ``deltas``. The bytes
    are shared across every subscriber pulling the same range: append them,
    never mutate them."""

    status: str
    from_rv: int
    to_rv: int
    compacted: bool
    deltas: List[Delta]
    frames: List[bytes]


class FleetView:
    def __init__(self, *, compact_horizon: int = 8192, metrics=None, columnar: bool = True):
        self.compact_horizon = max(1, int(compact_horizon))
        # the columnar core (serve/columns.py), or the dict core with
        # ``columnar=False`` (``serve.columnar: off``); same wire bytes
        self.columnar = bool(columnar)
        # this incarnation of the rv space: a resume token is only meaningful
        # inside the instance that minted it, and clients echo it
        self.instance = os.urandom(6).hex()
        self._cond = threading.Condition()
        self._rv = 0
        self._oldest_rv = 0  # deltas with rv <= this are compacted away
        self._objects = ColumnarStore() if self.columnar else {}
        # parallel append-only arrays, trimmed together at the horizon:
        # bisect over _delta_rvs finds a resume point; _frames[variant][i] is
        # _deltas[i]'s frame in that variant, or None until a read fills it
        self._delta_rvs: List[int] = []
        self._deltas: List[Delta] = []
        self._frames: Dict[str, List[Optional[bytes]]] = {variant: [] for variant in FRAME_VARIANTS}
        # (rv, body) per codec: built at most once per rv and codec
        self._snapshot_cache: Dict[str, Tuple[int, bytes]] = {}
        # relay mode: reads resuming below this rv are flagged compacted,
        # since the upstream skipped rvs of this journal (latest-wins on its
        # side); 0 on every other view
        self._relay_sparse_rv = 0
        # per-kind object tables, built at most once per rv
        self._tables_cache: Optional[Tuple[int, Dict[str, List[Dict[str, Any]]]]] = None
        # post-publish wakeups, called outside the lock (the broadcast loops)
        self._wakeups: List[Callable[[], None]] = []
        # the durable WAL (history.HistoryStore) when the history plane is
        # on: every applied delta is handed to it under the publish lock,
        # which is what keeps the WAL rv-ordered across the writer threads
        self._history = None
        m = metrics
        self._publish_seconds = m.histogram("serve_publish_seconds") if m is not None else None
        self._delta_lag = m.histogram("serve_delta_lag_seconds") if m is not None else None
        self._deltas_published = m.counter("serve_deltas_published") if m is not None else None
        self._rv_gauge = m.gauge("serve_view_rv") if m is not None else None
        self._encode_seconds = m.histogram("serve_encode_seconds") if m is not None else None
        self._frame_encodes = m.counter("serve_frame_encodes") if m is not None else None
        self._frame_encodes_mp = m.counter("serve_frame_encodes_msgpack") if m is not None else None
        # stamped and traced fills bill their own counters, so encodes ==
        # publishes stays exact over the plain JSON path
        self._frame_encodes_fresh = m.counter("serve_frame_encodes_fresh") if m is not None else None
        self._frame_encodes_trace = m.counter("serve_frame_encodes_trace") if m is not None else None
        self._snap_hits = m.counter("serve_snapshot_cache_hits") if m is not None else None
        self._snap_misses = m.counter("serve_snapshot_cache_misses") if m is not None else None
        self._snap_hits_by_codec = {c: self._snap_hits.labels(codec=c) for c in CODECS} if m is not None else None
        self._snap_misses_by_codec = {c: self._snap_misses.labels(codec=c) for c in CODECS} if m is not None else None
        # watch receive -> local view visibility (monotonic, same host)
        self._watch_to_local = m.histogram("watch_to_local_view_seconds") if m is not None else None
        self._apply_seconds = m.histogram("view_apply_seconds") if m is not None else None
        self._resident_bytes = m.gauge("view_resident_bytes") if m is not None else None

    # -- durable history: an rv line that survives a restart -------------

    def restore(self, *, instance: str, rv: int, objects: Dict[Tuple[str, str], Dict[str, Any]],
                journal: List[Delta]) -> None:
        """Adopt WAL-recovered state: the previous incarnation's instance id,
        its rv line (new deltas continue from ``rv``), its objects and the
        preloaded journal tail (rv-ascending, contiguous, ending at ``rv``),
        so resume tokens minted before the restart read from memory. Call
        before any publish."""
        with self._cond:
            self.instance = instance
            self._rv = rv
            if self.columnar:
                self._objects.reseed(objects)  # the interners keep their codes
            else:
                self._objects = dict(objects)
            self._deltas = list(journal)
            self._delta_rvs = [d.rv for d in journal]
            # holes, not eager re-encodes: the first resumed read fills what
            # it pulls
            self._frames = {variant: [None] * len(journal) for variant in FRAME_VARIANTS}
            self._snapshot_cache = {}
            # the same rv may come back with other objects (replay across a
            # rebase hole): rv keying alone would serve stale tables
            self._tables_cache = None
            # tokens older than the preloaded tail get GONE
            self._oldest_rv = journal[0].rv - 1 if journal else rv
            self._relay_sparse_rv = 0
            if self._rv_gauge is not None:
                self._rv_gauge.set(self._rv)

    def attach_history(self, history) -> None:
        """Wire the durable WAL: every apply path hands it the deltas; it
        reads the live state back only to rebase after an overrun."""
        history.state_provider = self.state_for_history
        self._history = history

    def state_for_history(self) -> Tuple[int, Dict[Tuple[str, str], Dict[str, Any]]]:
        """``(rv, {(kind, key): obj})``: the WAL writer's rebase anchor. On
        the columnar core the structural snapshot is taken under the lock
        and the objects are rebuilt outside it."""
        with self._cond:
            if not self.columnar:
                return self._rv, dict(self._objects)
            rv = self._rv
            snap = self._objects.snapshot_parts(with_keys=True)
        return rv, {(kind, key): obj for kind, key, obj in iter_snapshot_objects(snap)}

    # -- relay mode: the upstream's rv line, mirrored (relay/plane.py) ----

    def adopt_relay(self, *, instance: str, rv: int, objects: Dict[Tuple[str, str], Dict[str, Any]]) -> None:
        """Take over an upstream serving plane's state: its instance id, rv
        and objects (the relay's snapshot reconcile). Unlike ``restore`` this
        may happen while serving (the upstream restarted, or the relay fell
        behind its horizon), so waiters are woken and the wakeup hooks fire:
        a subscriber of the old rv space gets GONE/INVALID and re-snapshots
        from this relay, not from the root. The journal starts empty;
        backfill through ``publish_relayed`` lowers ``oldest_rv`` again."""
        with self._cond:
            self.instance = instance
            self._rv = rv
            if self.columnar:
                self._objects.reseed(objects)
            else:
                self._objects = dict(objects)
            self._delta_rvs = []
            self._deltas = []
            self._frames = {variant: [] for variant in FRAME_VARIANTS}
            self._snapshot_cache = {}
            self._tables_cache = None
            self._relay_sparse_rv = 0
            self._oldest_rv = rv
            if self._rv_gauge is not None:
                self._rv_gauge.set(rv)
            self._cond.notify_all()
        for fn in self._wakeups:
            fn()

    def publish_relayed(self, entries, *, variant: str = CODEC_JSON, fold_objects: bool = True) -> int:
        """Journal upstream deltas as they are, at the upstream's rvs (the
        relay's publish path). ``entries`` are ``(Delta, frame_or_None)``
        pairs: the delta holds the decoded wire fields, ``frame`` the
        upstream's payload already chunk-framed, stored into the ``variant``
        array untouched, so ``serve_frame_encodes*`` stays 0 for relayed
        deltas. Every other variant journals a hole that a read fills.

        ``fold_objects=False`` is backfill: entries older than the adopted
        snapshot extend the journal and lower ``oldest_rv`` without touching
        the objects, which already reflect them.

        A skip in the upstream's rvs (it compacted this relay's stream)
        marks the journal sparse up to that rv; reads resuming below the
        mark are flagged compacted, so a downstream gap check gets the same
        sanction. Never handed to the WAL: a relay is a stateless edge and
        the root owns durability. Returns the entries journaled."""
        if not entries:
            return 0
        appended = 0
        first_rv = None
        with self._cond:
            for delta, frame in entries:
                rv = delta.rv
                if self._delta_rvs:
                    last = self._delta_rvs[-1]
                    if rv <= last:
                        continue  # already journaled by an earlier read
                    if rv > last + 1:
                        self._relay_sparse_rv = max(self._relay_sparse_rv, rv)
                elif fold_objects and rv > self._rv + 1:
                    # the first live entry after an adopt skips past the
                    # snapshot's rv: the same sanctioned hole
                    self._relay_sparse_rv = max(self._relay_sparse_rv, rv)
                if fold_objects:
                    map_key = (delta.kind, delta.key)
                    if delta.type == DELETE:
                        self._objects.pop(map_key, None)
                    else:
                        self._objects[map_key] = delta.object
                self._delta_rvs.append(rv)
                self._deltas.append(delta)
                for v in FRAME_VARIANTS:
                    self._frames[v].append(frame if v == variant else None)
                if first_rv is None:
                    first_rv = rv
                appended += 1
            if appended:
                self._rv = max(self._rv, self._delta_rvs[-1])
                # backfill lowers the horizon: tokens of the pre-adopt
                # journal resume from memory again
                self._oldest_rv = min(self._oldest_rv, first_rv - 1)
                self._trim_locked()
                if self._rv_gauge is not None:
                    self._rv_gauge.set(self._rv)
                self._cond.notify_all()
        if appended:
            if self._deltas_published is not None:
                self._deltas_published.inc(appended)
            for fn in self._wakeups:
                fn()
        return appended

    def note_upstream_rv(self, rv: int) -> int:
        """Take an upstream rv seen with no journal entry (a SYNC that
        outran the deltas held, when the upstream compacted or paged this
        stream): the journal goes sparse up to ``rv``, like a skip carried
        by a delta. Returns the view's rv, changed or not."""
        with self._cond:
            if rv <= self._rv:
                return self._rv
            self._rv = rv
            self._relay_sparse_rv = max(self._relay_sparse_rv, rv)
            if self._rv_gauge is not None:
                self._rv_gauge.set(self._rv)
            self._cond.notify_all()
        for fn in self._wakeups:
            fn()
        return rv

    # -- writing (pipeline thread + sink taps) ----------------------------

    def register_wakeup(self, fn: Callable[[], None]) -> None:
        """Register a post-publish hook, called outside the lock once per
        publish that applied at least one delta."""
        self._wakeups.append(fn)

    def unregister_wakeup(self, fn: Callable[[], None]) -> None:
        try:
            self._wakeups.remove(fn)
        except ValueError:
            pass

    def _encode_locked(self, delta: Delta) -> bytes:
        """The JSON frame of ``delta``, encoded under the lock before the
        delta is readable: the once of encode-once on the local paths."""
        t0 = time.perf_counter()
        frame = chunk_frame(delta.to_wire())
        if self._encode_seconds is not None:
            self._encode_seconds.record(time.perf_counter() - t0)
            self._frame_encodes.inc()
        return frame

    def _apply_locked(
        self,
        kind: str,
        key: str,
        obj: Optional[Dict[str, Any]],
        now: float,
        encode: bool = True,
        ts_wall: Optional[float] = None,
        pub_wall: float = 0.0,
        trace: Optional[Any] = None,
        frame: Optional[bytes] = None,
    ) -> bool:
        """One delta under the lock. False for no-ops (identical upsert, delete
        of an absent key): no rv, no journal entry. ``encode=False`` journals
        a hole in every frame array for the first read to fill; with a
        forwarded JSON ``frame`` payload (the sharded fan-in), the plain JSON
        slot gets that payload with this view's rv spliced in instead."""
        if self.columnar:
            if obj is None:
                if not self._objects.delete(kind, key):
                    return False
                delta_type = DELETE
            else:
                if not self._objects.upsert(kind, key, obj):
                    return False
                delta_type = UPSERT
        else:
            map_key = (kind, key)
            if obj is None:
                if self._objects.pop(map_key, None) is None:
                    return False
                delta_type = DELETE
            else:
                if self._objects.get(map_key) == obj:
                    return False
                self._objects[map_key] = obj
                delta_type = UPSERT
        self._rv += 1
        delta = Delta(self._rv, kind, key, delta_type, obj, now, ts_wall, pub_wall, trace)
        self._delta_rvs.append(self._rv)
        self._deltas.append(delta)
        if encode:
            json_frame: Optional[bytes] = self._encode_locked(delta)
        elif frame is not None:
            spliced = splice_frame_rv(frame, self._rv)
            json_frame = chunk_wrap(spliced) if spliced is not None else None
        else:
            json_frame = None
        self._frames[CODEC_JSON].append(json_frame)
        for variant in FRAME_VARIANTS[1:]:
            self._frames[variant].append(None)
        return True

    def _trim_locked(self) -> None:
        """Enforce the compaction horizon, in quarter-horizon chunks."""
        overflow = len(self._deltas) - self.compact_horizon
        if overflow < max(1, self.compact_horizon // 4):
            return
        self._oldest_rv = self._delta_rvs[overflow - 1]
        del self._delta_rvs[:overflow]
        del self._deltas[:overflow]
        for frames in self._frames.values():
            del frames[:overflow]

    def _published_locked(self, changed: int) -> None:
        if self._history is not None:
            # before the trim, so a horizon shorter than the batch never
            # costs the WAL a delta; the JSON frames ride along (holes are
            # re-packed by the writer)
            self._history.publish(self._deltas[-changed:], frames=self._frames[CODEC_JSON][-changed:])
        self._trim_locked()
        if self._rv_gauge is not None:
            self._rv_gauge.set(self._rv)
        self._cond.notify_all()

    def _after_publish(self, changed: int, t_start: float, t_end: float, *, batch: bool = True) -> None:
        """Metrics and wakeups, outside the lock (``serve_publish_seconds``
        times the batch paths only)."""
        if self._deltas_published is not None:
            self._deltas_published.inc(changed)
            if batch:
                self._publish_seconds.record(t_end - t_start)
            self._apply_seconds.record(t_end - t_start)
            if self.columnar:
                self._resident_bytes.set(self._objects.resident_bytes())
        for fn in self._wakeups:
            fn()

    def apply(self, kind: str, key: str, obj: Optional[Dict[str, Any]], *, ts_wall: Optional[float] = None,
              trace: Optional[Any] = None) -> bool:
        """Upsert (``obj``) or delete (``obj is None``) one object and wake the
        subscribers (the sink taps' path). ``ts_wall`` overrides the origin
        stamp (default: now); ``trace`` rides the ``?trace=1`` wire."""
        now = time.monotonic()
        wall = time.time()
        with self._cond:
            changed = self._apply_locked(kind, key, obj, now, ts_wall=ts_wall if ts_wall is not None else wall,
                                         pub_wall=wall, trace=trace)
            if changed:
                self._published_locked(1)
        if changed:
            self._after_publish(1, now, time.monotonic(), batch=False)
        return changed

    def apply_batch(self, items) -> int:
        """Fold a batch of ``(kind, key, obj_or_None)`` mutations under one
        lock hold, with one WAL hand-off and one wakeup. A fourth element
        carries the origin stamp ``ts_wall``, a fifth the journey's compact
        ``trace`` dict (the ``?trace=1`` field, forwarded as it is), a sixth
        the JSON frame payload a fan-in merge worker forwarded (the plain
        JSON slot is that payload with this view's rv spliced in). Other
        frames are journaled as holes that the first read in each variant
        fills. Returns the deltas minted."""
        now = time.monotonic()
        wall = time.time()
        changed = 0
        with self._cond:
            for item in items:
                ts = item[3] if len(item) > 3 and item[3] is not None else wall
                trace = item[4] if len(item) > 4 else None
                frame = item[5] if len(item) > 5 else None
                if self._apply_locked(item[0], item[1], item[2], now, encode=False, ts_wall=ts, pub_wall=wall,
                                      trace=trace, frame=frame):
                    changed += 1
            if changed:
                self._published_locked(changed)
        if changed:
            self._after_publish(changed, now, time.monotonic())
        return changed

    def publish_batch(self, events, results) -> int:
        """The pipeline hook: fold one processed batch into the view under one
        lock hold with one wakeup.

        Every event that passed the filters enters, ``no_significant_change``
        and gate-suppressed ones included (the view serves fields the pipeline
        does not weigh, such as ``node``); identical upserts are free. DELETED
        drops the key. Sampled journeys still open here (their only egress is
        the serving plane) get a ``serve_fanout`` span over this publish;
        handed-off journeys belong to the dispatcher's thread and are left
        alone."""
        t_start = time.monotonic()
        wall = time.time()
        changed = 0
        stamp = []
        applied_watch_stamps: List[float] = []
        with self._cond:
            for event, result in zip(events, results):
                if result.reason in NEVER_IN_VIEW:
                    continue
                ts_wall = getattr(event, "received_at", None) or wall
                trace = getattr(event, "trace", None)
                if event.type == EventType.DELETED:
                    meta = (event.pod or {}).get("metadata") or {}
                    applied = self._apply_locked("pod", pod_key(meta), None, t_start, ts_wall=ts_wall,
                                                 pub_wall=wall, trace=trace)
                else:
                    uid, obj = _pod_object(event)
                    applied = self._apply_locked("pod", uid, obj, t_start, ts_wall=ts_wall, pub_wall=wall,
                                                 trace=trace)
                if applied:
                    changed += 1
                    received = getattr(event, "received_monotonic", None)
                    if received is not None:
                        applied_watch_stamps.append(received)
                if trace is not None and not trace.handed_off:
                    stamp.append(trace)
            t_wal = 0.0
            if changed:
                if self._history is not None:
                    t_wal = time.monotonic()
                self._published_locked(changed)
        t_end = time.monotonic()
        for trace in stamp:
            trace.add_span("serve_fanout", t_start, t_end)
            if t_wal:
                # the WAL enqueue; disk time is the writer thread's
                # (history_wal_write_seconds)
                trace.add_span("wal_append", t_wal, t_end)
        if changed:
            if self._watch_to_local is not None:
                for received in applied_watch_stamps:
                    self._watch_to_local.record(max(0.0, t_end - received))
            self._after_publish(changed, t_start, t_end)
        return changed

    def observe_notification(self, notification) -> None:
        """Sink tap for the derived planes: slice aggregates and probe
        verdicts fold into the view on their way to the dispatcher. Pod
        payloads are ignored: pods enter through ``publish_batch``."""
        kind = notification.kind
        payload = notification.payload
        if kind == "slice":
            key = payload.get("slice")
            if not key:
                return
            transition = payload.get("phase_transition") or {}
            if transition.get("to") == "Terminated":
                self.apply("slice", key, None)
            else:
                self.apply("slice", key, {"kind": "slice", "key": key, **payload})
        elif kind == "probe":
            key = str(payload.get("host") or "local")
            self.apply("probe", key, {"kind": "probe", "key": key, **payload})

    # -- reading (serve plane / subscribers) ------------------------------

    @property
    def rv(self) -> int:
        with self._cond:
            return self._rv

    @property
    def oldest_rv(self) -> int:
        with self._cond:
            return self._oldest_rv

    def token_status(self, rv: int) -> str:
        """``OK``/``GONE``/``INVALID`` for a resume token without reading
        deltas: the pre-stream check costs two compares."""
        with self._cond:
            if rv > self._rv:
                return INVALID
            if rv < self._oldest_rv:
                return GONE
            return OK

    def snapshot(self) -> Tuple[int, List[Dict[str, Any]]]:
        """``(rv, objects)``: the structural snapshot is taken under the lock,
        the pod dicts are rebuilt from their fragments outside it."""
        with self._cond:
            if not self.columnar:
                return self._rv, list(self._objects.values())
            rv = self._rv
            snap = self._objects.snapshot_parts()
        return rv, [obj for _kind, _key, obj in iter_snapshot_objects(snap)]

    def snapshot_bytes(self, codec: str = CODEC_JSON) -> bytes:
        """The serialized ``GET /serve/fleet`` body, built at most once per
        ``(rv, codec)`` and served from cache while rv is unchanged; one
        codec's read never evicts the other's body."""
        with self._cond:
            cached = self._snapshot_cache.get(codec)
            if cached is not None and cached[0] == self._rv:
                if self._snap_hits is not None:
                    self._snap_hits.inc()
                    self._snap_hits_by_codec[codec].inc()
                return cached[1]
            rv = self._rv
            instance = self.instance
            if self.columnar:
                snap = self._objects.snapshot_parts()
                objects = None
            else:
                objects = list(self._objects.values())
        # serialized outside the lock: O(fleet) work must not stall publishes
        if codec == CODEC_MSGPACK and _msgpack is None:
            raise RuntimeError("msgpack codec requested but msgpack is not importable")
        if objects is None:
            if codec == CODEC_MSGPACK:
                data = assemble_msgpack_body(rv, instance, snap, lambda o: _msgpack.packb(o, use_bin_type=True))
            else:
                data = assemble_json_body(rv, instance, snap)
        elif codec == CODEC_MSGPACK:
            data = _msgpack.packb({"rv": rv, "view": instance, "objects": objects}, use_bin_type=True)
        else:
            data = json.dumps({"rv": rv, "view": instance, "objects": objects}).encode()
        with self._cond:
            self._snapshot_cache[codec] = (rv, data)
        if self._snap_misses is not None:
            self._snap_misses.inc()
            self._snap_misses_by_codec[codec].inc()
        return data

    def object_count(self) -> int:
        with self._cond:
            return len(self._objects)

    def snapshot_tables(self) -> Tuple[int, Dict[str, List[Dict[str, Any]]]]:
        """``(rv, {kind: [objects]})``: one object walk grouped by kind, built
        at most once per rv and shared by reference (treat it as immutable).
        The grouping happens outside the lock."""
        with self._cond:
            cached = self._tables_cache
            if cached is not None and cached[0] == self._rv:
                return cached
            rv = self._rv
            if self.columnar:
                snap = self._objects.snapshot_parts(with_keys=True)
                items = None
            else:
                items = list(self._objects.items())
        tables: Dict[str, List[Dict[str, Any]]] = {}
        if items is None:
            for kind, _key, obj in iter_snapshot_objects(snap):
                tables.setdefault(kind, []).append(obj)
        else:
            for (kind, _key), obj in items:
                tables.setdefault(kind, []).append(obj)
        result = (rv, tables)
        with self._cond:
            if self._rv == rv:
                self._tables_cache = result
        return result

    def fleet_columns(self):
        """``(rv, FleetColumns)`` straight off the columnar core, built at
        most once per generation and shared (columnar core only)."""
        with self._cond:
            return self._rv, self._objects.fleet_columns()

    def fleet_handle(self):
        """``(rv, PodHandle)``: the health plane's per-pod keys, phases and
        nodes plus the live slice objects, decoded from the columns at most
        once per generation (columnar core only; shared, read-only)."""
        with self._cond:
            return self._rv, self._objects.pod_handle()

    def federated_keys(self) -> List[Tuple[str, str, str]]:
        """``(kind, global_key, cluster)`` for every federated object: the
        merge registry's reseed, answered off the cluster column on the
        columnar core (no million-pod rebuild); the dict core walks."""
        with self._cond:
            if self.columnar:
                return self._objects.federated_entries()
            entries = []
            for (kind, key), obj in self._objects.items():
                cluster = obj.get("cluster") if isinstance(obj, dict) else None
                if cluster:
                    entries.append((kind, key, str(cluster)))
            return entries

    def freshness(self) -> Dict[str, Any]:
        """The local view's freshness watermark (``/debug/freshness``): the
        age of the newest published delta by the local publish stamp and by
        its origin wall stamp."""
        with self._cond:
            rv = self._rv
            objects = len(self._objects)
            last = self._deltas[-1] if self._deltas else None
        out: Dict[str, Any] = {
            "rv": rv,
            "objects": objects,
            "last_delta_age_seconds": round(time.monotonic() - last.t, 3) if last is not None else None,
        }
        if last is not None and last.ts_wall is not None:
            out["last_delta_origin_age_seconds"] = round(max(0.0, time.time() - last.ts_wall), 3)
        return out

    def read_since(self, rv: int, *, max_deltas: int = 128, limit: Optional[int] = None,
                   timeout: float = 0.0) -> ReadResult:
        """Deltas ``> rv``, the subscription primitive.

        - a token behind the horizon -> ``GONE``; ahead of the view ->
          ``INVALID``;
        - backlog ``<= max_deltas`` -> the raw contiguous range; more -> the
          range compacted latest-wins per key, flagged ``compacted``;
        - nothing pending -> wait up to ``timeout`` s, then an empty OK batch.

        ``limit`` is a page bound, never lossy: at most ``limit`` deltas, and
        ``to_rv`` retreats to the last one delivered. Non-positive = unpaged.
        """
        status, from_rv, to_rv, compacted, deltas, _ = self._read(rv, max_deltas, limit, timeout, want_frames=False)
        return ReadResult(status, from_rv, to_rv, compacted, deltas)

    def read_frames_since(self, rv: int, *, max_deltas: int = 128, limit: Optional[int] = None,
                          timeout: float = 0.0, codec: str = CODEC_JSON, fresh: bool = False,
                          traced: bool = False) -> FrameReadResult:
        """``read_since`` plus the wire frames of the chosen variant, encoded
        at most once per delta and shared by every subscriber pulling them."""
        return FrameReadResult(*self._read(rv, max_deltas, limit, timeout, want_frames=True,
                                           variant=frame_variant(codec, fresh, traced)))

    def _fill_frames(self, deltas: List[Delta], frames: List[Optional[bytes]], variant: str) -> None:
        """Encode the holes of one pulled slice off the publish lock, then
        memoize them into the master array under a short lock hold (found by
        rv bisect, so a delta trimmed meanwhile is simply not memoized). Two
        racing readers may both encode a hole: identical bytes."""
        traced = variant.endswith(TRACE_SUFFIX)
        base = variant[: -len(TRACE_SUFFIX)] if traced else variant
        fresh = base.endswith(FRESH_SUFFIX)
        codec = base[: -len(FRESH_SUFFIX)] if fresh else base
        t0 = time.perf_counter()
        encoded: List[Tuple[int, bytes]] = []
        for i, frame in enumerate(frames):
            if frame is None:
                frame = chunk_frame(deltas[i].to_wire(fresh=fresh, trace=traced), codec)
                frames[i] = frame
                encoded.append((deltas[i].rv, frame))
        if not encoded:
            return
        if self._encode_seconds is not None:
            self._encode_seconds.record(time.perf_counter() - t0)
            if traced:
                counter = self._frame_encodes_trace
            elif fresh:
                counter = self._frame_encodes_fresh
            else:
                counter = self._frame_encodes if codec == CODEC_JSON else self._frame_encodes_mp
            counter.inc(len(encoded))
        with self._cond:
            master = self._frames[variant]
            rvs = self._delta_rvs
            if not rvs:
                return  # a relay re-adopt emptied the journal meanwhile
            for frame_rv, frame in encoded:
                # found by rv, not by offset: a relay journal may be sparse
                pos = bisect_left(rvs, frame_rv)
                if pos < len(master) and rvs[pos] == frame_rv and master[pos] is None:
                    master[pos] = frame

    def _read(self, rv: int, max_deltas: int, limit: Optional[int], timeout: float, want_frames: bool,
              variant: str = CODEC_JSON) -> Tuple[str, int, int, bool, List[Delta], List[bytes]]:
        deadline = time.monotonic() + timeout if timeout > 0 else None
        frames: List[bytes] = []
        with self._cond:
            while True:
                if rv > self._rv:
                    return (INVALID, rv, rv, False, [], [])
                if rv < self._oldest_rv:
                    # covers falling behind while waiting, too
                    return (GONE, rv, rv, False, [], [])
                pending = self._rv - rv
                if pending:
                    break
                remaining = deadline - time.monotonic() if deadline is not None else 0.0
                if remaining <= 0:
                    return (OK, rv, rv, False, [], [])
                # one wait for the whole remaining window: publishes notify,
                # and GONE/INVALID can only change on a publish
                self._cond.wait(timeout=remaining)
            idx = bisect_right(self._delta_rvs, rv)
            to_rv = self._rv
            # only the slice happens under the lock; the latest-wins walk
            # below must not hold it
            deltas = self._deltas[idx:]
            if want_frames:
                frames = self._frames[variant][idx:]
            sparse_rv = self._relay_sparse_rv
        if not deltas:
            # a sparse relay journal only (note_upstream_rv moved rv past the
            # entries held): an empty batch to to_rv, sanctioned by the mark
            return (OK, rv, to_rv, rv < sparse_rv, [], [])
        oldest_pending_t = deltas[0].t
        # a relay journal may be sparse below the mark (the upstream
        # compacted this stream): resuming there is flagged compacted, so a
        # downstream gap check sees the skips sanctioned
        compacted = rv < sparse_rv
        if pending > max_deltas:
            # latest-wins per key: keep each key's last index; sorting the
            # indices keeps rv order and deltas/frames parallel
            latest: Dict[Tuple[str, str], int] = {}
            for i, delta in enumerate(deltas):
                latest[(delta.kind, delta.key)] = i
            order = sorted(latest.values())
            deltas = [deltas[i] for i in order]
            if want_frames:
                frames = [frames[i] for i in order]
            compacted = True
        if limit is not None and 0 < limit < len(deltas):
            deltas = deltas[:limit]
            if want_frames:
                frames = frames[:limit]
            to_rv = deltas[-1].rv
        if want_frames:
            # fill holes for exactly what this pull delivers
            self._fill_frames(deltas, frames, variant)
        if self._delta_lag is not None:
            self._delta_lag.record(time.monotonic() - oldest_pending_t)
        return (OK, rv, to_rv, compacted, deltas, frames)


def _pod_object(event) -> Tuple[str, Dict[str, Any]]:
    """The compact pod view object: what a fleet-state consumer needs to
    route and diagnose, not the whole manifest."""
    pod = event.pod or {}
    meta = pod.get("metadata") or {}
    status = pod.get("status") or {}
    uid = pod_key(meta)
    return uid, {
        "kind": "pod",
        "key": uid,
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", ""),
        "phase": status.get("phase", "Unknown"),
        "ready": pod_ready(pod),
        "node": (pod.get("spec") or {}).get("nodeName"),
        "pod_resource_version": meta.get("resourceVersion"),
    }


class Subscription:
    """One consumer's resumable cursor into the view: the cursor plus
    accounting (the journal is shared). Pull from one thread at a time."""

    __slots__ = ("view", "sub_id", "rv", "queue_depth", "pulls", "compacted_pulls", "resyncs")

    def __init__(self, view: FleetView, sub_id: int, rv: int, queue_depth: int):
        self.view = view
        self.sub_id = sub_id
        self.rv = rv
        self.queue_depth = queue_depth
        self.pulls = 0
        self.compacted_pulls = 0
        self.resyncs = 0

    def _advance(self, result):
        """The one cursor-advance rule of both pull shapes."""
        self.pulls += 1
        if result.status == OK:
            self.rv = result.to_rv
            if result.compacted:
                self.compacted_pulls += 1
        return result

    def pull(self, *, timeout: float = 0.0, limit: Optional[int] = None) -> ReadResult:
        """One cursor advance; ``queue_depth`` is the only lag-shedding
        trigger, ``limit`` only pages."""
        return self._advance(self.view.read_since(self.rv, max_deltas=self.queue_depth, limit=limit, timeout=timeout))

    def pull_frames(self, *, timeout: float = 0.0, limit: Optional[int] = None, codec: str = CODEC_JSON,
                    fresh: bool = False, traced: bool = False) -> FrameReadResult:
        """``pull`` with the wire frames of the chosen variant."""
        return self._advance(self.view.read_frames_since(
            self.rv, max_deltas=self.queue_depth, limit=limit, timeout=timeout, codec=codec, fresh=fresh,
            traced=traced))

    def rebase(self, rv: int) -> None:
        """Reset the cursor after a GONE -> re-snapshot resync."""
        self.rv = rv
        self.resyncs += 1


class SubscriptionHub:
    """Registry and admission control: at most ``max_subscribers`` live
    subscriptions; owns the subscriber-count gauge."""

    def __init__(self, view: FleetView, *, max_subscribers: int = 5000, queue_depth: int = 128, metrics=None):
        self.view = view
        self.max_subscribers = max(1, int(max_subscribers))
        self.queue_depth = max(1, int(queue_depth))
        self._lock = threading.Lock()
        self._active: Dict[int, Subscription] = {}
        self._next_id = 0
        self._rejected = metrics.counter("serve_subscribers_rejected") if metrics else None
        self._gauge = metrics.gauge("serve_subscribers") if metrics else None

    def subscribe(self, rv: Optional[int] = None) -> Optional[Subscription]:
        """A subscription resuming from ``rv`` (default: now); None when the
        hub is full."""
        with self._lock:
            if len(self._active) >= self.max_subscribers:
                if self._rejected is not None:
                    self._rejected.inc()
                return None
            self._next_id += 1
            sub = Subscription(self.view, self._next_id, rv if rv is not None else self.view.rv, self.queue_depth)
            self._active[sub.sub_id] = sub
            if self._gauge is not None:
                self._gauge.set(len(self._active))
            return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            self._active.pop(sub.sub_id, None)
            if self._gauge is not None:
                self._gauge.set(len(self._active))

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)
