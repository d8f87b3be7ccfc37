"""Durable fleet history: a segmented, CRC-framed delta WAL (the JAX
package's ``history/wal.py``).

The serving plane's delta journal (serve/view.py) lives in memory. This is
the persistence layer under it, so a restart keeps the rv line, the resume
tokens and the history a postmortem reads:

- every ``FleetView`` delta is appended to an append-only **WAL**, framed
  ``length(4B BE) + crc32(4B BE) + payload`` (msgpack, or compact JSON
  when msgpack is not importable);
- the WAL is **segmented**: the active segment rotates once it outgrows
  ``segment_max_bytes`` or ``segment_max_age_seconds``, and every segment
  opens with a full snapshot record of the state at rotation, so any
  retained segment is a self-contained recovery and time-travel anchor;
- **retention** keeps the newest ``retain_segments`` segments; the oldest
  retained segment's snapshot is the durable horizon (resume tokens and
  ``?at=`` reads 410 only past it);
- the **fsync policy** (``never`` / ``interval`` / ``always``) trades
  durability for write cost; ``interval`` bounds the crash-loss window
  without a sync per batch;
- a crash tears at most the tail of the active segment: the frame CRC
  finds the tear, and the writer truncates it when it reopens the
  directory (readers stop at it).

:meth:`HistoryStore.publish` is called by the view under its publish lock
(which keeps the WAL rv-ordered across the pipeline thread and the sink
taps), so it is O(1): it queues the delta references and returns. A writer
thread serializes, frames, rotates, writes and fsyncs, so disk latency never
rides the publish path. The writer keeps its own shadow of the fleet state,
advanced as it writes, so snapshot records agree exactly with the delta
prefix on disk.

If the writer falls ``max_queue_deltas`` behind (a wedged disk), the backlog
is dropped and counted (``history_wal_overruns``) and the next record is a
rebase snapshot of the live view: the WAL stays self-consistent at the cost
of a hole in the delta history.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# msgpack packs a drain batch several times faster than json.dumps; without
# it the payloads are JSON, and the decoder reads either (the frame CRC, not
# the codec, is the integrity check)
try:
    import msgpack as _msgpack
except ImportError:
    _msgpack = None

#: frame header: payload length + payload crc32, both 4-byte big-endian
FRAME_HEADER = struct.Struct(">II")
#: a length field above this is treated as corruption, not a record
MAX_RECORD_BYTES = 32 * 1024 * 1024
#: segment file naming: wal-<8-digit seq>.seg, seq strictly increasing
SEGMENT_RE = re.compile(r"^wal-(\d{8})\.seg$")

#: record types
SNAP = "snap"  # full shadow-state snapshot (opens every segment)
#: a BATCH of FleetView deltas: one framed record per writer drain, so
#: the per-delta cost is one list element inside one encode, not a dict
#: build + encode + crc + frame each. items: [[rv, kind, key, op, obj-or-null], ...]
#: — or, on the msgpack codec when the publisher handed over the delta's
#: already-encoded serve frame, the obj column holds the frame's JSON
#: payload BYTES instead of the dict (packed as bin = one memcpy, no
#: per-field re-pack; ``item_object`` decodes on read). rv-ascending and
#: contiguous within a record.
DELTAS = "d"
#: delta ops inside a DELTAS record
OP_UPSERT = "U"
OP_DELETE = "D"
#: bound on deltas per record: keeps one frame's blast radius (a torn
#: tail loses at most one frame) and memory bounded under huge drains; a
#: record is at most a few MB of pod skeletons, far under MAX_RECORD_BYTES
MAX_DELTAS_PER_RECORD = 16384

FSYNC_POLICIES = ("never", "interval", "always")


def codec() -> str:
    """The payload codec this process writes: ``"msgpack"`` or ``"json"``."""
    return "msgpack" if _msgpack is not None else "json"


def encode_record(record: Dict[str, Any], *, sort: bool = False) -> bytes:
    """Compact record bytes (msgpack; JSON when msgpack is absent).
    Record bytes are deterministic either way (fixed key order, sorted
    snapshot objects), but replay determinism is defined over the
    canonical TERMINAL snapshot (history/replay.py), not raw WAL bytes.
    ``sort`` only affects the JSON fallback."""
    if _msgpack is not None:
        return _msgpack.packb(record, use_bin_type=True)
    return json.dumps(record, separators=(",", ":"), sort_keys=sort).encode()


def decode_record(payload: bytes):
    """Payload bytes -> record dict, or None when neither codec parses
    (the CRC already vouched for the bytes; this failing means a foreign
    writer, not a tear)."""
    if _msgpack is not None:
        try:
            return _msgpack.unpackb(payload, raw=False, strict_map_key=False)
        except Exception:  # noqa: BLE001 - fall through to the JSON fallback
            pass
    try:
        return json.loads(payload)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return None


def frame(payload: bytes) -> bytes:
    return FRAME_HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def read_frames(data: bytes) -> Tuple[List[Dict[str, Any]], int, bool]:
    """Decode ``(records, clean_bytes, torn)`` from raw segment bytes.

    Stops at the first bad frame (short header, short payload, CRC or
    JSON mismatch, absurd length): everything before it is intact,
    everything after is unordered relative to the tear. ``clean_bytes``
    is the offset of the tear (== len(data) when the segment is clean).
    """
    records: List[Dict[str, Any]] = []
    offset = 0
    size = len(data)
    header = FRAME_HEADER
    while offset + header.size <= size:
        length, crc = header.unpack_from(data, offset)
        start = offset + header.size
        end = start + length
        if length == 0 or length > MAX_RECORD_BYTES or end > size:
            return records, offset, True
        payload = data[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return records, offset, True
        record = decode_record(payload)
        if not isinstance(record, dict) or "t" not in record:
            return records, offset, True
        records.append(record)
        offset = end
    return records, offset, offset != size


def segment_path(directory: Path, seq: int) -> Path:
    return directory / f"wal-{seq:08d}.seg"


def list_segments(directory: Path) -> List[Tuple[int, Path]]:
    """``(seq, path)`` pairs sorted by seq; ignores foreign files."""
    out: List[Tuple[int, Path]] = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        m = SEGMENT_RE.match(name)
        if m:
            out.append((int(m.group(1)), directory / name))
    out.sort()
    return out


def snapshot_record(
    rv: int,
    instance: str,
    state: Dict[Tuple[str, str], Dict[str, Any]],
    *,
    final: bool = False,
) -> Dict[str, Any]:
    """The segment-opening (and rebase / shutdown) full-state record.
    Objects are sorted by (kind, key), so identical state always encodes
    to identical bytes. ``final=True`` marks the terminal snapshot a
    clean close() writes — the marker recovery's clean-shutdown verdict
    keys off (an UNCLEAN end means acked-but-unwritten deltas may be
    lost, and the serve plane must mint a fresh view instance)."""
    record = {
        "t": SNAP,
        "rv": rv,
        "instance": instance,
        "wall": round(time.time(), 3),
        "objects": [
            [kind, key, state[(kind, key)]]
            for kind, key in sorted(state)
        ],
    }
    if final:
        record["final"] = True
    return record


def deltas_record(deltas, frames=None) -> Dict[str, Any]:
    """A batch of serve.view.Delta -> ONE WAL record (see ``DELTAS``).
    One wall stamp per record (forensics), not per delta.

    ``frames`` (parallel to ``deltas``, entries may be None) carries each
    delta's already-encoded chunk-framed JSON serve frame. On the msgpack
    codec, when EVERY delta in the batch has its frame (the eager-encode
    publish paths always do), the record is the frames CONCATENATED as
    one bin blob (``"f"``) — a join plus one memcpy into the record, no
    per-delta re-serialization at all; the chunk framing keeps the blob
    self-delimiting and each payload line carries rv/type/kind/key/object
    in full (``record_items`` decodes). A batch with holes falls back to
    the per-item ``"items"`` column shape, reusing frame payload bytes as
    the obj column where present (``item_object`` decodes). The JSON
    fallback codec cannot embed bytes, so it keeps packing dicts
    (correctness first)."""
    wall = round(time.time(), 3)
    if (
        frames is not None
        and _msgpack is not None
        and len(frames) == len(deltas)
        and None not in frames
    ):
        return {"t": DELTAS, "wall": wall, "f": b"".join(frames)}
    items = []
    reuse = frames is not None and _msgpack is not None
    for i, d in enumerate(deltas):
        if d.object is None:
            items.append([d.rv, d.kind, d.key, OP_DELETE, None])
            continue
        obj: Any = d.object
        if reuse:
            fr = frames[i]
            if fr is not None:
                head_end = fr.index(b"\r\n")
                obj = bytes(fr[head_end + 2:-2])  # strip chunk framing
        items.append([d.rv, d.kind, d.key, OP_UPSERT, obj])
    return {
        "t": DELTAS,
        "wall": wall,
        "items": items,
    }


def item_object(obj):
    """The obj column of one DELTAS item -> the object dict (or None).
    Frame-payload BYTES columns (see ``deltas_record``) decode through
    the wire line's ``object`` field; dict columns pass through."""
    if isinstance(obj, (bytes, bytearray)):
        return json.loads(obj).get("object")
    return obj


def record_items(record: Dict[str, Any]):
    """One DELTAS record -> its ``[rv, kind, key, op, obj-or-bytes]``
    items, whichever shape the writer chose (``"items"`` column lists,
    or the ``"f"`` concatenated-frames blob — decoded here by walking
    the chunk framing and reading each payload line's wire fields).
    Callers still pass the obj column through ``item_object``."""
    blob = record.get("f")
    if not blob:
        return record.get("items", ())
    items = []
    off, size = 0, len(blob)
    while off < size:
        head_end = blob.index(b"\r\n", off)
        length = int(blob[off:head_end], 16)
        start = head_end + 2
        line = json.loads(blob[start:start + length])
        off = start + length + 2
        items.append([
            line.get("rv"),
            line.get("kind"),
            line.get("key"),
            OP_DELETE if line.get("type") == "DELETE" else OP_UPSERT,
            line.get("object"),
        ])
    return items


class _Segment:
    """The writer's view of one on-disk segment (active or sealed)."""

    __slots__ = ("seq", "path", "bytes", "records", "first_rv", "last_rv", "opened_monotonic")

    def __init__(self, seq: int, path: Path):
        self.seq = seq
        self.path = path
        self.bytes = 0
        self.records = 0
        self.first_rv: Optional[int] = None
        self.last_rv: Optional[int] = None
        self.opened_monotonic = time.monotonic()

    def note(self, rv: int, nbytes: int, nrecords: int = 1) -> None:
        self.bytes += nbytes
        self.records += nrecords
        if self.first_rv is None:
            self.first_rv = rv
        self.last_rv = rv

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.path.name,
            "seq": self.seq,
            "bytes": self.bytes,
            "records": self.records,
            "first_rv": self.first_rv,
            "last_rv": self.last_rv,
            "age_seconds": round(time.monotonic() - self.opened_monotonic, 1),
        }


class HistoryStore:
    """The durable history plane: WAL writer + recovery/read surface.

    Lifecycle::

        store = HistoryStore(dir, ...)        # scans + truncates torn tail
        recovered = store.recover()           # -> recovery.RecoveredState
        view.restore(...recovered...)         # caller rebuilds the view
        store.open(view.instance)             # writer thread starts
        view.attach_history(store)            # publishes flow in
        ...
        store.close()                         # drain + final snapshot + fsync

    ``publish`` is the only hot-path entry point (O(1) enqueue, called
    under the view's publish lock — see the module docstring for why the
    lock ordering is what keeps the WAL rv-ordered).
    """

    def __init__(
        self,
        directory: os.PathLike | str,
        *,
        segment_max_bytes: int = 8 * 1024 * 1024,
        segment_max_age_seconds: float = 3600.0,
        retain_segments: int = 8,
        fsync: str = "interval",
        fsync_interval_seconds: float = 1.0,
        max_queue_deltas: int = 65536,
        metrics=None,  # metrics.MetricsRegistry, optional
    ):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync policy must be one of {FSYNC_POLICIES}, got {fsync!r}")
        self.directory = Path(directory)
        self.segment_max_bytes = max(4096, int(segment_max_bytes))
        self.segment_max_age_seconds = float(segment_max_age_seconds)
        self.retain_segments = max(2, int(retain_segments))
        self.fsync = fsync
        self.fsync_interval_seconds = max(0.01, float(fsync_interval_seconds))
        self.max_queue_deltas = max(1024, int(max_queue_deltas))
        self.metrics = metrics
        self.instance: Optional[str] = None
        # Callable[[], (rv, {(kind, key): obj})] — the live view's state,
        # used ONLY on overrun rebase: the dropped backlog means the
        # shadow no longer equals the view, so the rebase snapshot must
        # come from the source of truth (FleetView.state_for_history;
        # attach_history wires it)
        self.state_provider = None

        self._cond = threading.Condition()
        # deque[(deltas, frames-or-None)] — see publish()
        self._queue: collections.deque = collections.deque()
        self._queued = 0
        self._overrun = False  # queue blew past the cap; writer must rebase
        self._stop = False
        self._thread: Optional[threading.Thread] = None

        # writer-thread state (only the writer touches these after open(),
        # except under _cond for the stats/segments snapshot)
        self._state: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._rv = 0  # last rv written durably (well: handed to the OS)
        self._fh = None
        self._segments: List[_Segment] = []
        self._next_seq = 1
        self._last_fsync = time.monotonic()
        self._recovered = None  # recovery.RecoveredState after recover()
        # bumped whenever retained history RESHAPES under existing rvs —
        # overrun rebase (an rv hole opens) and retention deletion (the
        # floor moves): the serve plane's ?at= reconstruction LRU keys on
        # this, so anything that can change what an rv reconstructs to
        # (or whether it still can) invalidates cached bodies by simply
        # no longer matching their key
        self._cache_epoch = 0

        if metrics is not None:
            self._deltas_counter = metrics.counter("history_wal_deltas")
            self._records_counter = metrics.counter("history_wal_records")
            self._bytes_counter = metrics.counter("history_wal_bytes")
            self._fsync_counter = metrics.counter("history_wal_fsyncs")
            self._overrun_counter = metrics.counter("history_wal_overruns")
            self._snap_counter = metrics.counter("history_snapshots")
            self._segments_gauge = metrics.gauge("history_segments")
            self._rv_gauge = metrics.gauge("history_wal_rv")
            self._queue_gauge = metrics.gauge("history_wal_queue_depth")
            self._write_seconds = metrics.histogram("history_wal_write_seconds")
        else:
            self._deltas_counter = None
            self._records_counter = self._bytes_counter = self._fsync_counter = None
            self._overrun_counter = self._snap_counter = None
            self._segments_gauge = self._rv_gauge = self._queue_gauge = None
            self._write_seconds = None

    # -- recovery ---------------------------------------------------------

    def recover(self, *, journal_limit: int = 8192):
        """Scan the WAL directory, truncate the active segment's torn
        tail, rebuild the terminal state + the last ``journal_limit``
        deltas, and prime the writer's shadow. Returns the
        ``history.recovery.RecoveredState``."""
        from k8s_watcher_tpu_torch.history.recovery import recover_state

        self.directory.mkdir(parents=True, exist_ok=True)
        t0 = time.monotonic()
        recovered = recover_state(self.directory, journal_limit=journal_limit, truncate_tail=True)
        self._recovered = recovered
        self._state = dict(recovered.objects)
        self._rv = recovered.rv
        self.instance = recovered.instance
        self._segments = []
        for seq, path in list_segments(self.directory):
            seg = _Segment(seq, path)
            try:
                seg.bytes = path.stat().st_size
            except OSError:
                seg.bytes = 0
            info = recovered.segment_rvs.get(seq)
            if info is not None:
                seg.first_rv, seg.last_rv, seg.records = info
            self._segments.append(seg)
            self._next_seq = max(self._next_seq, seq + 1)
        if self._segments:
            logger.info(
                "History WAL recovered: rv=%d instance=%s segments=%d journal=%d%s",
                recovered.rv, recovered.instance, len(self._segments),
                len(recovered.journal),
                f" (truncated {recovered.truncated_bytes}B torn tail)" if recovered.truncated_bytes else "",
            )
        return recovered

    # -- lifecycle --------------------------------------------------------

    def open(self, instance: str) -> "HistoryStore":
        """Adopt the view's instance id and start the writer. On a cold
        directory (or after the view minted a fresh instance) the first
        thing written is a snapshot record of the current shadow state,
        so the WAL is never without a recovery anchor."""
        if self._thread is not None:
            return self
        self.directory.mkdir(parents=True, exist_ok=True)
        self.instance = instance
        if not self._segments:
            self._open_segment(write_snapshot=True)
        else:
            # append to the recovered active segment
            active = self._segments[-1]
            try:
                self._fh = open(active.path, "ab")
                # dirty marker: once this incarnation is appending, the
                # previous terminal snapshot is no longer the last record
                # — a crash from here on reads as UNCLEAN even if no
                # delta ever hits the disk (acked-but-unwritten deltas
                # may still have existed). Readers skip unknown types.
                self._write_bytes(frame(encode_record({"t": "open", "wall": round(time.time(), 3)})), self._rv, 1)
                self._sync(force=self.fsync != "never")
            except OSError as exc:
                logger.error("Could not reopen WAL segment %s (%s); rotating", active.path, exc)
                self._open_segment(write_snapshot=True)
        self._stop = False
        self._thread = threading.Thread(target=self._writer, name="history-wal", daemon=True)
        self._thread.start()
        return self

    @property
    def writer_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def recovered(self):
        """The :meth:`recover` result (None before recover ran)."""
        return self._recovered

    def close(self, *, final_snapshot: bool = True, timeout: float = 10.0) -> None:
        """Drain the queue, optionally write a terminal snapshot record
        (the fast-recovery anchor a clean SIGTERM leaves behind), fsync,
        and stop the writer. ``final_snapshot=False`` stops WITHOUT the
        terminal anchor — the 'pause' shape crash tests use."""
        thread = self._thread
        if thread is None:
            self._close_fh()
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        thread.join(timeout=timeout)
        if thread.is_alive():
            # wedged writer (stalled disk/NFS): do NOT touch the shared
            # file handle or shadow from this thread — interleaved writes
            # would tear the active segment. Leave the daemon detached
            # (it exits when it unwedges; _stop rejects new publishes);
            # the missing terminal snapshot makes the next boot read the
            # WAL as unclean, which is the truth.
            logger.error(
                "History WAL writer did not stop within %.1fs; detaching without a terminal snapshot",
                timeout,
            )
            return
        self._thread = None
        # the writer exited with the queue drained; anything left arrived
        # in the closing race — write it from this thread
        self._drain_once()
        if final_snapshot and self._fh is not None and self.instance is not None:
            self._write_snapshot(final=True)
        self._sync(force=self.fsync != "never")
        self._close_fh()

    def _close_fh(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    # -- hot path ---------------------------------------------------------

    def publish(self, deltas: Sequence, frames: Optional[Sequence] = None) -> None:
        """O(1) hand-off, called under the view's publish lock (that
        ordering IS the WAL's rv ordering). Never blocks on IO.
        ``frames`` (optional, parallel to ``deltas``, entries may be
        None) lets the writer reuse already-encoded serve frame bytes
        instead of re-packing objects — see ``deltas_record``."""
        with self._cond:
            if self._stop:
                return
            # callers hand over a fresh slice (never mutated after) — no
            # defensive copy on the hot path
            self._queue.append((deltas, frames))
            self._queued += len(deltas)
            if self._queued > self.max_queue_deltas:
                # wedged disk: drop the backlog, rebase with a snapshot
                dropped = self._queued
                self._queue.clear()
                self._queued = 0
                self._overrun = True
                if self._overrun_counter is not None:
                    self._overrun_counter.inc(dropped)
                logger.error(
                    "History WAL writer fell %d deltas behind; dropped backlog, "
                    "will rebase with a snapshot record", dropped,
                )
            self._cond.notify()

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until everything queued at call time is on disk (well,
        handed to the OS; fsync still follows the policy). The barrier
        ``reconstruct`` and the replay paths use."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._cond.notify_all()
            while self._queue or self._queued:
                if self._thread is None or not self._thread.is_alive():
                    # a dead writer with _queued deltas popped-but-unwritten
                    # means the barrier did NOT hold — never report success
                    return not self._queue and not self._queued
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.1))
        return True

    # -- writer thread ----------------------------------------------------

    def _writer(self) -> None:
        while True:
            idle_sync = False
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=min(0.5, self.fsync_interval_seconds))
                    if self.fsync == "interval" and not self._queue and not self._stop:
                        # idle clusters still get their crash-loss bound:
                        # without this, a batch written just after the
                        # previous fsync would sit unsynced until the
                        # NEXT publish — indefinitely on a quiet fleet.
                        # The sync itself runs OUTSIDE the cond (file IO
                        # must never block publish); _sync re-checks the
                        # interval, so early wakes are free.
                        idle_sync = True
                        break
                if not self._queue and self._stop:
                    return
            if idle_sync:
                self._sync()
                continue
            self._drain_once()
            if self.fsync == "interval":
                self._sync()

    def _drain_once(self) -> None:
        """Write everything currently queued as one buffered write (plus
        rotation / rebase snapshots as needed)."""
        with self._cond:
            batches = list(self._queue)
            self._queue.clear()
            overrun = self._overrun
            self._overrun = False
        if overrun:
            # rebase: the dropped backlog left a hole, so re-anchor on a
            # snapshot of the LIVE view (the shadow is stale past the
            # hole); recovery clears its journal across the rv jump
            self._cache_epoch += 1
            if self.state_provider is not None:
                try:
                    self._rv, state = self.state_provider()
                    self._state = dict(state)
                except Exception:  # noqa: BLE001 — never kill the writer
                    logger.exception("History state provider failed during rebase")
            self._maybe_rotate()
            self._write_snapshot()
        if not batches:
            with self._cond:
                self._queued = 0
                self._cond.notify_all()
            return
        t0 = time.monotonic()
        self._maybe_rotate()
        flat = []
        flat_frames = []
        for deltas, frames in batches:
            flat.extend(deltas)
            if frames is None:
                flat_frames.extend([None] * len(deltas))
            else:
                flat_frames.extend(frames)
        count = len(flat)
        last_rv = self._rv
        buf = bytearray()
        nrecords = 0
        for start in range(0, count, MAX_DELTAS_PER_RECORD):
            chunk = flat[start:start + MAX_DELTAS_PER_RECORD]
            fchunk = flat_frames[start:start + MAX_DELTAS_PER_RECORD]
            buf += frame(encode_record(deltas_record(chunk, fchunk)))
            nrecords += 1
        if flat:
            last_rv = flat[-1].rv
        written = bool(buf) and self._write_bytes(bytes(buf), last_rv, nrecords)
        if flat and not written:
            # the disk refused (open/write failure): these deltas are
            # LOST — count them so /metrics shows durable history
            # silently bleeding, and leave the shadow un-folded so the
            # next snapshot stays consistent with what is actually on
            # disk (the rv hole makes recovery clear journal continuity)
            if self._overrun_counter is not None:
                self._overrun_counter.inc(count)
            logger.error("History WAL dropped %d deltas on write failure", count)
        if written:
            self._rv = last_rv
            # advance the shadow AFTER the write sticks, so snapshots
            # stay exactly consistent with the delta prefix ON DISK —
            # a failed write leaves an rv hole (recovery clears journal
            # continuity across it), never deltas smuggled into a
            # snapshot without their rvs
            state = self._state
            for delta in flat:
                if delta.object is None:
                    state.pop((delta.kind, delta.key), None)
                else:
                    state[(delta.kind, delta.key)] = delta.object
            if self._deltas_counter is not None:
                self._deltas_counter.inc(count)
        if self._fh is not None:
            # hand the buffered bytes to the OS once per drain (NOT an
            # fsync): concurrent readers — ?at= reconstruction, replay,
            # the flush() barrier's contract — read the files directly
            try:
                self._fh.flush()
            except OSError as exc:
                logger.error("History WAL buffer flush failed: %s", exc)
        if self.fsync == "always":
            self._sync(force=True)
        if self._write_seconds is not None:
            self._write_seconds.record(time.monotonic() - t0)
        if self._rv_gauge is not None:
            self._rv_gauge.set(self._rv)
        with self._cond:
            self._queued = max(0, self._queued - count)
            if not self._queue:
                self._queued = 0
            self._cond.notify_all()
        if self._queue_gauge is not None:
            self._queue_gauge.set(self._queued)

    def _write_bytes(self, blob: bytes, last_rv: int, nrecords: int) -> bool:
        if self._fh is None:
            self._open_segment(write_snapshot=True)
            if self._fh is None:
                return False  # disk refused; deltas are lost (counted)
        try:
            self._fh.write(blob)
        except OSError as exc:
            logger.error("History WAL write failed: %s", exc)
            self._close_fh()
            return False
        seg = self._segments[-1]
        seg.note(last_rv, len(blob), nrecords)
        if self._records_counter is not None:
            self._records_counter.inc(nrecords)
            self._bytes_counter.inc(len(blob))
        return True

    def _write_snapshot(self, *, final: bool = False) -> bool:
        payload = encode_record(
            snapshot_record(self._rv, self.instance or "", self._state, final=final),
            sort=True,
        )
        ok = self._write_bytes(frame(payload), self._rv, 1)
        if ok and self._snap_counter is not None:
            self._snap_counter.inc()
        return ok

    def _sync(self, force: bool = False) -> None:
        if self._fh is None:
            return
        now = time.monotonic()
        if not force and now - self._last_fsync < self.fsync_interval_seconds:
            return
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._last_fsync = now
            if self._fsync_counter is not None:
                self._fsync_counter.inc()
        except OSError as exc:
            logger.warning("History WAL fsync failed: %s", exc)

    def _maybe_rotate(self) -> None:
        if self._fh is None or not self._segments:
            return
        active = self._segments[-1]
        if (
            active.bytes >= self.segment_max_bytes
            or time.monotonic() - active.opened_monotonic >= self.segment_max_age_seconds
        ):
            self._sync(force=self.fsync != "never")
            self._close_fh()
            self._open_segment(write_snapshot=True)
            self._enforce_retention()

    def _open_segment(self, write_snapshot: bool) -> None:
        seq = self._next_seq
        path = segment_path(self.directory, seq)
        try:
            self.directory.mkdir(parents=True, exist_ok=True)
            self._fh = open(path, "ab")
        except OSError as exc:
            logger.error("Could not open WAL segment %s: %s", path, exc)
            self._fh = None
            return
        self._next_seq = seq + 1
        with self._cond:
            self._segments.append(_Segment(seq, path))
        if self._segments_gauge is not None:
            self._segments_gauge.set(len(self._segments))
        if write_snapshot and self.instance is not None:
            self._write_snapshot()

    def _enforce_retention(self) -> None:
        while len(self._segments) > self.retain_segments:
            with self._cond:
                victim = self._segments.pop(0)
            # the retention floor moved: rvs under it stop reconstructing,
            # so cached ?at= bodies keyed on the old epoch must die
            self._cache_epoch += 1
            try:
                victim.path.unlink()
            except OSError as exc:
                logger.warning("Could not delete expired WAL segment %s: %s", victim.path, exc)
        if self._segments_gauge is not None:
            self._segments_gauge.set(len(self._segments))

    # -- read surface (time travel / debug) -------------------------------

    @property
    def cache_epoch(self) -> int:
        """Monotonic counter naming the current shape of retained history
        (bumped on overrun rebase and retention deletion) — the serve
        plane's ``?at=`` LRU cache-key component."""
        return self._cache_epoch

    def retention_floor_rv(self) -> int:
        """The oldest rv reconstructible from retained segments: the
        opening snapshot rv of the oldest segment (0 on a cold WAL)."""
        with self._cond:
            for seg in self._segments:
                if seg.first_rv is not None:
                    return seg.first_rv
        return 0

    def reconstruct(self, at_rv: int, *, flush_timeout: float = 2.0):
        """Rebuild the fleet state as of ``at_rv`` from snapshot+deltas.

        Returns ``(status, rv, objects)`` where status is ``"ok"``
        (objects is the ``{(kind, key): obj}`` map at exactly ``at_rv``),
        ``"gone"`` (``at_rv`` precedes the retention horizon; rv carries
        the floor) or ``"future"`` (``at_rv`` was never written; rv
        carries the newest durable rv). Reads sealed files end to end —
        a forensic path, deliberately not the hot one.
        """
        from k8s_watcher_tpu_torch.history.recovery import reconstruct_at

        self.flush(timeout=flush_timeout)
        return reconstruct_at(self.directory, at_rv)

    def stats(self) -> Dict[str, Any]:
        """The ``/debug/history`` segment inventory."""
        with self._cond:
            segments = [seg.to_dict() for seg in self._segments]
            queued = self._queued
        return {
            "dir": str(self.directory),
            "instance": self.instance,
            "fsync": self.fsync,
            "fsync_interval_seconds": self.fsync_interval_seconds,
            "segment_max_bytes": self.segment_max_bytes,
            "segment_max_age_seconds": self.segment_max_age_seconds,
            "retain_segments": self.retain_segments,
            "writer_alive": self.writer_alive,
            "durable_rv": self._rv,
            "retention_floor_rv": self.retention_floor_rv(),
            "queued_deltas": queued,
            "segments": segments,
            "total_bytes": sum(s["bytes"] for s in segments),
        }

    def health(self) -> Dict[str, Any]:
        """Folded into the serve plane's health: a dead writer thread
        means deltas silently stop persisting."""
        alive = self._thread is None or self._thread.is_alive()
        return {"healthy": alive, "writer_alive": self.writer_alive, "durable_rv": self._rv}
