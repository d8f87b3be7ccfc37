"""Generic supervised worker-pool wire (the JAX package's
``parallel/procpool.py``), on which the ingest tier (``watch/procpool.py``)
runs its reader processes.

What lives here is everything about a supervised child process that is
NOT specific to what the child streams:

- the length-prefixed pipe wire: one ``multiprocessing.Connection`` frame
  per message, payload a dict packed msgpack-first (JSON fallback), the
  first byte tagging the codec so a mixed pair still interoperates;
- the parent-side ``SupervisedEndpoint``: spawn (the spawn start method:
  never fork a parent that holds threads and a CUDA context), per-spawn
  sequence accounting (pipes cannot reorder, so a seq mismatch is a
  counted codec/framing tripwire, never a silent hole), hello/stats/eos
  control frames, cumulative counters across incarnations, and the
  respawn loop — jittered exponential backoff, reset after a spawn that
  delivered work;
- the worker-side contract (documented, enforced by the caller): hello
  first, then ``{"s": seq, "b": [...]}`` payload messages with ``seq``
  counting ITEMS (not messages), ``{"stats": {...}}`` at a bounded
  interval, and ``{"eos": True}`` exactly once on a clean SIGTERM drain.
  An unexpected EOF (no EOS) is the respawn path.

What a payload item is and what the child runs stay in the tier's module.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import multiprocessing
import random
import threading
import time
from typing import Any, Dict, Iterator, Optional

from k8s_watcher_tpu_torch.trace import trace_from_wire

logger = logging.getLogger(__name__)

try:  # the serve plane's optional codec dependency, reused for the wire
    import msgpack  # type: ignore
except Exception:  # noqa: BLE001 — absence is a supported configuration
    msgpack = None

TAG_MSGPACK = b"M"
TAG_JSON = b"J"

#: sentinel: "use this module's own msgpack import" (callers pass their
#: OWN module global instead so tests can strip one side's codec)
_DEFAULT_CODEC = object()


def pack(obj: Dict[str, Any], codec: Any = _DEFAULT_CODEC) -> bytes:
    """Dict -> tagged wire bytes. ``codec`` is the msgpack module to use
    (or None to force the JSON fallback); defaults to this module's."""
    mp = msgpack if codec is _DEFAULT_CODEC else codec
    if mp is not None:
        return TAG_MSGPACK + mp.packb(obj, use_bin_type=True)
    return TAG_JSON + json.dumps(obj).encode()


def unpack(data: bytes, codec: Any = _DEFAULT_CODEC) -> Dict[str, Any]:
    mp = msgpack if codec is _DEFAULT_CODEC else codec
    tag, payload = data[:1], data[1:]
    if tag == TAG_MSGPACK:
        if mp is None:
            raise ValueError("msgpack frame received but msgpack is unavailable")
        return mp.unpackb(payload, raw=False)
    if tag == TAG_JSON:
        return json.loads(payload)
    raise ValueError(f"unknown wire codec tag {tag!r}")


class SupervisedEndpoint:
    """One supervised worker subprocess, presented as a message stream.

    ``frames()`` is the parent-side generator: it spawns the worker,
    yields each payload message dict (anything carrying ``"b"``) in pipe
    order, folds hello/stats via overridable hooks, and on an unexpected
    death (EOF without EOS) respawns with jittered exponential backoff.
    Subclasses provide the child ``target`` and interpret the payload.

    Counter names are injected so each tier keeps its established
    metrics vocabulary (``ingest_wire_gaps`` vs ``fanin_wire_gaps``).
    """

    def __init__(
        self,
        plan: Any,
        *,
        target,
        name: str,
        index: int,
        metrics=None,
        heartbeat=None,
        respawn_backoff: float = 0.5,
        respawn_backoff_max: float = 15.0,
        gap_counter: Optional[str] = None,
        respawn_counter: Optional[str] = None,
        label: str = "worker",
        respawn_note: str = "",
        process_label: Optional[str] = None,
        trace_ring=None,
        rollup_exclude=frozenset(),
    ):
        self.plan = plan
        self.target = target
        self.name = name
        self.index = index
        self.metrics = metrics
        self.heartbeat = heartbeat or (lambda: None)
        self.respawn_backoff = respawn_backoff
        self.respawn_backoff_max = respawn_backoff_max
        self.gap_counter = gap_counter
        self.respawn_counter = respawn_counter
        self.label = label
        self.respawn_note = respawn_note
        #: the worker's ``process`` label value on every folded series
        #: (``ingest-shard-2``, ``merge-worker-0``); also the
        #: /debug/processes key
        self.process_label = process_label or name
        #: parent TraceRing imported worker traces land in (the shared
        #: /debug/trace ring when tracing is wired)
        self.trace_ring = trace_ring
        #: counter names whose UNLABELED parent totals another fold path
        #: already owns (ad-hoc stats fields) — fold_sample skips the
        #: unlabeled rollup for these so nothing double-counts
        self.rollup_exclude = frozenset(rollup_exclude)
        self.last_hello: Optional[Dict[str, Any]] = None
        self.last_stats: Dict[str, Any] = {}
        self.last_stats_at: Optional[float] = None
        self.spawns = 0
        self.respawns = 0
        self.wire_gaps = 0
        self.stats_frames = 0
        self.stale_stats_discarded = 0
        self.traces_imported = 0
        # cumulative payload ITEMS delivered across incarnations (the
        # seq unit): watch events for ingest, merged deltas for fan-in
        self.events_delivered = 0
        # per-spawn-generation registry-fold watermarks: swapped for a
        # fresh dict in on_spawn so a respawned worker's from-zero
        # counters fold as new deltas, never as a backwards step
        self._sample_watermarks: Dict[str, Any] = {}
        self._fold_errors = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._proc: Optional[multiprocessing.process.BaseProcess] = None
        self._conn = None
        self._ctx = multiprocessing.get_context("spawn")

    # -- subclass hooks ------------------------------------------------------

    def on_spawn(self) -> None:
        """Called after each (re)spawn, before any frame is read — reset
        per-incarnation fold state (cumulative in-child counters restart
        at zero; parent-side totals must not). Subclasses overriding this
        must call ``super().on_spawn()``."""
        self._sample_watermarks = {}

    def on_hello(self, hello: Dict[str, Any]) -> None:
        self.last_hello = hello

    def on_stats(self, stats: Dict[str, Any]) -> None:
        """Fold one stats frame: the generic registry/trace export first
        (when the frame carries them), then whatever the tier subclass
        adds. Subclasses must call ``super().on_stats(stats)``."""
        self.last_stats = stats
        self.last_stats_at = time.monotonic()
        self.stats_frames += 1
        self._fold_exported(stats)

    def on_eos(self, msg: Dict[str, Any]) -> None:
        """A clean drain's terminal message (stats already folded)."""

    def _fold_exported(self, stats: Dict[str, Any]) -> None:
        """Fold the worker's exported registry sample + completed traces
        off one stats frame. Defensive by contract: the fold runs on the
        pump thread, so a malformed frame must count and continue, never
        kill the event stream."""
        registry = stats.get("registry")
        if registry is not None and self.metrics is not None:
            try:
                self.metrics.fold_sample(
                    registry,
                    process=self.process_label,
                    watermarks=self._sample_watermarks,
                    rollup_exclude=self.rollup_exclude,
                )
            except Exception:
                self._fold_errors += 1
                self.metrics.counter("process_sample_fold_errors").inc()
                if self._fold_errors == 1:  # first failure tells the story
                    logger.warning(
                        "%s %d: registry sample fold failed (counted from now on)",
                        self.label, self.index, exc_info=True,
                    )
        traces = stats.get("traces")
        if traces and self.trace_ring is not None:
            imported = 0
            for wire in traces:
                try:
                    self.trace_ring.record(
                        trace_from_wire(wire, process=self.process_label)
                    )
                    imported += 1
                except Exception:  # noqa: BLE001 — same never-kill contract
                    continue
            self.traces_imported += imported
            if imported and self.metrics is not None:
                self.metrics.counter("process_traces_imported").inc(imported)

    def report(self) -> Dict[str, Any]:
        """One worker's /debug/processes row: liveness, spawn generation,
        stats freshness and the supervision counters."""
        proc = self._proc
        last = self.last_stats_at
        return {
            "process": self.process_label,
            "alive": bool(proc is not None and proc.is_alive()),
            "pid": proc.pid if proc is not None else None,
            "generation": self.spawns,
            "respawns": self.respawns,
            "wire_gaps": self.wire_gaps,
            "events_delivered": self.events_delivered,
            "stats_frames": self.stats_frames,
            "stale_stats_discarded": self.stale_stats_discarded,
            "traces_imported": self.traces_imported,
            "last_stats_age_seconds": (
                round(time.monotonic() - last, 3) if last is not None else None
            ),
        }

    # -- lifecycle -----------------------------------------------------------

    def _spawn(self):
        with self._lock:
            if self._stop.is_set():
                return None
            generation = self.spawns + 1
            plan = self.plan
            if dataclasses.is_dataclass(plan) and hasattr(plan, "generation"):
                # stamp the spawn generation into the child's plan: the
                # worker echoes it on every stats frame ("g"), and the
                # parent discards any frame whose generation is not the
                # CURRENT incarnation's — a stale frame drained off a
                # killed worker's pipe must never fold into fresh
                # watermarks (it would double-count the old incarnation)
                plan = dataclasses.replace(plan, generation=generation)
            recv_conn, send_conn = self._ctx.Pipe(duplex=False)
            proc = self._ctx.Process(
                target=self.target,
                args=(plan, send_conn),
                name=self.name,
                daemon=True,  # safety net only; stop() drains via SIGTERM
            )
            proc.start()
            send_conn.close()  # child holds the write end now; EOF tracks it
            self._proc, self._conn = proc, recv_conn
            self.spawns = generation
            return recv_conn

    def _reap(self) -> None:
        with self._lock:
            proc, conn = self._proc, self._conn
            self._proc = self._conn = None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        if proc is not None:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)

    @property
    def pid(self) -> Optional[int]:
        proc = self._proc
        return proc.pid if proc is not None else None

    def stop(self) -> None:
        """SIGTERM the worker (clean drain: it flushes durable state,
        sends EOS, closes the pipe — which unblocks the parent reader)."""
        self._stop.set()
        proc = self._proc
        if proc is not None and proc.is_alive():
            try:
                proc.terminate()
            except OSError:
                pass

    def kill(self) -> None:
        """Hard-stop a worker that ignored the drain grace."""
        self._stop.set()
        proc = self._proc
        if proc is not None and proc.is_alive():
            proc.kill()
        conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    # -- stream --------------------------------------------------------------

    def frames(self) -> Iterator[Dict[str, Any]]:
        backoff = self.respawn_backoff
        while not self._stop.is_set():
            conn = self._spawn()
            if conn is None:
                return
            self.on_spawn()
            clean_eos = False
            delivered_this_spawn = 0
            expected_seq = 0
            try:
                while True:
                    try:
                        data = conn.recv_bytes()
                    except (EOFError, OSError):
                        break  # worker died (or drained and closed)
                    self.heartbeat()  # any frame = a live worker process
                    msg = unpack(data)
                    batch = msg.get("b")
                    if batch is not None:
                        seq = msg.get("s", expected_seq)
                        if seq != expected_seq:
                            # pipes cannot reorder; this is a tripwire for
                            # codec/framing bugs, counted, never silent
                            self.wire_gaps += 1
                            if self.metrics is not None and self.gap_counter:
                                self.metrics.counter(self.gap_counter).inc()
                        expected_seq = seq + len(batch)
                        delivered_this_spawn += len(batch)
                        self.events_delivered += len(batch)
                        yield msg
                        continue
                    if "stats" in msg:
                        gen = msg.get("g")
                        if gen is not None and gen != self.spawns:
                            # a frame from a previous incarnation (stale
                            # pipe drain after a kill->respawn): folding
                            # it against the fresh watermarks would
                            # double-count — discard, visibly
                            self.stale_stats_discarded += 1
                            if self.metrics is not None:
                                self.metrics.counter(
                                    "procpool_stale_stats_discarded"
                                ).inc()
                            continue
                        self.on_stats(msg["stats"])
                        continue
                    if "hello" in msg:
                        self.on_hello(msg["hello"])
                        continue
                    if msg.get("eos"):
                        self.on_eos(msg)
                        clean_eos = True
                        break
            finally:
                self._reap()
            if clean_eos or self._stop.is_set():
                return
            # unexpected death: respawn and resume from durable state. A
            # spawn that delivered work was healthy — reset the escalation
            # so one crash after hours of service doesn't pay the
            # accumulated backoff.
            if delivered_this_spawn > 0:
                backoff = self.respawn_backoff
            self.respawns += 1
            if self.metrics is not None and self.respawn_counter:
                self.metrics.counter(self.respawn_counter).inc()
            logger.warning(
                "%s %d died (spawn %d); respawning in <=%.1fs%s",
                self.label, self.index, self.spawns, backoff * 1.5,
                f" ({self.respawn_note})" if self.respawn_note else "",
            )
            if self._stop.wait(backoff * (0.5 + random.random())):
                return
            backoff = min(backoff * 2.0, self.respawn_backoff_max)
