"""The sharded federation fan-in (the JAX package's ``federate/fanin.py``):
merge workers in supervised OS processes.

One interpreter folding every upstream's deltas (decode, re-key,
re-encode) is bound by its GIL long before the upstreams are. With
``federation.processes > 0``:

- each merge WORKER process owns a disjoint set of whole upstreams
  (``shard_of(cluster_name, processes)``), so per-(cluster, key) order
  holds end to end: one upstream, one subscriber thread, one FIFO pipe,
  one fold slot in the parent;
- a worker runs full ``FleetSubscriber`` consumers for its upstreams, with
  the same per-upstream token files as the in-process plane (switching
  the knob either way resumes instead of relisting), and does the
  per-frame work in its own interpreter: decode, re-key to
  ``cluster/key``, decorate, read the freshness stamp;
- **raw-frame passthrough**: a JSON frame whose re-keying needs nothing but
  the cluster prefix is rewritten on its bytes (the ``ts`` tail dropped,
  both ``"key"`` fields swapped for the global key, ``cluster`` and
  ``origin_key`` appended inside the object) and shipped beside the
  decoded fields, so the parent journals the worker's bytes with its rv
  spliced in and encodes nothing (``fanin_passthrough_frames``); a frame
  that does not qualify takes the decoded path, never a wrong frame;
- deltas ride the length-prefixed pipe as numbered batches into the
  parent's sequencer (``ShardedFanin``), which drops the crash-replay
  window against a per-cluster ``(epoch, upstream rv)`` watermark and
  folds each batch through ``GlobalMerge.apply_view_batch`` under one
  publish-lock hold;
- workers are supervised (``parallel.procpool.SupervisedEndpoint``): a
  killed worker respawns with jittered backoff and resumes every upstream
  from its token, at-least-once on the wire and exactly-once into the view;
- SIGTERM drains: the subscribers stop (persisting their exact positions),
  a last stats frame, EOS.

Staleness has one owner: with ``processes > 0`` the worker holds the
subscriber clocks, decides per-upstream staleness and the drop-stale arm,
and ships its verdicts in its stats frames; the parent plane only mirrors
them. Workers pin their upstream wire to JSON, the passthrough currency.
A worker imports neither torch nor anything that does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from k8s_watcher_tpu_torch.config import metric_safe_name as _metric_suffix
from k8s_watcher_tpu_torch.federate.client import (
    CODEC_JSON,
    DELETE,
    FleetClient,
    FleetSubscriber,
    ResyncRequired,
    Snapshot,
    TokenStore,
)
from k8s_watcher_tpu_torch.federate.merge import GlobalMerge, global_key
from k8s_watcher_tpu_torch.parallel.procpool import SupervisedEndpoint, pack, unpack
from k8s_watcher_tpu_torch.watch.sharded import shard_of

logger = logging.getLogger(__name__)

try:  # the serve plane's optional codec dependency, reused for the wire
    import msgpack  # type: ignore
except Exception:  # noqa: BLE001 — absence is a supported configuration
    msgpack = None


def _pack(obj: Dict[str, Any]) -> bytes:
    return pack(obj, codec=msgpack)


def _unpack(data: bytes) -> Dict[str, Any]:
    return unpack(data, codec=msgpack)


# -- raw-frame passthrough rewrite -------------------------------------------
#
# The upstream serve frame is the serve plane's JSON line (default
# ``json.dumps`` separators, trailing newline) with field order fixed by
# ``Delta.to_wire``: type, rv, kind, key, [object], [ts] (workers
# negotiate fresh=1, trace off — ts, when present, is the LAST field).
# What a single-process merge would encode for the same delta is the
# same line with (a) its own rv (the parent view splices that in at
# apply time — ``serve.view.splice_frame_rv``), (b) the global key at
# BOTH the frame level and inside the object, (c) no ts tail (the base
# JSON variant carries none; negotiated variants re-add it lazily from
# the journaled stamp), and (d) ``cluster``/``origin_key`` appended at
# the END of the object (``GlobalMerge._decorate`` is a dict-update:
# kind/key keep their original positions when the object already
# carries them — the eligibility condition — and the two new fields
# append). All four are byte-local rewrites; anything else falls back
# to the decoded path.

#: the negotiated freshness tail: ``, "ts": [<floats>]}\n`` at end of line
_TS_TAIL = re.compile(rb', "ts": \[[-+eE0-9., ]*\]\}\n$')


def strip_ts_tail(raw: bytes) -> Optional[bytes]:
    """Drop the negotiated ``ts`` tail from a raw JSON frame line (the
    base frame variant the view journals carries none). Returns the
    line unchanged when no tail is present, None when a ``"ts"`` field
    exists but not in the recognized tail position (unknown producer —
    fall back to the decoded path rather than guess)."""
    m = _TS_TAIL.search(raw)
    if m is not None:
        return raw[: m.start()] + b"}\n"
    if b'"ts":' in raw or b'"ts" :' in raw:
        return None
    return raw


def rewrite_passthrough(
    raw: bytes,
    *,
    cluster: str,
    kind: str,
    key: str,
    obj: Optional[Dict[str, Any]],
) -> Optional[bytes]:
    """Rewrite one upstream JSON frame line into the byte-identical
    frame a single-process merge would have encoded (modulo rv, which
    the view splices at apply time). Returns None whenever ANY
    eligibility check fails — the caller then takes the decoded
    re-encode path; passthrough is an optimization, never a different
    answer.

    What this does NOT re-validate: the frame's JSON well-formedness
    beyond the rewritten spans (the upstream's serve plane encoded it;
    the subscriber's decoder already parsed it for control fields) and
    the object's interior semantics — the bytes between the rewrite
    points pass through verbatim, which is the point.
    """
    if not raw.startswith(b"{"):
        return None  # not a JSON line (codec downgrade mid-window)
    out = strip_ts_tail(raw)
    if out is None:
        return None
    needle = b'"key": ' + json.dumps(key).encode()
    if obj is None:
        expected = 1  # DELETE: frame-level key only
    else:
        # UPSERT: the object must already carry the view convention
        # (kind/key fields matching the frame) so the decorated dict's
        # field ORDER equals a plain append, and must not already be
        # decorated (a federator federating a federator re-keys for
        # real — decoded path)
        if (
            obj.get("key") != key
            or obj.get("kind") != kind
            or "cluster" in obj
            or "origin_key" in obj
        ):
            return None
        if not out.endswith(b"}}\n"):
            return None
        expected = 2  # frame level + object level
    if out.count(needle) != expected:
        return None  # a nested value coincides with the needle — bail
    out = out.replace(needle, b'"key": ' + json.dumps(global_key(cluster, key)).encode())
    if obj is not None:
        out = (
            out[:-3]
            + b', "cluster": '
            + json.dumps(cluster).encode()
            + b', "origin_key": '
            + json.dumps(key).encode()
            + b"}}\n"
        )
    return out


# -- worker plan -------------------------------------------------------------


@dataclasses.dataclass
class FaninPlan:
    """Everything one merge-worker process needs, picklable for spawn.

    ``client_factory`` is the test seam: a MODULE-LEVEL callable
    ``factory(plan, upstream_cfg) -> FleetClient`` replacing the
    production construction (it must be picklable). Production plans
    carry ``config`` (the frozen FederationConfig) and derive clients
    from it.
    """

    proc_index: int
    processes: int
    owned: Tuple[str, ...]  # upstream names this worker folds
    config: Any = None  # config.schema.FederationConfig
    token_dir: Optional[str] = None
    stats_interval_seconds: float = 0.5
    client_factory: Optional[Callable[["FaninPlan", Any], Any]] = None
    #: spawn generation, stamped by the parent at each (re)spawn and
    #: echoed on every stats frame ("g") so stale frames are discarded
    generation: int = 0
    #: ship the worker registry's sample() (+ anomaly traces) on the
    #: periodic stats frame (``metrics.process_export``)
    export_registry: bool = True


def fanin_plans(
    config,
    token_dir: Optional[str] = None,
    *,
    process_export: bool = True,
) -> List[FaninPlan]:
    """Partition the upstream list across ``federation.processes``
    workers by ``shard_of(cluster_name, processes)`` — a pure function
    of (name, processes), so a worker always finds its upstreams' token
    FILES (keyed by upstream name, shared with the in-process plane)
    even after ``processes`` changes. Workers that own no upstream are
    not spawned (processes > upstream count is a legal, wasteful
    config; an idle process would add nothing but a pipe)."""
    plans = [
        FaninPlan(
            proc_index=p,
            processes=config.processes,
            owned=tuple(
                u.name
                for u in config.upstreams
                if shard_of(u.name, config.processes) == p
            ),
            config=config,
            token_dir=token_dir,
            export_registry=process_export,
        )
        for p in range(config.processes)
    ]
    return [plan for plan in plans if plan.owned]


def token_path(token_dir: str, name: str) -> str:
    """One upstream's durable resume-token file — the SAME path the
    in-process plane's ``token_store_for`` uses, so flipping
    ``federation.processes`` either way resumes instead of relisting."""
    return os.path.join(token_dir, f"{_metric_suffix(name)}.token")


# -- worker process ----------------------------------------------------------


class _PipeShip:
    """Serialized pipe writes with a SHARED item-seq across this
    worker's upstream subscriber threads (the SupervisedEndpoint seq
    tripwire needs one monotonic line per pipe). A broken pipe (parent
    died) latches ``broken`` instead of raising into the subscriber
    loops — the main loop notices and exits; tokens are already
    durable."""

    def __init__(self, conn):
        self._conn = conn
        self._lock = threading.Lock()
        self._seq = 0
        self.broken = threading.Event()

    def _send(self, msg: Dict[str, Any]) -> None:
        try:
            self._conn.send_bytes(_pack(msg))
        except (BrokenPipeError, OSError):
            self.broken.set()

    def payload(self, msg: Dict[str, Any], items: int) -> None:
        with self._lock:
            msg["s"] = self._seq
            self._seq += items
            self._send(msg)

    def control(self, msg: Dict[str, Any]) -> None:
        with self._lock:
            self._send(msg)


class _UpstreamPump:
    """One owned upstream inside a merge worker: the full resume-
    protocol subscriber in raw mode, folding each delivered run into a
    seq'd pipe batch of prepared view items (+ passthrough bytes when
    eligible). The worker's staleness tick reads the clocks here."""

    def __init__(
        self, plan: FaninPlan, cfg, ship: _PipeShip, index: int, registry=None
    ):
        import random

        self.cfg = cfg
        self.name = cfg.name
        self.ship = ship
        self.epoch: Optional[str] = None
        self.epoch_changes = 0
        self.stale = False
        self.dropped = False
        self.lag_since: Optional[float] = None
        self.passthrough = 0  # eligible frames shipped as raw bytes
        self.deltas = 0
        # worker-registry counters under WORKER-ONLY names: the parent
        # owns federation_deltas_applied (post-dedup) and
        # fanin_passthrough_frames (ad-hoc fold of stats["passthrough"]),
        # so the exported sample must never reuse those names or the
        # unlabeled rollup would double-count
        self._deltas_shipped = (
            registry.counter("federation_worker_deltas_shipped").labels(
                cluster=self.name
            )
            if registry is not None
            else None
        )
        self._raw_passthrough = (
            registry.counter("federation_worker_passthrough_frames").labels(
                cluster=self.name
            )
            if registry is not None
            else None
        )
        # same role as the in-process plane's per-upstream drop_lock:
        # serializes the drop decision against this subscriber thread's
        # snapshot-reconcile/delta-ship, and — because every ship
        # happens INSIDE it — makes pipe order match flag order
        self.drop_lock = threading.Lock()
        fed = plan.config
        if plan.client_factory is not None:
            self.client = plan.client_factory(plan, cfg)
        else:
            # JSON pinned: the passthrough currency is the serve
            # plane's JSON line (see module docstring)
            self.client = FleetClient(
                cfg.url,
                token=cfg.token,
                timeout=max(5.0, fed.stale_after_seconds),
                codec=CODEC_JSON,
                fresh=True,
            )
        store = (
            TokenStore(token_path(plan.token_dir, self.name))
            if plan.token_dir
            else None
        )
        self.resumed = store is not None and store.load() is not None
        self.subscriber = FleetSubscriber(
            self.client,
            on_snapshot=self._on_snapshot,
            on_raw_batch=self._on_raw_batch,
            token_store=store,
            stale_after_seconds=fed.stale_after_seconds,
            backoff_seconds=fed.resync_backoff_seconds,
            rng=random.Random((os.getpid() << 8) ^ index),
            name=self.name,
        )
        self.thread = threading.Thread(
            target=self.subscriber.run, name=f"fanin-{self.name}", daemon=True
        )

    # -- subscriber callbacks (subscriber thread) ---------------------------

    def _on_snapshot(self, snap: Snapshot) -> None:
        if self.epoch is not None and snap.view != self.epoch:
            self.epoch_changes += 1
            logger.warning(
                "Fan-in upstream %s changed view epoch %s -> %s (restart); reconciling",
                self.name, self.epoch, snap.view,
            )
        self.epoch = snap.view
        with self.drop_lock:
            self.dropped = False
            # full-reconcile hand-off: raw upstream objects; the parent
            # runs reset_cluster (decorate + delete-the-vanished) with
            # its authoritative key registry
            self.ship.payload(
                {
                    "c": self.name,
                    "e": snap.view,
                    "w": snap.rv,
                    "r": 1,
                    "b": snap.objects,
                },
                len(snap.objects),
            )

    def _on_raw_batch(self, pairs) -> None:
        with self.drop_lock:
            if self.dropped:
                # objects dropped while this stream stalled but stayed
                # open: a delta-only resume would leave every untouched
                # object missing — force the full reconcile
                raise ResyncRequired(
                    "objects dropped while stale; re-snapshot to reconcile"
                )
            json_wire = (
                msgpack is not None  # JSON-fallback pipe cannot carry bytes
                and self.client.active_codec == CODEC_JSON
            )
            items = []
            for frame, raw in pairs:
                kind = frame.get("kind") or "pod"
                key = frame["key"]
                ts = frame.get("ts")
                obj = None if frame["type"] == DELETE else (frame.get("object") or {})
                rewritten = (
                    rewrite_passthrough(
                        raw, cluster=self.name, kind=kind, key=key, obj=obj
                    )
                    if json_wire
                    else None
                )
                if rewritten is not None:
                    self.passthrough += 1
                    if self._raw_passthrough is not None:
                        self._raw_passthrough.inc()
                items.append(
                    [
                        kind,
                        global_key(self.name, key),
                        None
                        if obj is None
                        else GlobalMerge._decorate(self.name, kind, key, obj),
                        ts[0] if ts else None,
                        frame.get("trace") if isinstance(frame.get("trace"), dict) else None,
                        frame["rv"],
                        rewritten,
                    ]
                )
            self.deltas += len(items)
            if self._deltas_shipped is not None and items:
                self._deltas_shipped.inc(len(items))
            self.ship.payload(
                {"c": self.name, "e": self.subscriber.view, "b": items}, len(items)
            )

    # -- worker tick (main thread) ------------------------------------------

    def drop(self) -> None:
        """The drop-stale arm, worker-owned: flag (so an in-between
        delta forces a reconcile), invalidate (so the next (re)connect
        re-snapshots the objects back in), tell the parent to delete."""
        with self.drop_lock:
            self.dropped = True
            self.subscriber.invalidate()
            self.ship.payload({"c": self.name, "drop": 1, "b": []}, 0)

    def status(self) -> Dict[str, Any]:
        sub = self.subscriber
        body = sub.status()
        now = time.monotonic()
        lag_rv = max(0, sub.wire_rv - (sub.rv or 0))
        if lag_rv > 0:
            if self.lag_since is None:
                self.lag_since = now
        else:
            self.lag_since = None
        body.update(
            {
                "url": self.cfg.url,
                "stale": self.stale,
                "epoch": self.epoch,
                "epoch_changes": self.epoch_changes,
                "dropped": self.dropped,
                "lag_rv": lag_rv,
                "oldest_unpropagated_seconds": (
                    round(now - self.lag_since, 3) if self.lag_since is not None else 0.0
                ),
                "thread_alive": self.thread.is_alive(),
                "passthrough": self.passthrough,
                "deltas": self.deltas,
            }
        )
        return body


def _fanin_worker_entry(plan: FaninPlan, conn) -> None:
    """Child-process main: owned upstream subscribers -> seq'd pipe
    batches, plus the worker-owned staleness tick. SIGTERM stops the
    subscribers (their exit path persists the exact live tokens) and
    sends EOS; an unexpected death is the parent's respawn path (the
    durable tokens make the respawn resume, not relist)."""
    logging.basicConfig(
        level=logging.INFO,
        format=(
            f"%(asctime)s [fanin-worker-{plan.proc_index}] "
            "%(levelname)s %(name)s: %(message)s"
        ),
    )
    ship = _PipeShip(conn)
    registry = None
    tracer = None
    trace_export = None
    if plan.export_registry:
        # worker-side observability: a registry whose sample() rides the
        # stats frame, plus an anomaly-only tracer (sample_rate=0 — the
        # merge path has no per-event journey to head-sample; staleness
        # and drop verdicts are the anomalies worth shipping)
        import collections

        from k8s_watcher_tpu_torch.metrics import MetricsRegistry
        from k8s_watcher_tpu_torch.trace.trace import Tracer

        registry = MetricsRegistry()
        trace_export = collections.deque(maxlen=64)
        tracer = Tracer(
            sample_rate=0, ring_size=64, metrics=registry,
            export_buffer=trace_export,
        )
    owned = {u.name: u for u in plan.config.upstreams}
    pumps = [
        _UpstreamPump(plan, owned[name], ship, index, registry=registry)
        for index, name in enumerate(plan.owned)
    ]
    stopping = threading.Event()

    def on_sigterm(signum, frame):  # noqa: ARG001 — signal signature
        stopping.set()

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent Ctrl-C drains via SIGTERM

    ship.control(
        {
            "hello": {
                "proc": plan.proc_index,
                "pid": os.getpid(),
                "clusters": [p.name for p in pumps],
                "resumed": [p.name for p in pumps if p.resumed],
            }
        }
    )
    for pump in pumps:
        pump.thread.start()

    stale_threshold = max(3.0, plan.config.stale_after_seconds)
    tick = max(0.1, min(1.0, stale_threshold / 4.0))
    started_t = time.monotonic()
    last_stats = started_t

    def stats_payload() -> Dict[str, Any]:
        stats: Dict[str, Any] = {
            "upstreams": {p.name: p.status() for p in pumps},
            "passthrough": sum(p.passthrough for p in pumps),
            "deltas": sum(p.deltas for p in pumps),
        }
        if registry is not None:
            stats["registry"] = registry.sample(include_series=True)
        if trace_export is not None:
            drained = []
            while True:
                try:
                    drained.append(trace_export.popleft())
                except IndexError:
                    break
            if drained:
                stats["traces"] = drained
        return {"stats": stats, "g": plan.generation}

    try:
        while not stopping.is_set() and not ship.broken.is_set():
            stopping.wait(tick)
            if stopping.is_set():
                break
            now = time.monotonic()
            grace_over = now - started_t > stale_threshold
            for pump in pumps:
                age = pump.subscriber.last_frame_age()
                fresh = age is not None and age <= stale_threshold
                if fresh:
                    pump.stale = False
                elif grace_over or age is not None:
                    if not pump.stale:
                        pump.stale = True
                        logger.warning(
                            "Fan-in upstream %s went stale (last frame %s ago)",
                            pump.name, f"{age:.1f}s" if age is not None else "never",
                        )
                        if tracer is not None:
                            # always-captured anomaly, queryable at the
                            # PARENT's /debug/trace?uid=<upstream name>
                            # once it rides the next stats frame
                            trace = tracer.start_anomaly(
                                uid=pump.name, name=pump.name,
                                kind="upstream", t0=now,
                            )
                            if trace is not None:
                                tracer.finish(trace, "stale")
                    if plan.config.drop_stale and not pump.dropped:
                        age_now = pump.subscriber.last_frame_age()
                        if age_now is None or age_now > stale_threshold:
                            pump.drop()
                            logger.warning(
                                "Dropped stale upstream %s from the global view",
                                pump.name,
                            )
                            if tracer is not None:
                                trace = tracer.start_anomaly(
                                    uid=pump.name, name=pump.name,
                                    kind="upstream", t0=now,
                                )
                                if trace is not None:
                                    tracer.finish(trace, "dropped")
            if now - last_stats >= plan.stats_interval_seconds:
                last_stats = now
                ship.control(stats_payload())
    finally:
        for pump in pumps:
            pump.subscriber.stop()
        for pump in pumps:
            pump.thread.join(timeout=5.0)
        if not ship.broken.is_set():
            ship.control(stats_payload())
            ship.control({"eos": True, "drained": stopping.is_set()})
        try:
            conn.close()
        except OSError:
            pass


# -- parent side -------------------------------------------------------------


class FaninEndpoint(SupervisedEndpoint):
    """One supervised merge-worker subprocess. Supervision (spawn/
    respawn/backoff/seq/hello/stats/EOS) is the shared
    ``parallel.procpool.SupervisedEndpoint``; this subclass folds the
    worker's cumulative stats — passthrough frames and the per-upstream
    subscriber counters — into parent-side totals across incarnations
    (a respawned worker's counters restart at zero; the registry's must
    not)."""

    #: per-upstream monotonic counters diff-synced into plane counters
    _SYNCED = (
        ("reconnects", "federation_reconnects"),
        ("resyncs", "federation_resyncs"),
        ("stalls", "federation_heartbeat_stalls"),
        ("snapshots", "federation_snapshots"),
    )

    def __init__(
        self,
        plan: FaninPlan,
        *,
        metrics=None,
        heartbeat=None,
        trace_ring=None,
        respawn_backoff: float = 0.5,
        respawn_backoff_max: float = 15.0,
    ):
        super().__init__(
            plan,
            target=_fanin_worker_entry,
            name=f"fanin-merge-{plan.proc_index}",
            index=plan.proc_index,
            metrics=metrics,
            heartbeat=heartbeat,
            respawn_backoff=respawn_backoff,
            respawn_backoff_max=respawn_backoff_max,
            gap_counter="fanin_wire_gaps",
            respawn_counter="fanin_worker_respawns",
            label="Merge worker",
            respawn_note="resume from per-upstream tokens",
            process_label=f"merge-worker-{plan.proc_index}",
            trace_ring=trace_ring,
        )
        self.passthrough_total = 0
        self._passthrough_seen = 0
        self.upstream_stats: Dict[str, Dict[str, Any]] = {}
        self._synced: Dict[str, Dict[str, int]] = {}

    def on_spawn(self) -> None:
        super().on_spawn()  # reset registry-fold watermarks
        self._passthrough_seen = 0  # per-incarnation cumulative counters
        self._synced = {}

    def on_stats(self, stats: Dict[str, Any]) -> None:
        super().on_stats(stats)  # fold exported registry sample + traces
        passthrough = stats.get("passthrough")
        if passthrough is not None:
            delta = passthrough - self._passthrough_seen
            if delta > 0:
                self.passthrough_total += delta
                if self.metrics is not None:
                    self.metrics.counter("fanin_passthrough_frames").inc(delta)
            self._passthrough_seen = passthrough
        upstreams = stats.get("upstreams")
        if not isinstance(upstreams, dict):
            return
        self.upstream_stats.update(upstreams)
        if self.metrics is None:
            return
        for name, body in upstreams.items():
            synced = self._synced.setdefault(name, {})
            for field, counter in self._SYNCED:
                current = body.get(field)
                if current is None:
                    continue
                delta = current - synced.get(field, 0)
                if delta > 0:
                    self.metrics.counter(counter).inc(delta)
                    synced[field] = current


class ShardedFanin:
    """The parent-side sequencer: one pump thread per merge-worker
    endpoint drains its seq'd pipe batches into
    ``GlobalMerge.apply_view_batch`` / ``reset_cluster`` /
    ``drop_cluster``, deduping each worker's crash-replay window
    against a per-cluster ``(epoch, upstream rv)`` watermark — the
    durable token can trail the last shipped delta by up to a save
    cadence, so a respawned worker REPLAYS that window (at-least-once
    on the wire) and the watermark drops it (exactly-once into the
    view: zero gaps, zero dups through a kill).

    Clusters never migrate between workers at runtime (the partition is
    a pure function of the name), so one fold slot per cluster and
    per-(cluster, key) order holds without any cross-pipe sequencing.
    """

    def __init__(
        self,
        config,
        merge: GlobalMerge,
        *,
        metrics=None,
        token_dir: Optional[str] = None,
        resume_tokens_valid: bool = True,
        respawn_backoff: float = 0.5,
        heartbeat=None,
        trace_ring=None,
        process_export: bool = True,
    ):
        self.config = config
        self.merge = merge
        self.metrics = metrics
        self.token_dir = token_dir
        self.resume_tokens_valid = resume_tokens_valid
        self.endpoints = [
            FaninEndpoint(
                plan,
                metrics=metrics,
                heartbeat=heartbeat,
                trace_ring=trace_ring,
                respawn_backoff=respawn_backoff,
            )
            for plan in fanin_plans(config, token_dir, process_export=process_export)
        ]
        # cluster -> {"epoch": str, "urv": int}; single-writer per
        # cluster (its worker's pump thread), so no lock needed
        self._watermarks: Dict[str, Dict[str, Any]] = {}
        self._threads: List[threading.Thread] = []
        self.deltas_counter = metrics.counter("federation_deltas_applied") if metrics else None
        self.batches_counter = metrics.counter("federation_batches_applied") if metrics else None
        # end-to-end propagation stays measured at the FOLD (the moment
        # the delta reaches the global view) from the shipped origin
        # stamp; the serve-wire hop histogram is per-worker territory in
        # sharded mode and is not recorded here
        self.watch_to_global = (
            metrics.histogram("watch_to_global_view_seconds") if metrics else None
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ShardedFanin":
        if not self.resume_tokens_valid and self.token_dir:
            cleared = 0
            for u in self.config.upstreams:
                store = TokenStore(token_path(self.token_dir, u.name))
                store.clear()
                cleared += 1
            logger.warning(
                "Merged view did not restart cleanly on its prior rv line; "
                "cleared %d federation resume token(s) — merge workers will "
                "re-snapshot and reconcile", cleared,
            )
        for endpoint in self.endpoints:
            thread = threading.Thread(
                target=self._pump,
                args=(endpoint,),
                name=f"fanin-pump-{endpoint.index}",
                daemon=True,
            )
            thread.start()
            self._threads.append(thread)
        logger.info(
            "Sharded fan-in started: %d merge worker(s) over %d upstream(s) [%s]",
            len(self.endpoints),
            len(self.config.upstreams),
            "; ".join(
                f"worker {e.index}: {','.join(e.plan.owned)}" for e in self.endpoints
            ),
        )
        return self

    def stop(self, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        for endpoint in self.endpoints:
            endpoint.stop()  # SIGTERM: clean drain -> EOS
        for thread in self._threads:
            thread.join(timeout=max(0.1, deadline - time.monotonic()))
        for endpoint in self.endpoints:
            if time.monotonic() > deadline:
                endpoint.kill()  # a wedged worker cannot wedge the exit
        self._threads = []

    # -- the sequencer fold --------------------------------------------------

    def _pump(self, endpoint: FaninEndpoint) -> None:
        for msg in endpoint.frames():
            self._fold(msg)

    def _fold(self, msg: Dict[str, Any]) -> None:
        cluster = msg.get("c")
        if not cluster:
            return
        if msg.get("drop"):
            dropped = self.merge.drop_cluster(cluster)
            logger.warning(
                "Dropped %d stale object(s) of upstream %s from the global view "
                "(merge-worker verdict)", dropped, cluster,
            )
            return
        epoch = msg.get("e")
        if msg.get("r"):
            self.merge.reset_cluster(cluster, msg["b"])
            self._watermarks[cluster] = {"epoch": epoch, "urv": int(msg.get("w") or 0)}
            return
        items = msg["b"]
        if not items:
            return
        wm = self._watermarks.get(cluster)
        if wm is None or wm["epoch"] != epoch:
            # cold token-resume: no reset precedes the first batch —
            # adopt the epoch; the replay window (if any) re-applies,
            # which the view dedups exactly like an in-process
            # redelivery
            wm = self._watermarks[cluster] = {"epoch": epoch, "urv": 0}
        floor = wm["urv"]
        out = [
            (item[0], item[1], item[2], item[3], item[4], item[6])
            for item in items
            if item[5] > floor
        ]
        wm["urv"] = max(floor, items[-1][5])
        if not out:
            return  # the whole batch was crash-window replay
        self.merge.apply_view_batch(cluster, out)
        if self.deltas_counter is not None:
            self.deltas_counter.inc(len(out))
        if self.batches_counter is not None:
            self.batches_counter.inc()
        if self.watch_to_global is not None:
            now_wall = time.time()
            for item in out:
                if item[3] is not None:
                    self.watch_to_global.record(max(0.0, now_wall - item[3]))

    # -- surfaces ------------------------------------------------------------

    def upstream_report(self) -> Dict[str, Dict[str, Any]]:
        """Latest worker-reported per-upstream status (the staleness
        verdicts live HERE — satellite: the parent never recomputes
        them), keyed by upstream name. An upstream whose worker has not
        reported yet (startup, respawn backoff) is absent."""
        out: Dict[str, Dict[str, Any]] = {}
        for endpoint in self.endpoints:
            out.update(endpoint.upstream_stats)
        return out

    def workers_alive(self) -> bool:
        return all(thread.is_alive() for thread in self._threads)

    def worker_pids(self) -> List[Optional[int]]:
        return [endpoint.pid for endpoint in self.endpoints]

    def worker_stats(self) -> Dict[str, Any]:
        """Aggregated supervision counters (checks and debugging)."""
        return {
            "processes": len(self.endpoints),
            "spawns": sum(e.spawns for e in self.endpoints),
            "respawns": sum(e.respawns for e in self.endpoints),
            "wire_gaps": sum(e.wire_gaps for e in self.endpoints),
            "deltas_delivered": sum(e.events_delivered for e in self.endpoints),
            "passthrough": sum(e.passthrough_total for e in self.endpoints),
            "hellos": [e.last_hello for e in self.endpoints],
        }

    def process_report(self) -> List[Dict[str, Any]]:
        """Per-worker supervision rows for ``/debug/processes``."""
        return [e.report() for e in self.endpoints]
