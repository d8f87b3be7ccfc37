"""The federation plane (the JAX package's ``federate/plane.py``): N
upstream watchers fanned into one global view.

One ``FleetSubscriber`` thread per upstream serving plane, each a full
resume-protocol consumer, folds through ``GlobalMerge`` into the local
``FleetView``; the serving plane then republishes the merged fleet with
encode-once fan-out, the history WAL makes global resume tokens survive a
restart, and ``?at=`` reads the global past.

A monitor thread (about one tick a second) keeps what no single subscriber
can: per-upstream staleness verdicts and the drop-stale arm, the lag
gauges, and the subscribers' counters in the registry. ``health()`` folds
per-upstream liveness into ``/healthz``; ``freshness()`` feeds
``/debug/freshness`` and the health plane's freshness source.

``federation.processes > 0`` swaps the subscribers for the sharded fan-in
(``federate/fanin.py``): merge-worker processes own them and ship prepared
deltas over pipes, and this plane is the parent, folding into the view
and mirroring the workers' reports into the same gauges, health and
freshness surfaces. The staleness verdict is computed here only in the
in-process mode (``staleness_owner``), so a sharded federator never
reports ``federation_upstream_stale`` twice.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

from k8s_watcher_tpu_torch.config import metric_safe_name as _metric_suffix
from k8s_watcher_tpu_torch.metrics import MAX_LABEL_SETS
from k8s_watcher_tpu_torch.federate.client import (
    FleetClient,
    FleetSubscriber,
    ResyncRequired,
    Snapshot,
    TokenStore,
)
from k8s_watcher_tpu_torch.federate.merge import GlobalMerge

logger = logging.getLogger(__name__)


class _Upstream:
    """One upstream's subscriber + bookkeeping the monitor reads."""

    def __init__(self, plane: "FederationPlane", cfg, index: int):
        self.cfg = cfg
        self.name = cfg.name
        self.epoch: Optional[str] = None
        self.epoch_changes = 0
        self.stale = False
        self.dropped = False  # drop_stale already removed our objects
        # serializes the monitor's drop against the subscriber thread's
        # snapshot-reconcile/delta-apply: without it a drop could land
        # just after a reconcile repopulated the cluster (or a delta
        # could slip in between flag and drop), leaving untouched
        # objects missing for up to a watch window
        self.drop_lock = threading.Lock()
        self._synced: Dict[str, int] = {}  # counter diff-sync state
        # oldest-unpropagated tracking: monotonic stamp of when this
        # upstream FIRST fell behind (wire_rv ahead of the applied rv);
        # None while caught up. The monitor tick maintains it.
        self.lag_since: Optional[float] = None
        # request timeout floored well above the staleness knob: a tight
        # stale_after must not shrink the snapshot-read budget with it
        self.client = FleetClient(
            cfg.url, token=cfg.token,
            timeout=max(5.0, plane.config.stale_after_seconds),
            codec=plane.config.codec,
            # always negotiate freshness stamps: the propagation
            # histograms and watermarks are this plane's telemetry; an
            # upstream that predates the field just serves plain frames
            fresh=True,
            # negotiate in-band trace forwarding only when the joined-
            # trace plane is on — unjoined trace fields would be dead
            # wire bytes on every sampled delta
            trace=plane.trace_collector is not None,
        )
        if plane.trace_collector is not None:
            # lazy-stitch fetcher: the collector queries THIS upstream's
            # serve-port /debug/trace for spans not forwarded in-band
            # (each call opens its own connection — safe alongside the
            # subscriber thread's watch stream)
            plane.trace_collector.register_fetcher(self.name, self.client.debug_trace)
        self.subscriber = FleetSubscriber(
            self.client,
            on_snapshot=self._on_snapshot,
            on_batch=self._on_batch,
            token_store=plane.token_store_for(self.name),
            stale_after_seconds=plane.config.stale_after_seconds,
            backoff_seconds=plane.config.resync_backoff_seconds,
            # deterministic jitter spread across upstreams; reseeded per
            # process via the index + pid mix
            rng=random.Random((os.getpid() << 8) ^ index),
            name=self.name,
        )
        self.thread = threading.Thread(
            target=self.subscriber.run, name=f"federate-{self.name}", daemon=True
        )
        self._plane = plane
        metrics = plane.metrics
        # per-upstream series as REAL labels (`...{upstream="a"}`)
        if metrics is not None:
            label = {"upstream": self.name}
            self.lag_rv_gauge = metrics.gauge("federation_upstream_lag_rv").labels(**label)
            self.lag_seconds_gauge = metrics.gauge("federation_upstream_lag_seconds").labels(**label)
            self.stale_gauge = metrics.gauge("federation_upstream_stale").labels(**label)
            # freshness watermarks (the /debug/freshness surface):
            # watermark age = wall-now minus the newest applied delta's
            # ORIGIN stamp (ages while the upstream is paused/dark);
            # last-delta age = local monotonic since the last applied
            # delta; oldest-unpropagated = how long the subscriber has
            # been behind the newest rv it has SEEN on the wire
            self.watermark_age_gauge = metrics.gauge(
                "federation_upstream_watermark_age_seconds"
            ).labels(**label)
            self.last_delta_age_gauge = metrics.gauge(
                "federation_upstream_last_delta_age_seconds"
            ).labels(**label)
            self.oldest_unpropagated_gauge = metrics.gauge(
                "federation_upstream_oldest_unpropagated_seconds"
            ).labels(**label)
        else:
            self.lag_rv_gauge = None
            self.lag_seconds_gauge = None
            self.stale_gauge = None
            self.watermark_age_gauge = None
            self.last_delta_age_gauge = None
            self.oldest_unpropagated_gauge = None

    def _on_snapshot(self, snap: Snapshot) -> None:
        if self.epoch is not None and snap.view != self.epoch:
            # the upstream restarted into a fresh rv space (unclean end,
            # or history off): epochs fence its resume tokens; the full
            # reconcile below re-bases our copy of its state
            self.epoch_changes += 1
            logger.warning(
                "Federation upstream %s changed view epoch %s -> %s (restart); reconciling",
                self.name, self.epoch, snap.view,
            )
        self.epoch = snap.view
        with self.drop_lock:
            self.dropped = False
            self._plane.merge.reset_cluster(self.name, snap.objects)
        if self._plane.snapshots_counter is not None:
            self._plane.snapshots_counter.inc()

    def _on_batch(self, frames: List[Dict[str, Any]]) -> None:
        """One wire-read's worth of deltas, folded in ONE merge call:
        one registry-lock acquisition, one view publish-lock hold, one
        subscriber wakeup — however many frames the read carried (the
        per-delta ``apply_delta`` is the unbatched baseline)."""
        if not frames:
            return
        collector = self._plane.trace_collector
        # ONE cheap membership walk finds the sampled 1/N; the collector
        # then pays per TRACED frame only — the unsampled fan-in hot
        # path's whole trace bill is this `in` check
        traced = (
            [f for f in frames if "trace" in f] if collector is not None else ()
        )
        t_recv = time.time() if traced else 0.0
        if traced:
            # rewrite traced frames' in-band trace field with this hop's
            # serve_wire span BEFORE the fold — the merged deltas journal
            # the rewritten dict, so the global view's republished frames
            # carry the joined identity to any second-tier federator
            collector.note_receive(self.name, traced, t_recv)
        with self.drop_lock:
            if self.dropped:
                # drop_stale removed our objects while this stream was
                # stalled but still open; a delta-only resume would leave
                # every untouched object missing — force the full
                # reconcile instead
                raise ResyncRequired("objects dropped while stale; re-snapshot to reconcile")
            t_pub = time.time() if traced else 0.0
            self._plane.merge.apply_batch(self.name, frames)
        if traced:
            # close the journeys: federate_merge (receive -> merged
            # publish) + global_serve (merged publish -> fan-out
            # hand-off, i.e. apply_batch's wakeup returned) and record
            # the JOINED traces + attribution histograms
            collector.adopt(self.name, traced, t_recv, t_pub, time.time())
        if self._plane.deltas_counter is not None:
            self._plane.deltas_counter.inc(len(frames))
        if self._plane.batches_counter is not None:
            self._plane.batches_counter.inc()
        # propagation telemetry off the negotiated per-frame stamps
        # (ts = [origin_wall, upstream_publish_wall]): end-to-end
        # watch->global-view age and the serve-wire hop. Wall clocks —
        # origin is a REMOTE host — so readings are clamped at 0 and
        # carry the documented cross-host skew caveat.
        w2g = self._plane.watch_to_global
        wire = self._plane.serve_wire
        if w2g is not None or wire is not None:
            now_wall = time.time()
            for frame in frames:
                ts = frame.get("ts")
                if not ts:
                    continue
                if w2g is not None:
                    w2g.record(max(0.0, now_wall - ts[0]))
                if wire is not None:
                    wire.record(max(0.0, now_wall - ts[1]))

    def sync_counters(self, plane: "FederationPlane") -> None:
        """Diff-sync the subscriber's monotonic counts into the registry
        (counters only move forward, so diffing is exact)."""
        sub = self.subscriber
        for field, counter in (
            ("reconnects", plane.reconnects_counter),
            ("resyncs", plane.resyncs_counter),
            ("stalls", plane.stalls_counter),
        ):
            if counter is None:
                continue
            current = getattr(sub, field)
            delta = current - self._synced.get(field, 0)
            if delta > 0:
                counter.inc(delta)
                self._synced[field] = current

    def update_gauges(self) -> None:
        sub = self.subscriber
        now = time.monotonic()
        lag_rv = max(0, sub.wire_rv - (sub.rv or 0))
        # oldest-unpropagated: how long the oldest wire-seen-but-unapplied
        # event has been pending (0 while caught up). The true per-event
        # stamp is unknowable without applying it, so this measures from
        # when the lag BEGAN — a lower bound on the oldest event's age.
        if lag_rv > 0:
            if self.lag_since is None:
                self.lag_since = now
        else:
            self.lag_since = None
        oldest_unpropagated = (now - self.lag_since) if self.lag_since is not None else 0.0
        age = sub.last_frame_age()
        if self.lag_rv_gauge is not None:
            self.lag_rv_gauge.set(lag_rv)
            if age is not None:
                self.lag_seconds_gauge.set(age)
            self.stale_gauge.set(1.0 if self.stale else 0.0)
            watermark = sub.watermark_age()
            if watermark is not None:
                self.watermark_age_gauge.set(watermark)
            delta_age = sub.last_delta_age()
            if delta_age is not None:
                self.last_delta_age_gauge.set(delta_age)
            self.oldest_unpropagated_gauge.set(oldest_unpropagated)

    def freshness(self) -> Dict[str, Any]:
        """This upstream's watermark block for /debug/freshness."""
        sub = self.subscriber
        age = sub.last_frame_age()
        delta_age = sub.last_delta_age()
        watermark = sub.watermark_age()
        now = time.monotonic()
        return {
            "connected": sub.connected,
            "stale": self.stale,
            "rv": sub.rv,
            "wire_rv": sub.wire_rv,
            "lag_rv": max(0, sub.wire_rv - (sub.rv or 0)),
            "last_frame_age_seconds": round(age, 3) if age is not None else None,
            "last_delta_age_seconds": round(delta_age, 3) if delta_age is not None else None,
            "watermark_age_seconds": round(watermark, 3) if watermark is not None else None,
            "oldest_unpropagated_seconds": (
                round(now - self.lag_since, 3) if self.lag_since is not None else 0.0
            ),
        }

    def status(self) -> Dict[str, Any]:
        body = self.subscriber.status()
        body.update(
            {
                "url": self.cfg.url,
                "stale": self.stale,
                "epoch": self.epoch,
                "epoch_changes": self.epoch_changes,
                "objects": self._plane.merge.cluster_object_count(self.name),
                "thread_alive": self.thread.is_alive(),
            }
        )
        return body


class _UpstreamMirror:
    """Sharded mode's parent-side stand-in for ``_Upstream``: no
    subscriber lives here (a merge worker owns it, clocks and all); the
    monitor tick folds the worker-REPORTED status into the same labeled
    gauges, health fields and the stale-transition counter. The
    staleness verdict is MIRRORED, never recomputed — the plane's
    ``staleness_owner`` is ``"merge-workers"`` and exactly one
    component may ever flip ``federation_upstream_stale`` per upstream.
    """

    def __init__(self, plane: "FederationPlane", cfg):
        self.cfg = cfg
        self.name = cfg.name
        self.stale = False  # last mirrored verdict (transition edge detect)
        self.last: Dict[str, Any] = {}
        metrics = plane.metrics
        if metrics is not None:
            label = {"upstream": self.name}
            self.lag_rv_gauge = metrics.gauge("federation_upstream_lag_rv").labels(**label)
            self.lag_seconds_gauge = metrics.gauge("federation_upstream_lag_seconds").labels(**label)
            self.stale_gauge = metrics.gauge("federation_upstream_stale").labels(**label)
            self.watermark_age_gauge = metrics.gauge(
                "federation_upstream_watermark_age_seconds"
            ).labels(**label)
            self.last_delta_age_gauge = metrics.gauge(
                "federation_upstream_last_delta_age_seconds"
            ).labels(**label)
            self.oldest_unpropagated_gauge = metrics.gauge(
                "federation_upstream_oldest_unpropagated_seconds"
            ).labels(**label)
        else:
            self.lag_rv_gauge = None
            self.lag_seconds_gauge = None
            self.stale_gauge = None
            self.watermark_age_gauge = None
            self.last_delta_age_gauge = None
            self.oldest_unpropagated_gauge = None

    def fold(self, body: Dict[str, Any], plane: "FederationPlane") -> None:
        self.last = body
        stale = bool(body.get("stale"))
        if stale and not self.stale and plane.stale_transitions_counter is not None:
            plane.stale_transitions_counter.inc()
        self.stale = stale
        if self.lag_rv_gauge is not None:
            self.lag_rv_gauge.set(body.get("lag_rv") or 0)
            age = body.get("last_frame_age_seconds")
            if age is not None:
                self.lag_seconds_gauge.set(age)
            self.stale_gauge.set(1.0 if stale else 0.0)
            watermark = body.get("watermark_age_seconds")
            if watermark is not None:
                self.watermark_age_gauge.set(watermark)
            delta_age = body.get("last_delta_age_seconds")
            if delta_age is not None:
                self.last_delta_age_gauge.set(delta_age)
            self.oldest_unpropagated_gauge.set(
                body.get("oldest_unpropagated_seconds") or 0.0
            )

    def freshness(self) -> Dict[str, Any]:
        """The ``_Upstream.freshness()`` block, from the last worker
        report (readings age by at most one stats interval)."""
        body = self.last
        return {
            "connected": bool(body.get("connected")),
            "stale": self.stale,
            "rv": body.get("rv"),
            "wire_rv": body.get("wire_rv", 0),
            "lag_rv": body.get("lag_rv", 0),
            "last_frame_age_seconds": body.get("last_frame_age_seconds"),
            "last_delta_age_seconds": body.get("last_delta_age_seconds"),
            "watermark_age_seconds": body.get("watermark_age_seconds"),
            "oldest_unpropagated_seconds": body.get("oldest_unpropagated_seconds", 0.0),
        }

    def status(self, plane: "FederationPlane") -> Dict[str, Any]:
        body = dict(self.last) if self.last else {"name": self.name, "connected": False}
        body.update(
            {
                "url": self.cfg.url,
                "stale": self.stale,
                "objects": plane.merge.cluster_object_count(self.name),
                "mirrored": True,  # worker-reported, not locally measured
            }
        )
        return body


class FederationPlane:
    """Runs the upstream subscriber fleet against the app's FleetView.

    Built when ``federation.enabled``; the app starts it after the serve
    plane (the view exists from construction, so ordering is about log
    hygiene, not correctness) and stops it before the history WAL closes
    (the plane is a view producer)."""

    def __init__(
        self,
        config,
        view,
        *,
        metrics=None,
        token_dir: Optional[str] = None,
        resume_tokens_valid: bool = True,
        trace_collector=None,  # trace.federation.FleetTraceCollector
        trace_ring=None,  # trace.TraceRing: worker anomaly traces land here
        process_export: bool = True,  # metrics.process_export
    ):
        self.config = config
        self.metrics = metrics
        self.token_dir = token_dir
        # joined-trace plane (trace.federation.enabled): upstream
        # subscribers negotiate ?trace=1 and feed it per batch — set
        # BEFORE the upstreams are built (they read it at construction)
        self.trace_collector = trace_collector
        # False when the merged view did NOT restart as a clean
        # continuation of the rv line the tokens were minted against
        # (unclean WAL end, cold/wiped WAL dir): a persisted token would
        # then resume delta-only AHEAD of the recovered state and the
        # lost window's objects would serve stale forever. start()
        # clears the stale tokens so every subscriber re-snapshots and
        # reconciles instead.
        self.resume_tokens_valid = resume_tokens_valid
        self.merge = GlobalMerge(view, drop_stale=config.drop_stale, metrics=metrics)
        # a history-recovered view already holds federated objects: the
        # registry must mirror them or the first reconcile can't delete
        # what vanished upstream while we were down (the app constructs
        # the serve plane — and runs WAL recovery — before this plane)
        seeded = self.merge.seed_from_view()
        if seeded:
            logger.info(
                "Federation registry seeded with %d recovered merged object(s)", seeded
            )
        self.reconnects_counter = metrics.counter("federation_reconnects") if metrics else None
        self.resyncs_counter = metrics.counter("federation_resyncs") if metrics else None
        self.stalls_counter = metrics.counter("federation_heartbeat_stalls") if metrics else None
        self.snapshots_counter = metrics.counter("federation_snapshots") if metrics else None
        self.deltas_counter = metrics.counter("federation_deltas_applied") if metrics else None
        # fan-in batching visibility: deltas/batches = the realized batch
        # size (1.0 means the wire is delivering per-delta — the thing
        # this plane exists to avoid under churn)
        self.batches_counter = metrics.counter("federation_batches_applied") if metrics else None
        self.stale_transitions_counter = (
            metrics.counter("federation_stale_transitions") if metrics else None
        )
        self.connected_gauge = (
            metrics.gauge("federation_upstreams_connected") if metrics else None
        )
        # the freshness plane's cross-cluster histograms, fed by the
        # negotiated per-frame stamps in _on_batch: end-to-end
        # watch->global-view propagation and the serve-wire hop alone
        # (upstream publish -> federator receive). Wall-clock spans
        # across hosts — see ARCHITECTURE "Freshness & SLO plane".
        self.watch_to_global = (
            metrics.histogram("watch_to_global_view_seconds") if metrics else None
        )
        self.serve_wire = (
            metrics.histogram("serve_wire_seconds") if metrics else None
        )
        if metrics is not None:
            # the per-upstream label dimension is bounded by CONFIG, not
            # by the registry's generic 64-set default: widen each
            # family's cardinality cap to fit the declared upstream list
            # (a 100-upstream federation is a legitimate bounded
            # dimension; a pod-uid label still is not)
            cap = max(MAX_LABEL_SETS, len(config.upstreams) + 8)
            for family_name in (
                "federation_upstream_lag_rv",
                "federation_upstream_lag_seconds",
                "federation_upstream_stale",
                "federation_upstream_watermark_age_seconds",
                "federation_upstream_last_delta_age_seconds",
                "federation_upstream_oldest_unpropagated_seconds",
            ):
                metrics.gauge(family_name).max_label_sets = cap
        # sharded fan-in (federation.processes > 0): merge workers own
        # the subscribers AND the staleness verdicts; this plane is the
        # sequencer + mirror. Exactly one staleness owner, ever — the
        # field makes the split greppable and testable instead of a
        # tick-time accident (a sharded deploy must never double-report
        # federation_upstream_stale from two clocks).
        self.processes = int(getattr(config, "processes", 0) or 0)
        self.staleness_owner = "merge-workers" if self.processes > 0 else "monitor"
        self.fanin = None
        self.mirrors: List[_UpstreamMirror] = []
        if self.processes > 0:
            from k8s_watcher_tpu_torch.federate.fanin import ShardedFanin

            if trace_collector is not None:
                # schema forbids the pairing (trace.federation requires
                # processes: 0); guard direct constructions too — merge
                # workers negotiate trace off, so the collector would
                # silently join nothing
                logger.warning(
                    "Joined-trace collection is not available with the sharded "
                    "fan-in (federation.processes > 0); ignoring the collector"
                )
                self.trace_collector = None
            self.fanin = ShardedFanin(
                config,
                self.merge,
                metrics=metrics,
                token_dir=token_dir,
                resume_tokens_valid=resume_tokens_valid,
                trace_ring=trace_ring,
                process_export=process_export,
            )
            self.upstreams: List[_Upstream] = []
            self.mirrors = [_UpstreamMirror(self, u) for u in config.upstreams]
        else:
            self.upstreams = [
                _Upstream(self, u, i) for i, u in enumerate(config.upstreams)
            ]
        # staleness floor mirrors FleetSubscriber's: the wire heartbeats
        # every 2 s when idle, so a sub-3s threshold would call every
        # healthy idle upstream dead between SYNCs
        self.stale_threshold = max(3.0, config.stale_after_seconds)
        self._started = False
        self._started_t = 0.0
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    def token_store_for(self, name: str) -> Optional[TokenStore]:
        if not self.token_dir:
            return None
        return TokenStore(os.path.join(self.token_dir, f"{_metric_suffix(name)}.token"))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FederationPlane":
        self._stop.clear()
        self._started = True
        self._started_t = time.monotonic()
        if self.fanin is not None:
            # token clearing on an invalid resume line happens inside
            # the fan-in (same files, same warning shape)
            self.fanin.start()
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="federate-monitor", daemon=True
            )
            self._monitor.start()
            logger.info(
                "Federation plane started (sharded fan-in): %d merge worker(s) "
                "over %d upstream(s) (stale_after=%.1fs, drop_stale=%s, "
                "staleness_owner=%s)",
                len(self.fanin.endpoints), len(self.config.upstreams),
                self.config.stale_after_seconds, self.config.drop_stale,
                self.staleness_owner,
            )
            return self
        if not self.resume_tokens_valid:
            for upstream in self.upstreams:
                store = upstream.subscriber.token_store
                if store is not None:
                    store.clear()
            if self.token_dir:
                logger.warning(
                    "Merged view did not restart cleanly on its prior rv line; "
                    "cleared %d federation resume token(s) — upstream subscribers "
                    "will re-snapshot and reconcile", len(self.upstreams),
                )
        for upstream in self.upstreams:
            upstream.thread.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="federate-monitor", daemon=True
        )
        self._monitor.start()
        logger.info(
            "Federation plane started: %d upstream(s) [%s] (stale_after=%.1fs, drop_stale=%s)",
            len(self.upstreams),
            ", ".join(u.name for u in self.upstreams),
            self.config.stale_after_seconds,
            self.config.drop_stale,
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.fanin is not None:
            self.fanin.stop()
            if self._monitor is not None:
                self._monitor.join(timeout=2.0)
                self._monitor = None
            self._started = False
            return
        for upstream in self.upstreams:
            upstream.subscriber.stop()
        for upstream in self.upstreams:
            if upstream.thread.is_alive():
                upstream.thread.join(timeout=5.0)
                if upstream.thread.is_alive():
                    # subscriber.stop() aborts the blocking read, so this
                    # should never fire; if it does, the caller's next
                    # shutdown step (e.g. the WAL's terminal snapshot)
                    # may race a late delta — say so loudly
                    logger.warning(
                        "Federation subscriber %s did not stop within the join budget",
                        upstream.name,
                    )
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
            self._monitor = None
        for upstream in self.upstreams:
            upstream.sync_counters(self)
        self._started = False

    # -- the monitor tick --------------------------------------------------

    def _monitor_loop(self) -> None:
        interval = max(0.1, min(1.0, self.stale_threshold / 4.0))
        while not self._stop.wait(interval):
            self._tick()

    def _tick(self) -> None:
        if self.fanin is not None:
            self._tick_sharded()
            return
        now = time.monotonic()
        grace_over = now - self._started_t > self.stale_threshold
        connected = 0
        for upstream in self.upstreams:
            sub = upstream.subscriber
            age = sub.last_frame_age()
            if sub.connected:
                connected += 1
            fresh = age is not None and age <= self.stale_threshold
            if fresh:
                upstream.stale = False
            elif grace_over or age is not None:
                # dark past the threshold (or never reached at all once
                # the startup grace lapses)
                if not upstream.stale:
                    upstream.stale = True
                    if self.stale_transitions_counter is not None:
                        self.stale_transitions_counter.inc()
                    logger.warning(
                        "Federation upstream %s went stale (last frame %s ago)",
                        upstream.name, f"{age:.1f}s" if age is not None else "never",
                    )
                if self.config.drop_stale and not upstream.dropped:
                    # under the per-upstream lock (serialized against the
                    # subscriber's apply/reconcile) and with staleness
                    # RE-validated inside it: a reconcile racing this tick
                    # refreshes last_frame_age, so the drop backs off
                    # instead of deleting a just-repopulated cluster.
                    # Flagging before the delete makes any in-between
                    # delta raise ResyncRequired into a full reconcile;
                    # invalidate() makes the next (re)connect re-snapshot
                    # the objects back in — a token-resume must not skip
                    # re-materializing them.
                    with upstream.drop_lock:
                        age_now = sub.last_frame_age()
                        if age_now is None or age_now > self.stale_threshold:
                            upstream.dropped = True
                            sub.invalidate()
                            dropped = self.merge.drop_cluster(upstream.name)
                            logger.warning(
                                "Dropped %d stale object(s) of upstream %s from the global view",
                                dropped, upstream.name,
                            )
            upstream.sync_counters(self)
            upstream.update_gauges()
        if self.connected_gauge is not None:
            self.connected_gauge.set(connected)

    def _tick_sharded(self) -> None:
        """Mirror-only tick (``staleness_owner == "merge-workers"``):
        fold worker-reported per-upstream status into the gauges and
        health state. The staleness verdicts — and the drop-stale arm —
        are computed in the workers, never recomputed here; an upstream
        whose worker is mid-respawn simply keeps its last report."""
        report = self.fanin.upstream_report()
        connected = 0
        for mirror in self.mirrors:
            body = report.get(mirror.name)
            if body:
                mirror.fold(body, self)
            if mirror.last.get("connected"):
                connected += 1
        if self.connected_gauge is not None:
            self.connected_gauge.set(connected)

    # -- freshness ---------------------------------------------------------

    def freshness(self) -> Dict[str, Any]:
        """Per-upstream freshness watermarks + the propagation histogram
        summaries — the federation half of ``GET /debug/freshness``.

        What a watermark does and does NOT guarantee: it is the origin
        stamp of the newest APPLIED delta per upstream — it bounds how
        stale the merged copy of that cluster can be, but encodes no
        cross-cluster happens-before (two clusters' concurrent events
        interleave in arrival order), and cross-host spans compare wall
        clocks (skew shifts readings; the monotonic-local/wall-remote
        split is documented in ARCHITECTURE.md)."""
        out: Dict[str, Any] = {
            "upstreams": (
                {m.name: m.freshness() for m in self.mirrors}
                if self.fanin is not None
                else {u.name: u.freshness() for u in self.upstreams}
            ),
        }
        if self.watch_to_global is not None:
            out["watch_to_global_view_seconds"] = self.watch_to_global.summary()
            out["serve_wire_seconds"] = self.serve_wire.summary()
        return out

    # -- health ------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """Per-upstream liveness folded into the /healthz BODY: the plane
        is unhealthy while any upstream is stale (its slice of the global
        view is dark) or any subscriber thread died. The status server
        deliberately keeps this out of the liveness verdict (no 503) —
        restarting the federator cannot revive a dark remote cluster, and
        a liveness kill would wipe the last-known state the keep policy
        serves. Readiness probes and alerts key off ``healthy`` here."""
        if self.fanin is not None:
            upstreams = {m.name: m.status(self) for m in self.mirrors}
            healthy = not self._started or (
                self.fanin.workers_alive()
                and not any(m.stale for m in self.mirrors)
            )
            return {
                "healthy": healthy,
                "started": self._started,
                "upstreams": upstreams,
                "merged_objects": self.merge.object_count(),
                "drop_stale": self.config.drop_stale,
                "stale_after_seconds": self.stale_threshold,
                "staleness_owner": self.staleness_owner,
                "workers": self.fanin.worker_stats(),
            }
        upstreams = {u.name: u.status() for u in self.upstreams}
        healthy = not self._started or all(
            not u.stale and u.thread.is_alive() for u in self.upstreams
        )
        return {
            "healthy": healthy,
            "started": self._started,
            "upstreams": upstreams,
            "merged_objects": self.merge.object_count(),
            "drop_stale": self.config.drop_stale,
            "stale_after_seconds": self.stale_threshold,
            "staleness_owner": self.staleness_owner,
        }

    def process_report(self) -> List[Dict[str, Any]]:
        """Per-merge-worker supervision rows for ``/debug/processes``
        (empty in in-process mode — there are no worker processes)."""
        return self.fanin.process_report() if self.fanin is not None else []
