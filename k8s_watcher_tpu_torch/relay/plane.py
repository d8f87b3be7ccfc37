"""RelayPlane (the JAX package's ``relay/plane.py``): one upstream serving
plane mirrored, its frames re-broadcast with no re-encode.

- **Mirroring.** One ``FleetSubscriber`` in raw mode consumes the upstream's
  ``?watch=1`` stream. A snapshot is adopted wholesale
  (``FleetView.adopt_relay``: the upstream's instance id, rv and objects),
  so a resume token minted at the root resumes here and one minted here
  resumes at the root. Deltas are journaled at the upstream's rvs with the
  upstream's frame bytes stored as they are (``publish_relayed``), so
  ``serve_frame_encodes*`` stays 0 for relayed deltas; a variant the
  upstream wire did not carry is filled lazily, once per delta.
- **Sparse journal.** Where the upstream compacted the relay's stream (rv
  skips), reads resuming below the mark are flagged compacted, so a
  downstream gap check gets the same sanction.
- **Re-adopts.** An upstream restart or a relay fallen past the upstream's
  horizon re-adopts mid-life; existing subscribers get GONE/INVALID and
  re-snapshot from the relay, not from the root.
- **Backfill.** After a relay restart, ``relay.backfill`` deltas before the
  adopted snapshot are read from the upstream's journal, so tokens minted
  before the restart resume with deltas instead of a re-snapshot.
- **Depth.** The relay reads its upstream's depth from ``/serve/healthz``
  and serves its own as one more; ``depth_limit`` refuses deeper trees.
  Per-hop freshness rides the negotiated ``ts`` stamps
  (``relay_hop_seconds``, ``watch_to_relay_seconds``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional

from k8s_watcher_tpu_torch.federate.client import (
    FleetClient,
    FleetSubscriber,
    ResyncRequired,
    Snapshot,
)
from k8s_watcher_tpu_torch.serve.view import Delta, FleetView, chunk_wrap, frame_variant

logger = logging.getLogger(__name__)

#: extra rvs kept above the upstream's retention floor when choosing the
#: backfill base: churn between the healthz read and the watch connect
#: must not race the base past the floor into a resync loop
BACKFILL_FLOOR_MARGIN = 64


class RelayPlane:
    """Feeds a FleetView from one upstream serving plane (see module
    docstring). Built when ``relay.enabled``; the app starts it BEFORE
    the local serve plane binds and waits for the initial sync, so the
    first subscriber never sees a half-adopted view."""

    def __init__(self, config, view: FleetView, *, metrics=None):
        self.config = config
        self.view = view
        self.metrics = metrics
        self.depth: Optional[int] = None
        self.depth_exceeded = False
        self.adopts = 0
        self._sync_rv = -1  # rv of the last adopted upstream snapshot
        self._backfill_base = -1
        # True while the LAST adopt guessed a backfill base without
        # upstream retention info and hasn't seen a frame yet — the next
        # adopt then skips the guess (bounds a 410'd guess to one resync)
        self._blind_backfill = False
        self._synced = threading.Event()
        self._started = False
        self.client = FleetClient(
            config.upstream.url,
            token=config.upstream.token,
            # request timeout floored well above the staleness knob (the
            # federation plane's posture): a tight stale_after must not
            # shrink the snapshot-read budget with it
            timeout=max(5.0, config.stale_after_seconds),
            codec=config.codec,
            # the negotiated superset this relay's own clients may ask
            # for: stamped frames when relay.fresh (the default — depth
            # freshness needs ts anyway), trace forwarding when
            # relay.trace. An upstream that predates a field serves
            # plain frames and the passthrough stays byte-consistent.
            fresh=config.fresh,
            trace=config.trace,
        )
        self.subscriber = FleetSubscriber(
            self.client,
            on_snapshot=self._on_snapshot,
            on_raw_batch=self._on_raw_batch,
            stale_after_seconds=config.stale_after_seconds,
            backoff_seconds=config.resync_backoff_seconds,
            name=config.upstream.name,
        )
        self._thread: Optional[threading.Thread] = None
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if metrics is not None:
            self._frames_counter = metrics.counter("relay_frames_relayed")
            self._batches_counter = metrics.counter("relay_batches")
            self._bytes_counter = metrics.counter("relay_bytes")
            self._backfill_counter = metrics.counter("relay_backfill_deltas")
            self._adopts_counter = metrics.counter("relay_adopts")
            self._depth_gauge = metrics.gauge("relay_depth")
            self._lag_gauge = metrics.gauge("relay_lag_rv")
            self._connected_gauge = metrics.gauge("relay_connected")
            # per-hop freshness off the negotiated ts stamps (wall
            # clocks across hosts — the documented skew caveat applies):
            # hop = upstream publish -> relay receive; watch_to_relay =
            # origin -> relay apply (the tier-N propagation histogram)
            self._hop_hist = metrics.histogram("relay_hop_seconds")
            self._w2r_hist = metrics.histogram("watch_to_relay_seconds")
            # the cross-process encode-once invariant, surfaced: these
            # are the view's own counters, read back for health()
            self._encode_counters = tuple(
                metrics.counter(name)
                for name in (
                    "serve_frame_encodes",
                    "serve_frame_encodes_msgpack",
                    "serve_frame_encodes_fresh",
                    "serve_frame_encodes_trace",
                )
            )
        else:
            self._frames_counter = self._batches_counter = None
            self._bytes_counter = self._backfill_counter = None
            self._adopts_counter = None
            self._depth_gauge = self._lag_gauge = self._connected_gauge = None
            self._hop_hist = self._w2r_hist = None
            self._encode_counters = ()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RelayPlane":
        self._stop.clear()
        self._started = True
        self._thread = threading.Thread(
            target=self.subscriber.run, name="relay-subscriber", daemon=True
        )
        self._thread.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="relay-monitor", daemon=True
        )
        self._monitor.start()
        logger.info(
            "Relay plane started: upstream %s (%s), depth_limit=%d, codec=%s, "
            "fresh=%s, trace=%s, backfill=%d",
            self.config.upstream.name, self.config.upstream.url,
            self.config.depth_limit, self.config.codec,
            self.config.fresh, self.config.trace, self.config.backfill,
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        self.subscriber.stop()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        self._started = False

    def wait_synced(self, timeout: float) -> bool:
        """Block until the first upstream adopt (+ backfill catch-up to
        the snapshot rv) or ``timeout``. The app gates local serving on
        this so the first subscriber never races a half-warmed journal;
        on timeout serving starts anyway (degraded — health says so)."""
        ok = self._synced.wait(timeout)
        if not ok:
            logger.warning(
                "Relay did not sync with upstream %s within %.1fs; serving "
                "anyway (degraded until the upstream answers)",
                self.config.upstream.url, timeout,
            )
        return ok

    # -- subscriber callbacks (subscriber thread) --------------------------

    def _on_snapshot(self, snap: Snapshot) -> None:
        """Adopt the upstream state wholesale, then aim the watch cursor
        BELOW the snapshot for the journal backfill."""
        info: Dict[str, Any] = {}
        try:
            info = self.client.healthz() or {}
        except Exception:  # noqa: BLE001 - healthz is advisory
            info = {}
        upstream_depth = 0
        relay_fold = info.get("relay")
        if isinstance(relay_fold, dict):
            try:
                upstream_depth = int(relay_fold.get("depth") or 0)
            except (TypeError, ValueError):
                upstream_depth = 0
        depth = upstream_depth + 1
        if depth > self.config.depth_limit:
            # the loop-breaker: a relay cycle re-discovers a growing
            # depth on every reconnect and self-quarantines here instead
            # of circulating frames forever. MUST be ResyncRequired: its
            # subscriber arm clears the resume cursor (rv=None), so every
            # escalating backoff re-snapshots and re-checks the depth — a
            # transient-error exception here would leave _resnapshot's
            # already-set cursor in place and the next iteration would
            # stream frames into a view this relay never adopted.
            self.depth_exceeded = True
            raise ResyncRequired(
                f"relay depth {depth} exceeds relay.depth_limit="
                f"{self.config.depth_limit} (upstream {self.config.upstream.url} "
                f"reports depth {upstream_depth}) — mis-wired relay chain?"
            )
        self.depth_exceeded = False
        self.depth = depth
        if self._depth_gauge is not None:
            self._depth_gauge.set(depth)
        self.view.adopt_relay(
            instance=snap.view,
            rv=snap.rv,
            objects={
                (o.get("kind", ""), o.get("key", "")): o for o in snap.objects
            },
        )
        self._sync_rv = snap.rv
        self.adopts += 1
        if self._adopts_counter is not None:
            self._adopts_counter.inc()
        # backfill base: recent window below the snapshot, floored by the
        # upstream's retention (+ a churn margin so the watch connect
        # doesn't race the floor into a pre-stream 410 loop). When the
        # upstream's healthz doesn't advertise oldest_rv (bare
        # ServeServer, older build), we still ATTEMPT the backfill — but
        # only while the previous adopt wasn't itself a blind attempt
        # that 410'd before delivering a frame (self._blind_backfill):
        # that alternation bounds a too-deep guess to one extra resync
        # instead of a loop.
        base = snap.rv
        if self.config.backfill > 0:
            oldest = info.get("oldest_rv")
            if isinstance(oldest, int) and not isinstance(oldest, bool):
                base = max(oldest, snap.rv - self.config.backfill)
                if base == oldest and snap.rv - base > 2 * BACKFILL_FLOOR_MARGIN:
                    # pinned at the retention floor of a deep window:
                    # stand clear of the advancing trim so the watch
                    # connect doesn't race it into a pre-stream 410
                    base += BACKFILL_FLOOR_MARGIN
                base = min(base, snap.rv)
                self._blind_backfill = False
            elif not self._blind_backfill:
                base = max(0, snap.rv - self.config.backfill)
                self._blind_backfill = base < snap.rv
        self._backfill_base = base
        # the subscriber's next watch window starts at the backfill base
        # (we run on its thread, between its _resnapshot and its
        # _watch_window — the one safe moment to retarget the cursor)
        self.subscriber.rv = base
        if base >= snap.rv:
            self._synced.set()
        logger.info(
            "Relay adopted upstream %s at rv=%d (view=%s, depth=%d%s)",
            self.config.upstream.name, snap.rv, snap.view, depth,
            f", backfilling from rv={base}" if base < snap.rv else "",
        )

    def _on_raw_batch(self, pairs) -> None:
        """Fold one wire read: chunk-frame the upstream payload bytes
        (a length prefix — never a re-serialization) and journal them at
        their upstream rvs. Entries at or below the adopted snapshot rv
        are backfill (journal only); the rest fold object state too."""
        if not pairs:
            return
        self._blind_backfill = False  # the guessed base delivered frames
        now_wall = time.time()
        t_mono = time.monotonic()
        variant = frame_variant(
            self.client.active_codec, self.config.fresh, self.config.trace
        )
        sync_rv = self._sync_rv
        backfill = []
        live = []
        nbytes = 0
        hop = self._hop_hist
        w2r = self._w2r_hist
        for frame, raw in pairs:
            rv = frame["rv"]
            ts = frame.get("ts")
            ts_wall, pub_wall = (ts[0], ts[1]) if ts else (None, 0.0)
            delta = Delta(
                rv, frame.get("kind", ""), frame.get("key", ""), frame["type"],
                frame.get("object"), t_mono, ts_wall, pub_wall,
                frame.get("trace"),
            )
            chunked = chunk_wrap(raw)
            nbytes += len(raw)
            if rv <= sync_rv:
                backfill.append((delta, chunked))
            else:
                live.append((delta, chunked))
                if ts is not None:
                    # per-hop freshness (live frames only — backfill ages
                    # are history, not propagation)
                    if hop is not None:
                        hop.record(max(0.0, now_wall - ts[1]))
                    if w2r is not None:
                        w2r.record(max(0.0, now_wall - ts[0]))
        if backfill:
            n = self.view.publish_relayed(backfill, variant=variant, fold_objects=False)
            if self._backfill_counter is not None:
                self._backfill_counter.inc(n)
        if live:
            self.view.publish_relayed(live, variant=variant)
        if self._frames_counter is not None:
            self._frames_counter.inc(len(pairs))
            self._batches_counter.inc()
            self._bytes_counter.inc(nbytes)
        if not self._synced.is_set() and pairs[-1][0]["rv"] >= sync_rv:
            self._synced.set()

    # -- monitor tick ------------------------------------------------------

    def _monitor_loop(self) -> None:
        interval = max(0.1, min(1.0, self.config.stale_after_seconds / 4.0))
        while not self._stop.wait(interval):
            self._tick()

    def _tick(self) -> None:
        sub = self.subscriber
        rv = sub.rv
        # a SYNC heartbeat can outrun the journal only when the upstream
        # compacted/paged our stream: adopt the rv (sparse-sanctioned) so
        # downstream long-polls don't park behind a cursor the journal
        # will never mint
        if rv is not None and self._synced.is_set() and rv > self.view.rv:
            self.view.note_upstream_rv(rv)
        if self._lag_gauge is not None:
            self._lag_gauge.set(max(0, sub.wire_rv - (rv or 0)))
            self._connected_gauge.set(1.0 if sub.connected else 0.0)
        if not self._synced.is_set() and rv is not None and 0 <= self._sync_rv <= rv:
            self._synced.set()

    # -- surfaces ----------------------------------------------------------

    @property
    def synced(self) -> bool:
        return self._synced.is_set()

    def frame_encodes(self) -> Optional[int]:
        """Sum of the view's encode counters — 0 is the cross-process
        encode-once invariant for a relay whose subscribers all ride the
        upstream-negotiated frame shape."""
        if not self._encode_counters:
            return None
        return sum(int(c.value) for c in self._encode_counters)

    def health(self) -> Dict[str, Any]:
        """The relay fold for ``/serve/healthz`` (downstream relays read
        ``depth`` here to stamp their own) and ``/debug/relay``. Healthy
        = subscriber thread alive, synced, inside the staleness window,
        and the depth limit holds. A dark upstream degrades this body
        but never the status plane's liveness verdict — restarting a
        relay cannot revive its upstream."""
        sub = self.subscriber
        thread_alive = self._thread is not None and self._thread.is_alive()
        age = sub.last_frame_age()
        stale = self._started and (
            age is None or age > max(3.0, self.config.stale_after_seconds)
        )
        healthy = (
            not self._started
            or (
                thread_alive
                and self._synced.is_set()
                and not self.depth_exceeded
                and not stale
            )
        )
        return {
            "healthy": healthy,
            "started": self._started,
            "thread_alive": thread_alive,
            "synced": self._synced.is_set(),
            "depth": self.depth,
            "depth_limit": self.config.depth_limit,
            "depth_exceeded": self.depth_exceeded,
            "upstream": self.config.upstream.name,
            "upstream_url": self.config.upstream.url,
            "connected": sub.connected,
            "stale": stale,
            "codec": self.client.active_codec,
            "rv": self.view.rv,
            "wire_rv": sub.wire_rv,
            "backfill_base": self._backfill_base,
            "adopts": self.adopts,
            "resyncs": sub.resyncs,
            "reconnects": sub.reconnects,
            "stalls": sub.stalls,
            "gaps": sub.checker.gaps,
            "dups": sub.checker.dups,
            "frames_relayed": sub.frames,
            "frame_encodes": self.frame_encodes(),
            "last_frame_age_seconds": round(age, 3) if age is not None else None,
            "last_error": sub.last_error,
        }
