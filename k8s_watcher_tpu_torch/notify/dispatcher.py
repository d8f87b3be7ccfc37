"""Async notification dispatcher: keyed worker fan-out over per-lane FIFOs
(the JAX package's ``notify/dispatcher.py``).

The pipeline (and the probe agent) submit and return; worker threads drain
their lanes and the event→notify latency histogram is recorded when the POST
*completes*, the honest end-to-end number.

- **Keyed lanes.** Notifications hash by coalesce key (crc32, stable) onto
  ``workers`` FIFO lanes, one worker per lane. One pod's updates always ride
  one lane → one worker → submit-order delivery; DISTINCT pods spread
  across lanes and POST concurrently. Keyless notifications (probe
  reports) round-robin — they carry no ordering contract.
- **Adaptive coalescing.** Latest-wins collapse is a LOSS (the receiver
  misses intermediate transitions); it exists to bound backlog, not to be
  the steady state. With ``coalesce_watermark > 0``, same-key updates
  queue uncollapsed while the lane is shallower than the watermark and
  only start collapsing once backlog proves the egress side is behind.
  ``coalesce_watermark=0`` collapses whenever a same-key payload waits.
- **Micro-batching.** When a lane has more than one claimable entry and a
  ``send_batch`` callable is wired (ClusterApiClient.update_pod_statuses),
  the worker drains up to ``batch_max`` entries into ONE batched POST.
  ``send_batch`` returning None means the receiver doesn't support the
  batch endpoint — the worker falls back to per-item sends for that batch
  (and the client remembers, so the probe costs one request ever).

Backpressure policy, in order: adaptive coalescing (above), then
**drop-oldest** when the bounded lane still fills (pathological fan-out of
distinct keys): the oldest entry in the lane is dropped (and counted)
rather than blocking the watch stream.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import zlib
from typing import Any, Callable, List, Optional, Tuple, Union

from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.notify.client import ClusterApiClient
from k8s_watcher_tpu_torch.pipeline.pipeline import Notification
from k8s_watcher_tpu_torch.trace import clear_current_traces, send_attempts, set_current_traces

logger = logging.getLogger(__name__)

_Key = Tuple[str, str]


def build_notifier(config: Any) -> ClusterApiClient:
    """The cluster API client of ``config.clusterapi`` (an ``AppConfig`` or
    the agent's ``AgentConfig``), with one keep-alive connection per egress
    worker, so workers never serialize on a shared socket. The agent runs no
    watch ingest: its pool is sized for one ingest shard."""
    c = config.clusterapi
    ingest = getattr(config, "ingest", None)
    return ClusterApiClient(
        c.base_url,
        c.api_key,
        c.timeout,
        pod_update_endpoint=c.pod_update_endpoint,
        pod_update_batch_endpoint=c.pod_update_batch_endpoint,
        health_endpoint=c.health_endpoint,
        retry=c.retry,
        verify_tls=c.verify_tls,
        pool_size=c.resolved_pool_size(ingest.shards if ingest is not None else 1),
    )


def coalesce_key(notification: Notification) -> Optional[_Key]:
    """Ordering/coalescing identity of a notification, or None if it has
    neither (each probe report carries distinct measurements). Pods key on
    uid, slices on the slice key, nodes on the node name."""
    payload = notification.payload
    if notification.kind == "pod":
        uid = payload.get("uid")
        return ("pod", uid) if uid else None
    if notification.kind == "slice":
        key = payload.get("slice")
        return ("slice", key) if key else None
    if notification.kind == "node":
        key = payload.get("node")
        return ("node", key) if key else None
    return None


class _Lane:
    """One worker's bounded FIFO: entries are either a Notification
    (keyless) or a _Key marker. Markers map 1:1 onto elements of
    ``waiting[key]`` (a per-key FIFO of payloads), which is what keeps
    per-key submit order exact under coalescing, overflow AND the
    mixed collapse/no-collapse regimes of the adaptive watermark."""

    __slots__ = ("cond", "entries", "waiting", "high_water", "progress")

    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.entries: collections.deque = collections.deque()
        self.waiting: dict = {}  # _Key -> deque[Notification]
        self.high_water = 0
        # last time this lane's worker claimed or completed work —
        # egress_health's wedge detector (a lane with backlog whose
        # stamp stopped moving has a worker stuck in a send)
        self.progress = time.monotonic()


class Dispatcher:
    def __init__(
        self,
        send: Callable[[dict], bool],
        *,
        capacity: int = 1024,
        workers: int = 2,
        coalesce: bool = True,
        coalesce_watermark: int = 0,
        metrics: Optional[MetricsRegistry] = None,
        abort: Optional[Callable[[], None]] = None,
        send_batch: Optional[Callable[[List[dict]], Optional[List[bool]]]] = None,
        batch_max: int = 16,
        tracer=None,  # trace.Tracer: span stamps + terminal accounting
        audit=None,  # metrics.audit.AuditRing: egress terminal outcomes
    ):
        """``abort``: called when stop()'s drain window expires with sends
        still in flight — it must cut them fast (ClusterApiClient.abort
        closes live sockets and cancels retry backoff), making
        ``drain_timeout`` a real bound on shutdown even against a dead or
        hung notify target.

        ``capacity`` is the TOTAL backlog bound, split evenly across the
        per-worker lanes. ``coalesce_watermark``: lane depth at which
        latest-wins collapse starts (0 = collapse whenever a same-key
        payload is still waiting).
        ``send_batch``/``batch_max``: see the module docstring."""
        self._send = send
        self._send_batch = send_batch
        self._batch_max = max(1, batch_max)
        self._abort_cb = abort
        self._workers = max(1, workers)
        self._lanes = [_Lane() for _ in range(self._workers)]
        self._lane_capacity = max(1, capacity // self._workers)
        self._coalesce = coalesce
        # clamp the watermark below the per-lane capacity: overflow caps
        # lane depth at _lane_capacity, so a watermark at or above it
        # would be unreachable — adaptive coalescing would silently never
        # engage and backpressure would degrade to pure drop-oldest loss
        # (e.g. auto-scaled workers shrinking each lane's share)
        self._coalesce_watermark = min(
            max(0, coalesce_watermark), max(1, self._lane_capacity // 2)
        )
        self.metrics = metrics or MetricsRegistry()
        self.tracer = tracer
        self.audit = audit
        self._threads: list = []
        self._started = False
        # serializes the check-then-spawn in start(): two producers'
        # first submit() calls racing the auto-start must not each spawn
        # a worker set (2x the configured POST fan-out)
        self._start_lock = threading.Lock()
        self._stopping = threading.Event()
        # set when the drain window expired: workers stop claiming work
        self._abandon = threading.Event()
        # accepted-but-undelivered entries; drain() blocks on this
        # condition instead of polling (submit +1; send completion,
        # overflow drop and the shutdown sweep -1)
        self._drain_cond = threading.Condition()
        self._outstanding = 0
        self._rr = 0  # round-robin cursor for keyless notifications

    # -- introspection -------------------------------------------------------

    @property
    def lane_high_water(self) -> int:
        return max(lane.high_water for lane in self._lanes)

    def lane_depths(self) -> List[int]:
        return [len(lane.entries) for lane in self._lanes]

    def start(self) -> None:
        with self._start_lock:
            if self._started:
                return
            self._started = True
            for i, lane in enumerate(self._lanes):
                t = threading.Thread(
                    target=self._worker, args=(i, lane),
                    name=f"notify-worker-{i}", daemon=True,
                )
                t.start()
                self._threads.append(t)

    # -- submit side --------------------------------------------------------

    def _lane_index_for(self, key: Optional[_Key]) -> int:
        if key is None:
            # keyless: no ordering contract, spread the load (plain int
            # increment; a rare race only skews balance, never correctness)
            self._rr = rr = (self._rr + 1) % self._workers
            return rr
        return zlib.crc32(f"{key[0]}\x00{key[1]}".encode()) % self._workers

    def _lane_for(self, key: Optional[_Key]) -> _Lane:
        return self._lanes[self._lane_index_for(key)]

    def submit(self, notification: Notification) -> bool:
        """Enqueue without blocking; coalesce per-key above the watermark,
        drop-oldest on overflow. Returns True when the notification (or,
        under coalescing, a queue slot now carrying ITS payload as the
        key's latest state) was accepted. Lossy semantics under pressure:
        acceptance is not a delivery guarantee — a later overflow drop may
        still evict this key's oldest waiting payload (counted as
        ``dispatch_dropped_overflow``). Returns False only for shutdown in
        progress — overflow never rejects the NEW entry (the oldest queued
        one is evicted instead), so callers must watch the drop counters,
        not the return value, for backpressure."""
        if self._stopping.is_set():
            self.metrics.counter("dispatch_dropped_stopping").inc()
            # the audit ring records UNtraced shutdown drops too — same
            # "what happened to my pod's notification" contract the
            # overflow/abandon paths honor (_egress_terminal itself no-ops
            # when neither a trace nor a ring nor a tracer is wired)
            self._egress_terminal(notification, "dropped_stopping", lane=None)
            return False
        if not self._started:
            self.start()

        # the key decides the LANE whether or not collapsing is enabled:
        # per-key submit-order delivery is the structural contract,
        # coalescing is only the backpressure policy on top of it
        key = coalesce_key(notification)
        lane_index = self._lane_index_for(key)
        lane = self._lanes[lane_index]
        trace = notification.trace
        if trace is not None:
            trace.lane = lane_index
            trace.lane_enter = time.monotonic()
        counter = self.metrics.counter
        dropped = dropped_coalesced = 0
        replaced: Optional[Notification] = None
        evicted: List[Notification] = []
        with lane.cond:
            if key is not None and self._coalesce:
                q = lane.waiting.get(key)
                if q and len(lane.entries) >= self._coalesce_watermark:
                    # backlog past the watermark: latest-wins on the key's
                    # NEWEST waiting payload — no new slot, order intact
                    replaced = q[-1]
                    q[-1] = notification
                else:
                    if q is None:
                        q = lane.waiting[key] = collections.deque()
                    q.append(notification)
            if replaced is None:
                if key is not None and self._coalesce:
                    entry: Union[Notification, _Key] = key
                else:
                    entry = notification
                while len(lane.entries) >= self._lane_capacity:
                    oldest = lane.entries.popleft()
                    # (cannot be our own entry: it isn't enqueued yet)
                    if not isinstance(oldest, Notification):
                        oq = lane.waiting.get(oldest)
                        if oq:
                            # markers map 1:1 onto waiting payloads
                            evicted.append(oq.popleft())
                            if not oq:
                                del lane.waiting[oldest]
                            dropped_coalesced += 1
                    else:
                        evicted.append(oldest)
                    dropped += 1
                # count the entry outstanding BEFORE it becomes claimable
                # (we still hold lane.cond): counting after the unlock
                # would let a fast worker's completion transiently zero
                # the balance and wake drain() with another send in flight
                with self._drain_cond:
                    self._outstanding += 1
                lane.entries.append(entry)
                depth = len(lane.entries)
                if depth > lane.high_water:
                    lane.high_water = depth
                    self.metrics.gauge("dispatch_lane_high_water").set_max(depth)
                lane.cond.notify()
        # terminal accounting OUTSIDE lane.cond: trace finish takes the
        # ring lock and may log — never under a lane lock
        if replaced is not None:
            counter("dispatch_coalesced").inc()
            if replaced.trace is not None:
                self._egress_terminal(replaced, "coalesced", lane=lane_index)
            return True
        if dropped:
            counter("dispatch_dropped_overflow").inc(dropped)
            if dropped_coalesced:
                counter("dispatch_dropped_overflow_coalesced").inc(dropped_coalesced)
            for victim in evicted:
                self._egress_terminal(victim, "dropped_overflow", lane=lane_index)
            self._finish(dropped)
        counter("dispatch_enqueued").inc()
        return True

    # -- worker side ---------------------------------------------------------

    @staticmethod
    def _claim(lane: _Lane, entry: Union[Notification, _Key]) -> Notification:
        """Resolve an entry to its payload-bearing Notification. Call under
        ``lane.cond``. Never misses: markers and waiting payloads are
        maintained 1:1 by submit and the overflow drop."""
        if isinstance(entry, Notification):
            return entry
        q = lane.waiting[entry]
        notification = q.popleft()
        if not q:
            del lane.waiting[entry]
        return notification

    def _worker(self, index: int, lane: _Lane) -> None:
        hist = self.metrics.histogram("event_to_notify_latency")
        while True:
            if self._abandon.is_set():
                return  # drain window expired: leave the backlog unclaimed
            with lane.cond:
                if not lane.entries:
                    if self._stopping.is_set():
                        return
                    lane.cond.wait(0.1)
                    continue
                take = 1
                if self._send_batch is not None and self._batch_max > 1:
                    # micro-batching is backlog-driven: a quiet lane sends
                    # single POSTs (no added latency); a backlog drains in
                    # batched POSTs
                    take = min(len(lane.entries), self._batch_max)
                claimed = [self._claim(lane, lane.entries.popleft()) for _ in range(take)]
                lane.progress = time.monotonic()
            self._deliver(claimed, hist, lane_index=index, lane=lane)

    def _deliver(
        self,
        notifications: List[Notification],
        hist,
        lane_index: Optional[int] = None,
        lane: Optional[_Lane] = None,
    ) -> None:
        claim_time = time.monotonic()
        traces = []
        for n in notifications:
            trace = n.trace
            if trace is not None:
                # lane_wait closes at claim; the send window (post span +
                # the client's conn_borrow stamps) starts here
                trace.add_span("lane_wait", trace.lane_enter or claim_time, claim_time)
                traces.append(trace)
        # park the in-flight traces for the client's conn_borrow/attempt
        # stamps; also zeroes the per-thread attempt counter so the audit
        # entry below reports attempts for UNtraced sends too. Skipped
        # entirely when neither consumer exists (a bare dispatcher) — the
        # previous window's clear leaves the thread-local empty.
        audit = self.audit
        window = bool(traces) or audit is not None
        if window:
            set_current_traces(tuple(traces))
        payloads = [n.payload for n in notifications]
        counter = self.metrics.counter
        results: Optional[List[bool]] = None
        if len(payloads) > 1 and self._send_batch is not None:
            try:
                results = self._send_batch(payloads)
                if results is not None:
                    # count only batch POSTs that actually completed — a
                    # raising batch path must not report a healthy batch rate
                    counter("dispatch_batches").inc()
                    counter("dispatch_batch_items").inc(len(payloads))
            except Exception as exc:  # send contract is list-or-None, but be safe
                logger.error("Batch notifier raised: %s", exc)
                results = [False] * len(payloads)
            if results is not None and len(results) < len(payloads):
                # a short result list (misbehaving receiver) must not
                # leave the tail uncounted — pad as failed
                results = list(results) + [False] * (len(payloads) - len(results))
        per_item_attempts: Optional[List[int]] = None
        per_item_ends: Optional[List[float]] = None
        if results is None:  # no batch path, or receiver doesn't support it
            results = []
            # per-item end stamps: this loop makes one POST per payload,
            # so closing every item at the loop's end would inflate each
            # post span (and watch_to_notify) by up to the claimed-batch
            # size worth of round-trips
            per_item_ends = []
            if window:
                # re-park PER ITEM for the same reason: leaving the whole
                # claim's traces parked would stamp every POST's
                # conn_borrow into every trace and report window-total
                # attempts on each
                per_item_attempts = []
            for notification, payload in zip(notifications, payloads):
                if per_item_attempts is not None:
                    item_trace = notification.trace
                    set_current_traces((item_trace,) if item_trace is not None else ())
                ok = False
                try:
                    ok = self._send(payload)
                except Exception as exc:  # send contract is boolean, but be safe
                    logger.error("Notifier raised: %s", exc)
                results.append(ok)
                per_item_ends.append(time.monotonic())
                if per_item_attempts is not None:
                    per_item_attempts.append(send_attempts())
        now = time.monotonic()
        # batch POSTs share one send window: the attempt count (and the
        # conn_borrow stamps above) legitimately apply to every item
        attempts = send_attempts() if window else 0
        if window:
            clear_current_traces()
        tracer = self.tracer
        sent = failed = 0
        for i, (notification, ok) in enumerate(zip(notifications, results)):
            if per_item_ends is not None:
                # item i's POST ran from the previous item's end (or the
                # claim) to its own stamp — not the whole loop's window
                item_start = per_item_ends[i - 1] if i else claim_time
                item_end = per_item_ends[i]
            else:
                item_start, item_end = claim_time, now
            if ok:
                sent += 1
                hist.record(item_end - notification.received_monotonic)
            else:
                failed += 1
            trace = notification.trace
            if trace is not None:
                trace.add_span("post", item_start, item_end)
            # terminal accounting only when someone records it: a traced
            # journey, an audit ring, or a failure the tracer must capture
            if trace is not None or audit is not None or (not ok and tracer is not None):
                self._egress_terminal(
                    notification, "sent" if ok else "failed",
                    lane=lane_index, end=item_end,
                    attempts=(
                        per_item_attempts[i] if per_item_attempts is not None
                        else attempts
                    ),
                )
        if sent:
            counter("dispatch_sent").inc(sent)
        if failed:
            counter("dispatch_failed").inc(failed)
        if lane is not None:
            lane.progress = now
        self._finish(len(notifications))

    def _egress_terminal(
        self,
        notification: Notification,
        outcome: str,
        *,
        lane: Optional[int],
        end: Optional[float] = None,
        attempts: int = 0,
    ) -> None:
        """One notification's terminal egress accounting: close its trace
        (building an after-the-fact anomaly trace for drops/failures head
        sampling missed) and append the outcome to the audit ring, so
        ``/debug/events`` answers "what happened to my pod's notification"
        — not just its pipeline decision. Coalesced collapses skip the
        audit ring (they arrive at backlog rates and would evict the
        terminal outcomes operators actually ask about); their traces
        still complete normally."""
        tracer = self.tracer
        trace = notification.trace
        if tracer is not None:
            if trace is None and outcome in ("failed", "dropped_overflow", "abandoned"):
                payload = notification.payload
                trace = tracer.start_anomaly(
                    uid=str(payload.get("uid") or ""),
                    name=str(payload.get("name") or ""),
                    kind=notification.kind,
                    t0=notification.received_monotonic,
                )
            if trace is not None:
                if trace.lane is None:
                    trace.lane = lane
                if attempts and not trace.attempts:
                    trace.attempts = attempts
                tracer.finish(trace, outcome, end=end)
        if self.audit is not None and outcome != "coalesced":
            payload = notification.payload
            entry = {
                "kind": "egress",
                "outcome": outcome,
                "notify_kind": notification.kind,
                "uid": payload.get("uid"),
                "name": payload.get("name"),
                "lane": lane,
                "attempts": attempts or (trace.attempts if trace is not None else 0),
            }
            if trace is not None:
                entry["trace_id"] = trace.trace_id
            self.audit.record(entry)

    def egress_health(self, stall_after_seconds: float = 120.0) -> dict:
        """Liveness verdict for ``/healthz``: unhealthy when every worker
        thread is dead, or when any lane with backlog has made no progress
        for ``stall_after_seconds`` (its worker is wedged inside a send
        against a hung target). A dispatcher that never started, or is
        shutting down, reports healthy — lifecycle states, not faults."""
        now = time.monotonic()
        started = self._started
        stopping = self._stopping.is_set()
        workers_alive = sum(1 for t in self._threads if t.is_alive())
        stalled: List[dict] = []
        if started and not stopping:
            for i, lane in enumerate(self._lanes):
                with lane.cond:
                    depth = len(lane.entries)
                    age = now - lane.progress
                if depth > 0 and age > stall_after_seconds:
                    stalled.append(
                        {"lane": i, "depth": depth, "stalled_seconds": round(age, 1)}
                    )
        healthy = (not started) or stopping or (workers_alive > 0 and not stalled)
        with self._drain_cond:
            outstanding = self._outstanding
        return {
            "healthy": healthy,
            "started": started,
            "workers": self._workers,
            "workers_alive": workers_alive,
            "stall_after_seconds": stall_after_seconds,
            "stalled_lanes": stalled,
            "outstanding": outstanding,
        }

    def _finish(self, n: int) -> None:
        with self._drain_cond:
            self._outstanding -= n
            if self._outstanding <= 0:
                self._drain_cond.notify_all()

    # -- drain / shutdown ----------------------------------------------------

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait (bounded) until every accepted notification completed (sent,
        failed, or dropped); True if fully drained. Condition-based — the
        waiter wakes the moment the last send completes, not on the next
        tick of a poll loop."""
        with self._drain_cond:
            return self._drain_cond.wait_for(lambda: self._outstanding <= 0, timeout)

    def stop(self, drain_timeout: float = 5.0) -> None:
        """Shut down within ~``drain_timeout``: signal stop first (new
        submits are rejected), give in-flight + queued sends the drain
        window, then hard-abort whatever is still running so a dead or
        hung notify target cannot push shutdown past the grace budget
        k8s grants the pod (cli.py installs SIGTERM around this)."""
        if not self._started or self._stopping.is_set():
            return
        drain_timeout = max(0.1, drain_timeout)
        deadline = time.monotonic() + drain_timeout
        self._stopping.set()  # reject new submits; workers exit once dry
        for lane in self._lanes:
            with lane.cond:
                lane.cond.notify_all()
        # 90% of the budget drains; the rest joins workers post-abort
        drained = self.drain(drain_timeout * 0.9)
        if not drained:
            with self._drain_cond:
                backlog = max(0, self._outstanding)
            logger.warning(
                "Notify drain window expired with %d undelivered; aborting in-flight sends",
                backlog,
            )
            self.metrics.counter("dispatch_abandoned_shutdown").inc(backlog)
            self._abandon.set()
            for lane in self._lanes:
                with lane.cond:
                    lane.cond.notify_all()
            if self._abort_cb is not None:
                try:
                    self._abort_cb()
                except Exception:
                    logger.exception("Dispatcher abort callback failed")
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        # a submit() that passed the _stopping check just before set()
        # can land its entry AFTER drain saw an empty plane and the
        # workers exited — accepted (True, dispatch_enqueued counted) but
        # never claimable. Sweep and account the strays so no accepted
        # notification is lost UNACCOUNTED. (WatcherApp.shutdown stops
        # every producer before the dispatcher, so nothing races this
        # sweep itself.)
        strays = 0
        for i, lane in enumerate(self._lanes):
            # _claim resolves markers to their waiting payloads, so the
            # sweep never needs its own entry-type dispatch
            with lane.cond:
                abandoned: List[Notification] = [
                    self._claim(lane, lane.entries.popleft()) for _ in range(len(lane.entries))
                ]
            strays += len(abandoned)
            # terminal accounting outside lane.cond (ring lock + logging)
            for notification in abandoned:
                self._egress_terminal(notification, "abandoned", lane=i)
        if strays:
            self._finish(strays)
            # the drain-expiry branch above already counted its backlog —
            # only a CLEAN drain can have unaccounted strays
            if drained:
                logger.warning("%d notification(s) accepted mid-shutdown were never sent", strays)
                self.metrics.counter("dispatch_abandoned_shutdown").inc(strays)
