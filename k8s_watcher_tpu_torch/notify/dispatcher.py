"""Async notification dispatcher: keyed worker fan-out over per-lane FIFOs
(the JAX package's ``notify/dispatcher.py`` with ``coalesce=False``, and
without its trace, audit, micro-batching and egress-health parts, which no
probe notification uses).

The probe loop submits and returns; worker threads POST. One worker per
lane. Notifications hash by coalesce key (crc32) onto lanes, so one object's
updates keep their submit order; keyless ones (probe and remediation
reports) round-robin. A full lane drops its oldest entry
(``dispatch_dropped_overflow``) rather than block the producer.
``event_to_notify_latency`` is recorded when a POST completes.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import zlib
from typing import Callable, Optional, Tuple

from k8s_watcher_tpu_torch.config import AgentConfig
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.notification import Notification
from k8s_watcher_tpu_torch.notify.client import ClusterApiClient

logger = logging.getLogger(__name__)

_Key = Tuple[str, str]


def build_notifier(config: AgentConfig) -> ClusterApiClient:
    """The cluster API client of ``config.clusterapi``. The agent runs no
    watch ingest, so the pool is sized for one ingest shard."""
    c = config.clusterapi
    return ClusterApiClient(
        c.base_url,
        c.api_key,
        c.timeout,
        pod_update_endpoint=c.pod_update_endpoint,
        health_endpoint=c.health_endpoint,
        retry=c.retry,
        verify_tls=c.verify_tls,
        pool_size=c.resolved_pool_size(),
    )


def coalesce_key(notification: Notification) -> Optional[_Key]:
    """Ordering/coalescing identity, or None (a probe report carries distinct
    measurements). Pods key on uid, slices on the slice key, nodes on the
    node name."""
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
    """One worker's bounded FIFO of notifications."""

    __slots__ = ("cond", "entries", "high_water")

    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.entries: collections.deque = collections.deque()
        self.high_water = 0


class Dispatcher:
    def __init__(
        self,
        send: Callable[[dict], bool],
        *,
        capacity: int = 1024,
        workers: int = 2,
        metrics: Optional[MetricsRegistry] = None,
        abort: Optional[Callable[[], None]] = None,
    ):
        """``capacity`` is the total backlog bound, split evenly across the
        lanes. ``abort`` is called when stop()'s drain window expires with
        sends in flight and must cut them (``ClusterApiClient.abort``)."""
        self._send = send
        self._abort_cb = abort
        self._workers = max(1, workers)
        self._lanes = [_Lane() for _ in range(self._workers)]
        self._lane_capacity = max(1, capacity // self._workers)
        self.metrics = metrics or MetricsRegistry()
        self._threads: list = []
        self._started = False
        self._start_lock = threading.Lock()
        self._stopping = threading.Event()
        self._abandon = threading.Event()  # the drain window expired
        # accepted-but-undelivered entries; drain() waits on this condition
        self._drain_cond = threading.Condition()
        self._outstanding = 0
        self._rr = 0  # round-robin cursor for keyless notifications

    def start(self) -> None:
        with self._start_lock:
            if self._started:
                return
            self._started = True
            for i, lane in enumerate(self._lanes):
                t = threading.Thread(target=self._worker, args=(lane,), name=f"notify-worker-{i}", daemon=True)
                t.start()
                self._threads.append(t)

    # -- submit side --------------------------------------------------------

    def _lane_index_for(self, key: Optional[_Key]) -> int:
        if key is None:
            self._rr = rr = (self._rr + 1) % self._workers
            return rr
        return zlib.crc32(f"{key[0]}\x00{key[1]}".encode()) % self._workers

    def submit(self, notification: Notification) -> bool:
        """Enqueue without blocking. False only during shutdown; overflow
        never rejects the new entry (the lane's oldest is dropped and
        counted), so backpressure shows in the drop counters."""
        if self._stopping.is_set():
            self.metrics.counter("dispatch_dropped_stopping").inc()
            return False
        if not self._started:
            self.start()
        lane = self._lanes[self._lane_index_for(coalesce_key(notification))]
        dropped = 0
        with lane.cond:
            while len(lane.entries) >= self._lane_capacity:
                lane.entries.popleft()
                dropped += 1
            # outstanding before the entry is claimable: a fast worker's
            # completion must not zero the balance with this send pending
            with self._drain_cond:
                self._outstanding += 1
            lane.entries.append(notification)
            depth = len(lane.entries)
            if depth > lane.high_water:
                lane.high_water = depth
                self.metrics.gauge("dispatch_lane_high_water").set_max(depth)
            lane.cond.notify()
        if dropped:
            self.metrics.counter("dispatch_dropped_overflow").inc(dropped)
            self._finish(dropped)
        self.metrics.counter("dispatch_enqueued").inc()
        return True

    # -- worker side ---------------------------------------------------------

    def _worker(self, lane: _Lane) -> None:
        hist = self.metrics.histogram("event_to_notify_latency")
        while True:
            if self._abandon.is_set():
                return  # the drain window expired: leave the backlog unclaimed
            with lane.cond:
                if not lane.entries:
                    if self._stopping.is_set():
                        return
                    lane.cond.wait(0.1)
                    continue
                notification = lane.entries.popleft()
            ok = False
            try:
                ok = self._send(notification.payload)
            except Exception as exc:  # the send contract is boolean, but be safe
                logger.error("Notifier raised: %s", exc)
            if ok:
                hist.record(time.monotonic() - notification.received_monotonic)
                self.metrics.counter("dispatch_sent").inc()
            else:
                self.metrics.counter("dispatch_failed").inc()
            self._finish(1)

    def _finish(self, n: int) -> None:
        with self._drain_cond:
            self._outstanding -= n
            if self._outstanding <= 0:
                self._drain_cond.notify_all()

    # -- drain / shutdown ----------------------------------------------------

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait (bounded) until every accepted notification was sent, failed
        or dropped; True if fully drained."""
        with self._drain_cond:
            return self._drain_cond.wait_for(lambda: self._outstanding <= 0, timeout)

    def stop(self, drain_timeout: float = 5.0) -> None:
        """Shut down within ~``drain_timeout``: refuse new submits, give the
        backlog 90% of the window, then abort what still runs."""
        if not self._started or self._stopping.is_set():
            return
        drain_timeout = max(0.1, drain_timeout)
        deadline = time.monotonic() + drain_timeout
        self._stopping.set()
        for lane in self._lanes:
            with lane.cond:
                lane.cond.notify_all()
        drained = self.drain(drain_timeout * 0.9)
        if not drained:
            with self._drain_cond:
                backlog = max(0, self._outstanding)
            logger.warning("Notify drain window expired with %d undelivered; aborting in-flight sends", backlog)
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
        # a submit that passed the stopping check just before it was set can
        # land after the workers exited: account for such strays
        strays = 0
        for lane in self._lanes:
            with lane.cond:
                strays += len(lane.entries)
                lane.entries.clear()
        if strays:
            self._finish(strays)
            if drained:
                logger.warning("%d notification(s) accepted mid-shutdown were never sent", strays)
                self.metrics.counter("dispatch_abandoned_shutdown").inc(strays)
