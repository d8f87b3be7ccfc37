"""Resilient node watch loop (the JAX package's ``nodes/watcher.py``; the
companion of k8s/watch.py's pod source).

Runs on its own thread with its OWN ``K8sClient`` (a client carries at most
one live watch — ``abort_watch`` closes it). Same resilience contract as
the pod source: list→watch with resourceVersion resume, exponential
backoff, 410-relist. Node readiness transitions flow two ways:

- a notification payload per transition (``NODE_CONDITION_CHANGE`` /
  ``NODE_DELETED``) through the dispatcher, and
- into the slice tracker (``note_node``), which may emit
  ``SLICE_PHASE_CHANGE`` notifications for slices whose members sit on the
  affected node — THIS is the fast path that beats pod eviction by minutes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from k8s_watcher_tpu_torch.config import RetryPolicy
from k8s_watcher_tpu_torch.k8s.client import K8sClient, K8sGoneError
from k8s_watcher_tpu_torch.nodes.tracker import NodeTracker
from k8s_watcher_tpu_torch.pipeline.pipeline import Notification

logger = logging.getLogger(__name__)


class NodeWatcher:
    def __init__(
        self,
        client: K8sClient,
        tracker: NodeTracker,
        sink,  # Callable[[Notification], Any] — normally Dispatcher.submit
        *,
        slice_tracker=None,  # slices.SliceTracker: gets note_node() on transitions
        label_selector: Optional[str] = None,
        retry: Optional[RetryPolicy] = None,
        watch_timeout_seconds: int = 300,
        metrics=None,
        list_page_size: int = 500,  # LIST pagination (limit+continue)
    ):
        self.client = client
        self.tracker = tracker
        self.sink = sink
        self.slice_tracker = slice_tracker
        self.label_selector = label_selector
        self.retry = retry or RetryPolicy()
        self.watch_timeout_seconds = watch_timeout_seconds
        self.list_page_size = list_page_size
        self.metrics = metrics
        self.resource_version: Optional[str] = None
        # set once the first node list has been folded: callers (and tests)
        # can sequence against startup instead of racing the initial relist
        self.synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "NodeWatcher":
        self._thread = threading.Thread(target=self._run, name="node-watch", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.client.abort_watch()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- internals ---------------------------------------------------------

    def node_existence(self, name: str):
        """Existence answer for the slice plane (``Optional[bool]``): None
        when this watcher's view can't prove absence — before the first
        list has landed, or when a label selector makes the view partial —
        else whether the node is in the cluster view."""
        if self.label_selector is not None or not self.synced.is_set():
            return None
        return self.tracker.exists(name)

    def _emit(self, event_type: str, node: dict, received_monotonic: float) -> None:
        name = (node.get("metadata") or {}).get("name", "")
        was_known = self.tracker.exists(name)
        payloads = self.tracker.observe(event_type, node)
        for payload in payloads:
            self.sink(Notification(payload, received_monotonic, kind="node"))
            if self.metrics is not None:
                self.metrics.counter("node_notifications_enqueued").inc()
        if self.slice_tracker is None:
            return
        # Sync slice state on EVERY determination, not only on notifying
        # transitions: a deleted node re-added Ready arrives as a silent
        # baseline observation, and skipping the sync would leave it in the
        # slice tracker's down-set forever. note_node is a cheap no-op when
        # nothing changes.
        after = self.tracker.is_ready(name)
        if event_type == "DELETED":
            if not was_known:
                # a node never in our cluster view (deleted before the
                # first list): nothing to fold — the slice plane's
                # existence provider / relist reconciliation covers it
                slice_payloads = []
            else:
                # any known node (TPU-tracked or not — a TPU pod can sit on
                # a node whose device plugin never reported) folds as down;
                # exists=False lets the entry prune once unreferenced
                slice_payloads = self.slice_tracker.note_node(name, False, exists=False)
        elif after is not None:  # None = untracked (non-TPU) or unheartbeated
            slice_payloads = self.slice_tracker.note_node(name, bool(after))
        else:
            slice_payloads = []
        for slice_payload in slice_payloads:
            self.sink(Notification(slice_payload, received_monotonic, kind="slice"))
            if self.metrics is not None:
                self.metrics.counter("slice_notifications_enqueued").inc()

    def _relist(self) -> None:
        """Paged node LIST (limit+continue, same contract as the pod
        source's relist): bounded responses, and the listed-name set
        resets when an expired continue token restarts the list from a
        new snapshot — tombstones must come from ONE snapshot's view."""
        now = time.monotonic()
        listed: set = set()
        rv = None
        # shared consumption loop (K8sClient.iter_list_pages): same
        # snapshot-reset/cost-metric invariants as the pod relist, node-
        # prefixed metric names
        for page_rv, items, restarted in K8sClient.iter_list_pages(
            self.client.list_nodes_paged(
                page_size=self.list_page_size, label_selector=self.label_selector,
            ),
            metrics=self.metrics,
            metric_prefix="node_relist",
        ):
            if restarted:
                listed.clear()
            rv = page_rv or rv
            for node in items:
                listed.add((node.get("metadata") or {}).get("name", ""))
                self._emit("ADDED", node, now)
        # nodes that vanished while we were disconnected
        for name in [n for n in self.tracker.known_nodes() if n not in listed]:
            self._emit("DELETED", {"metadata": {"name": name}}, now)
        self.tracker.reconcile_existence(listed)
        # nodes that vanished before we EVER listed them (deleted while the
        # watcher was down/unstarted): no DELETED event exists to fold, so
        # reconcile slice members directly against the fresh node-list.
        # Only an UNfiltered list proves absence — with a label selector a
        # member's node may simply not match the selector.
        if self.slice_tracker is not None and self.label_selector is None:
            for slice_payload in self.slice_tracker.reconcile_nodes(listed):
                self.sink(Notification(slice_payload, now, kind="slice"))
                if self.metrics is not None:
                    self.metrics.counter("slice_notifications_enqueued").inc()
        self.resource_version = rv
        self.synced.set()

    def _run(self) -> None:
        backoff = self.retry.delay_seconds
        need_list = True
        # consecutive watch-phase 410s with nothing healthy in between:
        # the first relists immediately (normal recovery), repeats back
        # off with escalation — same discipline as the pod watch loop,
        # minus the give-up (this daemon thread must never die)
        gone_streak = 0
        while not self._stop.is_set():
            try:
                if need_list:
                    try:
                        self._relist()
                    except K8sGoneError as exc:
                        # the paged LIST's continue tokens kept expiring
                        # (max_restarts exhausted on a churning cluster):
                        # falling through to the watch-phase 410 handler
                        # would relist IMMEDIATELY in a tight loop — back
                        # off like any other error instead
                        logger.warning(
                            "Node LIST failed (%s%s); backing off %.1fs",
                            "continue tokens kept expiring: "
                            if getattr(exc, "token_expiry", False)
                            else "",
                            exc,
                            backoff,
                        )
                        if self._stop.wait(backoff):
                            return
                        backoff = min(
                            backoff * self.retry.backoff_multiplier,
                            self.retry.max_delay_seconds,
                        )
                        continue
                    need_list = False
                for raw in self.client.watch_nodes(
                    resource_version=self.resource_version,
                    timeout_seconds=self.watch_timeout_seconds,
                    label_selector=self.label_selector,
                ):
                    if self._stop.is_set():
                        return
                    obj = raw.get("object") or {}
                    rv = (obj.get("metadata") or {}).get("resourceVersion")
                    if rv:
                        self.resource_version = rv
                    event_type = raw.get("type", "")
                    backoff = self.retry.delay_seconds
                    gone_streak = 0  # a delivered frame breaks the 410 cycle
                    if event_type == "BOOKMARK":
                        continue
                    self._emit(event_type, obj, time.monotonic())
                gone_streak = 0  # surviving a whole window proves the rv
                logger.debug("Node watch window expired; reconnecting from rv=%s", self.resource_version)
            except K8sGoneError:
                logger.warning("Node watch resourceVersion expired; relisting")
                self.resource_version = None
                need_list = True
                gone_streak += 1
                if gone_streak > 1:
                    delay = min(
                        self.retry.delay_seconds
                        * self.retry.backoff_multiplier ** (gone_streak - 2),
                        self.retry.max_delay_seconds,
                    )
                    logger.warning(
                        "Node watch 410d again right after a relist (streak %d); backing off %.1fs",
                        gone_streak, delay,
                    )
                    if self._stop.wait(delay):
                        return
            except Exception as exc:  # noqa: BLE001 — this daemon thread must
                # never die silently: the pod plane's failures crash run() and
                # restart the process, but an uncaught error here would just
                # stop node-driven degradation while the app reports healthy
                if self._stop.is_set():
                    return
                logger.warning("Node watch error (%s); reconnecting in %.1fs", exc, backoff)
                need_list = True  # unknown failure point: relist to resync
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * self.retry.backoff_multiplier, self.retry.max_delay_seconds)
