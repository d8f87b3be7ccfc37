"""Resilient list+watch source.

The reference's loop died on any stream error (pod_watcher.py:273-275 —
re-raise, no reconnect, no resume; SURVEY.md §2 defect #4). This source
delivers the capability its dead retry config promised:

- initial LIST synthesizes ADDED events for existing pods (the same
  observable behavior as the SDK's list+watch at pod_watcher.py:264), then
  WATCH resumes from the list's resourceVersion;
- every event advances the resume version; BOOKMARK events keep it fresh
  on quiet streams;
- stream errors reconnect with exponential backoff (config-driven,
  ``watcher.retry``);
- 410 Gone triggers a full relist; the phase tracker downstream dedupes the
  re-ADDED pods so subscribers see no spurious transitions;
- an optional checkpoint store persists the resume version across restarts
  (SURVEY.md §5 checkpoint/resume — ABSENT in the reference).
"""

from __future__ import annotations

import logging
import threading
from typing import Iterator, Optional

from k8s_watcher_tpu_torch.config import RetryPolicy
from k8s_watcher_tpu_torch.k8s.client import K8sApiError, K8sClient, K8sGoneError
from k8s_watcher_tpu_torch.state.dirty import DirtyKeys
from k8s_watcher_tpu_torch.watch.sharded import shard_of
from k8s_watcher_tpu_torch.watch.source import EventType, WatchEvent

logger = logging.getLogger(__name__)


class KubernetesWatchSource:
    def __init__(
        self,
        client: K8sClient,
        *,
        namespace: Optional[str] = None,
        label_selector: Optional[str] = None,
        retry: Optional[RetryPolicy] = None,
        watch_timeout_seconds: int = 300,
        resource_version: Optional[str] = None,
        checkpoint=None,  # state.checkpoint.CheckpointStore, optional
        max_reconnects: Optional[int] = None,  # None = retry forever
        heartbeat=None,  # Callable[[], None]: stamped on any apiserver contact
        scanner=None,  # native.scanner.FrameScanner: skip-parse prefilter
        metrics=None,  # metrics.MetricsRegistry, optional
        list_page_size: int = 500,  # LIST pagination (limit+continue)
        shard: int = 0,  # this stream's shard index (uid-hash partition)
        shards: int = 1,  # total shard streams; 1 = whole cluster
        on_taken=None,  # Callable[[int], None]: the watch events each frame carries, bookmarks aside
    ):
        if not 0 <= shard < shards:
            raise ValueError(f"shard {shard} out of range for {shards} shards")
        self.client = client
        self.namespace = namespace
        self.label_selector = label_selector
        self.list_page_size = list_page_size
        self.retry = retry or RetryPolicy()
        self.watch_timeout_seconds = watch_timeout_seconds
        self.resource_version = resource_version
        self.checkpoint = checkpoint
        self.max_reconnects = max_reconnects
        self.heartbeat = heartbeat or (lambda: None)
        self.scanner = scanner
        self.metrics = metrics
        self.shard = shard
        self.shards = shards
        self.on_taken = on_taken
        # pushed to the server (mock apiserver / shard-aware proxy honor
        # it; a stock apiserver ignores it and the client-side ownership
        # checks below keep the partition correct)
        self.shard_selector = f"{shard}/{shards}" if shards > 1 else None
        self._stop = threading.Event()
        # uid -> pod SKELETON of live pods, so a relist can synthesize
        # DELETED events for pods that vanished while the watch was
        # disconnected (a plain relist only re-ADDs survivors, which would
        # leak dead members in downstream phase/slice trackers). The
        # skeleton keeps labels/annotations/nodeName/container resources —
        # a bare {name, namespace} tombstone would be DROPPED by the
        # accelerator resource filter and carry no slice identity, so the
        # slice tracker could never remove the member (the leak this map
        # exists to prevent, resurfacing one stage downstream). Restored
        # from the checkpoint so tombstones survive restarts that land past
        # the apiserver's compaction window.
        self._known: dict = {}
        # uids whose _known entry changed since the last drain — the
        # checkpoint's delta hint (JournaledMapStore), so a steady-state
        # flush journals only the churn instead of rewriting the whole
        # map. Entries restored from the checkpoint are NOT dirty: they
        # are already on disk. Bounded (state/dirty.py): collapses to
        # "everything changed" instead of growing forever when no
        # checkpoint ever drains it.
        self._dirty = DirtyKeys()
        if checkpoint is not None:
            for uid, entry in (checkpoint.get("known_pods") or {}).items():
                if shards > 1 and shard_of(uid, shards) != shard:
                    # not ours: a ShardCheckpointView pre-filters, but a raw
                    # store handed to a shard source must not make this
                    # shard tombstone the other shards' pods after restart
                    continue
                if isinstance(entry, dict):
                    self._known[uid] = entry
                    continue
                if not isinstance(entry, (list, tuple)):
                    # garbage entry (null/number/string from a foreign
                    # writer — strings would iterate into characters): a
                    # corrupt checkpoint degrades, never crashes or invents
                    logger.warning("Discarding malformed known_pods entry for uid %s", uid)
                    continue
                # pre-skeleton checkpoint format: [name, namespace, phase];
                # pad positionally so a truncated entry gets the RIGHT
                # defaults for the missing fields
                defaults = ["", "default", "Unknown"]
                entry = list(entry)[:3]
                name, namespace, phase = entry + defaults[len(entry):]
                self._known[uid] = {
                    "metadata": {"name": name, "namespace": namespace, "uid": uid},
                    "spec": {},
                    "status": {"phase": phase},
                    # no resource spec exists to reconstruct, so the
                    # eventual tombstone must be flagged past the
                    # accelerator filter. Stored IN the entry so it
                    # survives checkpoint round-trips across further
                    # restarts; unspoofable because _skeleton builds
                    # entries from fixed keys only — pod content can never
                    # plant a top-level key here. Cleared naturally when a
                    # relist replaces the entry with a fresh skeleton.
                    "legacy_tombstone": True,
                }

    # annotation values this long are blobs (kubectl's
    # last-applied-configuration can be the whole manifest) — skeletons
    # exist for identity, and every tracked pod's skeleton lands in the
    # checkpoint JSON on each flush, so bound them
    _SKELETON_ANNOTATION_MAX = 256

    @classmethod
    def _skeleton(cls, pod: dict) -> dict:
        """The minimal pod that downstream stages treat like the original:
        identity + labels/annotations (slice identity inference), node
        placement, container resources (accelerator filter — init
        containers included, same as the filter itself), and phase."""
        meta = pod.get("metadata") or {}
        spec = pod.get("spec") or {}
        # resourceVersion rides along so _track can prove "unchanged
        # object" on the next relist and skip the rebuild + dirty churn
        skel_meta = {
            k: meta[k]
            for k in ("name", "namespace", "uid", "labels", "resourceVersion")
            if meta.get(k)
        }
        annotations = {
            k: v for k, v in (meta.get("annotations") or {}).items()
            if isinstance(v, str) and len(v) <= cls._SKELETON_ANNOTATION_MAX
        }
        if annotations:
            skel_meta["annotations"] = annotations
        skel_spec: dict = {
            k: spec[k] for k in ("nodeName", "nodeSelector") if spec.get(k)
        }
        for field in ("containers", "initContainers"):
            kept = [
                {"name": c.get("name", ""), "resources": c["resources"]}
                for c in (spec.get(field) or [])
                if c.get("resources")
            ]
            if kept:
                skel_spec[field] = kept
        return {
            "metadata": skel_meta,
            "spec": skel_spec,
            "status": {"phase": (pod.get("status") or {}).get("phase", "Unknown")},
        }

    def known_pods(self) -> dict:
        """JSON-serializable live-pod skeleton map for the checkpoint.

        A SHALLOW copy is sound only because entries are never mutated in
        place after insertion — ``_track`` replaces whole entries and
        ``_relist`` strips the legacy flag from a copy. Keep it that way:
        a throttled CheckpointStore may hold this snapshot (and its shared
        inner dicts) until a later flush."""
        return dict(self._known)

    def drain_dirty_uids(self) -> Optional[set]:
        """Uids whose entry changed since the last drain (incl. deletes),
        or None for "unknown — persist everything"; clears the
        accumulator. Call BEFORE ``known_pods()``: a change landing
        between the drain and the snapshot journals its newer value this
        flush AND stays marked for the next — never the reverse order,
        where a change after the snapshot would be drained away while its
        value never made it to disk."""
        return self._dirty.drain()

    def stop(self) -> None:
        self._stop.set()
        # wake a consumer blocked in the stream read: on a quiet cluster the
        # next frame could be minutes away, far past any SIGTERM grace period
        self.client.abort_watch()

    # -- internals ---------------------------------------------------------

    def _save_rv(self, rv: Optional[str]) -> None:
        if rv:
            self.resource_version = rv
            if self.checkpoint is not None:
                self.checkpoint.update_resource_version(rv)

    def _track(self, event_type: str, pod: dict) -> None:
        meta = pod.get("metadata") or {}
        uid = meta.get("uid")
        if not uid:
            return
        if event_type == EventType.DELETED:
            self._known.pop(uid, None)
        else:
            rv = meta.get("resourceVersion")
            prev = self._known.get(uid)
            if (
                prev is not None
                and rv
                and (prev.get("metadata") or {}).get("resourceVersion") == rv
            ):
                # same object version we already track (the dominant case
                # across a relist — most pods didn't change during the
                # disconnect): identical skeleton, so skip the rebuild AND
                # the dirty mark. Before this, every relist marked every
                # uid dirty and forced a whole-map checkpoint compaction.
                return
            self._known[uid] = self._skeleton(pod)
        self._dirty.mark(uid, len(self._known))

    def _relist(self) -> Iterator[WatchEvent]:
        """LIST current pods: ADDED for each, synthetic DELETED for pods
        that vanished during the disconnect gap, then set the resume version.

        The LIST is paged (``limit``+``continue``, page size
        ``list_page_size``) so a relist of a large cluster streams bounded
        responses instead of one unbounded PodList — each page's events are
        yielded before the next page is fetched, so peak memory is one page
        plus the skeleton map. Tombstone synthesis runs only after the LAST
        page: only then is "absent from the list" meaningful. When an
        expired continue token forces the paged client to restart (new
        snapshot, new rv), the listed-uid set resets with it — a union
        across two snapshots would suppress tombstones for pods that
        vanished between them (re-ADDs of pods from the aborted attempt
        are harmless: downstream phase tracking dedupes, same as any
        relist)."""
        rv = None
        listed_uids: set = set()
        shards = self.shards
        for page_rv, items, restarted in K8sClient.iter_list_pages(
            self.client.list_pods_paged(
                self.namespace,
                page_size=self.list_page_size,
                label_selector=self.label_selector,
                shard_selector=self.shard_selector,
            ),
            metrics=self.metrics,
            # overlap the next page's fetch+decode with this page's
            # skeleton tracking/yields — relist wall time becomes
            # max(fetch, process) per page, not their sum. Sharded
            # streams prefetch too: each chain's synchronous
            # request->decode->track loop otherwise stalls a GIL-switch
            # interval per page handoff, and with N concurrent chains
            # those bubbles convoy; the in-flight page per chain hides
            # the handoff inside decode
            prefetch=True,
        ):
            if self._stop.is_set():
                # shutdown mid-pagination: abort WITHOUT the tombstone
                # sweep or rv save below — synthesizing DELETED for every
                # not-yet-listed pod would be wrong, and the partial list
                # must not become the resume point. Bounds shutdown at one
                # in-flight page request instead of the whole relist.
                return
            if restarted:
                listed_uids.clear()
            rv = page_rv or rv
            for pod in items:
                uid = (pod.get("metadata") or {}).get("uid")
                if shards > 1 and shard_of(uid or "", shards) != self.shard:
                    # server ignored the shard selector (stock apiserver):
                    # this shard must neither track nor emit pods another
                    # shard owns — the ownership filter IS the partition
                    continue
                listed_uids.add(uid)
                self._track(EventType.ADDED, pod)
                yield WatchEvent(type=EventType.ADDED, pod=pod, resource_version=rv)
        for uid in [u for u in self._known if u not in listed_uids]:
            tombstone = self._known.pop(uid)
            self._dirty.mark(uid, len(self._known))
            legacy = bool(tombstone.get("legacy_tombstone", False))
            if legacy:
                # strip the marker from a COPY — a pending throttled
                # checkpoint snapshot (known_pods() is a shallow copy) may
                # still reference this entry, and popping in place would
                # persist it flag-less: after a crash the restart would
                # re-synthesize this DELETED without the flag, the
                # accelerator filter would drop it, and the pod would leak
                # in the phase/slice trackers — the exact leak the flag
                # exists to prevent
                tombstone = {k: v for k, v in tombstone.items() if k != "legacy_tombstone"}
            meta = tombstone.get("metadata") or {}
            logger.info(
                "Relist: pod %s/%s vanished during disconnect; emitting DELETED",
                meta.get("namespace", "default"), meta.get("name", ""),
            )
            yield WatchEvent(
                type=EventType.DELETED, pod=tombstone, resource_version=rv,
                legacy_tombstone=legacy,
            )
        self._save_rv(rv)

    def events(self) -> Iterator[WatchEvent]:
        """Yield events forever (until ``stop()``), reconnecting as needed."""
        backoff = self.retry.delay_seconds
        reconnects = 0
        # consecutive watch-phase 410s with no delivered frame or clean
        # window expiry in between: the first is normal recovery (relist
        # immediately), repeats mean the relist itself keeps outlasting
        # the watch cache — those must back off and count, or the loop
        # degenerates into unbounded back-to-back full-cluster LISTs
        gone_streak = 0

        if self.resource_version is None and self.checkpoint is not None:
            self.resource_version = self.checkpoint.resource_version()
            if self.resource_version:
                logger.info("Resuming watch from checkpointed resourceVersion %s", self.resource_version)

        need_list = self.resource_version is None

        def backoff_or_raise(exc, what: str) -> bool:
            """Count one failure against max_reconnects (raising ``exc`` on
            exhaustion), back off, and return True when stop() interrupted
            the wait."""
            nonlocal backoff, reconnects
            reconnects += 1
            if self.max_reconnects is not None and reconnects > self.max_reconnects:
                logger.error("%s failed after %d attempts: %s", what, reconnects - 1, exc)
                raise exc
            logger.warning(
                "%s error (%s); retrying in %.1fs (attempt %d)", what, exc, backoff, reconnects
            )
            stopped = self._stop.wait(backoff)
            backoff = min(backoff * self.retry.backoff_multiplier, self.retry.max_delay_seconds)
            return stopped

        while not self._stop.is_set():
            # The LIST phase has its OWN handlers, outside the watch try
            # below: a K8sGoneError escaping the paged LIST means the
            # continue tokens kept expiring max_restarts times (churning
            # cluster) — letting the watch-phase 410 handler catch it
            # would relist IMMEDIATELY in a tight full-LIST loop against
            # an already-stressed apiserver, and nothing would ever bound
            # it. Both list failure modes back off and count against
            # max_reconnects instead.
            if need_list:
                try:
                    yield from self._relist()
                    if self._stop.is_set():
                        return
                    need_list = False
                    self.heartbeat()
                    # a completed relist is proof of a healthy apiserver:
                    # transient blips must not accumulate across days into
                    # max_reconnects exhaustion (or a forever-escalated
                    # backoff) on an otherwise-recovering stream
                    backoff = self.retry.delay_seconds
                    reconnects = 0
                except (K8sGoneError, K8sApiError) as exc:
                    if self._stop.is_set():
                        return
                    what = (
                        "Paged LIST (continue tokens kept expiring)"
                        if getattr(exc, "token_expiry", False)
                        else "LIST"
                    )
                    if backoff_or_raise(exc, what):
                        return
                    continue

            try:
                for raw in self.client.watch_pods(
                    self.namespace,
                    resource_version=self.resource_version,
                    timeout_seconds=self.watch_timeout_seconds,
                    label_selector=self.label_selector,
                    scanner=self.scanner,
                    shard_selector=self.shard_selector,
                ):
                    if self._stop.is_set():
                        return
                    self.heartbeat()  # any frame (incl. bookmarks) = live apiserver link
                    obj = raw.get("object") or {}
                    meta = obj.get("metadata") or {}
                    rv = meta.get("resourceVersion")
                    event_type = raw.get("type", "")
                    if event_type == EventType.BOOKMARK or event_type == EventType.PREFILTERED:
                        # rv-only frames: bookmarks, and frames the native
                        # prefilter dropped unparsed (no accelerator key —
                        # the pipeline's resource filter would drop them too;
                        # one marker may stand for a coalesced run of them)
                        if event_type == EventType.PREFILTERED:
                            if self.metrics is not None:
                                self.metrics.counter("events_prefiltered").inc(raw.get("count", 1))
                            if self.on_taken is not None:
                                self.on_taken(raw.get("count", 1))
                        # a delivered frame proves the stream is healthy — in
                        # an all-non-TPU cluster these may be the ONLY frames,
                        # so backoff must reset here too or one blip escalates
                        # every later reconnect to max_delay forever
                        backoff = self.retry.delay_seconds
                        reconnects = 0
                        gone_streak = 0
                        self._save_rv(rv)
                        continue
                    if self.on_taken is not None:
                        self.on_taken(1)
                    if (
                        self.shards > 1
                        and shard_of(meta.get("uid") or "", self.shards) != self.shard
                    ):
                        # another shard's pod reached us (stock apiserver
                        # ignored the shard selector and the scanner could
                        # not skip it pre-parse): rv-only treatment, same
                        # as a prefiltered frame — the resume point must
                        # still advance or a quiet shard would replay these
                        if self.metrics is not None:
                            self.metrics.counter("events_other_shard").inc()
                        backoff = self.retry.delay_seconds
                        reconnects = 0
                        gone_streak = 0
                        self._save_rv(rv)
                        continue
                    event = WatchEvent(type=event_type, pod=obj, resource_version=rv)
                    self._track(event_type, obj)
                    backoff = self.retry.delay_seconds  # healthy stream resets backoff
                    reconnects = 0
                    gone_streak = 0
                    yield event
                    # checkpoint only after the consumer processed the event
                    # (generator resumes here on next()) — a crash mid-event
                    # then replays it instead of silently skipping it
                    self._save_rv(rv)
                # bounded watch expired normally -> reconnect immediately.
                # Surviving a whole window (even frameless — the bookmark
                # hint is advisory and a fully-prefiltered stream can be
                # silent) proves both the link and the resume rv, so it
                # resets the same counters a delivered frame does:
                # otherwise unrelated blips accumulate across days into
                # max_reconnects exhaustion on a healthy quiet cluster
                self.heartbeat()
                backoff = self.retry.delay_seconds
                reconnects = 0
                gone_streak = 0
                logger.debug("Watch window expired; reconnecting from rv=%s", self.resource_version)

            except K8sGoneError as exc:
                logger.warning("resourceVersion %s expired (410 Gone); relisting", self.resource_version)
                self.resource_version = None
                need_list = True
                gone_streak += 1
                if gone_streak > 1:
                    # relist -> watch 410 -> relist with nothing healthy in
                    # between: the relist keeps outlasting the watch cache.
                    # Its OWN escalation and bound (the shared counters
                    # deliberately reset on every successful relist, which
                    # this cycle contains by construction) — without them
                    # this loop would hammer full-cluster LISTs forever.
                    if (
                        self.max_reconnects is not None
                        and gone_streak - 1 > self.max_reconnects
                    ):
                        logger.error(
                            "Watch 410d immediately after %d consecutive relists; giving up",
                            gone_streak,
                        )
                        raise
                    delay = min(
                        self.retry.delay_seconds
                        * self.retry.backoff_multiplier ** (gone_streak - 2),
                        self.retry.max_delay_seconds,
                    )
                    logger.warning(
                        "Watch 410d again right after a relist (streak %d); backing off %.1fs",
                        gone_streak, delay,
                    )
                    if self._stop.wait(delay):
                        return

            except K8sApiError as exc:
                if self._stop.is_set():
                    # the abort_watch() teardown path surfaces as a stream
                    # error; a clean shutdown must not log a scary
                    # "reconnecting" warning on every SIGTERM
                    return
                if backoff_or_raise(exc, "Watch stream"):
                    return
