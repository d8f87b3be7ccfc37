"""Sharded watch ingest: N shard streams -> bounded MPSC queue -> batches.

One ``WatchSource.events()`` generator feeding ``EventPipeline.process()``
one event at a time caps sustained ingest below what the prefilter and the
async dispatcher can take. This module replaces that loop:

- the pod space is partitioned across ``shards`` watch streams by a STABLE
  hash of the pod UID (``shard_of``) — per-pod-UID event ordering is
  preserved because one UID always rides one stream, one FIFO queue slot
  sequence, and one drain thread;
- each shard stream pumps into one bounded MPSC queue (``EventBatchQueue``)
  whose drain side hands out BATCHES (one lock round per batch, not per
  event) for ``EventPipeline.process_batch``;
- every shard keeps its own resourceVersion bookkeeping and relists
  independently, so a 410 Gone on one shard relists 1/N of the cluster
  while the other streams keep flowing — and a full relist runs its page
  fetches shard-parallel (per-shard continue tokens).

``shards: 1`` is not a special case: the single stream rides the same
queue + batch machinery, so the fake source, the mock tier and production
all exercise one code path.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence

from k8s_watcher_tpu_torch.watch.source import WatchEvent

logger = logging.getLogger(__name__)


def shard_of(uid: str, shards: int) -> int:
    """Stable shard index for a pod UID (crc32, NOT hash() — PYTHONHASHSEED
    randomization would repartition the cluster on every restart and break
    per-shard checkpoint resume)."""
    if shards <= 1:
        return 0
    return zlib.crc32(uid.encode()) % shards


def parse_shard_selector(selector: str) -> Optional[tuple]:
    """``"i/n"`` -> (i, n), or None for a malformed selector. The wire
    format the mock apiserver (k8s/mock_server.py) honors for server-side
    shard push-down; a stock apiserver ignores the unknown query param and
    the client-side ownership filter keeps correctness."""
    try:
        shard_str, shards_str = selector.split("/", 1)
        shard, shards = int(shard_str), int(shards_str)
    except (ValueError, AttributeError):
        return None
    if shards < 1 or not 0 <= shard < shards:
        return None
    return shard, shards


class EventBatchQueue:
    """Bounded MPSC queue with batch drain.

    Producers (shard pump threads) append one event per call; the single
    consumer takes everything available up to ``batch_max`` per call — the
    amortization that lets the drain side keep pace with N producers.
    ``put`` blocks when full (backpressure into the watch streams, exactly
    like a slow single-stream consumer would); the high-water mark is kept
    for the bench/saturation verdict ("was the drain ever the limiting
    stage?").

    The hot path is deliberately LOCK-FREE: ``deque.append`` and
    ``popleft`` are GIL-atomic, and a mutex here convoyed — N producers +
    the drain contending for one lock at 30k+ events/s cost ~140 us/event
    in handoffs, 5x the whole pipeline budget. The only synchronization is
    a wakeup Event, and ``Event.set()`` is guarded by the lock-free
    ``is_set()`` read so the steady state never takes its internal lock.
    Single-consumer is a hard contract (ShardedWatchSource.batches is the
    one drain); per-producer FIFO order is the deque's own guarantee.
    """

    def __init__(self, capacity: int = 8192):
        self.capacity = max(1, capacity)
        self._items: collections.deque = collections.deque()
        self._data_ready = threading.Event()
        self._closed = False
        self.high_water = 0  # approximate (unlocked) — a bench/debug stat
        self.put_blocked = 0  # times a producer hit the capacity wall

    def put(self, event: WatchEvent) -> bool:
        """Enqueue; blocks while full. False once the queue is closed."""
        items = self._items
        while len(items) >= self.capacity:
            if self._closed:
                return False
            self.put_blocked += 1
            time.sleep(0.001)  # backpressure path: rare, latency-insensitive
        if self._closed:
            return False
        items.append(event)
        depth = len(items)
        if depth > self.high_water:
            self.high_water = depth
        if not self._data_ready.is_set():
            self._data_ready.set()
        return True

    def get_batch(self, batch_max: int, timeout: float = 0.5) -> Optional[List[WatchEvent]]:
        """Up to ``batch_max`` events in arrival order; [] on timeout with
        the queue still open; None once closed AND drained. Never waits to
        FILL a batch — whatever is available when the first event lands is
        the batch (a quiet stream gets batch size 1 and pays no added
        latency)."""
        items = self._items
        if not items:
            if self._closed:
                return None
            # clear-then-recheck closes the lost-wakeup race: a producer
            # appending between the emptiness check and clear() re-sets
            # the event, and the recheck sees its item either way
            self._data_ready.clear()
            if not items and not self._closed:
                self._data_ready.wait(timeout)
            if not items:
                return None if self._closed else []
        batch = []
        append = batch.append
        popleft = items.popleft
        try:
            for _ in range(batch_max):
                append(popleft())
        except IndexError:
            pass  # drained mid-batch: the batch is whatever we got
        return batch

    def close(self) -> None:
        """Wake everyone; producers stop, the consumer drains what's left."""
        self._closed = True
        self._data_ready.set()

    def depth(self) -> int:
        return len(self._items)


class ShardedWatchSource:
    """Compose per-shard ``WatchSource``s behind one batched event stream.

    Also a plain ``WatchSource`` itself (``events()`` flattens batches), so
    every consumer of the old protocol keeps working. The per-shard event
    counts and the queue high-water mark are exported both as attributes
    (bench) and gauges (``/metrics``) so the next saturation verdict can
    say WHICH side — producers or drain — gave out.
    """

    def __init__(
        self,
        sources: Sequence[Any],  # WatchSource per shard
        *,
        batch_max: int = 128,
        queue_capacity: int = 8192,
        metrics=None,  # metrics.MetricsRegistry, optional
        tracer=None,  # trace.Tracer, optional — head-samples at the pump
    ):
        if not sources:
            raise ValueError("ShardedWatchSource needs at least one shard source")
        self.sources = list(sources)
        self.batch_max = max(1, batch_max)
        self.queue = EventBatchQueue(queue_capacity)
        self.metrics = metrics
        self.tracer = tracer
        self.per_shard_counts = [0] * len(self.sources)
        self._threads: List[threading.Thread] = []
        self._started = False
        self._stop = threading.Event()
        self._start_lock = threading.Lock()

    # -- WatchSource-protocol surface --------------------------------------

    @property
    def client(self):
        """First shard's k8s client (leader election / node watch /
        remediation need ONE control-plane client, not one per shard)."""
        return getattr(self.sources[0], "client", None)

    def events(self) -> Iterator[WatchEvent]:
        for batch in self.batches():
            yield from batch

    def stop(self) -> None:
        self._stop.set()
        for source in self.sources:
            source.stop()
        self.queue.close()

    # -- batched surface ---------------------------------------------------

    def _pump(self, shard: int, source) -> None:
        # head-sampling decision, made HERE and only here — and INLINED:
        # the unsampled steady state (255/256 of a 30k events/s stream)
        # pays one local-bool branch, up to three interned-string
        # compares and a countdown decrement; no call, no allocation, no
        # lock (a maybe_start() call per event alone costs ~0.6 us — 2%
        # of the whole event budget). Each shard stream samples its own
        # 1st, N+1th, 2N+1th… pod event, so the kept set is deterministic
        # per shard. The trace attaches BEFORE the queue put so the drain
        # side can never observe a sampled event trace-less; any
        # put-block backpressure wait then honestly lands in queue_wait.
        tracer = self.tracer
        tracing = (
            tracer is not None and tracer.enabled and tracer.sample_rate != 0
        )
        rate = max(1, tracer.sample_rate) if tracing else 0
        countdown = 1  # sample this shard's first pod event
        monotonic = time.monotonic
        try:
            for event in source.events():
                if self._stop.is_set():
                    return
                if tracing:
                    et = event.type
                    if et == "ADDED" or et == "MODIFIED" or et == "DELETED":
                        countdown -= 1
                        if countdown == 0:
                            countdown = rate
                            trace = tracer.start(event, shard)
                            now = monotonic()
                            trace.add_span("shard_receive", trace.t0, now)
                            trace.queue_enter = now
                            event.trace = trace
                if not self.queue.put(event):
                    return
                self.per_shard_counts[shard] += 1
        except Exception:
            # a dead shard stream must be VISIBLE, not a silent 1/N
            # coverage hole; the liveness heartbeat (stamped per drained
            # batch from the remaining shards) keeps beating, so this log
            # + counter is the operator's signal
            logger.exception("Shard %d watch stream died", shard)
            if self.metrics is not None:
                self.metrics.counter("ingest_shard_stream_deaths").inc()
            if tracer is not None:
                # always-captured anomaly: /debug/trace answers for it
                trace = tracer.start_anomaly(
                    uid=f"shard-{shard}", name=f"shard-{shard}",
                    kind="watch_stream", t0=time.monotonic(),
                )
                if trace is not None:
                    trace.shard = shard
                    tracer.finish(trace, "failed")
        finally:
            with self._start_lock:
                self._live_pumps -= 1
                live = self._live_pumps
            if live == 0:
                self.queue.close()  # all streams ended: drain then stop

    def start(self) -> None:
        with self._start_lock:
            if self._started:
                return
            self._started = True
            self._live_pumps = len(self.sources)
            for i, source in enumerate(self.sources):
                t = threading.Thread(
                    target=self._pump, args=(i, source),
                    name=f"ingest-shard-{i}", daemon=True,
                )
                self._threads.append(t)
                t.start()

    def batches(self) -> Iterator[List[WatchEvent]]:
        """Yield event batches until every shard stream ends (or stop()).
        Single consumer: per-UID ordering holds because each UID lives on
        exactly one shard stream and batches drain FIFO."""
        self.start()
        gauge = self.metrics.gauge("ingest_queue_high_water") if self.metrics is not None else None
        while True:
            batch = self.queue.get_batch(self.batch_max)
            if batch is None:
                break
            if not batch:
                if self._stop.is_set() and self.queue.depth() == 0:
                    break
                continue
            if gauge is not None:
                gauge.set(self.queue.high_water)
            # queue_wait spans are stamped by EventPipeline.process_batch
            # (one batch-enter stamp), not here: a second per-event scan of
            # every batch on the drain thread would double the tracing
            # plane's per-event tax for no extra fidelity
            yield batch

    def join(self, timeout: float = 5.0) -> None:
        """Wait up to ``timeout`` for each shard pump thread to end."""
        for t in self._threads:
            t.join(timeout=timeout)

    # -- checkpoint integration (merged across shards) ---------------------

    def known_pods(self) -> Optional[Dict[str, Any]]:
        """Union of the shard sources' live-pod skeleton maps, or None when
        no shard tracks pods (fake sources). Shard key spaces are disjoint
        by construction (uid-hash partition), so a plain merge is exact."""
        merged: Optional[Dict[str, Any]] = None
        for source in self.sources:
            known = getattr(source, "known_pods", None)
            if callable(known):
                merged = known() if merged is None else {**merged, **known()}
        return merged

    def drain_dirty_uids(self) -> Optional[set]:
        """Union of the shards' dirty-uid hints; None ("persist
        everything") if ANY pod-tracking shard can't say — including a
        source that tracks pods (``known_pods``) but offers no drain
        support at all, which must fall back to full rewrites, not be
        silently treated as "idle". Same drain-before-snapshot contract
        as the per-shard method."""
        merged: set = set()
        for source in self.sources:
            drain = getattr(source, "drain_dirty_uids", None)
            if not callable(drain):
                if callable(getattr(source, "known_pods", None)):
                    return None  # tracks pods, can't hint: persist everything
                continue
            drained = drain()
            if drained is None:
                return None
            merged.update(drained)
        return merged


class ShardCheckpointView:
    """A shard's view of the shared CheckpointStore.

    Each shard stream resumes from its OWN resourceVersion — the shards
    watch at different positions of the cluster's rv timeline, and resuming
    shard 2 from shard 0's rv would replay or skip events. The key embeds
    the shard COUNT, so changing ``ingest.shards`` invalidates every resume
    point and forces a clean relist under the new partition (resuming an
    old rv under a new partition would skip events that changed owners).
    ``known_pods`` restore is filtered to the shard's own uids — restoring
    the full map would make every shard's relist tombstone the OTHER
    shards' pods (absent from its shard-limited LIST by construction).
    """

    def __init__(self, store, shard: int, shards: int):
        self._store = store
        self._shard = shard
        self._shards = shards
        self._rv_key = f"resource_version_shard_{shard}_of_{shards}"

    def resource_version(self) -> Optional[str]:
        return self._store.get(self._rv_key)

    def update_resource_version(self, rv: str) -> None:
        self._store.put(self._rv_key, rv)

    def get(self, key: str, default=None):
        value = self._store.get(key, default)
        if key == "known_pods" and isinstance(value, dict):
            return {
                uid: entry for uid, entry in value.items()
                if shard_of(uid, self._shards) == self._shard
            }
        return value

    def put(self, key: str, value, **kwargs) -> None:
        self._store.put(key, value, **kwargs)
