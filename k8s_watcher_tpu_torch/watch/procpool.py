"""Multi-process watch-shard readers: N OS processes feed one pipeline (the
JAX package's ``watch/procpool.py``).

One interpreter caps sustained ingest below what the native prefilter can
scan. This module splits the shard streams
across ``ingest.processes`` worker processes (the Podracer split: cheap
high-rate I/O workers feeding one central consumer over a compact wire):

- each WORKER process owns whole shard streams — its watch connections,
  its native prefilter (``scan_chunk`` over raw chunked bytes BEFORE any
  ``json.loads``), and its durable per-shard resourceVersion checkpoint
  (one ``CheckpointStore`` file per shard under the parent checkpoint's
  directory, so resume points survive both worker crashes and
  ``processes`` count changes);
- significant events ride a length-prefixed pipe (``multiprocessing.Pipe``
  framing) as msgpack batches (JSON fallback, tagged per frame) into the
  PARENT's existing ``EventBatchQueue`` -> ``EventPipeline.process_batch``
  drain — the parent never touches a skipped frame's bytes at all;
- workers are SUPERVISED: a crashed reader respawns with jittered
  exponential backoff (the federate-client idiom) and resumes each of its
  shards from its checkpointed rv — at-least-once across the crash window
  (replay, never skip), with downstream phase/view dedup absorbing the
  replays exactly as it does for a relist;
- SIGTERM drains cleanly: the worker stops its streams, flushes queued
  events down the pipe, force-flushes every shard checkpoint (rv +
  known_pods skeletons), then sends EOS.

Ordering contract: per-pod-UID ordering holds (one UID -> one shard ->
one worker -> one FIFO pipe -> one parent pump slot); CROSS-shard order is
per-shard only — same as in-process sharded ingest, now also across
process boundaries.

A reader process imports neither torch nor anything that does: the spawned
child re-imports only this module, the watch client, the prefilter and the
checkpoint store (``tests/test_torch_import.py`` holds it to that).

``ingest.processes: 0`` never constructs any of this — the in-process
path is untouched, byte for byte.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from k8s_watcher_tpu_torch.parallel.procpool import SupervisedEndpoint, pack, unpack
from k8s_watcher_tpu_torch.watch.sharded import ShardedWatchSource
from k8s_watcher_tpu_torch.watch.source import WatchEvent

logger = logging.getLogger(__name__)

try:  # the serve plane's optional codec dependency, reused for the wire
    import msgpack  # type: ignore
except Exception:  # noqa: BLE001 — absence is a supported configuration
    msgpack = None


# -- wire codec (worker -> parent) ------------------------------------------
# The generic tagged codec lives in parallel/procpool; these wrappers bind
# it to THIS module's msgpack global so a test can strip one side's codec
# and the pair still interoperates via the per-frame tag.


def _pack(obj: Dict[str, Any]) -> bytes:
    return pack(obj, codec=msgpack)


def _unpack(data: bytes) -> Dict[str, Any]:
    return unpack(data, codec=msgpack)


# -- worker plan -------------------------------------------------------------


@dataclasses.dataclass
class WorkerPlan:
    """Everything one shard-reader process needs, picklable for spawn.

    ``source_factory`` is the bench/test seam: a module-level callable
    ``factory(plan) -> list[WatchSource]`` replacing the production
    construction (real K8s watch streams from ``config``). Production
    plans carry ``config`` (the frozen AppConfig dataclass tree) and
    ``checkpoint_dir`` instead.
    """

    proc_index: int
    processes: int
    owned_shards: Tuple[int, ...]
    shards: int
    batch_max: int = 128
    queue_capacity: int = 8192
    stats_interval_seconds: float = 0.5
    config: Any = None  # config.AppConfig (production path)
    checkpoint_dir: Optional[str] = None
    source_factory: Optional[Callable[["WorkerPlan"], Sequence[Any]]] = None
    factory_arg: Any = None
    #: spawn generation, stamped by the parent at each (re)spawn and
    #: echoed on every stats frame ("g") so stale frames are discarded
    generation: int = 0
    #: ship the worker registry's sample() (+ completed traces) on the
    #: periodic stats frame (``metrics.process_export``; the bench A/B's
    #: off switch)
    export_registry: bool = True
    #: factory-path head-sampling rate for the worker tracer (production
    #: plans read ``config.trace`` instead; 0 = off)
    trace_sample_rate: int = 0


def plans_from_config(config) -> List[WorkerPlan]:
    """Round-robin the shard indices across ``ingest.processes`` workers.

    The partition is a pure function of (shard, processes), so a worker
    always finds its shards' checkpoint FILES (keyed ``shard-i-of-n``)
    even after ``processes`` changes — only a ``shards`` change
    invalidates resume points, same as in-process sharding."""
    ingest = config.ingest
    checkpoint_dir = worker_checkpoint_dir(config.state.checkpoint_path)
    return [
        WorkerPlan(
            proc_index=p,
            processes=ingest.processes,
            owned_shards=tuple(range(ingest.shards))[p :: ingest.processes],
            shards=ingest.shards,
            batch_max=ingest.batch_max,
            queue_capacity=ingest.queue_capacity,
            config=config,
            checkpoint_dir=checkpoint_dir,
            export_registry=config.metrics.process_export,
        )
        for p in range(ingest.processes)
    ]


def worker_checkpoint_dir(checkpoint_path: Optional[str]) -> Optional[str]:
    """Per-shard checkpoint files live NEXT TO the parent checkpoint
    (``<checkpoint>.ingest-shards/shard-i-of-n.json``): one file per shard,
    one writer per file (the owning worker), no cross-process lock."""
    if not checkpoint_path:
        return None
    path = os.path.abspath(checkpoint_path)
    return os.path.join(
        os.path.dirname(path), os.path.basename(path) + ".ingest-shards"
    )


# -- worker process ----------------------------------------------------------


class _DeferredRvView:
    """Checkpoint view whose resourceVersion WRITES are deferred to the
    pipe drain loop.

    The watch source saves rv the moment an event enters the worker's
    INTERNAL queue — but across a worker crash the durable rv must never
    run ahead of what actually reached the parent, or the respawn would
    SKIP the queued-but-unsent window (the in-process contract is replay,
    never skip). So rv saves from the pump thread only land in
    ``pending_rv``; the drain loop commits

    - the per-shard max rv of every batch it has put ON THE PIPE (exact
      at-least-once for significant events), and
    - ``pending_rv`` whenever the internal queue is observed empty (an
      rv saved by the pump implies its event was already queued, so an
      empty queue proves everything saved so far was sent) — this is what
      keeps a mostly-PREFILTERED stream's resume point advancing.

    Reads and the known_pods map delegate to the real store unchanged.
    """

    def __init__(self, store):
        self._store = store
        self.pending_rv: Optional[str] = None  # GIL-atomic pump-thread write

    def resource_version(self):
        return self._store.resource_version()

    def update_resource_version(self, rv) -> None:
        self.pending_rv = rv

    def commit(self, rv: Optional[str] = None) -> None:
        rv = rv if rv is not None else self.pending_rv
        if rv is not None:
            self._store.update_resource_version(rv)

    def get(self, key, default=None):
        return self._store.get(key, default)

    def put(self, key, value, **kwargs) -> None:
        self._store.put(key, value, **kwargs)


def _build_k8s_sources(plan: WorkerPlan):
    """The production worker's shard streams: one K8sClient + resilient
    ``KubernetesWatchSource`` per owned shard (a client carries at most one
    live watch), each with its own per-shard ``CheckpointStore`` file and
    its own scanner instance (the native scanner's record buffers are
    per-instance scratch)."""
    from k8s_watcher_tpu_torch.k8s.client import K8sClient
    from k8s_watcher_tpu_torch.k8s.kubeconfig import load_connection
    from k8s_watcher_tpu_torch.k8s.watch import KubernetesWatchSource
    from k8s_watcher_tpu_torch.metrics import MetricsRegistry
    from k8s_watcher_tpu_torch.native.scanner import make_scanner
    from k8s_watcher_tpu_torch.state.checkpoint import CheckpointStore

    config = plan.config
    metrics = MetricsRegistry()
    connection = load_connection(
        use_incluster=config.kubernetes.use_incluster_config,
        config_file=config.kubernetes.config_file,
        verify_tls=config.kubernetes.verify_tls,
    )
    mode = config.ingest.resolved_prefilter(config.tpu.prefilter)
    sources, checkpoints, rv_views = [], {}, {}
    for shard in plan.owned_shards:
        store = view = None
        if plan.checkpoint_dir:
            store = CheckpointStore(
                os.path.join(
                    plan.checkpoint_dir, f"shard-{shard}-of-{plan.shards}.json"
                ),
                interval_seconds=config.state.checkpoint_interval_seconds,
                metrics=metrics,
            )
            store.attach_journaled_map("known_pods")
            view = _DeferredRvView(store)
        sources.append(
            KubernetesWatchSource(
                K8sClient(
                    connection, request_timeout=config.kubernetes.request_timeout
                ),
                label_selector=config.watcher.label_selector,
                retry=config.watcher.retry,
                watch_timeout_seconds=config.kubernetes.watch_timeout_seconds,
                checkpoint=view,
                scanner=make_scanner(
                    config.tpu.resource_key,
                    mode=mode,
                    extract_uid=plan.shards > 1,
                ),
                metrics=metrics,
                list_page_size=config.watcher.list_page_size,
                shard=shard,
                shards=plan.shards,
            )
        )
        checkpoints[shard] = store
        rv_views[shard] = view
    return sources, checkpoints, rv_views, metrics


def _worker_entry(plan: WorkerPlan, conn) -> None:
    """Child-process main: shard streams -> batched pipe writes.

    Runs the worker's OWN ``ShardedWatchSource`` (queue + pump threads) over
    its shards, draining the queue straight into pipe frames. SIGTERM stops
    the streams, drains what is queued, force-flushes every shard
    checkpoint, and sends EOS; an unexpected death is the parent's respawn
    path (per-shard checkpoints make the respawn resume, not relist)."""
    logging.basicConfig(
        level=logging.INFO,
        format=(
            f"%(asctime)s [ingest-worker-{plan.proc_index}] "
            "%(levelname)s %(name)s: %(message)s"
        ),
    )
    stopping = threading.Event()
    checkpoints: Dict[int, Any] = {}
    rv_views: Dict[int, Any] = {}
    k8s_metrics = None
    if plan.source_factory is not None:
        sources = list(plan.source_factory(plan))
        # always instrumented, matching the production path (k8s_metrics
        # below): export_registry gates only the sample/ship/fold — so
        # the bench A/B measures exactly what metrics.process_export
        # toggles, not the cost of having counters at all
        from k8s_watcher_tpu_torch.metrics import MetricsRegistry

        registry = MetricsRegistry()
    else:
        sources, checkpoints, rv_views, k8s_metrics = _build_k8s_sources(plan)
        registry = k8s_metrics
    # worker-side tracer: head-samples journeys at the shard pumps and
    # always-captures anomalies; completed traces ride the stats frame
    # into the parent ring. Gated on export_registry — a trace nobody can
    # ever read is pure overhead.
    tracer = None
    trace_export: Optional[Any] = None
    trace_cfg = getattr(plan.config, "trace", None) if plan.config is not None else None
    if plan.export_registry and registry is not None and (
        (trace_cfg is not None and trace_cfg.enabled) or plan.trace_sample_rate > 0
    ):
        import collections

        from k8s_watcher_tpu_torch.trace import Tracer

        trace_export = collections.deque(maxlen=128)
        tracer = Tracer(
            sample_rate=(
                trace_cfg.sample_rate if trace_cfg is not None and trace_cfg.enabled
                else plan.trace_sample_rate
            ),
            ring_size=trace_cfg.ring_size if trace_cfg is not None and trace_cfg.enabled else 256,
            metrics=registry,
            export_buffer=trace_export,
        )
    sharded = ShardedWatchSource(
        sources,
        batch_max=plan.batch_max,
        queue_capacity=plan.queue_capacity,
        metrics=registry,
        tracer=tracer,
    )

    def on_sigterm(signum, frame):  # noqa: ARG001 — signal signature
        stopping.set()
        sharded.stop()  # stop streams; the drain loop below flushes the rest

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent Ctrl-C: drain via SIGTERM

    def persist(force: bool = False) -> None:
        for shard, source in zip(plan.owned_shards, sources):
            store = checkpoints.get(shard)
            if store is None:
                continue
            if not (force or store.due()):
                continue
            drain = getattr(source, "drain_dirty_uids", None)
            known = getattr(source, "known_pods", None)
            if callable(drain) and callable(known):
                changed = drain()
                if changed is None or changed:
                    store.put("known_pods", known(), changed_keys=changed)
            if force:
                store.flush()

    def stats_payload() -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "shard_counts": list(sharded.per_shard_counts),
            "queue_high_water": sharded.queue.high_water,
        }
        if k8s_metrics is not None:
            out["prefiltered"] = int(k8s_metrics.counter("events_prefiltered").value)
            out["relists"] = int(k8s_metrics.counter("relists").value)
        else:
            # factory sources (bench/tests) count their own skips
            counts = [getattr(s, "prefiltered", None) for s in sources]
            known = [c for c in counts if c is not None]
            if known:
                out["prefiltered"] = int(sum(known))
        if plan.export_registry and registry is not None:
            out["registry"] = registry.sample(include_series=True)
        if trace_export is not None:
            drained = []
            while True:
                try:
                    drained.append(trace_export.popleft())
                except IndexError:
                    break
            if drained:
                out["traces"] = drained
        return out

    resumed = [
        shard
        for shard, source in zip(plan.owned_shards, sources)
        if getattr(source, "resource_version", None)
        or (
            checkpoints.get(shard) is not None
            and checkpoints[shard].resource_version()
        )
    ]
    try:
        conn.send_bytes(
            _pack(
                {
                    "hello": {
                        "proc": plan.proc_index,
                        "pid": os.getpid(),
                        "shards": list(plan.owned_shards),
                        "resumed_shards": resumed,
                        # the prefilter each shard stream runs (the native
                        # scanner degrades to the Python one where it cannot
                        # build): "NativeFrameScanner", "PythonFrameScanner"
                        # or None (ingest.prefilter: off, factory sources)
                        "scanners": [
                            type(s.scanner).__name__ if getattr(s, "scanner", None) is not None else None
                            for s in sources
                        ],
                    }
                }
            )
        )
        from k8s_watcher_tpu_torch.watch.sharded import shard_of

        sent_counts: Dict[int, int] = {}
        sent_unattributed = False  # a uid-less event poisons shard
        # attribution: quiescent commits go conservative (idle-only)

        def commit_sent(batch) -> None:
            """Durable rv = the newest rv per shard that is ON THE PIPE
            (see _DeferredRvView: replay-never-skip across a crash)."""
            nonlocal sent_unattributed
            if not rv_views:
                return
            last: Dict[int, str] = {}
            for ev in batch:
                if not ev.uid:
                    sent_unattributed = True
                    continue
                shard = shard_of(ev.uid, plan.shards)
                sent_counts[shard] = sent_counts.get(shard, 0) + 1
                if ev.resource_version:
                    last[shard] = ev.resource_version
            for shard, rv in last.items():
                view = rv_views.get(shard)
                if view is not None:
                    view.commit(rv)

        def commit_quiescent() -> None:
            """Commit the pending rv of every shard with no queued-but-
            unsent events. A shard whose frames are (almost) all
            prefiltered never appears in a sent batch, and under sustained
            sibling churn the queue never drains to empty — without this
            its durable resume point would starve forever, and a crash
            would resume from an ancient rv (410 Gone -> full relist).
            Safety: the pump orders put -> per_shard_counts++ -> rv save,
            so snapshotting pending_rv BEFORE reading the enqueue count
            guarantees every event that preceded that rv is already
            counted; enqueued == sent then proves nothing of this shard's
            is still queued."""
            if sent_unattributed:
                return
            for idx, shard in enumerate(plan.owned_shards):
                view = rv_views.get(shard)
                if view is None:
                    continue
                rv = view.pending_rv
                if rv is None:
                    continue
                if sent_counts.get(shard, 0) == sharded.per_shard_counts[idx]:
                    view.commit(rv)

        sharded.start()
        seq = 0
        shipped_counter = registry.counter("ingest_events_shipped") if registry is not None else None
        last_stats = time.monotonic()
        while True:
            batch = sharded.queue.get_batch(plan.batch_max, timeout=0.5)
            if batch is None:
                break  # every stream ended (or stop()) and the queue drained
            if batch:
                conn.send_bytes(
                    _pack(
                        {
                            "s": seq,
                            "b": [
                                [
                                    ev.type,
                                    ev.pod,
                                    ev.resource_version,
                                    ev.received_monotonic,
                                    ev.received_at,
                                    1 if ev.legacy_tombstone else 0,
                                ]
                                for ev in batch
                            ],
                        }
                    )
                )
                seq += len(batch)
                if shipped_counter is not None:
                    shipped_counter.inc(len(batch))
                if tracer is not None:
                    # a worker journey ends at the pipe: close sampled
                    # traces here so they ride the next stats frame into
                    # the parent ring (the parent pump re-samples its own
                    # journeys on the decoded stream independently)
                    now_mono = time.monotonic()
                    for ev in batch:
                        trace = ev.trace
                        if trace is not None:
                            trace.add_span("queue_wait", trace.queue_enter, now_mono)
                            tracer.finish(trace, "shipped", end=now_mono)
                            ev.trace = None  # the wire encode drops it anyway
                commit_sent(batch)
            elif sharded.queue.depth() == 0:
                # idle with an empty queue: everything the pumps saved rv
                # for has been sent — safe to commit the pending rv line
                # (what keeps a mostly-prefiltered stream's resume fresh)
                for view in rv_views.values():
                    if view is not None:
                        view.commit()
            now = time.monotonic()
            if now - last_stats >= plan.stats_interval_seconds:
                last_stats = now
                commit_quiescent()
                conn.send_bytes(
                    _pack({"stats": stats_payload(), "g": plan.generation})
                )
                persist()
        for view in rv_views.values():
            # end of stream: the queue is fully drained onto the pipe
            if view is not None:
                view.commit()
        persist(force=True)
        conn.send_bytes(_pack({"stats": stats_payload(), "g": plan.generation}))
        conn.send_bytes(_pack({"eos": True, "drained": stopping.is_set()}))
    except (BrokenPipeError, OSError):
        # parent died or closed the pipe: durable state first, then exit —
        # the respawned incarnation resumes from these checkpoints
        stopping.set()
        sharded.stop()
        persist(force=True)
    finally:
        try:
            conn.close()
        except OSError:
            pass


# -- parent side -------------------------------------------------------------


class _WorkerEndpoint(SupervisedEndpoint):
    """One supervised shard-reader subprocess, presented as a WatchSource.

    Supervision (spawn/respawn/backoff/seq/hello/stats/EOS) is the shared
    ``parallel.procpool.SupervisedEndpoint``; this subclass adds the
    ingest-specific pieces: decoding pipe batch items into ``WatchEvent``s
    and folding the worker's cumulative ``prefiltered`` stat into the
    parent's ``events_prefiltered`` counter across incarnations.
    """

    def __init__(
        self,
        plan: WorkerPlan,
        *,
        metrics=None,
        heartbeat=None,
        trace_ring=None,
        respawn_backoff: float = 0.5,
        respawn_backoff_max: float = 15.0,
    ):
        super().__init__(
            plan,
            target=_worker_entry,
            name=f"ingest-reader-{plan.proc_index}",
            index=plan.proc_index,
            metrics=metrics,
            heartbeat=heartbeat,
            respawn_backoff=respawn_backoff,
            respawn_backoff_max=respawn_backoff_max,
            gap_counter="ingest_wire_gaps",
            respawn_counter="ingest_worker_respawns",
            label="Ingest worker",
            respawn_note="resume from per-shard checkpoints",
            process_label=f"ingest-shard-{plan.proc_index}",
            trace_ring=trace_ring,
            # the ad-hoc prefiltered fold below already owns the unlabeled
            # events_prefiltered total — registry folding must not add it twice
            rollup_exclude={"events_prefiltered"},
        )
        # cumulative ACROSS incarnations (a respawned worker's counters
        # restart at zero; parent-side totals must not)
        self.prefiltered_total = 0
        self._prefiltered_seen = 0

    def on_spawn(self) -> None:
        super().on_spawn()  # reset registry-fold watermarks
        self._prefiltered_seen = 0  # per-incarnation cumulative counters

    def on_stats(self, stats: Dict[str, Any]) -> None:
        super().on_stats(stats)  # fold exported registry sample + traces
        prefiltered = stats.get("prefiltered")
        if prefiltered is not None:
            delta = prefiltered - self._prefiltered_seen
            if delta > 0:
                self.prefiltered_total += delta
                if self.metrics is not None:
                    self.metrics.counter("events_prefiltered").inc(delta)
            self._prefiltered_seen = prefiltered

    def events(self):
        for msg in self.frames():
            for etype, pod, rv, mono, wall, legacy in msg["b"]:
                yield WatchEvent(
                    type=etype,
                    pod=pod,
                    resource_version=rv,
                    received_monotonic=mono,
                    received_at=wall,
                    legacy_tombstone=bool(legacy),
                )


class ProcessShardedWatchSource(ShardedWatchSource):
    """``ShardedWatchSource`` whose per-"shard" sources are supervised
    worker PROCESSES — the parent side of the multi-process ingest tier.

    Everything downstream (bounded MPSC queue, batch drain, tracing
    head-sampling at the pump, ``batches()``) is inherited unchanged: one
    pump thread per worker endpoint replaces one pump thread per watch
    stream. ``client`` is the parent's control-plane K8sClient (leader
    election / node watch / remediation — exactly one, never per shard).
    """

    def __init__(
        self,
        plans: Sequence[WorkerPlan],
        *,
        batch_max: int = 128,
        queue_capacity: int = 8192,
        metrics=None,
        tracer=None,
        heartbeat=None,
        client=None,
        respawn_backoff: float = 0.5,
    ):
        self.endpoints = [
            _WorkerEndpoint(
                plan,
                metrics=metrics,
                heartbeat=heartbeat,
                trace_ring=tracer.ring if tracer is not None else None,
                respawn_backoff=respawn_backoff,
            )
            for plan in plans
        ]
        super().__init__(
            self.endpoints,
            batch_max=batch_max,
            queue_capacity=queue_capacity,
            metrics=metrics,
            tracer=tracer,
        )
        self._control_client = client

    @property
    def client(self):
        return self._control_client

    def worker_pids(self) -> List[Optional[int]]:
        return [endpoint.pid for endpoint in self.endpoints]

    def worker_stats(self) -> Dict[str, Any]:
        """Aggregated supervision/ingest counters (smoke/bench/debug)."""
        return {
            "processes": len(self.endpoints),
            "spawns": sum(e.spawns for e in self.endpoints),
            "respawns": sum(e.respawns for e in self.endpoints),
            "wire_gaps": sum(e.wire_gaps for e in self.endpoints),
            "events_delivered": sum(e.events_delivered for e in self.endpoints),
            "prefiltered": sum(e.prefiltered_total for e in self.endpoints),
            "hellos": [e.last_hello for e in self.endpoints],
        }

    def process_report(self) -> List[Dict[str, Any]]:
        """Per-worker supervision rows for ``/debug/processes``."""
        return [e.report() for e in self.endpoints]

    def join(self, timeout: float = 5.0) -> None:
        """Bounded shutdown: give workers the drain grace, then hard-kill
        survivors so a wedged reader can never wedge the parent's exit."""
        deadline = time.monotonic() + timeout
        super().join(timeout=timeout)
        for endpoint in self.endpoints:
            if time.monotonic() > deadline:
                endpoint.kill()


def build_process_source(
    config,
    *,
    metrics=None,
    tracer=None,
    heartbeat=None,
) -> ProcessShardedWatchSource:
    """The production multi-process ingest source (``ingest.processes > 0``).

    The parent keeps ONE control-plane client (and fails fast on a bad
    kubeconfig with the same version probe the in-process path does);
    workers build their own connections from the same config."""
    from k8s_watcher_tpu_torch.k8s.client import K8sClient
    from k8s_watcher_tpu_torch.k8s.kubeconfig import load_connection

    connection = load_connection(
        use_incluster=config.kubernetes.use_incluster_config,
        config_file=config.kubernetes.config_file,
        verify_tls=config.kubernetes.verify_tls,
    )
    client = K8sClient(connection, request_timeout=config.kubernetes.request_timeout)
    version = client.get_api_version()
    logger.info(
        "Successfully connected to Kubernetes API version: %s "
        "(multi-process ingest: %d reader processes x %d shard streams)",
        version, config.ingest.processes, config.ingest.shards,
    )
    return ProcessShardedWatchSource(
        plans_from_config(config),
        batch_max=config.ingest.batch_max,
        queue_capacity=config.ingest.queue_capacity,
        metrics=metrics,
        tracer=tracer,
        heartbeat=heartbeat,
        client=client,
    )
