"""Application wiring: config -> source -> pipeline -> dispatcher (the JAX
package's ``app.py``).

``WatcherApp.run()`` lists and watches the pods through the sharded ingest,
runs each batch through the event pipeline (namespace filter, resource
filter, critical gate, phase tracker, slice tracker, payload extraction),
hands the notifications to the keyed egress lanes, checkpoints the journaled
state, serves the status routes, and runs the in-process probe agent on this
rank's GPU when ``tpu.probe.enabled`` is set. With ``serve.enabled`` the
pipeline and the notification sink fold into the serving plane's fleet view
(``/serve/fleet``), and ``analytics.enabled`` answers ``/serve/analytics``
with kernels on this rank's GPU. ``history.enabled`` puts a durable WAL under
the view (recovered before it serves, so the rv line and resume tokens
survive a restart, and ``?at=`` reads the past); ``health.enabled`` scores
nodes against their slice peers from the view's phases, the trace stages and
the in-process probe's reports, escalating through the remediation actuator;
``slo.enabled`` evaluates burn rates over the registry.
``watcher.leader_election.enabled`` makes a replica stand by (status routes
up, liveness beating, no watch held, nothing sent) until it holds the
Lease; ``tpu.node_watch.enabled`` adds the node plane's list+watch, whose
readiness changes degrade the slices of their members; ``ingest.processes``
moves the shard streams, their native prefilter and their checkpoints into
supervised reader processes (``/debug/processes``). ``federation.enabled``
subscribes to N upstream serving planes and merges them into this view under
``"<cluster>/<key>"`` keys (``federation.processes`` shards that fan-in over
merge-worker processes; ``trace.federation.enabled`` joins their sampled
journeys); ``relay.enabled`` mirrors one upstream's view and re-broadcasts
its frames without encoding them again.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Optional

from k8s_watcher_tpu_torch.config import AppConfig
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.notify.client import ClusterApiClient
from k8s_watcher_tpu_torch.notify.dispatcher import Dispatcher, build_notifier
from k8s_watcher_tpu_torch.pipeline.filters import CriticalEventGate, NamespaceFilter, TpuResourceFilter
from k8s_watcher_tpu_torch.pipeline.phase import PhaseTracker
from k8s_watcher_tpu_torch.pipeline.pipeline import EventPipeline, Notification
from k8s_watcher_tpu_torch.probe import spans
from k8s_watcher_tpu_torch.slices.tracker import SliceTracker
from k8s_watcher_tpu_torch.state.checkpoint import CheckpointStore
from k8s_watcher_tpu_torch.status import Liveness, StatusServer
from k8s_watcher_tpu_torch.watch.sharded import ShardedWatchSource
from k8s_watcher_tpu_torch.watch.source import WatchSource

logger = logging.getLogger(__name__)

def build_source(
    config: AppConfig,
    checkpoint: Optional[CheckpointStore] = None,
    heartbeat=None,
    metrics: Optional[MetricsRegistry] = None,
    tracer=None,  # trace.Tracer: head-samples at the shard pumps
) -> WatchSource:
    """The sharded watch ingest for this environment: always a
    ``ShardedWatchSource`` (``ingest.shards: 1`` is one stream through the
    same queue and batch drain). ``kubernetes.use_mock`` replays an
    in-process fake pod lifecycle instead of watching a cluster."""
    ingest = config.ingest
    if config.kubernetes.use_mock:
        from k8s_watcher_tpu_torch.watch.fake import pod_lifecycle, sharded_fake_sources

        logger.info(
            "use_mock=true: replaying an in-process fake pod lifecycle over %d shard stream(s)",
            ingest.shards,
        )
        return ShardedWatchSource(
            sharded_fake_sources(
                pod_lifecycle("mock-tpu-pod", "default", phases=("Pending", "Running"), tpu_chips=4),
                ingest.shards,
                hold_open=True,
            ),
            batch_max=ingest.batch_max,
            queue_capacity=ingest.queue_capacity,
            metrics=metrics,
            tracer=tracer,
        )

    if ingest.processes > 0:
        # the multi-process ingest tier: the shard streams, their prefilters
        # and their per-shard checkpoints run in supervised reader
        # processes; this process keeps the pipeline, the view and one
        # control-plane client
        from k8s_watcher_tpu_torch.watch.procpool import build_process_source

        logger.info(
            "Multi-process ingest: %d reader processes x %d shard streams (prefilter=%s; per-shard checkpoints "
            "under %s)",
            ingest.processes, ingest.shards, ingest.resolved_prefilter(config.tpu.prefilter),
            config.state.checkpoint_path,
        )
        return build_process_source(config, metrics=metrics, tracer=tracer, heartbeat=heartbeat)

    from k8s_watcher_tpu_torch.k8s.client import K8sClient
    from k8s_watcher_tpu_torch.k8s.kubeconfig import load_connection
    from k8s_watcher_tpu_torch.k8s.watch import KubernetesWatchSource
    from k8s_watcher_tpu_torch.native.scanner import make_scanner
    from k8s_watcher_tpu_torch.watch.sharded import ShardCheckpointView

    connection = load_connection(
        use_incluster=config.kubernetes.use_incluster_config,
        config_file=config.kubernetes.config_file,
        verify_tls=config.kubernetes.verify_tls,
    )
    first_client = K8sClient(connection, request_timeout=config.kubernetes.request_timeout)
    logger.info("Successfully connected to Kubernetes API version: %s", first_client.get_api_version())

    shards = ingest.shards
    prefilter_mode = ingest.resolved_prefilter(config.tpu.prefilter)
    if prefilter_mode != "off":
        logger.info("Watch-frame prefilter enabled (%s, mode=%s)", config.tpu.resource_key, prefilter_mode)
    sources = []
    for shard in range(shards):
        shard_checkpoint = checkpoint
        if checkpoint is not None and shards > 1:
            shard_checkpoint = ShardCheckpointView(checkpoint, shard, shards)
        sources.append(KubernetesWatchSource(
            # one client per shard: a client carries at most one live watch
            first_client if shard == 0 else K8sClient(
                connection, request_timeout=config.kubernetes.request_timeout
            ),
            label_selector=config.watcher.label_selector,
            retry=config.watcher.retry,
            watch_timeout_seconds=config.kubernetes.watch_timeout_seconds,
            checkpoint=shard_checkpoint,
            heartbeat=heartbeat,
            # one scanner per shard stream (the native scanner's record
            # buffers are per-instance scratch); uid extraction (the
            # pre-parse foreign-shard skip) only matters with more than one
            # shard
            scanner=make_scanner(config.tpu.resource_key, mode=prefilter_mode, extract_uid=shards > 1),
            metrics=metrics,
            list_page_size=config.watcher.list_page_size,
            shard=shard,
            shards=shards,
            on_taken=spans.take,
        ))
    if shards > 1:
        logger.info("Sharded ingest: %d watch streams (uid-hash partition)", shards)
    return ShardedWatchSource(
        sources,
        batch_max=ingest.batch_max,
        queue_capacity=ingest.queue_capacity,
        metrics=metrics,
        tracer=tracer,
    )


class WatcherApp:
    def __init__(
        self,
        config: AppConfig,
        *,
        source: Optional[WatchSource] = None,
        notifier: Optional[ClusterApiClient] = None,
        metrics: Optional[MetricsRegistry] = None,
        device: Any = None,
        expected_platform: Optional[str] = "auto",
    ):
        """``device`` is where the in-process probe agent and the analytics
        plane run: by default this rank's GPU, and they raise here when there
        is none; ``device="cpu"`` runs them on the CPU. ``expected_platform``
        goes to the probe agent (``"cpu"`` holds it to the CPU platform)."""
        self.config = config
        self.metrics = metrics or MetricsRegistry()
        self.checkpoint = (
            CheckpointStore(
                config.state.checkpoint_path,
                interval_seconds=config.state.checkpoint_interval_seconds,
                metrics=self.metrics,
            )
            if config.state.checkpoint_path
            else None
        )
        if self.checkpoint is not None:
            # known_pods and phases grow with the tracked pods while their
            # churn per window is small: journal both, so a steady-state
            # flush costs O(churn), not O(cluster)
            self.checkpoint.attach_journaled_map("known_pods")
            self.checkpoint.attach_journaled_map("phases")
        self.notifier = notifier or build_notifier(config)
        self.liveness = Liveness(config.watcher.liveness_stale_seconds)
        self.audit = None
        if config.watcher.audit_ring_size > 0:
            from k8s_watcher_tpu_torch.audit import AuditRing

            self.audit = AuditRing(config.watcher.audit_ring_size)
        # one Tracer shared by every stage: the shard pumps head-sample, the
        # pipeline and dispatcher stamp spans and close journeys
        self.tracer = None
        if config.trace.enabled:
            from k8s_watcher_tpu_torch.trace import Tracer

            self.tracer = Tracer(
                sample_rate=config.trace.sample_rate,
                ring_size=config.trace.ring_size,
                metrics=self.metrics,
            )
        self.status_server: Optional[StatusServer] = None
        # the durable history plane: recovery runs here, before the view
        # exists, so the serving plane builds its view straight onto the
        # previous incarnation's rv line; the journal preload is bounded by
        # the in-memory horizon (deeper history still serves ?at= reads)
        self.history = None
        if config.history.enabled:
            from k8s_watcher_tpu_torch.history import HistoryStore

            h = config.history
            self.history = HistoryStore(
                h.dir,
                segment_max_bytes=h.segment_max_bytes,
                segment_max_age_seconds=h.segment_max_age_seconds,
                retain_segments=h.retain_segments,
                fsync=h.fsync,
                fsync_interval_seconds=h.fsync_interval_seconds,
                metrics=self.metrics,
            )
            self.history.recover(journal_limit=config.serve.compact_horizon)
        # the fleet-state serving plane: the view exists from construction
        # (the pipeline publishes into it); its HTTP server and broadcast
        # loops start in run() with the other servers
        self.serve = None
        if config.serve.enabled:
            from k8s_watcher_tpu_torch.serve import ServePlane

            self.serve = ServePlane(
                config.serve,
                metrics=self.metrics,
                # the status plane's bearer: no unauthenticated side door
                auth_token=config.watcher.status_auth_token,
                history=self.history,
            )
            if self.tracer is not None:
                # /debug/trace on the serve port too: a downstream federator
                # knows only this URL and stitches local spans from it
                self.serve.attach_trace(self.tracer.ring)
        # the relay tier: this view mirrors an upstream serving plane (its
        # instance id, its rv line, its frame bytes re-broadcast as they
        # are). The local pipeline does not publish into a relayed view: its
        # deltas would mint rvs on a foreign rv space
        self.relay = None
        if config.relay.enabled:
            from k8s_watcher_tpu_torch.relay import RelayPlane

            self.relay = RelayPlane(config.relay, self.serve.view, metrics=self.metrics)
            self.serve.attach_relay(self.relay)
        # the federation plane: N upstream serving planes, subscribed with
        # durable resume tokens and merged into this view under
        # (kind, "<cluster>/<key>") keys, so the serve and history planes
        # republish the global fleet. Its subscribers start in run(), after
        # the serve plane binds, and stop before the WAL closes
        self.federation = None
        # trace joining (trace.federation.enabled): the subscribers negotiate
        # ?trace=1 and the collector joins each sampled journey's upstream
        # spans with the serve_wire, federate_merge and global_serve hops, in
        # the shared ring (/debug/trace?uid=, /debug/trace/diagnosis)
        self.trace_collector = None
        if config.federation.enabled:
            from k8s_watcher_tpu_torch.federate import FederationPlane

            if self.tracer is not None and config.trace.federation.enabled:
                from k8s_watcher_tpu_torch.trace import ALL_STAGES, FleetTraceCollector

                self.trace_collector = FleetTraceCollector(
                    tracer=self.tracer,
                    metrics=self.metrics,
                    forward_spans=config.trace.federation.forward_spans,
                    max_joined=config.trace.federation.max_joined,
                    # the (stage x upstream) labels are bounded by the config
                    max_label_sets=len(config.federation.upstreams) * len(ALL_STAGES) + 8,
                )
            # durable resume tokens only when the merged view is durable: a
            # token resumed into an empty restarted view would serve a partial
            # fleet. They sit beside the checkpoint, else under the WAL's
            # directory, and are valid only after a clean recovery (a torn WAL
            # tail can leave the view behind a token; the plane then clears
            # them and re-snapshots)
            token_dir = None
            tokens_valid = False
            if config.history.enabled:
                recovered = self.history.recovered if self.history is not None else None
                tokens_valid = recovered is not None and bool(recovered.instance) and recovered.clean
                if config.state.checkpoint_path:
                    token_dir = os.path.join(
                        os.path.dirname(os.path.abspath(config.state.checkpoint_path)), "federation-tokens"
                    )
                elif config.history.dir:
                    token_dir = os.path.join(config.history.dir, "federation-tokens")
            self.federation = FederationPlane(
                config.federation,
                self.serve.view,
                metrics=self.metrics,
                token_dir=token_dir,
                resume_tokens_valid=tokens_valid,
                trace_collector=self.trace_collector,
                # the sharded fan-in's worker anomaly traces land in the ring
                trace_ring=self.tracer.ring if self.tracer is not None else None,
                process_export=config.metrics.process_export,
            )
            if config.federation.processes > 0:
                logger.info(
                    "Federation fan-in sharded across %d merge worker process(es) "
                    "(%d upstream(s); staleness owner: merge workers)",
                    config.federation.processes,
                    len(config.federation.upstreams),
                )
        # the analytics plane: the view's columns, kernels on ``device``,
        # /serve/analytics; passive (refreshed per request), attached before
        # the serve plane starts
        self.analytics = None
        if config.analytics.enabled:
            from k8s_watcher_tpu_torch.analytics import AnalyticsPlane

            self.analytics = AnalyticsPlane(config.analytics, self.serve.view, metrics=self.metrics, device=device)
            self.serve.attach_analytics(self.analytics)
        # the node-health plane: it reads the view (built above) and its
        # gauges join the registry before the SLO engine's first sample; the
        # actuator and the probe feed arm in run()
        self.health = None
        if config.health.enabled:
            from k8s_watcher_tpu_torch.health import HealthPlane

            self.health = HealthPlane(
                config.health,
                metrics=self.metrics,
                view=self.serve.view if self.serve is not None else None,
                federation=self.federation,
                environment=config.environment,
            )
        # the SLO engine, last among the planes, so its first sample sees
        # their series
        self.slo = None
        if config.slo.enabled:
            from k8s_watcher_tpu_torch.slo import SLOPlane

            self.slo = SLOPlane(config.slo, self.metrics)
        c = config.clusterapi
        # each egress POST is a watcher span (notify.post)
        post = spans.traced("notify.post", keep=True)
        send_batch = getattr(self.notifier, "update_pod_statuses", None) if c.batch_max > 1 else None
        self.dispatcher = Dispatcher(
            post(self.notifier.update_pod_status),
            capacity=c.queue_capacity,
            # egress fan-out scales with the ingest fan-in unless pinned
            workers=c.resolved_workers(config.ingest.shards),
            coalesce=c.coalesce,
            coalesce_watermark=c.coalesce_watermark,
            metrics=self.metrics,
            # bounds shutdown: when stop()'s drain window expires, cut
            # in-flight sends instead of waiting out attempts x timeout
            abort=getattr(self.notifier, "abort", None),
            # micro-batching under backlog; a receiver without the batch
            # endpoint falls back per item
            send_batch=post(send_batch) if send_batch is not None else None,
            batch_max=c.batch_max,
            tracer=self.tracer,
            audit=self.audit,
        )
        # the sink every producer uses: with the serving plane on, slice
        # aggregates and probe verdicts fold into the view on their way to
        # the dispatcher (pods reach it through the pipeline's publish hook,
        # which also sees the events the critical gate keeps from notifying)
        self._notify_sink = (
            self.serve.wrap_sink(self.dispatcher.submit)
            if self.serve is not None and self.relay is None
            else self.dispatcher.submit
        )
        self.source = source or build_source(
            config, self.checkpoint, self.liveness.beat, self.metrics, self.tracer
        )
        # every source runs behind the sharded-ingest machinery: a plain
        # source is one shard stream, not a separate code path
        self.ingest = (
            self.source
            if isinstance(self.source, ShardedWatchSource)
            else ShardedWatchSource(
                [self.source],
                batch_max=config.ingest.batch_max,
                queue_capacity=config.ingest.queue_capacity,
                metrics=self.metrics,
                tracer=self.tracer,
            )
        )
        if self.tracer is not None and self.ingest.tracer is None:
            self.ingest.tracer = self.tracer
        self.slice_tracker = SliceTracker(
            config.environment,
            resource_key=config.tpu.resource_key,
            topology_label=config.tpu.topology_label,
            accelerator_label=config.tpu.accelerator_label,
        )
        self.phase_tracker = PhaseTracker()
        if self.checkpoint is not None:
            self.phase_tracker.restore(self.checkpoint.get("phases", {}) or {})
            self.slice_tracker.restore(self.checkpoint.get("slices", {}) or {})
        self.pipeline = EventPipeline(
            environment=config.environment,
            sink=self._notify_sink,
            namespace_filter=NamespaceFilter(config.watcher.namespaces),
            resource_filter=TpuResourceFilter(config.tpu.resource_key),
            critical_gate=CriticalEventGate(config.environment, config.watcher.critical_events_only),
            phase_tracker=self.phase_tracker,
            slice_tracker=self.slice_tracker,
            metrics=self.metrics,
            audit=self.audit,
            tracer=self.tracer,
            view=self.serve.view if self.serve is not None and self.relay is None else None,
            resource_key=config.tpu.resource_key,
            topology_label=config.tpu.topology_label,
            accelerator_label=config.tpu.accelerator_label,
        )
        self._stop = threading.Event()
        self.elector = None  # k8s.leader.LeaderElector with watcher.leader_election
        self.node_watcher = None  # nodes.NodeWatcher with tpu.node_watch
        self.remediation = None  # remediate.ProbeRemediationPolicy when armed
        self._probe_agent = None
        self._owns_process_group = False
        if config.tpu.probe_enabled:
            import torch.distributed as dist

            from k8s_watcher_tpu_torch.probe.agent import ProbeAgent

            # raises here, before anything runs, when CUDA is asked for
            # (the default) and the machine has none
            self._probe_agent = ProbeAgent(
                config.tpu,
                environment=config.environment,
                sink=self._notify_sink,
                metrics=self.metrics,
                device=device,
                expected_platform=expected_platform,
            )
            # the agent's first cycle starts a one-rank group unless a
            # torchrun group exists; shutdown ends only the group it made
            self._owns_process_group = not dist.is_initialized()

    def run(self) -> None:
        """Blocking steady-state loop, until ``stop()`` or the ingest ends."""
        self.dispatcher.start()
        if self.relay is not None:
            # before the serve plane binds, so the first subscriber finds the
            # mirrored view; the wait is bounded (a dark upstream degrades
            # health instead of wedging the start)
            self.relay.start()
            self.relay.wait_synced(self.config.relay.sync_timeout_seconds)
        if self.serve is not None:
            # before the status server, so /healthz folds a started plane
            self.serve.start()
        if self.federation is not None:
            # after the serve plane (the merged view republishes through it)
            self.federation.start()
        if self.health is not None:
            # ticks start now so peer baselines and trend anchors warm up;
            # the actuator arms in _start_health
            self.health.start()
        if self.slo is not None:
            # its first tick seeds the ring, so the burn windows have a base
            self.slo.start()
        if self.config.watcher.status_port:
            agent = self._probe_agent
            trend = agent.trend.snapshot if agent is not None and agent.trend is not None else None
            remediation_state = (
                # answers "configured but not armed" until the policy arms
                (lambda: self.remediation.snapshot() if self.remediation is not None else None)
                if self.config.tpu.remediation_enabled
                else None
            )
            stall_after = self.config.clusterapi.egress_stall_seconds
            # the worker-process surface, only when a process tier is live
            procs_live = callable(getattr(self.ingest, "process_report", None)) or (
                self.federation is not None and self.federation.fanin is not None
            )
            self.status_server = StatusServer(
                self.metrics,
                self.liveness,
                port=self.config.watcher.status_port,
                audit=self.audit,
                trace=self.tracer.ring if self.tracer is not None else None,
                # /healthz covers the egress side too: all workers dead, or a
                # wedged lane past the stall threshold, turns it 503
                egress=lambda: self.dispatcher.egress_health(stall_after),
                # ... and the serving plane: a dead serve thread or broadcast
                # loop silently starves every subscriber
                serve=self.serve.health if self.serve is not None else None,
                federation=self.federation.health if self.federation is not None else None,
                relay=self.relay.health if self.relay is not None else None,
                trace_stitch=self.trace_collector.stitch if self.trace_collector is not None else None,
                trace_diagnosis=self.trace_collector.diagnosis if self.trace_collector is not None else None,
                freshness=self._freshness_snapshot if self.serve is not None else None,
                slices=self.slice_tracker.debug_snapshot,
                checkpoint=self.checkpoint.stats if self.checkpoint is not None else None,
                trend=trend,
                remediation=remediation_state,
                probes=agent.recent_cycles if agent is not None else None,
                history=self.history.stats if self.history is not None else None,
                slo=self.slo.snapshot if self.slo is not None else None,
                slo_health=self.slo.health if self.slo is not None else None,
                node_health=self.health.snapshot if self.health is not None else None,
                node_health_fold=self.health.health if self.health is not None else None,
                processes=self._processes_snapshot if procs_live else None,
                processes_fold=self._processes_health if procs_live else None,
                auth_token=self.config.watcher.status_auth_token,
            ).start()
            routes = "/metrics, /healthz, /debug/slices" + (
                ", /debug/events" if self.audit is not None else ""
            ) + (", /debug/trace" if self.tracer is not None else "") + (
                ", /debug/trace/diagnosis" if self.trace_collector is not None else ""
            ) + (
                ", /debug/trend" if trend is not None else ""
            ) + (", /debug/probes" if agent is not None else "") + (
                ", /debug/remediation" if remediation_state is not None else ""
            ) + (", /debug/checkpoint" if self.checkpoint is not None else "") + (
                ", /debug/history" if self.history is not None else ""
            ) + (", /debug/federation" if self.federation is not None else "") + (
                ", /debug/relay" if self.relay is not None else ""
            ) + (", /debug/freshness" if self.serve is not None else "") + (
                ", /debug/slo" if self.slo is not None else ""
            ) + (", /debug/health" if self.health is not None else "") + (
                ", /debug/processes" if procs_live else ""
            )
            logger.info("Status endpoint on :%d (%s)", self.status_server.port, routes)
        if self.config.watcher.leader_election.enabled:
            self._campaign()  # blocks until this replica leads (or stop())
            if self._stop.is_set():
                self.shutdown()
                return
        if self.notifier.health_check():
            logger.info("ClusterAPI health check passed")
        else:
            logger.warning("ClusterAPI health check failed, but continuing...")
        namespaces = self.config.watcher.namespaces
        logger.info("Monitoring %s", f"namespaces: {list(namespaces)}" if namespaces else "all namespaces")
        self._start_remediation()
        self._start_health()
        if self._probe_agent is not None:
            self._probe_agent.start()
        self._start_node_watch()
        try:
            # batched drain: whatever accumulated in the ingest queue since
            # the last iteration (<= ingest.batch_max) goes through the
            # pipeline in one call, and the checkpoint sweep runs once per
            # batch. A quiet stream gives batches of one: no added latency.
            for batch in self.ingest.batches():
                if self._stop.is_set():
                    break
                self.liveness.beat()
                with spans.watch_span("watch.batch"):
                    self.pipeline.process_batch(batch)
                self._maybe_checkpoint()
        except KeyboardInterrupt:
            logger.info("Stopping Pod watcher...")
        finally:
            self.shutdown()

    def _campaign(self) -> None:
        """Stand by until this replica holds the leadership Lease. A standby
        is hot (dispatcher and status routes up, liveness beating) but holds
        no watch and sends nothing. Losing a held leadership stops the app;
        the restarted process rejoins as a standby (the client-go
        convention)."""
        client = getattr(self.source, "client", None)
        if client is None:
            logger.warning("Leader election enabled but the watch source has no k8s client (mock/fake source); "
                           "skipping")
            return
        from k8s_watcher_tpu_torch.k8s.leader import LeaderElector, default_identity, elector_client

        le = self.config.watcher.leader_election
        identity = le.identity or default_identity()

        def lost() -> None:
            logger.error("Leadership lost; stopping watcher (restart to rejoin as standby)")
            self.stop()

        self.elector = LeaderElector(
            # a dedicated short-timeout client: a stalled renew must not
            # outlive the renew deadline
            elector_client(client, le.renew_deadline_seconds, le.lease_duration_seconds),
            lease_namespace=le.lease_namespace,
            lease_name=le.lease_name,
            identity=identity,
            lease_duration_seconds=le.lease_duration_seconds,
            renew_deadline_seconds=le.renew_deadline_seconds,
            retry_period_seconds=le.retry_period_seconds,
            on_stopped_leading=lost,
        ).start()
        logger.info("Standing by for leadership of %s/%s as %s", le.lease_namespace, le.lease_name, identity)
        while not self._stop.is_set():
            self.liveness.beat()  # a healthy standby is alive, just not leading
            if self.elector.wait_for_leadership(timeout=1.0):
                return

    def _start_remediation(self) -> None:
        """Arm remediation (``tpu.remediation.enabled``): the probe agent's
        reports feed a confirmation policy that may quarantine (cordon and
        taint) implicated nodes through a dedicated Kubernetes client."""
        if not self.config.tpu.remediation_enabled:
            return
        if self._probe_agent is None:
            logger.warning("tpu.remediation enabled but tpu.probe is not; nothing to act on — skipping")
            return
        client = getattr(self.source, "client", None)
        if client is None:
            logger.warning("tpu.remediation enabled but the watch source has no k8s client (mock/fake source); skipping")
            return
        from k8s_watcher_tpu_torch.k8s.client import K8sClient
        from k8s_watcher_tpu_torch.remediate import build_actuator, build_policy

        t = self.config.tpu
        self.remediation = build_policy(
            build_actuator(
                # node PATCHes must not contend with the watch stream (a
                # client carries at most one live watch)
                K8sClient(client.connection, request_timeout=self.config.kubernetes.request_timeout),
                t,
                metrics=self.metrics,
            ),
            t,
            dispatcher=self.dispatcher,
            metrics=self.metrics,
            environment=self.config.environment,
        )
        self._probe_agent.report_observer = self.remediation.observe_report
        logger.info(
            "Remediation plane armed (dry_run=%s, confirm_cycles=%d, budget=%d nodes, taint %s=%s:%s)",
            t.remediation_dry_run, t.remediation_confirm_cycles, t.remediation_max_quarantined_nodes,
            t.remediation_taint_key, t.remediation_taint_value, t.remediation_taint_effect,
        )

    def _start_health(self) -> None:
        """Arm the health plane's write side: the probe reports feed it
        (after the remediation policy, when that is armed), its TPU_HEALTH
        escalations ride the dispatcher, and its confirmed nodes go to the
        remediation plane's actuator (one budget and cooldown for both
        confirmation paths), or to a dedicated one built from the same
        ``tpu.remediation`` settings. With remediation off the verdicts stop
        at confirmed."""
        if self.health is None:
            return
        if self._probe_agent is not None and self.config.health.source_probe:
            prev = self._probe_agent.report_observer
            observe = self.health.observe_report

            def chained(report, _prev=prev, _observe=observe):
                if _prev is not None:
                    _prev(report)
                _observe(report)

            self._probe_agent.report_observer = chained

        def health_sink(payload, _submit=self.dispatcher.submit):
            _submit(Notification(payload, time.monotonic(), kind="health"))

        self.health.detector.sink = health_sink
        actuator = None
        if self.remediation is not None:
            actuator = self.remediation.actuator
        elif self.config.tpu.remediation_enabled:
            client = getattr(self.source, "client", None)
            if client is not None:
                from k8s_watcher_tpu_torch.k8s.client import K8sClient
                from k8s_watcher_tpu_torch.remediate import build_actuator

                actuator = build_actuator(
                    K8sClient(client.connection, request_timeout=self.config.kubernetes.request_timeout),
                    self.config.tpu,
                    metrics=self.metrics,
                )
        if actuator is not None:
            self.health.arm_actuator(actuator)
            logger.info("Health plane actuator armed (dry_run=%s, shared_with_remediation=%s)",
                        actuator.dry_run, self.remediation is not None)

    def _start_node_watch(self) -> None:
        """Start the node plane (``tpu.node_watch.enabled``): a second
        list+watch over /api/v1/nodes on its own thread and client. Only the
        leader runs it (run() reaches here after the campaign), so a standby
        never notifies node transitions twice."""
        if not self.config.tpu.node_watch_enabled:
            return
        client = getattr(self.source, "client", None)
        if client is None:
            logger.warning("tpu.node_watch enabled but the watch source has no k8s client (mock/fake source); "
                           "skipping")
            return
        from k8s_watcher_tpu_torch.k8s.client import K8sClient
        from k8s_watcher_tpu_torch.nodes import NodeTracker, NodeWatcher

        t = self.config.tpu
        tracker = NodeTracker(
            self.config.environment,
            resource_key=t.resource_key,
            accelerator_label=t.accelerator_label,
            topology_label=t.topology_label,
        )
        self.node_watcher = NodeWatcher(
            # a client carries at most one live watch: the node stream gets
            # its own, on the same connection settings
            K8sClient(client.connection, request_timeout=self.config.kubernetes.request_timeout),
            tracker,
            self._notify_sink,
            slice_tracker=self.slice_tracker,
            label_selector=t.node_watch_label_selector,
            retry=self.config.watcher.retry,
            watch_timeout_seconds=self.config.kubernetes.watch_timeout_seconds,
            metrics=self.metrics,
            list_page_size=self.config.watcher.list_page_size,
        ).start()
        # pod events folded after the node plane syncs get a live existence
        # answer: a member landing on an already-deleted node starts down
        self.slice_tracker.set_node_existence_provider(self.node_watcher.node_existence)
        logger.info("Node watch started (selector=%s)", t.node_watch_label_selector or "<all nodes>")

    def _maybe_checkpoint(self, force: bool = False) -> None:
        if self.checkpoint is None:
            return
        # snapshots are O(tracked pods): build them only when the throttled
        # store will flush (or at shutdown)
        if not (force or self.checkpoint.due()):
            return
        # drain the dirty hint BEFORE the snapshot (the other order can lose
        # an update); an idle window skips the snapshot entirely
        changed_phases = self.phase_tracker.drain_dirty_uids()
        if changed_phases is None or changed_phases:  # None = persist everything
            self.checkpoint.put("phases", self.phase_tracker.snapshot(), changed_keys=changed_phases)
        self.checkpoint.put("slices", self.slice_tracker.snapshot())
        # the live-pod map (merged across shard streams), so a relist after
        # a restart can synthesize DELETED for pods that vanished meanwhile
        changed = self.ingest.drain_dirty_uids()
        if changed is None or changed:
            known = self.ingest.known_pods()
            if known is not None:
                self.checkpoint.put("known_pods", known, changed_keys=changed)

    def _freshness_snapshot(self) -> dict:
        """The ``/debug/freshness`` body: the local view's watermark, the
        watch-to-local-view histogram and, on a federator, each upstream's
        watermark and the cross-cluster propagation histograms."""
        out = {"local": self.serve.view.freshness()}
        local_hist = self.metrics.histogram("watch_to_local_view_seconds")
        if local_hist.count:
            out["local"]["watch_to_local_view_seconds"] = local_hist.summary()
        if self.federation is not None:
            out["federation"] = self.federation.freshness()
        return out

    def _process_reports(self) -> list:
        """Supervision rows of every live process tier: the ingest readers
        (``ingest.processes``) and the fan-in's merge workers
        (``federation.processes``)."""
        out = []
        report = getattr(self.ingest, "process_report", None)
        if callable(report):
            out.extend(report())
        if self.federation is not None:
            out.extend(self.federation.process_report())
        return out

    def _processes_snapshot(self) -> dict:
        """The ``/debug/processes`` body: each worker's supervision row with
        its hottest process-labelled counter series."""
        rows = self._process_reports()
        top = self.config.metrics.process_top_series
        for row in rows:
            label = row.get("process")
            if label:
                row["hottest_series"] = self.metrics.hottest_series(label, top)
        return {"processes": len(rows), "export": self.config.metrics.process_export, "workers": rows}

    def _processes_health(self) -> dict:
        """The ``/healthz`` body fold: degraded (never liveness) while any
        reader's stats are stale; a dead reader waiting out its respawn
        backoff reads as stale too. The threshold is 10x the 0.5 s stats
        cadence, floored at 5 s."""
        rows = self._process_reports()
        threshold = max(5.0, 10.0 * 0.5)
        stale = [row.get("process") for row in rows
                 if row.get("last_stats_age_seconds") is None or row["last_stats_age_seconds"] > threshold]
        return {"healthy": not stale, "processes": len(rows), "stale": stale}

    def stop(self) -> None:
        self._stop.set()
        self.ingest.stop()  # stops the shard streams (incl. self.source)

    def shutdown(self) -> None:
        self.ingest.stop()
        if callable(getattr(self.ingest, "process_report", None)):
            # the reader processes drain (checkpoints flushed, EOS sent) and
            # are reaped; a reader that ignores the grace is killed
            self.ingest.join(5.0)
        if self.node_watcher is not None:
            self.node_watcher.stop()
            self.node_watcher = None
        if self.elector is not None:
            self.elector.stop()  # release the Lease: a standby takes over now
            self.elector = None
        if self.status_server is not None:
            self.status_server.stop()
            self.status_server = None
        if self.slo is not None:
            self.slo.stop()
        if self.health is not None:
            # before the federation and serve planes: its tick reads both
            self.health.stop()
        if self.federation is not None:
            # before the serve plane and the WAL: the subscribers produce
            # deltas, and the WAL's final snapshot must follow their last one
            self.federation.stop()
        if self.relay is not None:
            self.relay.stop()  # the relay's subscriber feeds the view too
        if self.serve is not None:
            self.serve.stop()
        joined = True
        if self._probe_agent is not None:
            joined = self._probe_agent.stop()
        self.dispatcher.stop()
        if self.history is not None:
            # after every delta producer stopped: drain the WAL queue, write
            # the final snapshot (the next boot's clean recovery anchor), fsync
            self.history.close()
        if self.checkpoint is not None:
            self._maybe_checkpoint(force=True)
            self.checkpoint.flush()
        if self._owns_process_group:
            import torch.distributed as dist

            if dist.is_initialized():
                if joined:
                    dist.destroy_process_group()
                else:
                    logger.warning("The probe loop did not stop within 5 s; leaving the process group to the exit")
        logger.info("Watcher metrics: %s", self.metrics.dump())
