"""The probe agent's entry point: one cycle, or the DaemonSet loop.

Usage: ``python -m k8s_watcher_tpu_torch.probe_agent [environment] [--once] [--cpu]``

Reads the environment's settings from ``config/`` (relative to the working
directory). Runs on this rank's GPU; ``--cpu`` runs on the CPU with the
kernels' plain versions, held to the ``cpu`` platform. Under ``torchrun
--nproc-per-node N`` every rank runs and joins the collectives.

- ``--once``: one cycle with every sub-probe the settings enable; prints the
  payload as JSON and exits 1 when the report is unhealthy.
- Without it, the loop a DaemonSet runs (:func:`run_loop`): a cycle every
  ``tpu.probe.interval_seconds``, reports POSTed to ``clusterapi`` through
  the dispatcher (rank 0 for the group, another rank when its own view is
  unhealthy), the status server on ``tpu.probe.status_port`` (``/metrics``,
  ``/healthz``, ``/debug/trend``, ``/debug/probes``, and
  ``/debug/remediation`` when remediation is armed) and, with
  ``tpu.remediation.enabled``, the remediation policy after every cycle.
  SIGINT or SIGTERM stops it and the command exits 0.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import signal
import sys
import threading
from typing import Callable, List, Optional

import torch.distributed as dist

from k8s_watcher_tpu_torch.config import AgentConfig, load_agent_config, resolve_environment
from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import load_connection
from k8s_watcher_tpu_torch.logging_setup import setup_logging
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.notify.client import ClusterApiClient
from k8s_watcher_tpu_torch.notify.dispatcher import Dispatcher, build_notifier
from k8s_watcher_tpu_torch.parallel.mesh import initialize_process_group
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent
from k8s_watcher_tpu_torch.probe.device import process_count, resolve_device
from k8s_watcher_tpu_torch.remediate import ProbeRemediationPolicy, build_actuator, build_policy
from k8s_watcher_tpu_torch.status import Liveness, StatusServer

logger = logging.getLogger("probe_agent")

# the remediation client's per-request cap: the policy runs on the probe
# thread after the heartbeat, so an unresponsive apiserver delays a cycle by
# a few requests x 10 s, well inside the liveness threshold (>= 300 s)
REMEDIATION_TIMEOUT_CAP_S = 10.0


@dataclasses.dataclass
class AgentLoop:
    """What :func:`run_loop` built."""

    agent: ProbeAgent
    notifier: ClusterApiClient
    dispatcher: Dispatcher
    liveness: Optional[Liveness] = None
    status_server: Optional[StatusServer] = None
    remediation: Optional[ProbeRemediationPolicy] = None
    # set when the loop has stopped: whether the loop thread joined
    joined: Optional[bool] = None


def _arm_remediation(agent: ProbeAgent, config: AgentConfig, environment: str, dispatcher) -> Optional[
        ProbeRemediationPolicy]:
    """The remediation policy as the agent's report observer, with
    ``tpu.remediation.enabled``.

    Every rank arms one: rank 0 acts on slice-scope findings, every rank on
    the local findings about its own GPU (remediate/policy.py), so the fences,
    ``max_quarantined_nodes`` included, are per rank. The connection needs
    get/list/patch on nodes (the pod's ServiceAccount in-cluster). Without a
    usable connection, shown by ``/version`` and a one-node LIST failing, the
    agent logs and probes on without remediation."""
    if not config.tpu.remediation_enabled:
        return None
    try:
        connection = load_connection(
            use_incluster=config.kubernetes.use_incluster_config,
            config_file=config.kubernetes.config_file,
            verify_tls=config.kubernetes.verify_tls,
        )
        client = K8sClient(
            connection, request_timeout=min(float(config.kubernetes.request_timeout), REMEDIATION_TIMEOUT_CAP_S)
        )
        client.get_api_version()  # fail fast: no cluster -> no remediation
        client.list_nodes(limit=1)  # ... and no node access -> no remediation
    except Exception as exc:  # noqa: BLE001 — probing must survive without a cluster
        logger.warning("tpu.remediation enabled but no usable k8s credentials (%s); probing without remediation", exc)
        return None
    t = config.tpu
    policy = build_policy(
        # a single rank is the sole actor and adopts pre-restart quarantines;
        # with several, adopting the others' taints would fill this rank's
        # budget with foreign quarantines and refuse its own
        build_actuator(client, t, metrics=agent.metrics, adopt=process_count() == 1),
        t,
        dispatcher=dispatcher,
        metrics=agent.metrics,
        environment=environment,
    )
    agent.report_observer = policy.observe_report
    logger.info(
        "Remediation armed on the probe agent (dry_run=%s, confirm_cycles=%d)",
        t.remediation_dry_run, t.remediation_confirm_cycles,
    )
    return policy


def run_loop(
    config: AgentConfig,
    environment: str,
    stop: threading.Event,
    *,
    device=None,
    expected_platform: Optional[str] = "auto",
    started: Optional[Callable[[AgentLoop], None]] = None,
) -> AgentLoop:
    """Run the agent's loop until ``stop`` is set, then shut it down; returns
    what it built.

    ``started`` is called with the built parts just before the first cycle.
    The shutdown order: the loop thread (after its cycle in flight), the
    status server, the dispatcher (its backlog drained, then cut after 5 s),
    and last the process group, only once the loop thread has joined, so no
    collective is in flight when it goes."""
    device = resolve_device(device)
    initialize_process_group(device)
    metrics = MetricsRegistry()
    notifier = build_notifier(config)
    dispatcher = Dispatcher(
        notifier.update_pod_status,
        capacity=config.clusterapi.queue_capacity,
        workers=1,
        metrics=metrics,
        abort=notifier.abort,
    )
    dispatcher.start()
    t = config.tpu
    liveness = None
    if t.probe_status_port:
        # beats land at cycle end only, so the steady gap is cycle +
        # interval + the policy's I/O; the first cycle pays every set-up
        liveness = Liveness(
            stale_after_seconds=max(300.0, 5 * t.probe_interval_seconds),
            first_beat_grace_seconds=max(900.0, 10 * t.probe_interval_seconds),
        )
    agent = ProbeAgent(
        t, environment=environment, sink=dispatcher.submit, metrics=metrics, device=device,
        expected_platform=expected_platform, heartbeat=liveness.beat if liveness is not None else None,
    )
    loop = AgentLoop(agent=agent, notifier=notifier, dispatcher=dispatcher, liveness=liveness)
    try:
        loop.remediation = _arm_remediation(agent, config, environment, dispatcher)
        if liveness is not None:
            loop.status_server = StatusServer(
                metrics,
                liveness,
                port=t.probe_status_port,
                trend=agent.trend.snapshot if agent.trend is not None else None,
                remediation=loop.remediation.snapshot if loop.remediation is not None else None,
                probes=agent.recent_cycles,
                auth_token=t.probe_status_auth_token,
            ).start()
            routes = "/metrics, /healthz, /debug/trend, /debug/probes" + (
                ", /debug/remediation" if loop.remediation is not None else ""
            )
            print(f"probe status endpoint on :{loop.status_server.port} ({routes})", flush=True)
        if started is not None:
            started(loop)
        agent.start()
        while not stop.wait(0.5):
            pass
    finally:
        loop.joined = agent.stop()
        if loop.status_server is not None:
            loop.status_server.stop()
        dispatcher.stop()
        if dist.is_initialized():
            if loop.joined:
                dist.destroy_process_group()
            else:
                logger.warning("The probe loop did not stop within 5 s; leaving the process group to the exit")
    return loop


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    flags = {a for a in argv if a.startswith("--")}
    unknown = flags - {"--once", "--cpu"}
    if unknown:
        print(f"unknown option(s): {' '.join(sorted(unknown))}", file=sys.stderr)
        return 2
    environment = resolve_environment(args[:1])
    config = load_agent_config(environment)
    setup_logging(environment, config.log_level)
    on_cpu = "--cpu" in flags
    device = "cpu" if on_cpu else None
    # an explicit --cpu run is held to the CPU; by default the contract is CUDA
    expected_platform = "cpu" if on_cpu else "auto"
    if "--once" not in flags:
        stop = threading.Event()
        for signum in (signal.SIGINT, signal.SIGTERM):
            signal.signal(signum, lambda *_: stop.set())
        run_loop(config, environment, stop, device=device, expected_platform=expected_platform)
        return 0
    agent = ProbeAgent(
        config.tpu, environment=environment, sink=lambda notification: None,
        device=device, expected_platform=expected_platform,
    )
    try:
        report = agent.run_once()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(report.to_payload(), indent=2, default=str))
    return 0 if report.healthy else 1


if __name__ == "__main__":
    sys.exit(main())
