"""The port's remediation (actuator, policy, arming) held against the JAX
package's.

Every scenario runs twice, once per package, each actuator against its own
``MockApiServer`` holding the same three nodes. What the scenario returns
(``ActionRecord``s, budget sets, counters), the node specs left on the
server and the notification payloads (without ``event_timestamp``) must be
equal.

Each reference device maps to one port rank: the reference's reports have
two processes with two chips each (device ``d`` on process ``d // 2``), the
port's four ranks, two to a node (rank ``r`` on node ``tpu-node-{r // 2}``).
A reference process ``p`` stands for rank ``2p`` where a report names
processes, and a dead chip is reported by its own rank, under its local CUDA
index. :func:`translate` rewrites the reference's evidence text by that map;
nothing else is rewritten.

Two rank semantics differ from the reference on purpose (``ROADMAP.md`` §C):
a link triangulation is slice scope on every rank, so only rank 0 acts on
it (``test_own_triangulated_gpu_is_left_to_rank_0`` and the 8-rank gloo
test pin it), and a link endpoint is looked up as a rank. As the reference's
one process per host, each node has one actor for its GPUs' local findings:
its lowest rank, on the findings the agent gathered from every rank of the
node (``ProbeReport.node_findings``;
``test_two_ranks_of_one_node_each_with_a_local_fault``).
"""

import dataclasses
import json
import re
import threading
from types import SimpleNamespace
from typing import List

import pytest

import k8s_watcher_tpu.remediate as ref_remediate
import k8s_watcher_tpu.remediate.policy as ref_policy_mod
import k8s_watcher_tpu_torch.remediate as port_remediate
import k8s_watcher_tpu_torch.remediate.policy as port_policy_mod
from k8s_watcher_tpu.config.schema import TpuConfig as RefTpuConfig
from k8s_watcher_tpu.k8s import client as ref_client_mod
from k8s_watcher_tpu.k8s.kubeconfig import K8sConnection as RefConnection
from k8s_watcher_tpu.k8s.mock_server import MockApiServer, MockCluster
from k8s_watcher_tpu.metrics import MetricsRegistry as RefRegistry
from k8s_watcher_tpu.probe.links import LinkProbeResult as RefLinks
from k8s_watcher_tpu.probe.multislice import MultiSliceProbeResult as RefMultiSlice
from k8s_watcher_tpu.probe.report import ProbeReport as RefReport
from k8s_watcher_tpu_torch.config import TpuConfig
from k8s_watcher_tpu_torch.k8s import client as port_client_mod
from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.probe.links import LinkProbeResult
from k8s_watcher_tpu_torch.probe.multislice import MultiSliceProbeResult
from k8s_watcher_tpu_torch.probe.report import ProbeReport
from test_torch_ranks import run_ranks

TAINT_KEY = "k8s-watcher-tpu/ici-fault"
NODES = ("tpu-node-0", "tpu-node-1", "tpu-node-2")

PACKAGES = {
    "ref": SimpleNamespace(
        remediate=ref_remediate, policy_mod=ref_policy_mod, client_mod=ref_client_mod, Connection=RefConnection,
        Registry=RefRegistry, Links=RefLinks, MultiSlice=RefMultiSlice, Report=RefReport, TpuConfig=RefTpuConfig,
    ),
    "port": SimpleNamespace(
        remediate=port_remediate, policy_mod=port_policy_mod, client_mod=port_client_mod, Connection=K8sConnection,
        Registry=MetricsRegistry, Links=LinkProbeResult, MultiSlice=MultiSliceProbeResult, Report=ProbeReport,
        TpuConfig=TpuConfig,
    ),
}


class FastMockApiServer(MockApiServer):
    """The mock apiserver with a 50 ms shutdown poll (the default 0.5 s
    would dominate a scenario's time)."""

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self


def make_server():
    cluster = MockCluster()
    for name in NODES:
        cluster.add_node({
            "metadata": {"name": name, "labels": {"cloud.google.com/gke-tpu-accelerator": "tpu-v5p"}},
            "spec": {},
            "status": {"conditions": [{"type": "Ready", "status": "True"}]},
        })
    return FastMockApiServer(cluster)


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


class Side:
    """One package's half of a scenario: its client, actuators, policies and
    reports, against its own mock apiserver."""

    def __init__(self, pkg: str, server, monkeypatch):
        self.pkg = pkg
        self.m = PACKAGES[pkg]
        self.server = server
        self.monkeypatch = monkeypatch
        self.clock = FakeClock()
        self.sent: List[dict] = []

    def pick(self, ref, port):
        return ref if self.pkg == "ref" else port

    def client(self):
        return self.m.client_mod.K8sClient(self.m.Connection(server=self.server.url), request_timeout=5.0)

    def actuator(self, **kwargs):
        kwargs.setdefault("dry_run", False)
        kwargs.setdefault("cooldown_seconds", 0.0)
        return self.m.remediate.NodeActuator(self.client(), **kwargs)

    def policy(self, confirm_cycles=3, **kwargs):
        actuator = self.actuator(**kwargs)
        policy = self.m.remediate.ProbeRemediationPolicy(actuator, confirm_cycles=confirm_cycles, sink=self.sent.append)
        return policy, actuator

    def view(self, ref, port):
        """Run the policy as process/rank ``index`` of ``count``."""
        count, index = self.pick(ref, port)
        if self.pkg == "ref":
            self.monkeypatch.setattr(ref_policy_mod.jax, "process_count", lambda: count)
            self.monkeypatch.setattr(ref_policy_mod.jax, "process_index", lambda: index)
        else:
            self.monkeypatch.setattr(port_policy_mod, "process_count", lambda: count)
            self.monkeypatch.setattr(port_policy_mod, "process_index", lambda: index)

    def hosts(self, by_process=None):
        by_process = by_process if by_process is not None else {
            "0": {"hostname": "h0", "process_index": 0, "node_name": "tpu-node-0"},
            "1": {"hostname": "h1", "process_index": 1, "node_name": "tpu-node-1"},
        }
        if self.pkg == "ref":
            return by_process
        return {str(2 * int(p) + k): {**identity, "process_index": 2 * int(p) + k}
                for p, identity in by_process.items() for k in (0, 1)}

    def multislice(self, *, dcn_suspect_slices=(), suspect_pairs=None, slice_processes=None,
                   timing_unreliable=False, error=None, pair_reason="slow", n_slices=3):
        """tests/test_remediate.py's 3-slice walk; process ``p`` becomes rank ``2p``."""
        if suspect_pairs is None:
            suspect_pairs = [
                {"name": f"slice{min(s, o)}-slice{max(s, o)}", "device_ids": [min(s, o), max(s, o)],
                 "reason": pair_reason, "rtt_ms": 9.0}
                for s in dcn_suspect_slices for o in range(n_slices) if o != s
            ]
        procs = [[0], [1], [0]] if slice_processes is None else slice_processes
        return self.m.MultiSlice(
            ok=not dcn_suspect_slices, n_slices=n_slices, devices_per_slice=2, per_slice_sums=[2.0] * n_slices,
            suspect_slices=[], ici_rtt_ms=0.1, total_rtt_ms=0.3, dcn_overhead_ms=0.2, compile_ms=1.0,
            error=error, timing_unreliable=timing_unreliable, pair_rtts=[], suspect_pairs=suspect_pairs,
            dcn_suspect_slices=list(dcn_suspect_slices),
            slice_processes=self.pick(procs, [[2 * p for p in members] for members in procs]),
        )

    def report(self, *, suspect_devices=(), dead_devices=(), hosts=None, reporting=(0, 0), multislice=None,
               links=None):
        """tests/test_remediate.py's report: 4 devices; in the port, the
        report of rank ``reporting[1]``, whose own GPU is dead when its rank
        is in ``dead_devices``."""
        if self.pkg == "ref":
            devices = {
                "process_index": reporting[0], "process_count": 2, "visible_devices": 4, "local_devices": 2,
                "healthy_devices": 4 - len(dead_devices),
                "devices": [{"id": i, "process_index": i // 2, "alive": i not in dead_devices} for i in range(4)],
            }
        else:
            rank = reporting[1]
            devices = {
                "process_index": rank, "process_count": 4, "visible_devices": 2, "local_devices": 2,
                "healthy_devices": 2 - (rank in dead_devices),
                "devices": [
                    {"id": k, "process_index": rank if k == rank % 2 else None,
                     "alive": (rank not in dead_devices) if k == rank % 2 else None}
                    for k in range(2)
                ],
            }
        if links is None and suspect_devices:
            suspect_links = [
                {"name": f"link{d}-{k}", "device_ids": [d, other], "reason": "slow", "rtt_ms": 9.0}
                for d in suspect_devices for k, other in enumerate(((d + 1) % 4, (d - 1) % 4))
            ]
            links = self.links(suspect_links, suspect_devices)
        return self.m.Report(environment="test", devices=devices, links=links, hosts=self.hosts(hosts),
                             multislice=multislice)

    def links(self, suspect_links, suspect_devices):
        return self.m.Links(ok=False, n_links=4, n_observed=4, median_rtt_ms=0.1, links=[],
                            suspect_links=suspect_links, suspect_devices=list(suspect_devices), compile_ms=0.0)

    def specs(self):
        client = self.client()
        return {name: client.get_node(name)["spec"] for name in NODES}


def translate(obj):
    """The reference's evidence text in the port's terms: process ``p`` is
    rank ``2p``, and a dead chip is named by its local index."""
    if isinstance(obj, str):
        obj = re.sub(r"host process (\d+)", lambda m: f"host process {2 * int(m.group(1))}", obj)
        return re.sub(r"chip (\d+) failed", lambda m: f"chip {int(m.group(1)) % 2} failed", obj)
    if isinstance(obj, dict):
        return {translate(k): translate(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(translate(v) for v in obj)
    return obj


def records(items):
    return [r.to_dict() for r in items]


# -- scenarios: tests/test_remediate.py, through either package ------------------

def s_quarantine_cordons_and_taints(side):
    actuator = side.actuator()
    return [actuator.quarantine("tpu-node-0", "test evidence").to_dict(), actuator.quarantined_nodes()]


def s_quarantine_preserves_existing_taints(side):
    side.client().patch_node("tpu-node-0", {"spec": {"taints": [{"key": "other", "effect": "NoExecute"}]}})
    return [side.actuator().quarantine("tpu-node-0", "x").to_dict()]


def s_dry_run_touches_nothing(side):
    return [side.actuator(dry_run=True).quarantine("tpu-node-0", "dry").to_dict()]


def s_idempotent_adoption(side):
    out = [side.actuator().quarantine("tpu-node-0", "first").to_dict()]
    fresh = side.actuator()
    out += [fresh.quarantine("tpu-node-0", "again").to_dict(), fresh.quarantined_nodes()]
    tight = side.actuator(max_quarantined_nodes=1)
    out += [tight.quarantine("tpu-node-0", "adopt").to_dict(), tight.quarantine("tpu-node-1", "x").to_dict()]
    return out


def s_cooldown_refuses_repeat(side):
    actuator = side.actuator(cooldown_seconds=600.0, clock=side.clock)
    out = [actuator.quarantine("tpu-node-0", "x").to_dict(), actuator.quarantine("tpu-node-0", "y").to_dict()]
    side.clock.now += 601.0
    return out + [actuator.quarantine("tpu-node-0", "z").to_dict()]


def s_rate_limit(side):
    actuator = side.actuator(max_actions_per_hour=2, max_quarantined_nodes=10, clock=side.clock)
    out = records([actuator.quarantine(n, n) for n in NODES])
    side.clock.now += 3601.0
    return out + [actuator.quarantine("tpu-node-2", "c").to_dict()]


def s_budget_cap_and_release(side):
    actuator = side.actuator(max_quarantined_nodes=2, max_actions_per_hour=100)
    out = records([actuator.quarantine(n, n) for n in NODES])
    out.append(actuator.release("tpu-node-0").to_dict())
    return out + [actuator.quarantine("tpu-node-2", "c").to_dict(), actuator.quarantined_nodes()]


def s_release_removes_only_our_taint(side):
    side.client().patch_node("tpu-node-0", {"spec": {"taints": [{"key": "other", "effect": "NoSchedule"}]}})
    actuator = side.actuator()
    actuator.quarantine("tpu-node-0", "x")
    return [actuator.release("tpu-node-0", "hardware cleared").to_dict(), actuator.quarantined_nodes()]


def s_restart_adopts_existing_quarantines(side):
    first = side.actuator(max_quarantined_nodes=2, max_actions_per_hour=100)
    out = records([first.quarantine("tpu-node-0", "a"), first.quarantine("tpu-node-1", "b")])
    fresh = side.m.remediate.build_actuator(
        side.client(), side.m.TpuConfig(), dry_run=False, cooldown_seconds=0.0,
        max_actions_per_hour=100, max_quarantined_nodes=2,
    )
    return out + [fresh.quarantined_nodes(), fresh.quarantine("tpu-node-2", "c").to_dict()]


def s_external_release_frees_budget(side):
    actuator = side.actuator(max_quarantined_nodes=2, max_actions_per_hour=100)
    out = records([actuator.quarantine("tpu-node-0", "a"), actuator.quarantine("tpu-node-1", "b")])
    side.client().patch_node("tpu-node-0", {"spec": {"taints": None, "unschedulable": None}})
    return out + [actuator.quarantine("tpu-node-2", "c").to_dict(), actuator.quarantined_nodes()]


def s_dry_run_budget_decisions_age_out(side):
    actuator = side.actuator(dry_run=True, max_quarantined_nodes=2, max_actions_per_hour=100,
                             cooldown_seconds=600.0, clock=side.clock)
    out = records([actuator.quarantine(n, n) for n in NODES])
    side.clock.now += 601.0
    return out + [actuator.quarantine("tpu-node-2", "c").to_dict()]


def s_transient_failure_refunds_fences(side):
    actuator = side.actuator(cooldown_seconds=3600.0, max_actions_per_hour=2, clock=side.clock)
    side.server.cluster.fail_next(1, status=500)
    out = [actuator.quarantine("tpu-node-0", "x").to_dict()]
    return out + records([actuator.quarantine("tpu-node-0", "x"), actuator.quarantine("tpu-node-1", "y")])


def s_failed_requarantine_keeps_budget_slot(side):
    actuator = side.actuator(max_quarantined_nodes=2, max_actions_per_hour=100)
    out = records([actuator.quarantine("tpu-node-0", "a"), actuator.quarantine("tpu-node-1", "b")])
    side.server.cluster.fail_next(1, status=500)
    out.append(actuator.quarantine("tpu-node-0", "re-confirm").to_dict())
    return out + [actuator.quarantined_nodes(), actuator.quarantine("tpu-node-2", "c").to_dict()]


def s_missing_node_errors_cleanly(side):
    actuator = side.actuator()
    return [actuator.quarantine("no-such-node", "x").to_dict(), actuator.quarantined_nodes()]


def s_metrics_counters(side):
    metrics = side.m.Registry()
    actuator = side.actuator(metrics=metrics, max_actions_per_hour=1)
    out = records([actuator.quarantine("tpu-node-0", "x"), actuator.quarantine("tpu-node-1", "y")])
    return out + [metrics.counter("remediation_actions").value, metrics.counter("remediation_refusals").value,
                  metrics.gauge("remediation_quarantined_nodes").read()]


def s_invalid_taint_effect_rejected(side):
    with pytest.raises(ValueError) as info:
        side.actuator(taint_effect="EvictEverything")
    return [str(info.value)]


def s_stale_rv_conflicts(side):
    client = side.client()
    stale = client.get_node("tpu-node-0")["metadata"]["resourceVersion"]
    client.patch_node("tpu-node-0", {"spec": {"unschedulable": True}})
    with pytest.raises(side.m.client_mod.K8sConflictError) as info:
        client.patch_node("tpu-node-0", {"metadata": {"resourceVersion": stale}, "spec": {"taints": []}})
    fresh = client.get_node("tpu-node-0")["metadata"]["resourceVersion"]
    out = client.patch_node("tpu-node-0", {"metadata": {"resourceVersion": fresh}, "spec": {"taints": []}})
    return [info.value.status, out["metadata"]["resourceVersion"] != fresh]


def s_concurrent_taint_edit_is_not_clobbered(side):
    real = side.client()

    class RacingClient:
        raced = False

        def get_node(self, name):
            current = real.get_node(name)
            if not self.raced:
                self.raced = True
                real.patch_node(name, {"spec": {"taints": [
                    {"key": "node.kubernetes.io/unreachable", "effect": "NoExecute"}]}})
            return current

        def __getattr__(self, attr):
            return getattr(real, attr)

    actuator = side.m.remediate.NodeActuator(RacingClient(), dry_run=False, cooldown_seconds=0.0)
    return [actuator.quarantine("tpu-node-0", "evidence").to_dict()]


def s_release_leaves_operator_cordon_alone(side):
    client = side.client()
    client.patch_node("tpu-node-0", {"spec": {"unschedulable": True}})
    rv_before = client.get_node("tpu-node-0")["metadata"]["resourceVersion"]
    actuator = side.actuator(max_actions_per_hour=4)
    out = [actuator.release("tpu-node-0", "operator release").to_dict()]
    return out + [client.get_node("tpu-node-0")["metadata"]["resourceVersion"] == rv_before,
                  len(actuator._action_times)]


def s_release_uncordons_when_our_taint_present(side):
    side.actuator().quarantine("tpu-node-0", "x")
    return [side.actuator().release("tpu-node-0", "cleared").to_dict()]


def s_noop_release_keeps_the_quarantine_cooldown_free(side):
    actuator = side.actuator(cooldown_seconds=3600.0, clock=side.clock)
    out = [actuator.release("tpu-node-0", "operator cleanup").to_dict()]
    side.clock.now += 5.0
    return out + [actuator.quarantine("tpu-node-0", "probe confirmed fault").to_dict()]


def s_adoption_scan_failure_keeps_partial_set(side):
    side.actuator().quarantine("tpu-node-0", "pre-existing")
    actuator = side.m.remediate.NodeActuator(side.client(), dry_run=False, cooldown_seconds=0.0,
                                             max_quarantined_nodes=1, max_actions_per_hour=100)
    actuator._ADOPT_PAGE_SIZE = 2
    real_list = actuator.client.list_nodes
    calls = {"n": 0}

    def flaky_list(**kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise side.m.client_mod.K8sApiError("injected blip")
        return real_list(**kw)

    actuator.client.list_nodes = flaky_list
    return [actuator.adopt_existing(), actuator.quarantine("tpu-node-1", "x").to_dict()]


def s_adopted_quarantine_is_not_an_action(side):
    metrics = side.m.Registry()
    side.actuator().quarantine("tpu-node-0", "first")
    fresh = side.actuator(metrics=metrics)
    return [fresh.quarantine("tpu-node-0", "re-confirm").to_dict(), metrics.counter("remediation_actions").value,
            metrics.gauge("remediation_quarantined_nodes").read()]


def s_adoption_scan_records_cost_metrics(side):
    metrics = side.m.Registry()
    side.actuator().quarantine("tpu-node-0", "pre-existing")
    fresh = side.actuator(metrics=metrics)
    return [fresh.adopt_existing(), metrics.counter("adopt_scans").value,
            metrics.counter("adopt_scan_pages").value, metrics.histogram("adopt_scan_duration").count]


def s_refund_removes_this_calls_rate_slot(side):
    actuator = side.actuator(clock=side.clock, max_actions_per_hour=10)
    with actuator._lock:
        ts_a = actuator._consume("tpu-node-0")
        side.clock.now += 10.0
        ts_b = actuator._consume("tpu-node-1")
        actuator._refund_locked("tpu-node-0", None, ts_a)
        return [list(actuator._action_times) == [ts_b], dict(actuator._last_action)]


def s_confirmation_requires_consecutive_cycles(side):
    policy, _ = side.policy(confirm_cycles=3)
    report = side.report(suspect_devices=[2])
    return [records(policy.observe_report(report)) for _ in range(3)]


def s_clean_cycle_resets_streak(side):
    policy, _ = side.policy(confirm_cycles=2)
    bad, clean = side.report(suspect_devices=[0]), side.report()
    return [records(policy.observe_report(r)) for r in (bad, clean, bad, bad)]


def s_dead_local_chip_implicates_its_node(side):
    policy, _ = side.policy(confirm_cycles=1)
    return [records(policy.observe_report(side.report(dead_devices=[3], reporting=(0, 3))))]


def s_error_suspects_never_actuate(side):
    report = side.report()
    report.links = side.links([
        {"name": "a", "device_ids": [2, 3], "reason": "error", "rtt_ms": -1.0},
        {"name": "b", "device_ids": [2, 1], "reason": "error", "rtt_ms": -1.0},
    ], [2])
    policy, actuator = side.policy(confirm_cycles=1)
    return [records(policy.observe_report(report)), actuator.quarantined_nodes()]


def s_unmapped_process_never_acts(side):
    policy, actuator = side.policy(confirm_cycles=1)
    hosts = {"0": {"hostname": "h0", "process_index": 0}}
    out = [records(policy.observe_report(side.report(suspect_devices=[0], hosts=hosts)))]
    return out + [actuator.quarantined_nodes()]


def s_notifications_carry_evidence_and_actions(side):
    policy, _ = side.policy(confirm_cycles=1)
    return [records(policy.observe_report(side.report(suspect_devices=[2])))]


def s_healthy_report_emits_nothing(side):
    policy, _ = side.policy(confirm_cycles=1)
    return [records(policy.observe_report(side.report()))]


def s_refused_action_restarts_streak(side):
    policy, _ = side.policy(confirm_cycles=2, max_actions_per_hour=1, max_quarantined_nodes=10, clock=side.clock)
    a, b = side.report(suspect_devices=[0]), side.report(suspect_devices=[2])
    return [records(policy.observe_report(r)) for r in (a, a, b, b, b)]


def s_only_rank_0_acts_on_remote_findings(side):
    policy, actuator = side.policy(confirm_cycles=1)
    side.view(ref=(4, 2), port=(4, 2))
    out = [records(policy.observe_report(side.report(suspect_devices=[2]))), actuator.quarantined_nodes()]
    side.view(ref=(4, 0), port=(4, 0))
    return out + [records(policy.observe_report(side.report(suspect_devices=[2])))]


def s_non_zero_rank_acts_on_its_own_node(side):
    policy, _ = side.policy(confirm_cycles=1)
    side.view(ref=(2, 1), port=(4, 2))
    report = side.report(dead_devices=[3], reporting=(0, 3))
    if side.pkg == "port":
        # rank 3's dead GPU reaches its node's lowest rank, 2, which acts for
        # the node, through the agent's gather (ProbeReport.node_findings)
        report = dataclasses.replace(side.report(reporting=(0, 2)),
                                     node_findings={"3": port_policy_mod.local_findings(report)})
    return [records(policy.observe_report(report))]


def s_non_zero_rank_ignores_remote_device_link_findings(side):
    policy, actuator = side.policy(confirm_cycles=1)
    side.view(ref=(2, 1), port=(4, 2))
    return [records(policy.observe_report(side.report(suspect_devices=[2]))), actuator.quarantined_nodes()]


def s_dcn_suspect_slice_implicates_member_node(side):
    policy, _ = side.policy(confirm_cycles=2)
    report = side.report(multislice=side.multislice(dcn_suspect_slices=[1]))
    return [records(policy.observe_report(report)) for _ in range(2)]


def s_dcn_multi_host_slice_implicates_every_member_node(side):
    policy, _ = side.policy(confirm_cycles=1)
    ms = side.multislice(dcn_suspect_slices=[0], slice_processes=[[0, 1], [], []])
    return [records(policy.observe_report(side.report(multislice=ms)))]


def s_dcn_error_pairs_never_actuate(side):
    policy, actuator = side.policy(confirm_cycles=1)
    ms = side.multislice(dcn_suspect_slices=[1], pair_reason="error")
    return [records(policy.observe_report(side.report(multislice=ms))), actuator.quarantined_nodes()]


def s_dcn_single_suspect_pair_implicates_the_route(side):
    policy, actuator = side.policy(confirm_cycles=1)
    ms = side.multislice(dcn_suspect_slices=[1], suspect_pairs=[
        {"name": "slice0-slice1", "device_ids": [0, 1], "reason": "slow", "rtt_ms": 9.0}])
    return [records(policy.observe_report(side.report(multislice=ms))), actuator.quarantined_nodes()]


def s_dcn_two_degraded_slices_spare_healthy_ones(side):
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3)]
    ms = side.multislice(
        n_slices=4, dcn_suspect_slices=[0, 1, 2, 3], slice_processes=[[0], [1], [2], [2]],
        suspect_pairs=[{"name": f"slice{i}-slice{j}", "device_ids": [i, j], "reason": "slow", "rtt_ms": 9.0}
                       for i, j in pairs],
    )
    policy, _ = side.policy(confirm_cycles=1, max_quarantined_nodes=8, max_actions_per_hour=100)
    hosts = {str(p): {"hostname": f"h{p}", "process_index": p, "node_name": f"tpu-node-{p}"} for p in range(3)}
    return [records(policy.observe_report(side.report(multislice=ms, hosts=hosts)))]


def s_dcn_unreliable_timing_never_actuates(side):
    policy, actuator = side.policy(confirm_cycles=1)
    ms = side.multislice(dcn_suspect_slices=[1], timing_unreliable=True)
    return [records(policy.observe_report(side.report(multislice=ms))), actuator.quarantined_nodes(),
            policy.snapshot()]


def s_dcn_errored_walk_never_actuates(side):
    policy, actuator = side.policy(confirm_cycles=1)
    ms = side.multislice(dcn_suspect_slices=[1], error="mesh construction failed")
    return [records(policy.observe_report(side.report(multislice=ms))), actuator.quarantined_nodes()]


def s_dcn_without_member_map_reports_unmapped(side):
    policy, actuator = side.policy(confirm_cycles=1)
    ms = side.multislice(dcn_suspect_slices=[1], slice_processes=[[0], [], [0]])
    return [records(policy.observe_report(side.report(multislice=ms))), actuator.quarantined_nodes()]


def s_dcn_findings_are_slice_scope_rank_0_only(side):
    policy, actuator = side.policy(confirm_cycles=1)
    side.view(ref=(2, 1), port=(4, 2))
    report = side.report(multislice=side.multislice(dcn_suspect_slices=[1]), reporting=(1, 2))
    out = [records(policy.observe_report(report)), actuator.quarantined_nodes()]
    side.view(ref=(2, 0), port=(4, 0))
    return out + [records(policy.observe_report(report))]


def s_hbm_bad_blocks_implicate_local_node(side):
    report = side.report()
    report.hbm_write = {"ok": False, "integrity_ok": False, "error": None,
                        "bad_blocks": [{"block": 7, "byte_offset": 7 << 19}]}
    policy, _ = side.policy(confirm_cycles=1)
    return [records(policy.observe_report(report))]


def s_hbm_checksum_failure_implicates_local_node(side):
    report = side.report(reporting=(1, 2))
    side.view(ref=(2, 1), port=(4, 2))
    report.hbm = {"ok": False, "integrity_ok": False, "error": None, "bad_blocks": []}
    policy, _ = side.policy(confirm_cycles=1)
    return [records(policy.observe_report(report))]


def s_mxu_nonfinite_implicates_local_node(side):
    report = side.report()
    report.mxu = {"ok": False, "finite": False, "error": None}
    policy, _ = side.policy(confirm_cycles=1)
    return [records(policy.observe_report(report))]


def s_snapshot_shape(side):
    policy, _ = side.policy(confirm_cycles=3)
    policy.observe_report(side.report(suspect_devices=[0]))
    return [policy.snapshot()]


SCENARIOS = {name[2:]: fn for name, fn in dict(globals()).items() if name.startswith("s_")}


@pytest.fixture
def sides(monkeypatch):
    servers = [make_server().__enter__() for _ in range(2)]
    yield [Side(pkg, server, monkeypatch) for pkg, server in zip(("ref", "port"), servers)]
    for server in servers:
        server.__exit__(None, None, None)


def _without_timestamp(payloads):
    return [{k: v for k, v in p.items() if k != "event_timestamp"} for p in payloads]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_reference(sides, scenario):
    ref, port = sides
    want = SCENARIOS[scenario](ref)
    got = SCENARIOS[scenario](port)
    assert json.dumps(got, sort_keys=True) == json.dumps(translate(want), sort_keys=True)
    assert port.specs() == ref.specs()
    assert _without_timestamp(port.sent) == translate(_without_timestamp(ref.sent))


def test_scenarios_act(sides):
    """The replay is not vacuous: the scenarios quarantine, refuse, adopt and
    notify on the port's side."""
    _, port = sides
    first = SCENARIOS["confirmation_requires_consecutive_cycles"](port)
    assert first[:2] == [[], []] and first[2][0]["node"] == "tpu-node-1" and first[2][0]["applied"]
    assert port.specs()["tpu-node-1"]["unschedulable"] is True
    assert any(t["key"] == TAINT_KEY for t in port.specs()["tpu-node-1"]["taints"])
    assert port.sent[-1]["event_type"] == "TPU_REMEDIATION" and port.sent[-1]["quarantined_nodes"] == ["tpu-node-1"]


def test_own_triangulated_gpu_is_left_to_rank_0(sides):
    """The reference's process 1 acts on a triangulation of its own chip
    (local scope). In the port every rank classifies the merged walk, so the
    suspect's own rank leaves it to rank 0 (slice scope)."""
    ref, port = sides
    ref_policy, _ = ref.policy(confirm_cycles=1)
    ref.view(ref=(2, 1), port=None)
    ref_records = ref_policy.observe_report(ref.report(suspect_devices=[2], reporting=(1, None)))
    assert [r.node for r in ref_records] == ["tpu-node-1"]
    port_policy, actuator = port.policy(confirm_cycles=1)
    report = port.report(suspect_devices=[2], reporting=(None, 2))
    port.view(ref=None, port=(4, 2))
    assert port_policy.observe_report(report) == [] and actuator.quarantined_nodes() == []
    port.view(ref=None, port=(4, 0))
    assert [r.node for r in port_policy.observe_report(report)] == ["tpu-node-1"]


@pytest.mark.parametrize("fault", ["hbm", "mxu"])
def test_two_ranks_of_one_node_each_with_a_local_fault(sides, fault):
    """Ranks 2 and 3 share tpu-node-1 and each finds a fault on its own GPU
    (local scope). The agent gathers the node's local findings to each of its
    ranks (``ProbeReport.node_findings``), and only the node's lowest rank
    acts, on both, with a reason that names both ranks; rank 3 stays silent.
    That is the reference's one process per host: one action, one PATCH and
    one remediation payload for the node."""

    def faulty(side, reporting):
        report = side.report(reporting=reporting)
        if fault == "hbm":
            report.hbm = {"ok": False, "integrity_ok": False, "error": None, "bad_blocks": [{"block": 3}]}
        else:
            report.mxu = {"ok": False, "finite": False, "error": None}
        return report

    ref, port = sides
    ref.view(ref=(2, 1), port=None)
    ref_policy, _ = ref.policy(confirm_cycles=1)
    ref_records = records(ref_policy.observe_report(faulty(ref, (1, None))))
    gathered = {str(rank): port_policy_mod.local_findings(faulty(port, (None, rank))) for rank in (2, 3)}
    port_records = []
    for rank in (2, 3):
        port.view(ref=None, port=(4, rank))
        policy, _ = port.policy(confirm_cycles=1)
        report = faulty(port, (None, rank))
        report.node_findings = gathered
        port_records.append(records(policy.observe_report(report)))
    assert [(r["node"], r["applied"], r["adopted"]) for r in ref_records] == [("tpu-node-1", True, False)]
    ((first,), second) = port_records
    assert {k: v for k, v in first.items() if k != "reason"} == {
        k: v for k, v in ref_records[0].items() if k != "reason"}
    assert second == []
    (evidence,) = gathered["2"]
    assert f"rank 2: {evidence}; rank 3: {evidence}" in first["reason"]
    assert port.specs() == ref.specs()
    assert [t["key"] for t in port.specs()["tpu-node-1"]["taints"]] == [TAINT_KEY]
    assert len(port.sent) == len(ref.sent) == 1 and len(port.sent[0]["actions"]) == 1


def test_link_endpoint_is_looked_up_as_a_rank(sides):
    """A port report's inventory lists only the node's GPUs by local index,
    so the reference's device-to-process join finds no process for rank 3
    (the finding is unmapped); the port looks rank 3 up in ``hosts``."""
    ref, port = sides
    report = port.report(suspect_devices=[3], reporting=(None, 0))
    assert ref_policy_mod.ProbeRemediationPolicy._implicated(report) == {"__unmapped__": [
        "link probe: device 3 is the common endpoint of 2 measured-suspect links"]}
    assert list(port_policy_mod.ProbeRemediationPolicy._implicated(report)) == ["tpu-node-1"]


# -- arming on the agent (scripts/probe_agent.py:_arm_remediation) ---------------

def _script():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "probe_agent.py"
    spec = importlib.util.spec_from_file_location("probe_agent_script", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _arming_config(pkg, tmp_path, server_url=None, enabled=True):
    from conftest import CONFIG_DIR
    from k8s_watcher_tpu.config.loader import load_config as ref_load_config
    from k8s_watcher_tpu_torch.config import load_agent_config

    config = (ref_load_config if pkg == "ref" else load_agent_config)("development", CONFIG_DIR, env={})
    kubernetes = config.kubernetes
    if server_url is not None:
        kc = tmp_path / "kubeconfig.json"
        kc.write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": "m", "cluster": {"server": server_url}}],
            "contexts": [{"name": "m", "context": {"cluster": "m", "user": "m"}}],
            "current-context": "m",
            "users": [{"name": "m", "user": {"token": "t"}}],
        }))
        kubernetes = dataclasses.replace(kubernetes, use_mock=False, config_file=str(kc))
    tpu = dataclasses.replace(config.tpu, remediation_enabled=enabled, remediation_dry_run=False,
                              remediation_confirm_cycles=1, remediation_cooldown_seconds=0.0)
    return dataclasses.replace(config, kubernetes=kubernetes, tpu=tpu)


def _arm(pkg, config, sent):
    class FakeDispatcher:
        def submit(self, notification):
            sent.append(notification)

    if pkg == "ref":
        from k8s_watcher_tpu.probe.agent import ProbeAgent as RefAgent

        agent = RefAgent(RefTpuConfig(probe_hbm_bytes=0, probe_matmul_size=64, probe_payload_bytes=1024),
                         environment="test", sink=lambda n: None, expected_platform=None)
        return agent, _script()._arm_remediation(agent, config, "test", FakeDispatcher())
    from k8s_watcher_tpu_torch import probe_agent
    from k8s_watcher_tpu_torch.probe.agent import ProbeAgent

    agent = ProbeAgent(TpuConfig(probe_hbm_bytes=0, probe_matmul_size=64, probe_payload_bytes=1024),
                       environment="test", sink=lambda n: None, device="cpu", expected_platform=None)
    return agent, probe_agent._arm_remediation(agent, config, "test", FakeDispatcher())


def test_arming_with_credentials_quarantines_alike(sides, tmp_path):
    for side in sides:
        sent = []
        agent, policy = _arm(side.pkg, _arming_config(side.pkg, tmp_path, side.server.url), sent)
        assert agent.report_observer is not None and policy is not None
        agent.report_observer(side.report(suspect_devices=[2]))
        assert side.specs()["tpu-node-1"].get("unschedulable") is True
        assert [n.kind for n in sent] == ["remediation"]
        side.sent = _without_timestamp([n.payload for n in sent])
    assert sides[1].specs() == sides[0].specs()
    assert sides[1].sent == translate(sides[0].sent)


@pytest.mark.parametrize("case", ["no_credentials", "disabled"])
def test_arming_without_a_cluster_probes_on(tmp_path, case):
    for pkg in ("ref", "port"):
        config = _arming_config(pkg, tmp_path, "http://127.0.0.1:1" if case == "no_credentials" else None,
                                enabled=case != "disabled")
        agent, policy = _arm(pkg, config, [])
        assert policy is None and agent.report_observer is None


# -- 8 gloo ranks: exactly one policy acts on a slow rank ------------------------

_GLOO = """
import os
os.environ["NODE_NAME"] = f"node-{rank // 4}"
from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
from k8s_watcher_tpu_torch.parallel.mesh import host_chip_mesh
from k8s_watcher_tpu_torch.probe.device import enumerate_devices, host_identity_map
from k8s_watcher_tpu_torch.probe.links import run_link_probe
from k8s_watcher_tpu_torch.probe.report import ProbeReport
from k8s_watcher_tpu_torch.remediate import NodeActuator, ProbeRemediationPolicy
cpu = torch.device("cpu")
mesh = host_chip_mesh(cpu)
actuator = NodeActuator(K8sClient(K8sConnection(server=%(url)r), request_timeout=10.0),
                        dry_run=False, cooldown_seconds=0.0)
policy = ProbeRemediationPolicy(actuator, confirm_cycles=%(confirm)d)
out = {"records": [], "suspects": []}
for cycle in range(%(confirm)d):
    links = run_link_probe(mesh, fault=IciFaultSpec(slow_rank=3, slow_iters=2000),
                           iters=3, inner_iters=4, rtt_floor_ms=10.0)
    report = ProbeReport(environment="test", devices=enumerate_devices(cpu, expected_platform=None),
                         links=links, hosts=host_identity_map(cpu))
    out["suspects"].append(links.suspect_devices)
    out["records"] += [r.to_dict() for r in policy.observe_report(report)]
out["payload"] = report.to_payload()
with open(out_path, "w") as fh:
    json.dump(out, fh, default=str)
"""

CONFIRM = 2


def test_eight_ranks_one_actor(tmp_path, monkeypatch):
    """8 gloo ranks on a (2, 4) grid, ``NODE_NAME`` node-<rank // 4>, rank 3
    slow. After ``confirm_cycles`` walks every rank names rank 3 (node-0), and
    only rank 0's policy quarantines it. Under the reference's scope rule,
    rank 3 would act on its own GPU as well."""
    with make_server() as server:
        server.cluster.add_node({"metadata": {"name": "node-0"}, "spec": {}})
        server.cluster.add_node({"metadata": {"name": "node-1"}, "spec": {}})
        ranks = run_ranks(_GLOO % {"url": server.url, "confirm": CONFIRM}, 8, tmp_path, local_world_size=4)
        client = PACKAGES["port"].client_mod.K8sClient(K8sConnection(server=server.url))
        node0, node1 = client.get_node("node-0")["spec"], client.get_node("node-1")["spec"]
        # the same rank-3 report under the reference's scope rule, with the
        # inventory the reference's single controller sees (every chip with
        # its process)
        payload = ranks[3]["payload"]
        ref_report = RefReport(
            environment="test",
            devices={"process_index": 3, "devices": [{"id": r, "process_index": r} for r in range(8)]},
            links=RefLinks(**{**payload["links"], "links": []}), hosts=payload["hosts"],
        )
        monkeypatch.setattr(ref_policy_mod.jax, "process_count", lambda: 8)
        monkeypatch.setattr(ref_policy_mod.jax, "process_index", lambda: 3)
        ref_policy = ref_remediate.ProbeRemediationPolicy(
            ref_remediate.NodeActuator(ref_client_mod.K8sClient(RefConnection(server=server.url)), dry_run=True,
                                       cooldown_seconds=0.0),
            confirm_cycles=1)
        ref_records = ref_policy.observe_report(ref_report)
    for r in ranks:
        assert r["suspects"] == [[3]] * CONFIRM
        assert r["payload"]["hosts"]["3"]["node_name"] == "node-0"
    acted = {rank: r["records"] for rank, r in enumerate(ranks) if r["records"]}
    assert list(acted) == [0]
    (record,) = acted[0]
    assert record["node"] == "node-0" and record["ok"] and record["applied"]
    assert "device 3 is the common endpoint" in record["reason"]
    assert node0.get("unschedulable") is True and any(t["key"] == TAINT_KEY for t in node0["taints"])
    assert not node1.get("unschedulable") and not node1.get("taints")
    assert [(r.node, r.ok) for r in ref_records] == [("node-0", True)]
