"""Remediation drill: injected fault -> localization -> node quarantine ->
release, on ranks (the JAX package's ``scripts/chaos_remediate.py``).

The whole remediation loop end to end: the port's mock apiserver holds the
drill's nodes, a recording HTTP sink stands in for clusterapi, and a fault is
injected into real link-walk runs on gloo CPU ranks or on the GPUs of a
``torchrun`` launch. The policy confirms the suspect across consecutive
cycles and the actuator cordons and taints its node over real HTTP, while
the TPU_REMEDIATION notification flows through the dispatcher to the sink.
Every stage is asserted:

1. the link walk names exactly the injected rank;
2. cycle 1 alone does NOT act (confirmation discipline);
3. after ``--confirm-cycles`` the mock node is unschedulable + tainted;
4. the sink received a TPU_REMEDIATION payload with the applied action;
5. ``release`` restores the node.

Then the DCN stage: a slow rank inside one slice stretches every slice pair
touching it, the pair walk names that slice, and the policy maps it to its
node and, after the same confirmation, makes a DRY-RUN quarantine decision
(whole-slice cordons are the operator-review case):

6. the pair walk implicates exactly the injected slice;
7. after ``--confirm-cycles`` a dry-run decision names the slice's node, with
   the slice index in its evidence, while every mock node stays untouched;
8. the TPU_REMEDIATION notification for it reaches the HTTP sink.

A slice is a node on ranks (parallel/mesh.py:slice_grid), so the DCN
stage's cluster holds one node per slice, ``drill-tpu-node-<i>``; the ICI
stage's node is ``drill-tpu-node-0``, holding every rank.

    python -m k8s_watcher_tpu_torch.chaos_remediate --cpu-ranks 8
    torchrun --nnodes=4 --nproc-per-node=gpu ... -m k8s_watcher_tpu_torch.chaos_remediate

``--cpu-ranks N`` runs the ICI stage on one node of N gloo ranks and the DCN
stage on ``--dcn-slices`` nodes of N/``--dcn-slices`` ranks, each stage a
group of its own, with the apiserver and the sink in this process. Under
``torchrun`` both stages run on the launch's own nodes and GPUs (the DCN
stage needs ``--dcn-slices`` to divide the node count), and rank 0 holds
the apiserver and the sink. Without ``--cpu-ranks`` and without CUDA it
raises; it never falls back to the CPU. Exit code 1 when a stage fails, 2
when the fault names no rank or slice of the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from k8s_watcher_tpu_torch.chaos_probe import RTT_FLOOR_MS
from k8s_watcher_tpu_torch.drill_common import start_sink, tpu_node

NODE_PREFIX = "drill-tpu-node-"
# the slow fault's chained 128x128 bf16 matmuls: on CPU ranks enough to clear
# the 50 ms floor under load (~0.075 ms each on one thread), on a GPU the JAX
# package's drill default
SLOW_ITERS = {"cpu": 3000, "cuda": 800}
# the pair walk's floor: the probe's default on a GPU, the CPU ranks' link
# floor on CPU ranks, where a loaded host stalls a rank for tens of ms
PAIR_RTT_FLOOR_MS = {"cuda": 0.2, "cpu": RTT_FLOOR_MS["cpu"]}
STAGE_MODULE = "k8s_watcher_tpu_torch.chaos_remediate"


def node_name(index: int) -> str:
    return f"{NODE_PREFIX}{index}"


def _rank_setup(rank: int, world: int, device: Optional[str]):
    """This rank's device, node index and ``NODE_NAME`` (the downward-API
    join the DaemonSet provides, pointed at the drill's nodes)."""
    from k8s_watcher_tpu_torch.probe.device import resolve_device

    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    os.environ["NODE_NAME"] = node_name(rank // local)
    return resolve_device(device), local


def _remediation(api_url: str, sink_url: str, *, dry_run: bool, max_quarantined: int, confirm_cycles: int):
    """A client, a started dispatcher to the sink, and a policy acting
    through an actuator on the drill's apiserver."""
    from k8s_watcher_tpu_torch.k8s.client import K8sClient
    from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
    from k8s_watcher_tpu_torch.notify.client import ClusterApiClient
    from k8s_watcher_tpu_torch.notify.dispatcher import Dispatcher
    from k8s_watcher_tpu_torch.pipeline.pipeline import Notification
    from k8s_watcher_tpu_torch.remediate import NodeActuator, ProbeRemediationPolicy

    client = K8sClient(K8sConnection(server=api_url), request_timeout=5.0)
    notifier = ClusterApiClient(sink_url, None, 5.0)
    dispatcher = Dispatcher(notifier.update_pod_status, capacity=64, workers=1)
    dispatcher.start()

    def submit(payload):
        dispatcher.submit(Notification(payload, time.monotonic(), kind="remediation"))

    actuator = NodeActuator(client, dry_run=dry_run, cooldown_seconds=0.0, max_actions_per_hour=100,
                            max_quarantined_nodes=max_quarantined)
    policy = ProbeRemediationPolicy(actuator, confirm_cycles=confirm_cycles, sink=submit, environment="drill")
    return client, dispatcher, actuator, policy


def _acted_elsewhere(acted: bool) -> List[int]:
    """The ranks other than 0 whose policy acted (only rank 0 may: every
    finding of the walks is slice scope)."""
    import torch.distributed as dist

    flags: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(acted))
    return [r for r, flag in enumerate(flags) if flag and r != 0]


def ici_stage(rank: int, world: int, *, api_url: str, sink_url: str, slow_device: int, slow_iters: int,
              confirm_cycles: int, device: Optional[str] = None) -> Dict[str, Any]:
    """Stages 1-3 and 5 on this rank; every rank calls it together, rank 0
    acts and checks. What rank 0 found (``failures`` among it)."""
    import torch.distributed as dist

    from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
    from k8s_watcher_tpu_torch.parallel.mesh import host_chip_mesh
    from k8s_watcher_tpu_torch.probe.device import enumerate_devices, host_identity_map
    from k8s_watcher_tpu_torch.probe.links import run_link_probe
    from k8s_watcher_tpu_torch.probe.report import ProbeReport

    dev, local = _rank_setup(rank, world, device)
    mesh = host_chip_mesh(dev)
    client, dispatcher, actuator, policy = _remediation(api_url, sink_url, dry_run=False, max_quarantined=2,
                                                        confirm_cycles=confirm_cycles)
    target = node_name(slow_device // local)
    fault = IciFaultSpec(slow_rank=slow_device, slow_iters=slow_iters)
    devices = enumerate_devices(dev, expected_platform=None)
    hosts = host_identity_map(dev)
    out: Dict[str, Any] = {}
    failures: List[str] = []

    def cycle():
        links = run_link_probe(mesh, iters=3, inner_iters=4, rtt_floor_ms=RTT_FLOOR_MS[dev.type], fault=fault)
        return links, ProbeReport(environment="drill", devices=devices, links=links, hosts=hosts)

    links1, report1 = cycle()
    out["links_cycle1"] = {
        "suspect_devices": links1.suspect_devices,
        "suspect_links": [s["name"] for s in links1.suspect_links],
    }
    if sorted(links1.suspect_devices) != [slow_device]:
        failures.append(f"link walk mislocalized: {links1.suspect_devices} != [{slow_device}]")
    actions1 = policy.observe_report(report1)
    if actions1:
        failures.append(f"acted on cycle 1 of {confirm_cycles} — confirmation discipline broken")
    if rank == 0 and (client.get_node(target).get("spec") or {}).get("unschedulable"):
        failures.append("node cordoned before confirmation")
    dist.barrier()  # every rank's cycle 1 is folded before cycle 2 can act

    all_actions = list(actions1)
    for _ in range(confirm_cycles - 1):
        _, report_n = cycle()
        all_actions += policy.observe_report(report_n)
    others = _acted_elsewhere(bool(all_actions))
    if others:
        failures.append(f"ranks {others} acted; only rank 0 acts on a walk's findings")
    if rank != 0:
        dispatcher.stop()
        return {"failures": failures}

    applied = [a for a in all_actions if a.ok and a.applied]
    out["actions"] = [a.to_dict() for a in all_actions]
    if not applied or applied[0].node != target:
        failures.append(f"no applied quarantine for {target}: {out['actions']}")
    spec = client.get_node(target).get("spec") or {}
    cordoned = bool(spec.get("unschedulable"))
    tainted = any(t.get("key") == actuator.taint_key for t in spec.get("taints") or [])
    out["node_after"] = {"unschedulable": cordoned, "tainted": tainted}
    if not (cordoned and tainted):
        failures.append(f"node not quarantined on the apiserver: {spec}")

    release = actuator.release(target, "drill cleanup")
    spec_released = client.get_node(target).get("spec") or {}
    out["released"] = {
        "ok": release.ok,
        "unschedulable": bool(spec_released.get("unschedulable")),
        "taints": spec_released.get("taints") or [],
    }
    if not release.ok or spec_released.get("unschedulable") or spec_released.get("taints"):
        failures.append(f"release did not restore the node: {spec_released}")
    dispatcher.stop()  # drains the notifications to the sink
    out["failures"] = failures
    return out


def dcn_stage(rank: int, world: int, *, api_url: str, sink_url: str, n_slices: int, dcn_slice: int,
              slow_iters: int, confirm_cycles: int, device: Optional[str] = None) -> Dict[str, Any]:
    """Stages 6 and 7 on this rank; every rank calls it together, rank 0
    decides and checks."""
    from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
    from k8s_watcher_tpu_torch.probe.device import enumerate_devices, host_identity_map
    from k8s_watcher_tpu_torch.probe.multislice import run_multislice_probe
    from k8s_watcher_tpu_torch.probe.report import ProbeReport

    dev, local = _rank_setup(rank, world, device)
    client, dispatcher, _, policy = _remediation(api_url, sink_url, dry_run=True, max_quarantined=8,
                                                 confirm_cycles=confirm_cycles)
    # slow down a rank INSIDE the target slice: every slice pair touching
    # that slice stretches, no other pair does
    per_slice = world // n_slices
    fault = IciFaultSpec(slow_rank=dcn_slice * per_slice, slow_iters=slow_iters)
    devices = enumerate_devices(dev, expected_platform=None)
    hosts = host_identity_map(dev)
    out: Dict[str, Any] = {}
    failures: List[str] = []

    def cycle():
        ms = run_multislice_probe(n_slices=n_slices, iters=3, inner_iters=4, fault=fault,
                                  pair_rtt_floor_ms=PAIR_RTT_FLOOR_MS[dev.type], device=dev)
        return ms, ProbeReport(environment="drill", devices=devices, multislice=ms, hosts=hosts)

    ms1, report1 = cycle()
    out["dcn_cycle1"] = {
        "dcn_suspect_slices": ms1.dcn_suspect_slices,
        "suspect_pairs": [s["name"] for s in ms1.suspect_pairs],
        "timing_unreliable": ms1.timing_unreliable,
    }
    if ms1.dcn_suspect_slices != [dcn_slice]:
        failures.append(f"DCN walk mislocalized: {ms1.dcn_suspect_slices} != [{dcn_slice}]")
    actions = list(policy.observe_report(report1))
    if actions:
        failures.append("DCN stage acted on cycle 1 — confirmation discipline broken")
    for _ in range(confirm_cycles - 1):
        _, report_n = cycle()
        actions += policy.observe_report(report_n)
    others = _acted_elsewhere(bool(actions))
    if others:
        failures.append(f"ranks {others} decided; only rank 0 acts on a walk's findings")
    if rank != 0:
        dispatcher.stop()
        return {"failures": failures}

    members = ms1.slice_processes[dcn_slice] if dcn_slice < len(ms1.slice_processes) else []
    expected = sorted({node_name(r // local) for r in members})
    decisions = [a for a in actions if a.ok and a.dry_run and not a.applied]
    out["dcn_actions"] = [a.to_dict() for a in actions]
    if not decisions:
        failures.append(f"no confirmed dry-run DCN decision: {out['dcn_actions']}")
    else:
        if sorted({d.node for d in decisions}) != expected:
            failures.append(f"DCN decision names {sorted({d.node for d in decisions})}, not {expected}")
        for decision in decisions:
            if f"slice {dcn_slice}" not in decision.reason:
                failures.append(f"DCN decision evidence lacks the slice index: {decision.reason}")
    for node in client.list_nodes().get("items", []):
        spec = node.get("spec") or {}
        if spec.get("unschedulable") or spec.get("taints"):
            failures.append(f"dry-run DCN stage wrote to the cluster: {node['metadata']['name']}: {spec}")
    dispatcher.stop()
    out["failures"] = failures
    return out


class _Harness:
    """The drill's mock apiserver and its recording sink, in one process."""

    def __init__(self):
        from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer, MockCluster

        self.received: List[dict] = []
        self._lock = threading.Lock()
        self.sink = start_sink(self._on_payload)
        self.cluster = MockCluster()
        self.api = MockApiServer(self.cluster).start()
        self.sink_url = f"http://127.0.0.1:{self.sink.server_address[1]}"

    def _on_payload(self, body, _now):
        with self._lock:
            self.received.append(body)

    def add_nodes(self, count: int) -> None:
        for i in range(count):
            if self.cluster.get_node(node_name(i)) is None:
                self.cluster.add_node(tpu_node(node_name(i)))

    def wait_for_payloads(self, predicate: Callable[[dict], bool], timeout: float = 10.0) -> List[dict]:
        """TPU_REMEDIATION payloads matching ``predicate``, polled until
        ``timeout``."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                matches = [p for p in self.received if p.get("event_type") == "TPU_REMEDIATION" and predicate(p)]
            if matches or time.monotonic() >= deadline:
                return matches
            time.sleep(0.05)

    def close(self) -> None:
        self.api.stop()
        self.sink.shutdown()
        self.sink.server_close()


def run_drill(harness: Optional[_Harness], run_stage: Callable[[str, Dict[str, Any], int], Dict[str, Any]], *,
              world: int, nodes: Tuple[int, int], slow_device: int, slow_iters: int, confirm_cycles: int,
              dcn_slices: int, dcn_slice: int) -> Dict[str, Any]:
    """Both stages; ``run_stage(name, kwargs, n)`` runs a stage function on
    every rank, the ranks split into ``n`` nodes (``nodes``: the ICI stage's
    and the DCN stage's), and returns this rank's result. The process holding
    ``harness`` adds the nodes and checks the sink; under ``torchrun`` the
    other ranks pass None and run the same stages. The result has the JAX
    package's drill's keys."""
    common = dict(slow_iters=slow_iters, confirm_cycles=confirm_cycles)
    result: Dict[str, Any] = {"injected_device": slow_device, "n_devices": world}
    failures: List[str] = []

    def sink_check(key: str, predicate: Callable[[dict], bool], missing: str) -> None:
        if harness is not None:
            result[key] = len(harness.wait_for_payloads(predicate))
            if not result[key]:
                failures.append(missing)

    if harness is not None:
        harness.add_nodes(nodes[0])
    ici = run_stage("ici_stage", dict(common, slow_device=slow_device), nodes[0])
    failures += ici.pop("failures")
    result.update(links_cycle1=ici.get("links_cycle1"), actions=ici.get("actions"), node_after=ici.get("node_after"))
    sink_check("sink_remediation_payloads", lambda p: p.get("actions"),
               "no TPU_REMEDIATION notification reached the HTTP sink")
    result["released"] = ici.get("released")

    if world % dcn_slices or nodes[1] % dcn_slices:
        failures.append(f"{world} ranks on {nodes[1]} nodes do not split into --dcn-slices {dcn_slices}")
    else:
        if harness is not None:
            harness.add_nodes(nodes[1])
        dcn = run_stage("dcn_stage", dict(common, n_slices=dcn_slices, dcn_slice=dcn_slice), nodes[1])
        failures += dcn.pop("failures")
        result.update(dcn_cycle1=dcn.get("dcn_cycle1"), dcn_actions=dcn.get("dcn_actions"))
        sink_check("sink_dcn_payloads", lambda p: p.get("dry_run") is True and any(
            "dcn probe" in e for ev in (p.get("implicated") or {}).values() for e in ev),
            "no DCN TPU_REMEDIATION notification reached the HTTP sink")
    result["failures"] = failures
    return result


def _refused(args, world: int) -> Optional[str]:
    """Why the drill cannot run as asked on ``world`` ranks, or None."""
    if not 0 <= args.slow_device < world:
        return f"--slow-device {args.slow_device} is not a rank of {world}"
    if not 0 <= args.dcn_slice < args.dcn_slices:
        return f"--dcn-slice {args.dcn_slice} is not a slice of --dcn-slices {args.dcn_slices}"
    return None


def _report(result: Dict[str, Any]) -> int:
    print(json.dumps(result, indent=2))
    failed = result["failures"]
    print("\nremediation drill: "
          + ("PASS — ICI fault quarantined, DCN fault localized to a dry-run decision" if not failed else "FAIL"))
    return 1 if failed else 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu-ranks", type=int, default=0, metavar="N",
                        help="run on N gloo ranks in CPU processes instead of the GPUs")
    parser.add_argument("--slow-device", type=int, default=3, help="rank to make slow")
    parser.add_argument("--slow-iters", type=int, default=None,
                        help="injected delay in chained matmuls (default: 3000 on CPU ranks, 800 on GPUs)")
    parser.add_argument("--confirm-cycles", type=int, default=2)
    parser.add_argument("--dcn-slices", type=int, default=4,
                        help="slices for the DCN stage (must divide the ranks, and under torchrun the nodes)")
    parser.add_argument("--dcn-slice", type=int, default=3, help="slice index to inject the DCN fault into")
    args = parser.parse_args(argv)
    drill = dict(slow_device=args.slow_device, confirm_cycles=args.confirm_cycles, dcn_slices=args.dcn_slices,
                 dcn_slice=args.dcn_slice)

    if args.cpu_ranks:
        from k8s_watcher_tpu_torch.parallel.cpu_ranks import run_cpu_ranks

        world = args.cpu_ranks
        refused = _refused(args, world)
        if refused:
            print(refused, file=sys.stderr)
            return 2
        harness = _Harness()

        def run_stage(name, kwargs, nodes):
            kwargs = dict(kwargs, api_url=harness.api.url, sink_url=harness.sink_url, device="cpu")
            return run_cpu_ranks(f"{STAGE_MODULE}:{name}", world, kwargs, local_world_size=world // nodes)[0]

        try:
            result = run_drill(harness, run_stage, world=world, nodes=(1, args.dcn_slices),
                               slow_iters=args.slow_iters or SLOW_ITERS["cpu"], **drill)
        finally:
            harness.close()
        return _report(result)

    import torch.distributed as dist

    from k8s_watcher_tpu_torch.parallel.mesh import initialize_process_group
    from k8s_watcher_tpu_torch.probe.device import process_count, process_index, resolve_device

    dev = resolve_device(None)  # raises without CUDA: the drill never falls back to the CPU
    initialize_process_group(dev)
    world, rank = process_count(), process_index()
    refused = _refused(args, world)
    if refused:
        dist.destroy_process_group()
        print(refused, file=sys.stderr)
        return 2
    nodes = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    harness = _Harness() if rank == 0 else None
    urls: List[Any] = [harness.api.url, harness.sink_url] if harness else [None, None]
    dist.broadcast_object_list(urls, src=0)

    def run_stage(name, kwargs, _nodes):
        return globals()[name](rank, world, **dict(kwargs, api_url=urls[0], sink_url=urls[1], device="cuda"))

    try:
        result = run_drill(harness, run_stage, world=world, nodes=(nodes, nodes),
                           slow_iters=args.slow_iters or SLOW_ITERS["cuda"], **drill)
        dist.barrier()
    finally:
        if harness is not None:
            harness.close()
        dist.destroy_process_group()
    if rank == 0:
        return _report(result)
    return 1 if result["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
