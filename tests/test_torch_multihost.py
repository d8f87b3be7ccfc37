"""The torchrun twin of ``tests/test_multihost.py``: the port's probe plane
across real processes and simulated nodes.

The reference runs one process per simulated host, each with 2 virtual
chips, joined through ``jax.distributed``. Here each simulated node is one
``torchrun`` agent (``--nnodes=H --node-rank=h --nproc-per-node=2``, its own
``NODE_NAME``), so a node's two chips are two ranks, and the agents meet in
the static rendezvous a deployment uses (``deploy/gpu-probe-statefulset.yaml``)
over gloo on 127.0.0.1. The worker body is ``_WORKER`` below.

The fault knobs are the reference worker's, with ranks for device ids: the
reference's device ``p * 2048`` (process p's chip 0) is rank ``2p``.
``MULTIHOST_CORRUPT_DEVICE`` corrupts a rank in a second link walk,
``MULTIHOST_PREP_FAIL=<rank>:<prefix>`` fails that rank's preparation of the
matching links in a third, ``MULTIHOST_MULTISLICE``/``MULTIHOST_SLICES``
add the multislice walk and ``MULTIHOST_DCN_FAULT_DEVICE`` a faulted one,
``MULTIHOST_REMEDIATE`` runs every rank's policy against a mock apiserver,
and ``MULTIHOST_LOCAL_REMEDIATE`` with ``MULTIHOST_LOCAL_FAULT_RANKS`` gives
those ranks a local HBM fault and runs the policies against a second one.
The reference starts one cluster per fault; to keep the torch imports few,
one launch per cluster shape runs every walk its tests need, each fault in
its own walk. Corruption classifies with no latency floor, so these twins
are deterministic; the walks use a 250 ms floor, far above gloo's jitter.

What differs by design (ROADMAP.md §C): every rank classifies the merged
walk, so every rank holds the verdict the reference's processes reach
together, and a link triangulation is slice scope, acted on by rank 0; one
rank's preparation failure skips the whole walk, intra-node links included.
Each node has one remediation actor, as the reference's one process per host
is: rank 0 for slice-scope findings, the node's lowest rank for its GPUs'
local findings, which every rank of the node gathers to it.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

import k8s_watcher_tpu.remediate.policy as ref_policy_mod
from k8s_watcher_tpu.k8s.client import K8sClient as RefClient
from k8s_watcher_tpu.k8s.kubeconfig import K8sConnection as RefConnection
from k8s_watcher_tpu.k8s.mock_server import MockApiServer, MockCluster
from k8s_watcher_tpu.probe.report import ProbeReport as RefReport
from k8s_watcher_tpu.remediate import NodeActuator as RefActuator
from k8s_watcher_tpu.remediate import ProbeRemediationPolicy as RefPolicy

REPO = Path(__file__).resolve().parent.parent
GPUS_PER_NODE = 2
TAINT_KEY = "k8s-watcher-tpu/ici-fault"
RANK_ENV = ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "NODE_NAME")
# the clusters' 2-3 CPU-minutes of torch imports yield to the suite's other
# workers, whose tests time threads and spawned processes
NICE = ("nice", "-n", "10")

_WORKER = r'''
import json, os, sys
import torch
torch.set_num_threads(1)  # the ranks share the host's cores
import torch.distributed as dist
from k8s_watcher_tpu_torch.config import TpuConfig
from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
from k8s_watcher_tpu_torch.parallel.mesh import host_chip_mesh, hybrid_slice_mesh, initialize_process_group
from k8s_watcher_tpu_torch.probe import links as links_mod
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent, gather_node_findings
from k8s_watcher_tpu_torch.probe.multislice import run_multislice_probe
from k8s_watcher_tpu_torch.probe.report import ProbeReport
from k8s_watcher_tpu_torch.remediate import NodeActuator, ProbeRemediationPolicy

out_dir = sys.argv[1]
env = os.environ
cpu = torch.device("cpu")
initialize_process_group(cpu)  # env:// from torchrun
rank, world = dist.get_rank(), dist.get_world_size()
mesh = host_chip_mesh(cpu)
reported = []
# the latency warning far above gloo's jitter: these tests are about shape
agent = ProbeAgent(TpuConfig(probe_enabled=True, probe_payload_bytes=1 << 16, probe_matmul_size=128,
                             probe_hbm_bytes=0, probe_rtt_warn_ms=1000.0),
                   environment="multihost-test", sink=reported.append, mesh=mesh, expected_platform="cpu", device=cpu)
report = agent.run_once()
agent._report(report)  # rank 0 reports for the group


def walk(fault=None):
    r = links_mod.run_link_probe(mesh, iters=2, inner_iters=4, rtt_floor_ms=250.0, fault=fault)
    return r, {
        "ok": r.ok, "n_links": r.n_links, "n_observed": r.n_observed, "error": r.error,
        "recorded": [{"axis": l.axis, "name": l.name, "correct": l.correct, "device_ids": list(l.device_ids),
                      "rtt_ms": l.rtt_ms, "error": l.error} for l in r.links],
        "suspect_links": r.suspect_links, "suspect_devices": r.suspect_devices,
    }


def slice_walk(fault=None):
    ms = run_multislice_probe(hybrid_slice_mesh(cpu, n_slices), iters=2, inner_iters=4, pair_rtt_floor_ms=250.0,
                              fault=fault)
    return ms, {"ok": ms.ok, "error": ms.error, "n_slices": ms.n_slices, "per_slice_sums": ms.per_slice_sums,
                "pairs": ms.pair_rtts, "suspect_pair_records": ms.suspect_pairs,
                "dcn_suspect_slices": ms.dcn_suspect_slices, "slice_processes": ms.slice_processes}


def remediate(url, probe_report):
    probe_report.node_findings = gather_node_findings(probe_report, cpu)  # a collective: every rank
    sent = []
    actuator = NodeActuator(K8sClient(K8sConnection(server=url), request_timeout=5.0), dry_run=False,
                            cooldown_seconds=0.0)
    policy = ProbeRemediationPolicy(actuator, confirm_cycles=1, sink=sent.append)
    actions = policy.observe_report(probe_report)
    return {"actions": [a.to_dict() for a in actions], "quarantined": actuator.quarantined_nodes(),
            "payloads": sent, "node_findings": probe_report.node_findings}


result = {
    "rank": rank, "world": world, "initialized": dist.is_initialized(), "node_name": env["NODE_NAME"],
    "local_world_size": int(env["LOCAL_WORLD_SIZE"]), "mesh_shape": list(mesh.ranks.shape),
    "ici": report.ici.to_dict(), "mxu_ok": bool(report.mxu and report.mxu.get("ok")), "healthy": report.healthy,
    "host": report.host, "hosts": report.hosts, "payload_keys": sorted(report.to_payload()),
    "reported": len(reported), "payload_event_type": reported[0].payload["event_type"] if reported else None,
    "observed": [name for _, name, a, b in links_mod.enumerate_links(mesh) if rank in (a, b)],
}
link_report, result["links"] = walk()
if "MULTIHOST_CORRUPT_DEVICE" in env:
    link_report, result["faulted_links"] = walk(IciFaultSpec(corrupt_rank=int(env["MULTIHOST_CORRUPT_DEVICE"])))
if "MULTIHOST_PREP_FAIL" in env:
    fail_rank, _, prefix = env["MULTIHOST_PREP_FAIL"].partition(":")
    if rank == int(fail_rank):
        links_mod._PREP_FAILURE_HOOK = lambda name: name.startswith(prefix)
    _, result["prep_links"] = walk()
    links_mod._PREP_FAILURE_HOOK = None
ms_obj = None
if env.get("MULTIHOST_MULTISLICE") == "1":
    # one slice per node by default; MULTIHOST_SLICES groups the nodes
    n_slices = int(env.get("MULTIHOST_SLICES", world // int(env["LOCAL_WORLD_SIZE"])))
    _, result["multislice"] = slice_walk()
    if "MULTIHOST_DCN_FAULT_DEVICE" in env:
        ms_obj, result["faulted_multislice"] = slice_walk(
            IciFaultSpec(corrupt_rank=int(env["MULTIHOST_DCN_FAULT_DEVICE"])))
if "MULTIHOST_REMEDIATE" in env:
    result["remediation"] = remediate(env["MULTIHOST_REMEDIATE"], ProbeReport(
        environment="multihost-test", devices=report.devices, links=link_report, hosts=report.hosts,
        multislice=ms_obj))
if "MULTIHOST_LOCAL_REMEDIATE" in env:
    local = ProbeReport(environment="multihost-test", devices=report.devices, hosts=report.hosts)
    if rank in [int(r) for r in env["MULTIHOST_LOCAL_FAULT_RANKS"].split(",")]:
        local.hbm = {"ok": False, "integrity_ok": False, "error": None, "bad_blocks": [{"block": 3}]}
    result["local_remediation"] = remediate(env["MULTIHOST_LOCAL_REMEDIATE"], local)
with open(os.path.join(out_dir, f"result_{rank}.json"), "w") as fh:
    json.dump(result, fh, default=str)
dist.barrier()  # no rank tears the group down while a peer still talks to it
dist.destroy_process_group()
'''


class CountingCluster(MockCluster):
    """The mock apiserver's cluster, counting the PATCHes each node gets."""

    def __init__(self, nodes):
        super().__init__()
        self.patches = []
        for n in range(nodes):
            self.add_node({"metadata": {"name": f"test-node-{n}"}, "spec": {},
                           "status": {"conditions": [{"type": "Ready", "status": "True"}]}})

    def patch_node(self, name, patch):
        self.patches.append(name)
        return super().patch_node(name, patch)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cluster(out_dir, nodes, extra_env, timeout=240):
    """``nodes`` torchrun agents of 2 ranks each on 127.0.0.1; each rank's
    result, by rank."""
    worker = out_dir / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = []
    for node in range(nodes):
        env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
        env.update(extra_env, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", NODE_NAME=f"test-node-{node}")
        argv = [*NICE, sys.executable, "-m", "torch.distributed.run", f"--nnodes={nodes}", f"--node-rank={node}",
                f"--nproc-per-node={GPUS_PER_NODE}", "--master-addr=127.0.0.1", f"--master-port={port}",
                str(worker), str(out_dir)]
        procs.append(subprocess.Popen(argv, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, start_new_session=True))
    outputs = []
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{nodes} torchrun agents did not finish in {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for proc, out in zip(procs, outputs):
        assert proc.returncode == 0, f"agent failed:\n{out[-3000:]}"
    return {rank: json.loads((out_dir / f"result_{rank}.json").read_text())
            for rank in range(nodes * GPUS_PER_NODE)}


def _cluster(tmp_path_factory, name, nodes, env, servers=("MULTIHOST_REMEDIATE",)):
    clusters = {key: CountingCluster(nodes) for key in servers}
    apis = {key: MockApiServer(cluster).start() for key, cluster in clusters.items()}
    try:
        results = _run_cluster(tmp_path_factory.mktemp(name), nodes,
                               dict(env, **{key: api.url for key, api in apis.items()}))
    finally:
        for api in apis.values():
            api.stop()
    return results, clusters


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    """2 nodes x 2 ranks: the reference's worker_results, faulted_results,
    prep_fail_results and remediation cluster in one launch. The corrupt
    and prep-failing rank is 2 (the reference's process 1, chip 0); ranks
    2 and 3 (node 1) each get a local HBM fault for the one-actor check."""
    return _cluster(tmp_path_factory, "two_nodes", 2, {
        "MULTIHOST_CORRUPT_DEVICE": "2", "MULTIHOST_PREP_FAIL": "2:chip0/", "MULTIHOST_LOCAL_FAULT_RANKS": "2,3",
    }, servers=("MULTIHOST_REMEDIATE", "MULTIHOST_LOCAL_REMEDIATE"))


@pytest.fixture(scope="module")
def three_nodes(tmp_path_factory):
    """3 nodes = 3 one-node slices: ring_results, multislice_results and the
    DCN fault in slice 1 (rank 2)."""
    return _cluster(tmp_path_factory, "three_nodes", 3,
                    {"MULTIHOST_MULTISLICE": "1", "MULTIHOST_DCN_FAULT_DEVICE": "2"})


@pytest.fixture(scope="module")
def four_nodes(tmp_path_factory):
    """The acceptance-4 shape, (2 slices, 2 nodes, 2 GPUs): healthy walks,
    and rank 4 (node 2's first GPU, the reference's 4096) corrupt."""
    return _cluster(tmp_path_factory, "four_nodes", 4, {
        "MULTIHOST_MULTISLICE": "1", "MULTIHOST_SLICES": "2", "MULTIHOST_CORRUPT_DEVICE": "4",
        "MULTIHOST_DCN_FAULT_DEVICE": "4",
    })


def _names(records):
    return sorted(r["name"] for r in records)


def _untouched(cluster, node):
    spec = cluster.get_node(node)["spec"]
    return "unschedulable" not in spec and not spec.get("taints")


def _quarantined(cluster, node):
    spec = cluster.get_node(node)["spec"]
    return spec.get("unschedulable") is True and any(t["key"] == TAINT_KEY for t in spec["taints"])


def _actors(results, key="remediation"):
    return {rank: r[key]["actions"] for rank, r in results.items() if r[key]["actions"]}


def test_global_device_visibility(two_nodes):
    results, _ = two_nodes
    for rank, r in results.items():
        assert r["initialized"] and r["rank"] == rank and r["world"] == 4
        assert r["local_world_size"] == GPUS_PER_NODE and r["node_name"] == f"test-node-{rank // 2}"


def test_mesh_groups_hosts_by_process(two_nodes):
    results, _ = two_nodes
    assert all(r["mesh_shape"] == [2, GPUS_PER_NODE] for r in results.values())


def test_psum_crosses_process_boundary(two_nodes):
    results, _ = two_nodes
    for rank, r in results.items():
        ici = r["ici"]
        assert ici["n_devices"] == 4 and ici["n_hosts"] == 2, rank
        assert ici["psum_correct"] and ici["psum_rtt_ms"] > 0 and r["mxu_ok"] and r["healthy"], rank


def test_inter_host_links_localized_per_link(two_nodes):
    """Every link recorded once, by its lower rank: each rank walks its
    within-node link and its one cross-node link, and a node's ranks
    together walk the reference host's 3."""
    results, _ = two_nodes
    for rank, r in results.items():
        assert r["links"]["error"] is None and r["links"]["ok"], rank
        assert r["links"]["n_observed"] == 2 == len(r["observed"])
    for node in range(2):
        assert len({n for rank in (2 * node, 2 * node + 1) for n in results[rank]["observed"]}) == 3
    recorded = [l for r in results.values() for l in r["links"]["recorded"]]
    assert len(_names(recorded)) == len(set(_names(recorded))) == 4
    assert len([l for l in recorded if l["axis"] == "hosts"]) == GPUS_PER_NODE
    assert len([l for l in recorded if l["axis"] == "chips"]) == 2
    assert all(l["correct"] and l["rtt_ms"] > 0 for l in recorded)
    # cross-node records live on the lower node's ranks
    assert all(l["axis"] == "chips" for rank in (2, 3) for l in results[rank]["links"]["recorded"])


def test_corrupt_chip_triangulated_across_process_ownership(two_nodes):
    results, _ = two_nodes
    for rank, r in results.items():
        assert not r["faulted_links"]["ok"] and r["faulted_links"]["suspect_devices"] == [2], rank
    reasons = {s["reason"] for r in results.values() for s in r["faulted_links"]["suspect_links"]
               if 2 in s["device_ids"]}
    assert reasons == {"corrupt"}


def test_three_host_ring_links_localized(three_nodes):
    results, _ = three_nodes
    recorded = [l for r in results.values() for l in r["links"]["recorded"]]
    names = _names(recorded)
    assert len(names) == len(set(names))
    assert [n for n in names if n.startswith("host")] == ["host0/chip0-chip1", "host1/chip0-chip1", "host2/chip0-chip1"]
    assert [n for n in names if n.startswith("chip")] == [
        "chip0/host0-host1", "chip0/host1-host2", "chip0/host2-host0",
        "chip1/host0-host1", "chip1/host1-host2", "chip1/host2-host0"]
    assert all(l["correct"] and l["rtt_ms"] > 0 for l in recorded)
    assert all(r["links"]["error"] is None and r["links"]["ok"] for r in results.values())
    # wraparound edges: endpoints on nodes 2 and 0, recorded by node 0's ranks
    assert [l["name"] for l in results[0]["links"]["recorded"] if "host2-host0" in l["name"]] == ["chip0/host2-host0"]
    assert [l["name"] for l in results[1]["links"]["recorded"] if "host2-host0" in l["name"]] == ["chip1/host2-host0"]


def test_remediation_across_processes(two_nodes):
    """The corrupt GPU (rank 2, node 1) is triangulated by the merged walk
    and quarantined once: one action for node 1, from rank 0 (a
    triangulation is slice scope; the reference's actor is node 1's process),
    node 0 untouched. Then ranks 2 and 3 each find a local HBM fault: node 1's
    lowest rank, 2, is its only actor, on both GPUs' findings: one record,
    one PATCH, one remediation payload, as the reference's one process per
    host gives on the same fault."""
    results, clusters = two_nodes
    acted = _actors(results)
    assert list(acted) == [0]
    (action,) = acted[0]
    assert action["node"] == "test-node-1" and action["ok"] and action["applied"]
    assert "device 2 is the common endpoint" in action["reason"]
    assert [len(r["remediation"]["payloads"]) for r in results.values()] == [1, 0, 0, 0]
    cluster = clusters["MULTIHOST_REMEDIATE"]
    assert _quarantined(cluster, "test-node-1") and _untouched(cluster, "test-node-0")
    assert cluster.patches == ["test-node-1"]

    local = _actors(results, "local_remediation")
    assert list(local) == [2]
    (record,) = local[2]
    assert record["node"] == "test-node-1" and record["ok"] and record["applied"]
    evidence = "hbm read probe: 1 HBM block(s) failed pattern readback"
    assert f"rank 2: {evidence}; rank 3: {evidence}" in record["reason"]
    for rank in (2, 3):
        assert results[rank]["local_remediation"]["node_findings"] == {"2": [evidence], "3": [evidence]}
    assert [len(r["local_remediation"]["payloads"]) for r in results.values()] == [0, 0, 1, 0]
    (payload,) = results[2]["local_remediation"]["payloads"]
    assert list(payload["implicated"]) == ["test-node-1"] and len(payload["actions"]) == 1
    cluster = clusters["MULTIHOST_LOCAL_REMEDIATE"]
    assert cluster.patches == ["test-node-1"] and _untouched(cluster, "test-node-0")

    # the reference, one process per host, on the same fault (its process 1)
    ref_cluster = CountingCluster(2)
    with MockApiServer(ref_cluster) as api, pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_policy_mod.jax, "process_count", lambda: 2)
        mp.setattr(ref_policy_mod.jax, "process_index", lambda: 1)
        hosts = {str(p): {"process_index": p, "node_name": f"test-node-{p}"} for p in range(2)}
        ref_report = RefReport(environment="multihost-test", hosts=hosts, devices={
            "process_index": 1, "devices": [{"id": d, "process_index": d // 2, "alive": True} for d in range(4)]})
        ref_report.hbm = {"ok": False, "integrity_ok": False, "error": None, "bad_blocks": [{"block": 3}]}
        sent = []
        ref_actions = RefPolicy(RefActuator(RefClient(RefConnection(server=api.url), request_timeout=5.0),
                                            dry_run=False, cooldown_seconds=0.0),
                                confirm_cycles=1, sink=sent.append).observe_report(ref_report)
    assert [(a.node, a.applied) for a in ref_actions] == [(record["node"], record["applied"])]
    assert ref_cluster.patches == cluster.patches and len(sent) == 1
    assert ref_cluster.get_node("test-node-1")["spec"] == cluster.get_node("test-node-1")["spec"]
    # the gathered findings ride the report unsent: its keys are the reference's
    keys = sorted(RefReport(environment="x", devices={}).to_payload())
    assert all(r["payload_keys"] == keys for r in results.values())


def test_multislice_pair_walk_across_processes(three_nodes):
    results, _ = three_nodes
    for rank, r in results.items():
        ms = r["multislice"]
        assert ms["error"] is None and ms["ok"] and ms["n_slices"] == 3, rank
        assert ms["per_slice_sums"] == [2.0, 2.0, 2.0]
        own = rank // 2
        assert _names(ms["pairs"]) == sorted(
            f"slice{min(own, o)}-slice{max(own, o)}" for o in range(3) if o != own)
        for p in ms["pairs"]:
            i, j = p["device_ids"]
            assert p["error"] is None and p["correct"] and p["rtt_ms"] > 0
            # the lowest rank of the pair's two slices owns the record
            assert p["owner"] == (rank == 2 * min(i, j)), (rank, p)
    owned = sorted(p["name"] for r in results.values() for p in r["multislice"]["pairs"] if p["owner"])
    assert owned == ["slice0-slice1", "slice0-slice2", "slice1-slice2"]


def test_dcn_fault_localized_and_remediated_across_processes(three_nodes):
    results, clusters = three_nodes
    for rank, r in results.items():
        ms = r["faulted_multislice"]
        assert ms["error"] is None and ms["dcn_suspect_slices"] == [1], rank
        assert ms["slice_processes"] == [[0, 1], [2, 3], [4, 5]]
        assert _names(ms["suspect_pair_records"]) == ["slice0-slice1", "slice1-slice2"]
        assert all(s["reason"] == "corrupt" for s in ms["suspect_pair_records"])
    acted = _actors(results)
    assert list(acted) == [0]
    (action,) = acted[0]
    assert action["node"] == "test-node-1" and action["ok"] and action["applied"]
    assert "dcn probe" in action["reason"] and "slice 1" in action["reason"]
    cluster = clusters["MULTIHOST_REMEDIATE"]
    assert _quarantined(cluster, "test-node-1") and cluster.patches == ["test-node-1"]
    assert _untouched(cluster, "test-node-0") and _untouched(cluster, "test-node-2")


def test_prep_failure_skips_all_cross_process_links(two_nodes):
    """Rank 2 fails preparing its cross-node link: the agreement round makes
    every rank skip the walk (no rank hangs in an exchange its peer never
    joins). The reference's host still measures its within-host links; a
    rank here has no other process's links to keep (ROADMAP.md §C)."""
    results, _ = two_nodes
    for rank, r in results.items():
        walk = r["prep_links"]
        assert walk["error"] is None and not walk["ok"], rank
        for l in walk["recorded"]:
            assert l["rtt_ms"] < 0 and ("skipped" in l["error"] or "preparation" in l["error"]), l
    inter0 = [l for l in results[0]["prep_links"]["recorded"] if l["axis"] == "hosts"]
    assert len(inter0) == 1 and "skipped" in inter0[0]["error"]
    assert any(s["name"].startswith("chip0/") and s["reason"] == "error"
               for s in results[2]["prep_links"]["suspect_links"])


N_ACCEPT = 4


def test_acceptance4_psum_crosses_all_four_hosts(four_nodes):
    results, _ = four_nodes
    assert len(results) == N_ACCEPT * GPUS_PER_NODE
    for rank, r in results.items():
        assert r["initialized"] and r["world"] == N_ACCEPT * GPUS_PER_NODE
        assert r["mesh_shape"] == [N_ACCEPT, GPUS_PER_NODE]
        ici = r["ici"]
        assert ici["n_devices"] == N_ACCEPT * GPUS_PER_NODE and ici["n_hosts"] == N_ACCEPT, rank
        assert ici["psum_correct"] and ici["psum_rtt_ms"] > 0 and r["mxu_ok"] and r["healthy"]


def test_acceptance4_link_walk_covers_the_four_host_ring(four_nodes):
    results, _ = four_nodes
    for rank, r in results.items():
        assert r["links"]["error"] is None and r["links"]["ok"], rank
        # its within-node link and its two ring neighbours across nodes
        assert r["links"]["n_observed"] == 3
    for node in range(N_ACCEPT):
        assert len({n for rank in (2 * node, 2 * node + 1) for n in results[rank]["observed"]}) == 5
    recorded = [l for r in results.values() for l in r["links"]["recorded"]]
    names = _names(recorded)
    assert len(names) == len(set(names))
    assert [n for n in names if n.startswith("host")] == [f"host{h}/chip0-chip1" for h in range(N_ACCEPT)]
    assert [n for n in names if n.startswith("chip")] == sorted(
        f"chip{c}/host{h}-host{(h + 1) % N_ACCEPT}" for c in range(GPUS_PER_NODE) for h in range(N_ACCEPT))
    assert all(l["correct"] and l["rtt_ms"] > 0 for l in recorded)
    wrap = sorted(l["name"] for rank in (0, 1) for l in results[rank]["links"]["recorded"]
                  if "host3-host0" in l["name"])
    assert wrap == ["chip0/host3-host0", "chip1/host3-host0"]


def test_acceptance4_dcn_pair_walk_with_multihost_slices(four_nodes):
    results, _ = four_nodes
    for rank, r in results.items():
        ms = r["multislice"]
        assert ms["error"] is None and ms["ok"], rank
        assert ms["n_slices"] == 2 and ms["per_slice_sums"] == [4.0, 4.0]
        assert ms["slice_processes"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        (pair,) = ms["pairs"]
        assert pair["name"] == "slice0-slice1" and pair["error"] is None and pair["correct"] and pair["rtt_ms"] > 0
        assert pair["owner"] == (rank == 0)


def test_acceptance4_process_zero_reports(four_nodes):
    results, _ = four_nodes
    assert results[0]["reported"] == 1 and results[0]["payload_event_type"] == "TPU_PROBE"
    assert all(results[rank]["reported"] == 0 for rank in range(1, N_ACCEPT * GPUS_PER_NODE))
    for r in results.values():
        assert {int(k): v["node_name"] for k, v in r["hosts"].items()} == {
            rank: f"test-node-{rank // 2}" for rank in range(N_ACCEPT * GPUS_PER_NODE)}


def test_acceptance4_corrupt_chip_localized_and_remediated(four_nodes):
    """Rank 4 (node 2's first GPU) corrupt: the merged walk names it on every
    rank, the lone DCN pair fails its checksum without implicating an
    endpoint slice, and node 2 is quarantined once, by one actor."""
    results, clusters = four_nodes
    for rank, r in results.items():
        assert not r["faulted_links"]["ok"] and r["faulted_links"]["suspect_devices"] == [4], rank
        ms = r["faulted_multislice"]
        assert ms["per_slice_sums"][0] == 4.0 and ms["per_slice_sums"][1] != 4.0
        assert _names(ms["suspect_pair_records"]) == ["slice0-slice1"] and ms["dcn_suspect_slices"] == []
    acted = _actors(results)
    assert list(acted) == [0]
    (action,) = acted[0]
    assert action["node"] == "test-node-2" and action["ok"] and action["applied"]
    assert "device 4 is the common endpoint" in action["reason"]
    cluster = clusters["MULTIHOST_REMEDIATE"]
    assert _quarantined(cluster, "test-node-2") and cluster.patches == ["test-node-2"]
    assert all(_untouched(cluster, f"test-node-{n}") for n in (0, 1, 3))


def test_dcn_fault_in_multinode_slice_quarantines_all_member_nodes(tmp_path_factory):
    """(3 slices x 2 nodes x 2 GPUs): rank 4 corrupt, in slice 1 (nodes 2
    and 3), fails both of its pairs; the merged verdict names slice 1 on
    every rank, and rank 0 alone quarantines both member nodes, one action
    each, filling the default 2-node budget."""
    results, clusters = _cluster(tmp_path_factory, "six_nodes", 6, {
        "MULTIHOST_MULTISLICE": "1", "MULTIHOST_SLICES": "3", "MULTIHOST_DCN_FAULT_DEVICE": "4"})
    for rank, r in results.items():
        ms = r["faulted_multislice"]
        assert ms["error"] is None and ms["slice_processes"] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
        assert ms["dcn_suspect_slices"] == [1], rank
        assert _names(ms["suspect_pair_records"]) == ["slice0-slice1", "slice1-slice2"]
    acted = _actors(results)
    assert list(acted) == [0]
    assert sorted(a["node"] for a in acted[0]) == ["test-node-2", "test-node-3"]
    assert all(a["ok"] and a["applied"] for a in acted[0])
    cluster = clusters["MULTIHOST_REMEDIATE"]
    assert sorted(cluster.patches) == ["test-node-2", "test-node-3"]
    assert _quarantined(cluster, "test-node-2") and _quarantined(cluster, "test-node-3")
    assert all(_untouched(cluster, f"test-node-{n}") for n in (0, 1, 4, 5))


def test_host_identity_map_covers_every_process(two_nodes):
    results, _ = two_nodes
    for rank, r in results.items():
        assert r["host"]["node_name"] == f"test-node-{rank // 2}" and r["host"]["process_index"] == rank
        assert set(r["hosts"]) == {"0", "1", "2", "3"}
        for idx in range(4):
            assert r["hosts"][str(idx)]["node_name"] == f"test-node-{idx // 2}"
            assert r["hosts"][str(idx)]["process_index"] == idx


def test_only_process_zero_reports(two_nodes):
    results, _ = two_nodes
    assert results[0]["reported"] == 1 and results[0]["payload_event_type"] == "TPU_PROBE"
    assert all(results[rank]["reported"] == 0 for rank in range(1, 4))
