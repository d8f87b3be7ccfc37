"""The port's node plane held against the JAX package's.

``tests/test_nodes.py`` is replayed through the port (node readiness and TPU
facts, the node tracker's payloads, slices degraded by a NotReady node and
restored, paged node LISTs with tombstones, the watch loop over HTTP, re-added
nodes, relist reconciliation, the down-node set's pruning). Side by side, one
seeded churn of pods and nodes (numpy RNG) goes through both packages'
``NodeWatcher`` + ``SliceTracker``: pod events folded into the slices, node
events through ``NodeWatcher._emit``, and relists against one mock apiserver
holding the same nodes. The node and slice payloads each produces (without
their ``event_timestamp`` wall stamp), the slice notifications of the pod
folds and the final slice snapshots must be identical.
"""

import numpy as np
import pytest

from k8s_watcher_tpu.k8s.client import K8sClient as RefClient
from k8s_watcher_tpu.k8s.kubeconfig import K8sConnection as RefConnection
from k8s_watcher_tpu.k8s.mock_server import MockApiServer, MockCluster
from k8s_watcher_tpu.nodes import NodeTracker as RefNodeTracker, NodeWatcher as RefNodeWatcher
from k8s_watcher_tpu.pipeline.phase import PhaseTracker as RefPhaseTracker
from k8s_watcher_tpu.slices.tracker import SliceTracker as RefSliceTracker
from k8s_watcher_tpu.watch.fake import build_node, build_pod
from k8s_watcher_tpu.watch.source import WatchEvent as RefWatchEvent
from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
from k8s_watcher_tpu_torch.nodes import NodeTracker, NodeWatcher
from k8s_watcher_tpu_torch.pipeline.phase import PhaseTracker
from k8s_watcher_tpu_torch.slices.tracker import SliceTracker
from k8s_watcher_tpu_torch.watch.source import WatchEvent
from test_torch_replay import replay, replayed_tests

_nodes = replay("test_nodes.py", keep=("k8s_watcher_tpu.k8s.mock_server",), rewrites=[
    ("from k8s_watcher_tpu.config.schema import RetryPolicy", "from k8s_watcher_tpu.config import RetryPolicy"),
])
mock_api = _nodes.mock_api  # the replayed tests' fixture
globals().update(replayed_tests(_nodes))

PACKAGES = {
    "ref": (RefClient, RefConnection, RefNodeTracker, RefNodeWatcher, RefPhaseTracker, RefSliceTracker, RefWatchEvent),
    "port": (K8sClient, K8sConnection, NodeTracker, NodeWatcher, PhaseTracker, SliceTracker, WatchEvent),
}
NODES = 12
JOBSETS = 4
WORKERS = 3


def churn(seed, steps=240):
    """Seeded steps: ``("pod", type, pod)``, ``("node", type, node)`` and
    ``("relist", nodes)`` (the cluster's node set at that point; a node
    deleted meanwhile is absent, one re-added is back)."""
    rng = np.random.default_rng(seed)
    ready = {f"node-{i}": True for i in range(NODES)}
    gone = set()
    pods = {}  # name -> [jobset, worker, node, phase, ready, restarts, rv]
    out = [("relist", {n: True for n in ready})]
    rv = 0
    for j in range(JOBSETS):
        for w in range(WORKERS):
            rv += 1
            pods[f"js{j}-{w}"] = [f"js{j}", w, f"node-{int(rng.integers(NODES))}", "Pending", False, 0, rv]
            out.append(("pod", "ADDED", _pod(f"js{j}-{w}", pods[f"js{j}-{w}"])))
    for _ in range(steps):
        roll = rng.random()
        rv += 1
        if roll < 0.45 and pods:
            name = sorted(pods)[int(rng.integers(len(pods)))]
            st = pods[name]
            st[3], st[4] = ("Running", True) if rng.random() < 0.7 else ("Running", False)
            if rng.random() < 0.05:
                st[3], st[4] = "Failed", False
            st[5] += int(rng.random() < 0.1)
            st[6] = rv
            out.append(("pod", "MODIFIED", _pod(name, st)))
        elif roll < 0.55 and pods:
            name = sorted(pods)[int(rng.integers(len(pods)))]
            st = pods.pop(name)
            st[6] = rv
            out.append(("pod", "DELETED", _pod(name, st)))
            # its replacement, perhaps on another node
            repl = f"{st[0]}-{st[1]}-r{rv}"
            pods[repl] = [st[0], st[1], f"node-{int(rng.integers(NODES))}", "Pending", False, 0, rv]
            out.append(("pod", "ADDED", _pod(repl, pods[repl])))
        elif roll < 0.85:
            node = f"node-{int(rng.integers(NODES))}"
            if node in gone:
                gone.discard(node)
                ready[node] = True
                out.append(("node", "ADDED", build_node(node, ready=True, resource_version=str(rv))))
            else:
                ready[node] = not ready[node]
                out.append(("node", "MODIFIED", build_node(node, ready=ready[node], resource_version=str(rv))))
        elif roll < 0.93:
            live = sorted(n for n in ready if n not in gone)
            node = live[int(rng.integers(len(live)))]
            gone.add(node)
            if rng.random() < 0.5:
                out.append(("node", "DELETED", build_node(node, resource_version=str(rv))))
            # else: deleted while the watch was down, seen only by a relist
        else:
            out.append(("relist", {n: r for n, r in ready.items() if n not in gone}))
    return out


def _pod(name, st):
    jobset, worker, node, phase, ready, restarts, rv = st
    return build_pod(
        name, "default", uid=f"uid-{name}", phase=phase, node_name=node, tpu_chips=4, tpu_topology="2x2x1",
        gke_slice_fields={"jobset.sigs.k8s.io/jobset-name": jobset, "batch.kubernetes.io/job-completion-index": worker},
        container_statuses=[{"name": "main", "ready": ready, "restart_count": restarts,
                             "state": {"running": {}} if phase == "Running" else {"waiting": {}}}],
        resource_version=str(rv),
    )


def run(pkg, steps, server):
    client_cls, conn_cls, tracker_cls, watcher_cls, phases_cls, slices_cls, event_cls = PACKAGES[pkg]
    out = []

    def sink(notification):
        payload = {k: v for k, v in notification.payload.items() if k != "event_timestamp"}
        out.append((notification.kind, payload))

    slices, phases = slices_cls("development"), phases_cls()
    watcher = watcher_cls(client_cls(conn_cls(server=server.url), request_timeout=5.0), tracker_cls("development"),
                          sink, slice_tracker=slices, list_page_size=5)
    slices.set_node_existence_provider(watcher.node_existence)
    for step in steps:
        if step[0] == "pod":
            ev = event_cls(type=step[1], pod=step[2])
            info, notes = slices.observe(ev, phases.observe(ev))
            notes = [{k: v for k, v in n.items() if k != "event_timestamp"} for n in notes]
            out.append(("pod-fold", (info, notes)))
        elif step[0] == "node":
            watcher._emit(step[1], step[2], 0.0)
        else:
            cluster = server.cluster
            for name in list(cluster._nodes):
                cluster.delete_node(name)
            for name, ready in sorted(step[1].items()):
                cluster.add_node(build_node(name, ready=ready))
            watcher._relist()
    return out, slices.snapshot(), slices.debug_snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_churn_same_node_and_slice_payloads(seed):
    steps = churn(seed)
    with MockApiServer(MockCluster()) as server:
        ref = run("ref", steps, server)
    with MockApiServer(MockCluster()) as server:
        port = run("port", steps, server)
    kinds = [kind for kind, _ in ref[0]]
    # the churn reached every path: node payloads, node-driven slice
    # payloads and slice payloads of the pod folds
    assert kinds.count("node") > 10 and kinds.count("slice") > 5
    assert sum(len(notes) for kind, (_, notes) in ((k, p) for k, p in ref[0] if k == "pod-fold")) > 5
    assert any(p["event_type"] == "NODE_DELETED" for kind, p in ref[0] if kind == "node")
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
