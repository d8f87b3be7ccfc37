"""Acceptance tier #2 on the port: integration against a REAL cluster (kind
or full), through the port's ``K8sClient``, ``KubernetesWatchSource`` and
``EventPipeline`` (the twin of ``tests/test_integration_cluster.py``). The
file imports no JAX, so ``--noconftest`` runs it where JAX is not installed.

SURVEY.md §6 acceptance ladder: mock cycle (CPU) → kind 3-pod → GKE probe →
multi-host psum → churn. Tiers 1 and 3-5 run in-process/on-chip elsewhere;
this module is tier 2. It needs an actual apiserver, so it is SKIPPED
unless ``WATCHER_INTEGRATION_KUBECONFIG`` points at a kubeconfig (e.g. one
created by ``kind create cluster``; see deploy/kind-config.yaml).

Read-only by default (list, version, bounded watch). Set
``WATCHER_INTEGRATION_WRITE=1`` to also run the full watch→pipeline cycle
against real pod creates/deletes in an ephemeral namespace.

Run:
    kind create cluster --config deploy/kind-config.yaml
    WATCHER_INTEGRATION_KUBECONFIG=~/.kube/config python -m pytest --noconftest \
        tests/test_torch_integration_cluster.py -v
    python -m k8s_watcher_tpu_torch.integration_tier --backend auto   # provisions one
"""

import os
import threading
import time
import uuid

import pytest

from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import load_kubeconfig
from k8s_watcher_tpu_torch.k8s.watch import KubernetesWatchSource
from k8s_watcher_tpu_torch.pipeline.filters import NamespaceFilter, TpuResourceFilter
from k8s_watcher_tpu_torch.pipeline.pipeline import EventPipeline

KUBECONFIG = os.environ.get("WATCHER_INTEGRATION_KUBECONFIG")
WRITE = os.environ.get("WATCHER_INTEGRATION_WRITE") == "1"

pytestmark = pytest.mark.skipif(
    not KUBECONFIG,
    reason="integration tier: set WATCHER_INTEGRATION_KUBECONFIG to a kubeconfig (e.g. a kind cluster)",
)


@pytest.fixture(scope="module")
def client() -> K8sClient:
    return K8sClient(load_kubeconfig(KUBECONFIG), request_timeout=15.0)


class TestClusterConnectivity:
    """Parity with the reference's manual diagnostic (test_k8s_connection.py)."""

    def test_version(self, client):
        assert client.get_api_version().startswith("v")

    def test_list_namespaces(self, client):
        # no limit: on a busy shared cluster 'default' may not be in the
        # first page; the connectivity contract is "the call works"
        names = client.list_namespaces()
        assert names and all(isinstance(n, str) for n in names)

    def test_list_and_bounded_watch(self, client):
        body = client.list_pods(limit=5)
        rv = (body.get("metadata") or {}).get("resourceVersion")
        assert rv
        # bounded watch: the stream must open and close cleanly even if idle
        seen = 0
        for event in client.watch_pods(resource_version=rv, timeout_seconds=3):
            seen += 1
            if seen >= 5:
                break
        assert seen >= 0  # no exception = the watch contract holds


@pytest.mark.skipif(not WRITE, reason="set WATCHER_INTEGRATION_WRITE=1 to exercise pod create/delete")
class TestRealPodLifecycle:
    """Full watch→pipeline cycle against real pod churn, driven through the
    framework's own write surface (K8sClient.create_pod/delete_pod) — no
    kubectl dependency, so the same tier runs against kind, GKE, and the
    in-repo mock apiserver."""

    @pytest.fixture()
    def namespace(self, client):
        ns = f"watcher-it-{uuid.uuid4().hex[:8]}"
        client.create_namespace(ns)
        yield ns
        client.delete_namespace(ns)

    def test_pipeline_sees_real_pod_cycle(self, client, namespace):
        notifications = []
        lock = threading.Lock()

        def sink(n):
            with lock:
                notifications.append(n)

        pipeline = EventPipeline(
            environment="development",
            sink=sink,
            namespace_filter=NamespaceFilter((namespace,)),
            # kind nodes have no TPUs; filter on a resource every pod has
            resource_filter=TpuResourceFilter("cpu"),
        )
        source = KubernetesWatchSource(client, namespace=namespace, watch_timeout_seconds=30)

        def pump():
            for event in source.events():
                pipeline.process(event)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        time.sleep(1.0)

        client.create_pod(namespace, {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": "it-pod", "namespace": namespace},
            "spec": {
                "containers": [
                    {
                        "name": "main",
                        "image": "busybox:1.36",
                        "command": ["sleep", "30"],
                        "resources": {"requests": {"cpu": "10m"}, "limits": {"cpu": "100m"}},
                    }
                ],
                "restartPolicy": "Never",
            },
        })

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with lock:
                if any(n.payload.get("name") == "it-pod" for n in notifications):
                    break
            time.sleep(0.5)
        client.delete_pod(namespace, "it-pod")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with lock:
                if any(n.payload.get("event_type") == "DELETED" for n in notifications):
                    break
            time.sleep(0.5)
        source.stop()
        t.join(timeout=10)

        with lock:
            kinds = [n.payload.get("event_type") for n in notifications]
        assert "ADDED" in kinds, f"saw {kinds}"
        assert "DELETED" in kinds, f"saw {kinds}"
