"""The port's mock apiserver and fault injectors held against the JAX
package's.

Each package's ``MockApiServer`` is built from one seeded cluster (300 pods
over 120 nodes, the same ``add_node``/``add_pod`` calls with each package's
own ``build_node``/``build_pod``), then both answer the same requests:
paged LISTs with ``limit``/``continue``, label and shard selectors, watch
frames from a resource version, the 410 after ``compact()``, node PATCHes,
Lease create/replace conflicts, ``fail_next`` and the notify surface. Parsed
JSON bodies and status codes must be equal, request for request.

``ChurnGenerator`` and ``FaultyNotifier`` must give the same events and the
same failures for the same seed, and the standalone server
(``python -m k8s_watcher_tpu_torch.mock_apiserver``) must seed what the JAX
package's ``scripts/run_mock_server.py`` seeds and churn on its cadence.
"""

import dataclasses
import http.client
import importlib.util
import itertools
import json
import random
from pathlib import Path
from urllib.parse import urlsplit

import pytest

from k8s_watcher_tpu.faults import injection as ref_injection
from k8s_watcher_tpu.k8s import mock_server as ref_mock
from k8s_watcher_tpu.watch import fake as ref_fake
from k8s_watcher_tpu_torch import mock_apiserver
from k8s_watcher_tpu_torch.faults import injection
from k8s_watcher_tpu_torch.k8s import mock_server
from k8s_watcher_tpu_torch.watch import fake

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"ref": (ref_mock, ref_fake, ref_injection), "port": (mock_server, fake, injection)}
SEED = 20261017
N_NODES, N_PODS = 120, 300
NAMESPACES = ("default", "team-a", "team-b")


def seeded_cluster(pkg):
    """The same seeded calls on ``pkg``'s own ``MockCluster``."""
    mock, fake_mod, _ = PACKAGES[pkg]
    rng = random.Random(SEED)
    cluster = mock.MockCluster()
    for i in range(N_NODES):
        cluster.add_node(fake_mod.build_node(
            f"node-{i:03d}", ready=rng.random() > 0.1, tpu_chips=rng.choice((0, 4, 8)),
            labels={"pool": rng.choice(("a", "b", "c"))},
        ))
    for i in range(N_PODS):
        chips = rng.choice((0, 4))
        cluster.add_pod(fake_mod.build_pod(
            f"pod-{i:03d}", rng.choice(NAMESPACES), uid=f"uid-{i:03d}",
            node_name=f"node-{rng.randrange(N_NODES):03d}", phase=rng.choice(("Pending", "Running", "Failed")),
            tpu_chips=chips, tpu_topology="2x2x4" if chips else None,
            gke_slice_fields={"jobset.sigs.k8s.io/jobset-name": f"js-{rng.randrange(10)}"} if chips else None,
        ))
    return cluster


def request(server, method, path, body=None, raw=None):
    """``(status, parsed body)``; a watch's body is its list of frames."""
    parts = urlsplit(server.url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=30)
    try:
        data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
        headers = {"Content-Type": "application/json"} if data is not None else {}
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        text = resp.read().decode()
    finally:
        conn.close()
    if "watch=true" in path and resp.status == 200:
        return resp.status, [json.loads(line) for line in text.splitlines() if line]
    return resp.status, json.loads(text) if text else None


def paged(server, path, limit):
    """Every page of a paged LIST, following ``continue`` tokens."""
    pages, token = [], None
    while True:
        sep = "&" if "?" in path else "?"
        query = f"{path}{sep}limit={limit}" + (f"&continue={token}" if token else "")
        status, body = request(server, "GET", query)
        pages.append((status, body))
        token = (body or {}).get("metadata", {}).get("continue") if status == 200 else None
        if not token:
            return pages


def lists_and_selectors(server):
    out = {
        "version": request(server, "GET", "/version"),
        "namespaces": request(server, "GET", "/api/v1/namespaces"),
        "pods": paged(server, "/api/v1/pods", 37),
        "team_a": paged(server, "/api/v1/namespaces/team-a/pods", 20),
        "label": paged(server, "/api/v1/pods?labelSelector=jobset.sigs.k8s.io/jobset-name%3Djs-3", 4),
        "shard": paged(server, "/api/v1/pods?shard=1/4", 25),
        "nodes": paged(server, "/api/v1/nodes", 50),
        "node_label": request(server, "GET", "/api/v1/nodes?labelSelector=pool%3Db"),
        "node": request(server, "GET", "/api/v1/nodes/node-007"),
        "missing_node": request(server, "GET", "/api/v1/nodes/node-999"),
        "bad_limit": request(server, "GET", "/api/v1/pods?limit=-1"),
        "bad_token": request(server, "GET", "/api/v1/pods?limit=5&continue=garbage"),
        "no_route": request(server, "GET", "/api/v1/secrets"),
    }
    assert len(out["pods"]) == 9 and out["pods"][0][0] == 200
    return out


def watches_and_compaction(server):
    cluster = server.cluster
    _, first = request(server, "GET", "/api/v1/pods?limit=10")
    rv = first["metadata"]["resourceVersion"]
    token = first["metadata"]["continue"]
    (ns0, name0), (ns1, name1) = [(p["metadata"]["namespace"], p["metadata"]["name"]) for p in first["items"][:2]]
    cluster.set_phase(ns0, name0, "Succeeded")
    cluster.delete_pod(ns1, name1)
    cluster.set_node_ready("node-003", False, reason="KubeletDead")
    out = {
        "pods": request(server, "GET", f"/api/v1/pods?watch=true&resourceVersion={rv}&timeoutSeconds=1"),
        "team_b": request(server, "GET",
                          f"/api/v1/namespaces/team-b/pods?watch=true&resourceVersion={rv}&timeoutSeconds=1"),
        "nodes": request(server, "GET", f"/api/v1/nodes?watch=true&resourceVersion={rv}&timeoutSeconds=1"),
        "continued": request(server, "GET", f"/api/v1/pods?limit=10&continue={token}"),
    }
    cluster.compact()
    out["gone_watch"] = request(server, "GET", f"/api/v1/pods?watch=true&resourceVersion={rv}&timeoutSeconds=1")
    out["gone_token"] = request(server, "GET", f"/api/v1/pods?limit=10&continue={token}")
    return out


def writes(server):
    cluster = server.cluster
    node_rv = cluster.get_node("node-010")["metadata"]["resourceVersion"]
    lease = {"metadata": {"name": "leader"}, "spec": {"holderIdentity": "a", "leaseDurationSeconds": 15}}
    leases = "/apis/coordination.k8s.io/v1/namespaces/default/leases"
    out = {
        "cordon": request(server, "PATCH", "/api/v1/nodes/node-010", {
            "spec": {"unschedulable": True,
                     "taints": [{"key": "k8s-watcher-tpu/ici-fault", "value": "suspect", "effect": "NoSchedule"}]},
        }),
        "stale_patch": request(server, "PATCH", "/api/v1/nodes/node-010",
                               {"metadata": {"resourceVersion": node_rv}, "spec": {}}),
        "uncordon": request(server, "PATCH", "/api/v1/nodes/node-010",
                            {"spec": {"unschedulable": None, "taints": None}}),
        "patch_missing": request(server, "PATCH", "/api/v1/nodes/node-999", {"spec": {}}),
        "patch_malformed": request(server, "PATCH", "/api/v1/nodes/node-010", raw=b"{not json"),
        "lease_get_missing": request(server, "GET", f"{leases}/leader"),
        "lease_create": request(server, "POST", leases, lease),
        "lease_create_again": request(server, "POST", leases, lease),
    }
    created_rv = out["lease_create"][1]["metadata"]["resourceVersion"]
    stale = dict(lease, metadata={"name": "leader", "resourceVersion": "1"})
    fresh = dict(lease, metadata={"name": "leader", "resourceVersion": created_rv},
                 spec={"holderIdentity": "b", "leaseDurationSeconds": 15})
    out.update(
        lease_replace_stale=request(server, "PUT", f"{leases}/leader", stale),
        lease_replace=request(server, "PUT", f"{leases}/leader", fresh),
        lease_get=request(server, "GET", f"{leases}/leader"),
        namespace_create=request(server, "POST", "/api/v1/namespaces", {"metadata": {"name": "it-ns"}}),
        pod_create=request(server, "POST", "/api/v1/namespaces/it-ns/pods",
                           {"metadata": {"name": "p"}, "spec": {}, "status": {"phase": "Pending"}}),
        pod_create_again=request(server, "POST", "/api/v1/namespaces/it-ns/pods",
                                 {"metadata": {"name": "p"}, "spec": {}}),
        pod_delete=request(server, "DELETE", "/api/v1/namespaces/it-ns/pods/p"),
        pod_delete_missing=request(server, "DELETE", "/api/v1/namespaces/it-ns/pods/p"),
        namespace_delete=request(server, "DELETE", "/api/v1/namespaces/it-ns"),
        notify=request(server, "POST", "/api/pods/update", {"name": "pod-001", "event_type": "MODIFIED"}),
        notify_batch=request(server, "POST", "/api/pods/update_batch", {"updates": [{"name": "a"}, 3]}),
        notify_bad_batch=request(server, "POST", "/api/pods/update_batch", {"updates": "x"}),
        health=request(server, "GET", "/health"),
    )
    cluster.fail_next(2, status=503)
    out["failures"] = [request(server, "GET", "/api/v1/nodes/node-010") for _ in range(3)]
    out["status_updates"] = cluster.status_updates
    out["node_after"] = cluster.get_node("node-010")
    return out


SCENARIOS = {"lists_and_selectors": lists_and_selectors, "watches_and_compaction": watches_and_compaction,
             "writes": writes}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_same_requests_same_answers(scenario):
    answers = {}
    for pkg in ("ref", "port"):
        with PACKAGES[pkg][0].MockApiServer(seeded_cluster(pkg)) as server:
            answers[pkg] = SCENARIOS[scenario](server)
    assert list(answers["port"]) == list(answers["ref"])
    for key in answers["ref"]:
        assert answers["port"][key] == answers["ref"][key], key


def test_the_scenarios_reach_what_they_claim():
    with mock_server.MockApiServer(seeded_cluster("port")) as server:
        watched = watches_and_compaction(server)
    types = [frame["type"] for frame in watched["pods"][1]]
    assert types == ["MODIFIED", "DELETED"]
    assert [f["type"] for f in watched["nodes"][1]] == ["MODIFIED"]
    assert watched["team_b"][1] == [] or all(f["object"]["metadata"]["namespace"] == "team-b"
                                             for f in watched["team_b"][1])
    assert watched["gone_watch"][0] == 410 and watched["gone_token"][0] == 410
    with mock_server.MockApiServer(seeded_cluster("port")) as server:
        wrote = writes(server)
    assert [wrote[k][0] for k in ("cordon", "stale_patch", "uncordon", "patch_missing", "patch_malformed")] == [
        200, 409, 200, 404, 400]
    assert [wrote[k][0] for k in ("lease_create", "lease_create_again", "lease_replace_stale", "lease_replace")] == [
        201, 409, 409, 200]
    assert [status for status, _ in wrote["failures"]] == [503, 503, 200]
    assert "unschedulable" not in wrote["node_after"]["spec"] and "taints" not in wrote["node_after"]["spec"]


def test_same_shard_partition_as_the_port_watch_source():
    """The server-side shard push-down partitions by the port's own
    ``watch.sharded.shard_of`` (the reference's crc32 rule)."""
    from k8s_watcher_tpu.watch.sharded import shard_of as ref_shard_of
    from k8s_watcher_tpu_torch.watch.sharded import shard_of

    with mock_server.MockApiServer(seeded_cluster("port")) as server:
        uids = {s: {p["metadata"]["uid"] for _, body in paged(server, f"/api/v1/pods?shard={s}/4", 40)
                    for p in body["items"]} for s in range(4)}
    assert sum(len(u) for u in uids.values()) == N_PODS
    for s, members in uids.items():
        assert all(shard_of(uid, 4) == ref_shard_of(uid, 4) == s for uid in members)


def _events(pkg, seed, n, **kwargs):
    gen = PACKAGES[pkg][2].ChurnGenerator(seed=seed, **kwargs)
    return [(e.type, e.resource_version, e.pod) for e in gen.events(n)]


@pytest.mark.parametrize("seed", [0, 3, 11, 2026])
def test_churn_same_events_for_the_same_seed(seed):
    kwargs = dict(n_slices=5, workers_per_slice=3, chips_per_worker=4, preempt_prob=0.2, fail_prob=0.1,
                  namespace="train")
    want = _events("ref", seed, 600, **kwargs)
    got = _events("port", seed, 600, **kwargs)
    assert got == want
    assert {t for t, _, _ in got} == {"ADDED", "MODIFIED", "DELETED"}
    assert any(p["status"].get("reason") == "Preempted" for _, _, p in got)


def test_churn_with_a_node_namer():
    namer = lambda s, w: f"host-{s}-{w % 2}"  # noqa: E731
    want = _events("ref", 5, 300, node_namer=namer)
    assert _events("port", 5, 300, node_namer=namer) == want
    assert {p["spec"]["nodeName"] for _, _, p in want} <= {f"host-{s}-{w}" for s in range(4) for w in range(2)}


@pytest.mark.parametrize("fail_prob", [0.0, 0.25, 0.9])
def test_faulty_notifier_same_failures_for_the_same_seed(fail_prob):
    out = {}
    for pkg in ("ref", "port"):
        delivered = []
        notifier = PACKAGES[pkg][2].FaultyNotifier(lambda p: (delivered.append(p["i"]), p["i"] % 7 != 0)[1],
                                                   fail_prob=fail_prob, seed=42)
        results = [notifier({"i": i}) for i in range(400)]
        out[pkg] = (results, delivered, notifier.calls, notifier.injected_failures)
    assert out["port"] == out["ref"]
    assert out["port"][2] == 400 and (out["port"][3] > 0) == (fail_prob > 0)


def test_faults_package_exports_the_injectors():
    import k8s_watcher_tpu.faults as ref_faults
    import k8s_watcher_tpu_torch.faults as faults

    for name in ("ChurnGenerator", "FaultyNotifier"):
        assert getattr(faults, name) is getattr(injection, name)
        assert hasattr(ref_faults, name)


def test_k8s_package_exports_the_reference_names():
    import k8s_watcher_tpu.k8s as ref_k8s
    import k8s_watcher_tpu_torch.k8s as k8s

    exported = {n for n in dir(ref_k8s) if not n.startswith("_") and n[0].isupper() or n == "load_connection"}
    exported -= {n for n in dir(ref_k8s) if isinstance(getattr(ref_k8s, n), type(ref_k8s))}
    assert exported == {"K8sApiError", "K8sClient", "K8sConnection", "KubernetesWatchSource", "load_connection"}
    for name in exported:
        assert getattr(k8s, name).__name__ == getattr(ref_k8s, name).__name__


def _reference_runner():
    spec = importlib.util.spec_from_file_location("ref_run_mock_server", REPO / "scripts" / "run_mock_server.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_standalone_server_seeds_what_the_reference_runner_seeds(monkeypatch):
    # both runners let build_pod number the uids: each package's counter
    # starts afresh, as in a new process
    monkeypatch.setattr(ref_fake, "_UID_COUNTER", itertools.count())
    monkeypatch.setattr(fake, "_UID_COUNTER", itertools.count())
    runner = _reference_runner()
    clusters = {"ref": ref_mock.MockCluster(), "port": mock_server.MockCluster()}
    runner.seed_nodes(clusters["ref"])
    runner.seed_slice(clusters["ref"])
    mock_apiserver.seed_nodes(clusters["port"])
    mock_apiserver.seed_slice(clusters["port"])
    answers = {pkg: (c.list_pods(None, None)[1].encode(), c.list_nodes()[1].encode()) for pkg, c in clusters.items()}
    assert answers["port"] == answers["ref"]
    assert len(json.loads(answers["port"][0])["items"]) == 4 and len(json.loads(answers["port"][1])["items"]) == 2


def test_churn_cadence_matches_the_reference_runner():
    """The reference runner's loop body (``scripts/run_mock_server.py``:
    worker ``i % 4`` takes ``phase_cycle[(i // 4) % 4]``, and every sixth
    tick node ``(i // 6) % 2`` flips Ready to ``(i // 12) % 2 == 1``) against
    ``mock_apiserver.churn_step``, over 48 ticks."""
    cluster = mock_server.MockCluster()
    mock_apiserver.seed_nodes(cluster)
    mock_apiserver.seed_slice(cluster)
    phase_cycle = ["Running", "Failed", "Pending", "Running"]
    for i in range(48):
        want = [f"churn: train-{i % 4} -> {phase_cycle[(i // 4) % len(phase_cycle)]}"]
        if i % 6 == 5:
            want.append(f"churn: tpu-node-{(i // 6) % 2} Ready -> {(i // 12) % 2 == 1}")
        assert mock_apiserver.churn_step(cluster, i) == want
    assert tuple(phase_cycle) == mock_apiserver.PHASE_CYCLE and mock_apiserver.CHURN_PERIOD_S == 5.0
    pods = {p["metadata"]["name"]: p["status"]["phase"] for p in json.loads(cluster.list_pods(None, None)[1].encode())[
        "items"]}
    assert pods == {f"train-{w}": "Running" for w in range(4)}


def test_watch_event_fields_match():
    """``ChurnGenerator`` yields the port's own ``WatchEvent``s with the
    reference's fields."""
    from k8s_watcher_tpu.watch.source import WatchEvent as RefEvent
    from k8s_watcher_tpu_torch.watch.source import WatchEvent

    event = next(injection.ChurnGenerator(seed=1).events(1))
    assert isinstance(event, WatchEvent)
    assert [f.name for f in dataclasses.fields(WatchEvent)] == [f.name for f in dataclasses.fields(RefEvent)]
