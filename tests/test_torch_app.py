"""The port's ``WatcherApp`` held against the JAX package's.

Both apps run at once, each against its own ``MockApiServer`` seeded alike
with ``chip_smoke.GpuCluster``'s cluster at a small size (about 200 pods, 16
JobSets of 4 GPU workers), under the ``development`` and ``production``
rules with the planes the port does not carry switched off. The cluster's
churn is applied to both; then both must have sent the same payloads
(without the ``event_timestamp`` wall stamp), the same last state per pod,
the same slice notifications, and left checkpoint files of the same names
that read back the same state through either package.
Under the ``production`` rules the result must also equal
``chip_smoke.fold_production``, the plain reference the card run checks
against. The watcher's status routes answer alike with and without the
bearer; a restart from the checkpoint synthesizes the same DELETED for pods
deleted while down; the app with the probe on runs with ``device="cpu"``;
and only federation and relay are refused at construction. With the serving and
analytics planes on, both apps' ``/serve/fleet`` snapshots and
``/serve/analytics`` bodies agree, and the JAX package's ``ResumeLoop``
following the port's serve plane through the churn folds to the same state.
With the history, health and SLO planes on as well, both apps answer the same
``?at=`` reads, list the same objectives at ``/debug/slo``, fold both
verdicts into the ``/healthz`` body, and after a stop and a restart from
their WALs resume a token minted before the stop with deltas, not a
re-snapshot. ``development`` builds every plane it enables, as shipped.
``staging`` and ``production`` run as shipped with ``--cpu`` against the JAX
package's mock apiserver (Leases and nodes served): the slice forms and a
NotReady node degrades it; two ``production`` apps on one Lease leave the
standby silent, watch-free and alive until the leader stops, then it takes
over within ``retry_period`` plus a margin; ``ingest.processes: 2`` POSTs pod
by pod what the in-process streams POST; and the card run's node-churn rule
holds against both packages' pipelines.
"""

import copy
import dataclasses
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import Counter

import pytest

import chip_smoke
from conftest import CONFIG_DIR
from k8s_watcher_tpu.app import WatcherApp as RefApp
from k8s_watcher_tpu.config.loader import load_config as ref_load_config
from k8s_watcher_tpu.federate.client import FleetClient, ResumeLoop, model_from_objects
from k8s_watcher_tpu.k8s.mock_server import MockApiServer, MockCluster
from k8s_watcher_tpu.state.checkpoint import CheckpointStore as RefStore
from k8s_watcher_tpu_torch.app import WatcherApp
from k8s_watcher_tpu_torch.config import AppConfig, ConfigError, deep_merge, load_app_config, load_raw_config
from k8s_watcher_tpu_torch.federate import merged_equals_union
from k8s_watcher_tpu_torch.state.checkpoint import CheckpointStore
from k8s_watcher_tpu_torch.watch.fake import FakeWatchSource

TOKEN = "app-status-tökén"
WAIT_S = 20.0


class FastMockApiServer(MockApiServer):
    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self


class Recorder:
    """Stands in for the cluster API client: records every payload."""

    def __init__(self):
        self.lock = threading.Lock()
        self.payloads = []

    def update_pod_status(self, payload):
        with self.lock:
            self.payloads.append(json.loads(json.dumps(payload)))
        return True

    def update_pod_statuses(self, payloads):
        return [self.update_pod_status(p) for p in payloads]

    def health_check(self):
        return True

    def snapshot(self):
        with self.lock:
            return list(self.payloads)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def small_cluster(seed, namespace):
    return chip_smoke.GpuCluster(seed, nodes=16, pods=200, jobsets=16, workers=4, churn=600, failures=2,
                                 down_deletions=3, jobset_namespace=namespace, node_flips=4)


def make_config(pkg, environment, server_url, workdir, *, status_port=0, probe=False, coalesce=True, planes=()):
    """``planes``: of serve, history, analytics, health and SLO, the ones to
    leave as the environment sets them (serve on an ephemeral port, the WAL
    under ``workdir``); the rest are switched off."""
    workdir.mkdir(parents=True, exist_ok=True)
    kubeconfig = workdir / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "m",
        "clusters": [{"name": "m", "cluster": {"server": server_url}}],
        "contexts": [{"name": "m", "context": {"cluster": "m", "user": "m"}}],
        "users": [{"name": "m", "user": {"token": "t"}}],
    }))
    env = {"WATCHER_STATUS_TOKEN": TOKEN, "WATCHER_CHECKPOINT_PATH": str(workdir / "ck.json"),
           "WATCHER_HISTORY_DIR": str(workdir / "history")}
    config = (ref_load_config if pkg == "ref" else load_app_config)(environment, CONFIG_DIR, env=env)
    off = {name: dataclasses.replace(getattr(config, name), enabled=False)
           for name in ("serve", "history", "analytics", "health", "slo") if name not in planes}
    if "serve" in planes:
        off["serve"] = dataclasses.replace(config.serve, port=0)
    tpu = dataclasses.replace(config.tpu, backend="gpu", resource_key=chip_smoke.GPU_KEY, node_watch_enabled=False,
                              probe_enabled=probe, probe_interval_seconds=0.2, probe_hbm_bytes=2 << 20,
                              probe_matmul_size=64, probe_payload_bytes=4096, probe_links_enabled=False)
    return dataclasses.replace(
        config, **off, tpu=tpu,
        watcher=dataclasses.replace(
            config.watcher, status_port=status_port,
            leader_election=dataclasses.replace(config.watcher.leader_election, enabled=False)),
        kubernetes=dataclasses.replace(config.kubernetes, use_mock=False, use_incluster_config=False,
                                       config_file=str(kubeconfig), watch_timeout_seconds=10),
        state=dataclasses.replace(config.state, checkpoint_path=str(workdir / "ck.json"),
                                  checkpoint_interval_seconds=3600.0),
        clusterapi=dataclasses.replace(config.clusterapi, coalesce=coalesce),
    )


class Side:
    """One package's app, its mock apiserver and its recorder."""

    def __init__(self, pkg, cluster, environment, tmp_path, **config_kw):
        self.pkg = pkg
        self.mock = MockCluster()
        self.mock.namespaces = list(chip_smoke.WATCHED_NAMESPACES) + [chip_smoke.UNWATCHED_NAMESPACE]
        for _, pod in chip_smoke.GpuCluster.pods(cluster.initial):
            self.mock.add_pod(copy.deepcopy(pod))
        self.server = FastMockApiServer(self.mock).start()
        self.workdir = tmp_path / pkg
        self.config_kw = dict(config_kw, environment=environment)
        self.recorder = None
        self.app = None

    def config(self):
        kw = dict(self.config_kw)
        return make_config(self.pkg, kw.pop("environment"), self.server.url, self.workdir, **kw)

    def start(self, **app_kw):
        self.recorder = Recorder()
        cls = RefApp if self.pkg == "ref" else WatcherApp
        self.app = cls(self.config(), notifier=self.recorder, **app_kw)
        self.thread = threading.Thread(target=self.app.run, daemon=True)
        self.thread.start()
        return self

    def source(self):
        return self.app.ingest.sources[0]

    def wait_synced(self):
        """Until the app has handled everything up to the mock's latest rv
        and the dispatcher is drained."""
        rv = str(self.mock.latest_rv())
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            if self.source().resource_version == rv and self.app.ingest.queue.depth() == 0:
                break
            time.sleep(0.02)
        assert self.source().resource_version == rv, (self.pkg, self.source().resource_version, rv)
        time.sleep(0.05)  # the drain thread's batch in flight
        assert self.app.dispatcher.drain(WAIT_S)

    def apply(self, steps):
        for kind, pod in chip_smoke.GpuCluster.pods(steps):
            pod = copy.deepcopy(pod)
            if kind == "ADDED":
                self.mock.add_pod(pod)
            elif kind == "MODIFIED":
                self.mock.modify_pod(pod)
            else:
                self.mock.delete_pod(pod["metadata"]["namespace"], pod["metadata"]["name"])

    def stop(self):
        t0 = time.monotonic()
        self.app.stop()
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive()
        return time.monotonic() - t0

    def close(self):
        self.server.stop()


def strip(payload):
    return {k: v for k, v in payload.items() if k != "event_timestamp"}


def summary(payloads):
    """(multiset of payloads, last pod payload per uid, slice transitions)."""
    multiset = Counter(json.dumps(strip(p), sort_keys=True) for p in payloads)
    last, slices = {}, {}
    for p in payloads:
        if p.get("event_type") == "SLICE_PHASE_CHANGE":
            slices.setdefault(p["slice"], []).append((p["phase_transition"]["from"], p["phase_transition"]["to"]))
        elif p.get("event_type") in ("ADDED", "MODIFIED", "DELETED"):
            last[p["uid"]] = (p["event_type"], p["status"]["phase"], p["namespace"], p["name"])
    return multiset, last, slices


def checkpoint_files(side):
    return sorted(p.name for p in side.workdir.iterdir() if p.name.startswith("ck.json"))


def checkpoint_state(side, reader):
    """What a restart reads back from ``side``'s checkpoint files, through
    ``reader``'s store. (When the flushes ran depends on thread timing, so
    the journals may split the same state differently; the state is what
    must match.)"""
    store = (RefStore if reader == "ref" else CheckpointStore)(side.workdir / "ck.json")
    for key in ("known_pods", "phases"):
        store.attach_journaled_map(key)
    return {"rv": store.resource_version(), **{k: store.get(k) for k in ("slices", "known_pods", "phases")}}


def run_both(tmp_path, environment, seed, *, namespace, coalesce=False, status=False, between=None):
    cluster = small_cluster(seed, namespace)
    ports = {"ref": free_port(), "port": free_port()} if status else {"ref": 0, "port": 0}
    sides = {pkg: Side(pkg, cluster, environment, tmp_path, status_port=ports[pkg], coalesce=coalesce)
             for pkg in ("ref", "port")}
    try:
        for side in sides.values():
            side.start()
        for side in sides.values():
            side.wait_synced()
        for side in sides.values():
            side.apply(cluster.churn)
        for side in sides.values():
            side.wait_synced()
        extra = between(sides) if between is not None else None
        stop_s = {pkg: side.stop() for pkg, side in sides.items()}
    finally:
        for side in sides.values():
            side.close()
    return cluster, sides, stop_s, extra


@pytest.mark.parametrize("environment, namespace", [("development", "default"), ("production", "production")])
def test_same_notifications_slices_and_checkpoint(tmp_path, environment, namespace):
    cluster, sides, stop_s, _ = run_both(tmp_path, environment, 0, namespace=namespace)
    got = summary(sides["port"].recorder.snapshot())
    want = summary(sides["ref"].recorder.snapshot())
    assert got == want
    assert checkpoint_files(sides["port"]) == checkpoint_files(sides["ref"])
    state = checkpoint_state(sides["port"], "port")
    assert state == checkpoint_state(sides["ref"], "ref") == checkpoint_state(sides["ref"], "port")
    assert state == checkpoint_state(sides["port"], "ref")
    assert state["rv"] and state["known_pods"] and state["phases"]
    assert max(stop_s.values()) < 10.0
    _, last, slices = got
    assert slices and (last if environment == "production" else got[0])
    if environment == "production":
        # the card run's plain reference agrees with both apps
        fold_last, fold_slices = chip_smoke.fold_production(
            chip_smoke.GpuCluster.facts(cluster.initial) + chip_smoke.GpuCluster.facts(cluster.churn))
        assert last == fold_last
        assert slices == fold_slices
        degraded = sorted(k for k, t in slices.items() if any(to == "Degraded" for _, to in t))
        assert degraded == cluster.failed_jobsets


def test_fold_reads_pods_as_the_cluster_steps_say():
    cluster = small_cluster(1, "production")
    steps = cluster.initial + cluster.churn
    assert [chip_smoke.facts_of(k, p) for k, p in chip_smoke.GpuCluster.pods(steps)] == \
        chip_smoke.GpuCluster.facts(steps)


def _get(port, route, token=None):
    headers = {"Authorization": f"Bearer {token}".encode("utf-8").decode("latin-1")} if token else {}
    request = urllib.request.Request(f"http://127.0.0.1:{port}{route}", headers=headers)
    try:
        with urllib.request.urlopen(request, timeout=10) as r:
            status, body, ctype = r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        status, body, ctype = e.code, e.read(), e.headers.get("Content-Type", "")
    return status, (json.loads(body) if ctype.startswith("application/json") else body)


ROUTES = ("/healthz", "/debug/slices", "/debug/events?n=1000", "/debug/events?n=x", "/debug/trace?n=1000",
          "/debug/trace?slowest=nope", "/debug/checkpoint", "/metrics", "/debug/nope")


def _normalize(route, body):
    """What must match: wall stamps, ids and timings left out."""
    if not isinstance(body, dict):
        return body
    if route == "/healthz":
        return {k: v for k, v in body.items() if k != "last_heartbeat_age_seconds"}
    if route.startswith("/debug/events") and "events" in body:
        drop = ("ts", "seq", "trace_id")
        return sorted(json.dumps({k: v for k, v in e.items() if k not in drop}, sort_keys=True)
                      for e in body["events"])
    if route.startswith("/debug/trace") and "traces" in body:
        return sorted((t["uid"], t["outcome"], t["kind"], t["sampled_by"], tuple(s["stage"] for s in t["spans"]))
                      for t in body["traces"])
    if route == "/debug/checkpoint":
        return sorted(body["checkpoint"])
    if route == "/metrics":
        counters = ("events_received", "notifications_enqueued", "slice_notifications_enqueued",
                    "events_dropped_namespace", "events_dropped_resource", "events_dropped_critical_gate",
                    "events_dropped_insignificant", "events_prefiltered", "dispatch_enqueued", "dispatch_sent",
                    "relists", "relist_pages")
        return {k: body[k]["count"] for k in counters if k in body}
    return body


def test_status_routes_answer_alike(tmp_path):
    def query(sides):
        ports = {pkg: side.app.config.watcher.status_port for pkg, side in sides.items()}
        out = {}
        for pkg, port in ports.items():
            out[pkg] = {(route, auth): _get(port, route, auth) for route in ROUTES
                        for auth in (None, "wrong", TOKEN)}
        return out

    _, _, _, answers = run_both(tmp_path, "production", 2, namespace="production", coalesce=True, status=True,
                                between=query)
    for key, (status, body) in answers["port"].items():
        route, auth = key
        want_status, want_body = answers["ref"][key]
        assert status == want_status, key
        assert _normalize(route, body) == _normalize(route, want_body), key
        if route != "/healthz" and auth != TOKEN:
            assert status == 401 and body == b""
    assert answers["port"][("/healthz", None)][1]["alive"] is True
    assert len(answers["port"][("/debug/slices", TOKEN)][1]["slices"]) == 16


def test_restart_synthesizes_deleted_alike(tmp_path):
    def restart(sides):
        out = {}
        for pkg, side in sides.items():
            side.stop()
            gone = cluster.down_deletions
            for ns, name, _ in gone:
                side.mock.delete_pod(ns, name)
            side.mock.compact()
            side.start()  # a new app on the same checkpoint
            side.wait_synced()
            out[pkg] = sorted((p["event_type"], p["uid"], p["status"]["phase"])
                              for p in side.recorder.snapshot() if p.get("event_type") == "DELETED")
        return out

    cluster = small_cluster(3, "production")  # run_both builds the same cluster from the seed
    _, sides, _, deleted = run_both(tmp_path, "production", 3, namespace="production", between=restart)
    assert deleted["port"] == deleted["ref"]
    assert [uid for _, uid, _ in deleted["port"]] == sorted(uid for _, _, uid in cluster.down_deletions)


def test_probe_on_the_cpu_reports_and_arms_remediation(tmp_path):
    cluster = small_cluster(4, "production")
    side = Side("port", cluster, "production", tmp_path, status_port=free_port(), probe=True)
    try:
        side.start(device="cpu", expected_platform="cpu")
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            if sum(p.get("event_type") == "TPU_PROBE" for p in side.recorder.snapshot()) >= 2:
                break
            time.sleep(0.05)
        port = side.app.config.watcher.status_port
        probes = _get(port, "/debug/probes?n=5", TOKEN)
        remediation = _get(port, "/debug/remediation", TOKEN)
        stop_s = side.stop()
    finally:
        side.close()
    reports = [p for p in side.recorder.snapshot() if p.get("event_type") == "TPU_PROBE"]
    assert len(reports) >= 2 and all(r["healthy"] for r in reports)
    assert probes[0] == 200 and len(probes[1]["probes"]) >= 2
    assert remediation[0] == 200 and remediation[1]["remediation"]["dry_run"] is True
    assert stop_s < 10.0


def test_probe_without_a_gpu_is_refused_at_construction(tmp_path):
    config = make_config("port", "production", "http://127.0.0.1:1", tmp_path, probe=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        WatcherApp(config, notifier=Recorder(), source=FakeWatchSource([]))


@pytest.mark.parametrize("overlay, message", [
    ({"relay": {"enabled": True, "upstream": {"url": "http://127.0.0.1:1"}},
      "federation": {"enabled": True, "upstreams": [{"name": "c0", "url": "http://127.0.0.1:1"}]}},
     "'relay.enabled': conflicts with federation.enabled"),
    ({"relay": {"enabled": True, "upstream": {"url": "http://127.0.0.1:1"}}},
     "'relay.enabled': conflicts with history.enabled"),
])
def test_relay_excludes_federation_and_history(overlay, message):
    """A relay mirrors its upstream's rv line: the schema refuses it beside a
    federation plane (which mints local rvs) or a history WAL (durability
    belongs to the root), in ``production`` as shipped."""
    raw = load_raw_config("production", CONFIG_DIR, env={})
    with pytest.raises(ConfigError, match=message):
        AppConfig.from_raw(deep_merge(raw, overlay), "production")


def test_analytics_without_a_gpu_is_refused_at_construction(tmp_path):
    config = make_config("port", "production", "http://127.0.0.1:1", tmp_path, planes=("serve", "analytics"))
    assert config.analytics.enabled and config.analytics.backend == "auto"
    with pytest.raises(RuntimeError, match="CUDA"):
        WatcherApp(config, notifier=Recorder(), source=FakeWatchSource([]))


def _serve_get(app, route):
    status, body = _get(app.serve.port, route, TOKEN)
    assert status == 200, (route, status, body)
    return body


def _fleet(body):
    """A snapshot's objects by (kind, key), and its rv."""
    return body["rv"], {(o["kind"], o["key"]): o for o in body["objects"]}


def test_serve_and_analytics_planes_answer_alike(tmp_path):
    cluster = small_cluster(5, "production")
    sides = {pkg: Side(pkg, cluster, "production", tmp_path, planes=("serve", "analytics"))
             for pkg in ("ref", "port")}
    try:
        sides["ref"].start()
        sides["port"].start(device="cpu")
        for side in sides.values():
            side.wait_synced()
        port_app = sides["port"].app
        assert port_app.analytics.backend.name == "torch" and port_app.analytics.backend.device.type == "cpu"
        # the JAX package's consumer follows the port's plane through the churn
        loop = ResumeLoop(FleetClient(f"http://127.0.0.1:{port_app.serve.port}", token=TOKEN))
        loop.start()
        for side in sides.values():
            side.apply(cluster.churn[:300])
        loop.poll(timeout=0.2)
        for side in sides.values():
            side.apply(cluster.churn[300:])
        for side in sides.values():
            side.wait_synced()
        loop.drain()
        snapshots = {pkg: _fleet(_serve_get(side.app, "/serve/fleet")) for pkg, side in sides.items()}
        assert snapshots["port"] == snapshots["ref"]
        rv, objects = snapshots["port"]
        assert rv == loop.rv and loop.model == objects and loop.checker.clean
        kinds = Counter(kind for kind, _ in objects)
        assert kinds == {"slice": 16, "pod": 64}  # the GPU workers of the watched namespaces
        summaries = {pkg: _serve_get(side.app, "/serve/analytics") for pkg, side in sides.items()}
        scenarios = json.dumps([{"kind": "baseline"}, {"kind": "drain_cluster", "cluster": ""},
                                {"kind": "cordon_nodes", "nodes": ["gpu-node-0003", "gpu-node-0011"]},
                                {"kind": "cordon_nodes", "nodes": ["ghost"]}])
        evaluations = {pkg: _serve_get(side.app, "/serve/analytics?scenarios=" + urllib.parse.quote(scenarios))
                       for pkg, side in sides.items()}
        health = {pkg: _get(side.app.serve.port, "/serve/healthz") for pkg, side in sides.items()}
        stop_s = {pkg: side.stop() for pkg, side in sides.items()}
    finally:
        for side in sides.values():
            side.close()
    assert {pkg: b["backend"] for pkg, b in summaries.items()} == {"ref": "jax", "port": "torch"}
    for bodies in (summaries, evaluations):
        assert {k: v for k, v in bodies["port"].items() if k != "backend"} == \
            {k: v for k, v in bodies["ref"].items() if k != "backend"}
    assert summaries["port"]["crosscheck"]["ok"] and summaries["port"]["fleet"]["slices"] == 16
    assert evaluations["port"]["scenarios"][1]["slices_losing_quorum"]  # draining the cluster breaks quorums
    assert health["port"][0] == 200 and health["port"][1]["view_rv"] == rv
    assert max(stop_s.values()) < 10.0


def _watch_once(app, rv, instance):
    return _get(app.serve.port, f"/serve/fleet?watch=1&once=1&timeout=0.2&rv={rv}&view={instance}", TOKEN)


def test_history_health_and_slo_planes_answer_alike(tmp_path):
    cluster = small_cluster(6, "production")
    sides = {pkg: Side(pkg, cluster, "production", tmp_path, status_port=free_port(),
                       planes=("serve", "history", "health", "slo")) for pkg in ("ref", "port")}
    fast = {}
    for pkg, side in sides.items():
        config = side.config()
        assert config.history.enabled and config.health.enabled and config.slo.enabled
        fast[pkg] = dataclasses.replace(config, health=dataclasses.replace(config.health, tick_seconds=0.2),
                                        slo=dataclasses.replace(config.slo, tick_seconds=0.2))
        side.config = lambda _config=fast[pkg]: _config
    try:
        for side in sides.values():
            side.start()
        for side in sides.values():
            side.wait_synced()
            side.apply(cluster.churn[:300])
        for side in sides.values():
            side.wait_synced()
        token = {pkg: (side.app.serve.view.rv, side.app.serve.view.instance) for pkg, side in sides.items()}
        assert token["port"][0] == token["ref"][0]
        for side in sides.values():
            side.apply(cluster.churn[300:])
        for side in sides.values():
            side.wait_synced()
        for side in sides.values():
            side.app.history.flush(WAIT_S)
        at = {pkg: _get(side.app.serve.port, f"/serve/fleet?at={token[pkg][0]}", TOKEN)
              for pkg, side in sides.items()}
        time.sleep(0.5)  # a few health and SLO ticks
        routes = {pkg: {route: _get(side.app.config.watcher.status_port, route, TOKEN)
                        for route in ("/healthz", "/debug/history", "/debug/health", "/debug/slo")}
                  for pkg, side in sides.items()}
        rv_before = {pkg: side.app.serve.view.rv for pkg, side in sides.items()}
        stop_s = {pkg: side.stop() for pkg, side in sides.items()}
        # the restart: the views continue from their WALs
        for side in sides.values():
            side.start()
        restored = {pkg: (side.app.serve.view.instance, side.app.history.recovered.clean)
                    for pkg, side in sides.items()}
        for side in sides.values():
            side.wait_synced()
        resumed = {pkg: _watch_once(side.app, *token[pkg]) for pkg, side in sides.items()}
        stop_s2 = {pkg: side.stop() for pkg, side in sides.items()}
    finally:
        for side in sides.values():
            side.close()
    for pkg in ("ref", "port"):
        assert at[pkg][0] == 200 and at[pkg][1]["historical"] is True, at[pkg]
        assert restored[pkg] == (token[pkg][1], True)
        status, body = resumed[pkg]
        assert status == 200 and body["from_rv"] == token[pkg][0] and not body["compacted"], body
        assert len(body["items"]) == body["to_rv"] - token[pkg][0] >= rv_before[pkg] - token[pkg][0] > 0
        health_status, health = routes[pkg]["/healthz"]
        assert health_status == 200 and health["alive"] is True
        assert {"slo", "health"} <= set(health) and health["serve"]["history"]["writer_alive"] is True
        for route in ("/debug/history", "/debug/health", "/debug/slo"):
            assert routes[pkg][route][0] == 200, (pkg, route, routes[pkg][route])
    assert {k: v for k, v in at["port"][1].items() if k != "view"} == \
        {k: v for k, v in at["ref"][1].items() if k != "view"}
    # the rv order of pod and slice deltas follows the ingest's batching;
    # what the resumed deltas fold to does not
    folded = {pkg: {(i["kind"], i["key"]): i.get("object") for i in resumed[pkg][1]["items"]} for pkg in sides}
    assert folded["port"] == folded["ref"]
    slo = {pkg: routes[pkg]["/debug/slo"][1]["slo"] for pkg in sides}
    assert sorted(slo["port"]["objectives"]) == sorted(slo["ref"]["objectives"]) == sorted(
        o.name for o in fast["port"].slo.objectives)
    for name, result in slo["port"]["objectives"].items():
        assert set(result["windows"]) == {"fast", "slow"} and result["kind"] == slo["ref"]["objectives"][name]["kind"]
    history = routes["port"]["/debug/history"][1]["history"]
    assert history["writer_alive"] and history["durable_rv"] == rv_before["port"]
    assert max(stop_s.values()) < 10.0 and max(stop_s2.values()) < 10.0


def test_development_as_shipped_builds_every_plane_it_enables(tmp_path):
    config = load_app_config("development", CONFIG_DIR, env={})
    assert config.health.enabled and config.slo.enabled and config.serve.enabled and config.analytics.enabled
    app = WatcherApp(config, notifier=Recorder(), device="cpu", expected_platform="cpu")
    assert app.health is not None and app.slo is not None and app.analytics is not None
    assert app.history is None and not config.history.enabled
    assert app.health.view is app.serve.view


# -- leader election, the node plane and the reader processes ------------------


def tpu_cluster():
    """A mock cluster of four TPU nodes (GKE TPU node labels, as the shipped
    node selectors expect) under one 8-worker JobSet, Running and ready."""
    from k8s_watcher_tpu.watch.fake import build_node, build_pod

    mock = MockCluster()
    for i in range(4):
        mock.add_node(build_node(f"tpu-node-{i}"))
    for i in range(8):
        mock.add_pod(build_pod(
            f"w-{i}", "default", uid=f"uid-w-{i}", phase="Running", tpu_chips=4, tpu_topology="2x2x2",
            node_name=f"tpu-node-{i % 4}",
            gke_slice_fields={"jobset.sigs.k8s.io/jobset-name": "train", "batch.kubernetes.io/job-completion-index": i},
            container_statuses=[{"name": "main", "ready": True, "restart_count": 0, "state": {"running": {}}}]))
    return mock


def shipped_config(environment, server_url, workdir, overlay=None, **watcher_kw):
    """``environment`` as shipped, every plane on, pointed at the mock
    apiserver through a kubeconfig, with free ports, a small probe and the
    state under ``workdir``; ``overlay`` is merged over the shipped files
    before the schema reads them."""
    workdir.mkdir(parents=True, exist_ok=True)
    kubeconfig = workdir / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "m",
        "clusters": [{"name": "m", "cluster": {"server": server_url}}],
        "contexts": [{"name": "m", "context": {"cluster": "m", "user": "m"}}],
        "users": [{"name": "m", "user": {"token": "t"}}],
    }))
    raw = load_raw_config(environment, CONFIG_DIR, env={
        "WATCHER_STATUS_TOKEN": TOKEN, "WATCHER_CHECKPOINT_PATH": str(workdir / "ck.json"),
        "WATCHER_HISTORY_DIR": str(workdir / "history")})
    config = AppConfig.from_raw(deep_merge(raw, overlay or {}), environment)
    return dataclasses.replace(
        config,
        kubernetes=dataclasses.replace(config.kubernetes, use_incluster_config=False, config_file=str(kubeconfig),
                                       watch_timeout_seconds=10),
        watcher=dataclasses.replace(config.watcher, status_port=free_port(), **watcher_kw),
        serve=dataclasses.replace(config.serve, port=0),
        tpu=dataclasses.replace(config.tpu, probe_interval_seconds=0.5, probe_hbm_bytes=2 << 20, probe_matmul_size=64,
                                probe_payload_bytes=4096),
    )


def _wait(predicate, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def _kinds(recorder, kind):
    return [p for p in recorder.snapshot() if p.get("event_type") == kind]


@pytest.mark.parametrize("environment", ["staging", "production"])
def test_shipped_environment_runs_on_the_cpu(tmp_path, environment):
    """``staging`` (two reader processes on the native prefilter, the node
    watch) and ``production`` (leader election, the node watch) as shipped,
    with ``--cpu``: the slice forms, a NotReady node degrades it, the status
    routes answer, the stop is prompt and, in production, releases the
    Lease."""
    mock = tpu_cluster()
    server = FastMockApiServer(mock).start()
    recorder = Recorder()
    try:
        config = shipped_config(environment, server.url, tmp_path)
        app = WatcherApp(config, notifier=recorder, device="cpu", expected_platform="cpu")
        thread = threading.Thread(target=app.run, daemon=True)
        thread.start()
        assert _wait(lambda: any(p["phase_transition"]["to"] == "Ready"
                                 for p in _kinds(recorder, "SLICE_PHASE_CHANGE")))
        assert _wait(lambda: app.node_watcher is not None and app.node_watcher.synced.is_set())
        mock.set_node_ready("tpu-node-1", False)
        assert _wait(lambda: _kinds(recorder, "NODE_CONDITION_CHANGE")
                     and _kinds(recorder, "SLICE_PHASE_CHANGE")[-1]["phase_transition"]["to"] == "Degraded")
        port = config.watcher.status_port
        healthz = _get(port, "/healthz")
        processes = _get(port, "/debug/processes", TOKEN)
        lease = mock.get_lease("default", config.watcher.leader_election.lease_name)
        pids = app.ingest.worker_pids() if environment == "staging" else []
        if environment == "staging":
            # the slice's events may all ride shard 0: on a loaded host the
            # other reader can still be starting when they have arrived
            _wait(lambda: all(e.last_hello is not None for e in app.ingest.endpoints))
        t0 = time.monotonic()
        app.stop()
        thread.join(WAIT_S)
        stop_s = time.monotonic() - t0
        lease_after = mock.get_lease("default", config.watcher.leader_election.lease_name)
    finally:
        server.stop()
    assert not thread.is_alive() and stop_s < 10.0
    assert healthz[0] == 200 and healthz[1]["alive"] is True
    (node,) = _kinds(recorder, "NODE_CONDITION_CHANGE")
    assert node["node"] == "tpu-node-1" and node["ready"] is False and node["tpu"]["chips"] == 4
    degraded = _kinds(recorder, "SLICE_PHASE_CHANGE")[-1]
    assert {w["node"] for w in degraded["workers"] if not w["node_ready"]} == {"tpu-node-1"}
    if environment == "staging":
        assert [p["name"] for p in _kinds(recorder, "ADDED")] and lease is None
        rows = processes[1]["processes"]["workers"]
        assert processes[0] == 200 and [r["process"] for r in rows] == ["ingest-shard-0", "ingest-shard-1"]
        assert [h["scanners"] for h in (e.last_hello for e in app.ingest.endpoints)] == [["NativeFrameScanner"]] * 2
        assert healthz[1]["processes"]["processes"] == 2
        assert len(pids) == 2 and not any(os.path.exists(f"/proc/{p}") for p in pids)
    else:
        assert processes[0] == 404 and "processes" not in healthz[1]
        assert lease["spec"]["holderIdentity"] and lease_after["spec"]["holderIdentity"] == ""


UPSTREAM_TOKEN = "upstream-token"


def _upstream(pods=6):
    """A port serving plane on 127.0.0.1 over a view of ``pods`` pods and
    one slice, behind a bearer token: the upstream a federator or a relay
    subscribes to."""
    from k8s_watcher_tpu_torch.serve import FleetView, ServeServer, SubscriptionHub

    view = FleetView(compact_horizon=1024)
    view.apply_batch([("pod", f"uid-{i}", {"kind": "pod", "key": f"uid-{i}", "name": f"w-{i}",
                                           "namespace": "default", "phase": "Running", "ready": True,
                                           "node": f"gpu-{i % 2}"}) for i in range(pods)]
                     + [("slice", "default/train", {"kind": "slice", "key": "default/train", "phase": "Ready"})])
    hub = SubscriptionHub(view)
    server = ServeServer(view, hub, host="127.0.0.1", port=0, auth_token=UPSTREAM_TOKEN).start()
    return view, server


@pytest.mark.parametrize("plane", ["federation", "relay"])
def test_federator_and_relay_run_on_the_cpu(tmp_path, plane):
    """``production`` with ``federation.enabled`` (one upstream, trace joining
    on) and ``production`` with ``relay.enabled`` (serve only: history,
    analytics, health and SLO off), each against a local upstream, with
    ``--cpu``: the federator's ``/serve/fleet`` holds the upstream's objects
    under ``"c0/<key>"`` and its routes answer; the relay's snapshot is the
    upstream's, on the upstream's rv line. Then a prompt stop."""
    view, upstream = _upstream()
    url = f"http://127.0.0.1:{upstream.port}"
    if plane == "federation":
        overlay = {"federation": {"enabled": True, "upstreams": [{"name": "c0", "url": url,
                                                                   "token": UPSTREAM_TOKEN}]},
                   "trace": {"federation": {"enabled": True}}}
    else:
        overlay = {"relay": {"enabled": True, "upstream": {"name": "root", "url": url, "token": UPSTREAM_TOKEN}},
                   **{name: {"enabled": False} for name in ("history", "analytics", "health", "slo")}}
    mock = tpu_cluster()
    server = FastMockApiServer(mock).start()
    try:
        config = shipped_config("production", server.url, tmp_path, overlay=overlay)
        app = WatcherApp(config, notifier=Recorder(), device="cpu", expected_platform="cpu")
        thread = threading.Thread(target=app.run, daemon=True)
        thread.start()
        assert _wait(lambda: app.serve.server is not None)
        upstream_snap = _get(upstream.port, "/serve/fleet", UPSTREAM_TOKEN)[1]

        def fleet():
            return _get(app.serve.port, "/serve/fleet", TOKEN)[1]

        if plane == "federation":
            assert _wait(lambda: merged_equals_union(fleet()["objects"], {"c0": upstream_snap["objects"]}))
            routes = {r: _get(config.watcher.status_port, r, TOKEN)
                      for r in ("/healthz", "/debug/federation", "/debug/trace/diagnosis", "/debug/relay")}
            assert routes["/healthz"][0] == 200 and routes["/healthz"][1]["federation"]["healthy"] is True
            assert routes["/debug/federation"][1]["federation"]["upstreams"]["c0"]["stale"] is False
            assert routes["/debug/trace/diagnosis"][0] == 200 and routes["/debug/relay"][0] == 404
            assert os.path.isdir(os.path.join(os.path.dirname(config.state.checkpoint_path), "federation-tokens"))
        else:
            assert _wait(lambda: fleet()["view"] == upstream_snap["view"])
            assert sorted(map(json.dumps, fleet()["objects"])) == sorted(map(json.dumps, upstream_snap["objects"]))
            assert fleet()["rv"] == upstream_snap["rv"] == view.rv
            relay = _get(config.watcher.status_port, "/debug/relay", TOKEN)
            assert relay[0] == 200 and relay[1]["relay"]["depth"] == 1
            assert _get(app.serve.port, "/serve/healthz")[1]["relay"]["depth"] == 1
        t0 = time.monotonic()
        app.stop()
        thread.join(WAIT_S)
        stop_s = time.monotonic() - t0
    finally:
        server.stop()
        upstream.stop()
    assert not thread.is_alive() and stop_s < 10.0


def test_standby_holds_no_watch_and_takes_over(tmp_path):
    """Two ``production`` apps on one Lease, at the shipped timings: the
    standby keeps its status routes and liveness but opens no watch and
    sends nothing; once the leader stops (releasing the Lease) it takes over
    within ``retry_period`` plus a margin, lists and notifies."""
    mock = tpu_cluster()
    server = FastMockApiServer(mock).start()
    apps, recorders, threads = {}, {}, {}
    try:
        for replica in ("a", "b"):
            config = shipped_config("production", server.url, tmp_path / replica, leader_election=dataclasses.replace(
                load_app_config("production", CONFIG_DIR, env={}).watcher.leader_election,
                identity=f"replica-{replica}"))
            recorders[replica] = Recorder()
            apps[replica] = WatcherApp(config, notifier=recorders[replica], device="cpu", expected_platform="cpu")
            threads[replica] = threading.Thread(target=apps[replica].run, daemon=True)
        le = apps["a"].config.watcher.leader_election
        threads["a"].start()
        assert _wait(lambda: _kinds(recorders["a"], "SLICE_PHASE_CHANGE"))
        threads["b"].start()
        assert _wait(lambda: apps["b"].elector is not None and apps["b"].status_server is not None)
        time.sleep(2 * le.retry_period_seconds)
        standby = apps["b"]
        assert not standby.elector.is_leader and standby.node_watcher is None
        assert standby.ingest._threads == [] and recorders["b"].snapshot() == []
        assert standby.liveness.alive()
        assert _get(standby.config.watcher.status_port, "/healthz")[1]["alive"] is True
        assert mock.get_lease("default", le.lease_name)["spec"]["holderIdentity"] == "replica-a"
        apps["a"].stop()
        threads["a"].join(WAIT_S)
        t0 = time.monotonic()
        assert _wait(lambda: standby.elector.is_leader, le.retry_period_seconds + 3.0)
        takeover_s = time.monotonic() - t0
        assert _wait(lambda: _kinds(recorders["b"], "SLICE_PHASE_CHANGE"))
        lease = mock.get_lease("default", le.lease_name)
        standby.stop()
        threads["b"].join(WAIT_S)
    finally:
        server.stop()
    assert takeover_s < le.retry_period_seconds + 3.0
    assert lease["spec"]["holderIdentity"] == "replica-b" and lease["spec"]["leaseTransitions"] == 1
    assert not threads["a"].is_alive() and not threads["b"].is_alive()


def test_reader_processes_post_what_in_process_ingest_posts(tmp_path):
    """``staging``'s two shard streams read by two spawned reader processes
    POST, pod by pod, the same payloads as the same two streams read in
    process, on the same churn; and both end where the plain staging fold
    ends. (Across shards the order is per shard only, so the slice phase a
    pod payload carries and the slices' intermediate transitions may differ
    between the runs; each slice's last phase may not.)"""
    namespaces = load_app_config("staging", CONFIG_DIR, env={}).watcher.namespaces
    cluster = small_cluster(5, "staging")
    last, transitions = chip_smoke.fold_production(
        chip_smoke.GpuCluster.facts(cluster.initial) + chip_smoke.GpuCluster.facts(cluster.churn),
        namespaces=namespaces, critical=False)
    final = {k: t[-1][1] for k, t in transitions.items()}
    got = {}
    for processes in (2, 0):
        side = Side("port", cluster, "staging", tmp_path / str(processes), coalesce=False)
        config = side.config()
        config = dataclasses.replace(config, ingest=dataclasses.replace(config.ingest, shards=2, processes=processes))
        recorder = Recorder()
        app = WatcherApp(config, notifier=recorder)
        thread = threading.Thread(target=app.run, daemon=True)
        try:
            thread.start()
            # the LIST first, so the churn reaches both runs as watch events
            assert _wait(lambda: app.metrics.counter("events_received").value >= len(cluster.initial))
            side.apply(cluster.churn)
            assert _wait(lambda: summary(recorder.snapshot())[1] == last and {
                k: t[-1][1] for k, t in summary(recorder.snapshot())[2].items()} == final), processes
            assert app.dispatcher.drain(WAIT_S)
            app.stop()
            thread.join(WAIT_S)
        finally:
            side.close()
        assert not thread.is_alive()
        per_pod = {}
        for p in recorder.snapshot():
            if p.get("event_type") in ("ADDED", "MODIFIED", "DELETED"):
                p = strip(p)
                p.get("tpu", {}).pop("slice", None)
                per_pod.setdefault(p["uid"], []).append(json.dumps(p, sort_keys=True))
        got[processes] = per_pod
    assert got[2] == got[0] and len(got[0]) == len(last)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_node_churn_fold_holds_against_the_pipeline(pkg):
    """The card run's rule for the node plane, held against each package's
    pipeline, slice tracker and node watcher fed the same steps in one
    thread: the pods of ``GpuCluster`` under the ``production`` rules, every
    node listed Ready first, then ``node_steps`` at their positions in the
    churn. The node payloads equal ``fold_node_payloads``; the slice
    transitions equal ``fold_production``'s, so every transition the node
    events cause (``node_caused``) is among them; the pods' last payloads
    equal the fold's."""
    from k8s_watcher_tpu.nodes import NodeTracker as RefNodeTracker, NodeWatcher as RefNodeWatcher
    from k8s_watcher_tpu.pipeline import filters as ref_filters
    from k8s_watcher_tpu.pipeline.phase import PhaseTracker as RefPhaseTracker
    from k8s_watcher_tpu.pipeline.pipeline import EventPipeline as RefPipeline
    from k8s_watcher_tpu.slices.tracker import SliceTracker as RefSliceTracker
    from k8s_watcher_tpu.watch.source import WatchEvent as RefWatchEvent
    from k8s_watcher_tpu_torch.nodes import NodeTracker, NodeWatcher
    from k8s_watcher_tpu_torch.pipeline import filters
    from k8s_watcher_tpu_torch.pipeline.phase import PhaseTracker
    from k8s_watcher_tpu_torch.pipeline.pipeline import EventPipeline
    from k8s_watcher_tpu_torch.slices.tracker import SliceTracker
    from k8s_watcher_tpu_torch.watch.source import WatchEvent

    parts = {"ref": (RefNodeTracker, RefNodeWatcher, ref_filters, RefPhaseTracker, RefPipeline, RefSliceTracker,
                     RefWatchEvent),
             "port": (NodeTracker, NodeWatcher, filters, PhaseTracker, EventPipeline, SliceTracker, WatchEvent)}
    node_tracker_cls, node_watcher_cls, flt, phase_cls, pipeline_cls, slice_cls, event_cls = parts[pkg]
    cluster = chip_smoke.GpuCluster(6, nodes=48, pods=600, jobsets=12, workers=4, churn=1500, failures=2,
                                    down_deletions=2, node_flips=6)
    key, namespaces = chip_smoke.GPU_KEY, chip_smoke.WATCHED_NAMESPACES
    sent = []
    slices = slice_cls("production", resource_key=key)
    pipe = pipeline_cls(environment="production", sink=sent.append, namespace_filter=flt.NamespaceFilter(namespaces),
                        resource_filter=flt.TpuResourceFilter(key),
                        critical_gate=flt.CriticalEventGate("production", True), phase_tracker=phase_cls(),
                        slice_tracker=slices, resource_key=key)
    tracker = node_tracker_cls("production", resource_key=key, accelerator_label=chip_smoke.GPU_PRODUCT_LABEL)
    watcher = node_watcher_cls(None, tracker, sent.append, slice_tracker=slices,
                               label_selector=chip_smoke.GPU_PRESENT_LABEL)
    for name in cluster.node_names():
        watcher._emit("ADDED", chip_smoke.GpuCluster.node(name, True, 1), 0.0)
    steps = {}
    for rv, (position, kind, node, ready) in enumerate(cluster.node_steps, start=2):
        steps.setdefault(position, []).append(
            (kind, chip_smoke.GpuCluster.node(node, bool(ready) if kind != "DELETED" else True, rv)))
    for i, (kind, pod) in enumerate(chip_smoke.GpuCluster.pods(cluster.initial + cluster.churn)):
        for node_kind, node in steps.get(i - len(cluster.initial), ()):
            watcher._emit(node_kind, node, 0.0)
        pipe.process_batch([event_cls(type=kind, pod=copy.deepcopy(pod), resource_version=str(i + 1))])
    node_caused = []
    last, transitions = chip_smoke.fold_production(
        chip_smoke.GpuCluster.facts(cluster.initial) + chip_smoke.GpuCluster.facts(cluster.churn),
        node_steps=[(len(cluster.initial) + p, *rest) for p, *rest in cluster.node_steps], node_caused=node_caused)
    payloads = [{k: v for k, v in n.payload.items() if k != "event_timestamp"} for n in sent]
    nodes, seen = {}, {}
    for p in payloads:
        if p["event_type"] in ("NODE_CONDITION_CHANGE", "NODE_DELETED"):
            nodes.setdefault(p["node"], []).append(p)
        elif p["event_type"] == "SLICE_PHASE_CHANGE":
            seen.setdefault(p["slice"], []).append((p["phase_transition"]["from"], p["phase_transition"]["to"]))
    _, last_seen, _ = summary(payloads)
    assert nodes == chip_smoke.fold_node_payloads(cluster.node_steps, "production")
    assert seen == transitions
    assert len(node_caused) >= len(cluster.flipped_nodes) + 1
    assert all((a, b) in seen[k] for k, a, b in node_caused)
    assert last_seen == last
