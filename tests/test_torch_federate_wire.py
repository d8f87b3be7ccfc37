"""The port's federation and relay held against the JAX package's over the
wire, on 127.0.0.1.

Federation and relay are a wire protocol, so the strongest parity check is
that the two packages interoperate:

- three JAX-package upstream ``ServeServer`` s feed a port
  ``FederationPlane``, and three port upstreams feed a JAX-package
  ``FederationPlane``; both merged views equal the union of their upstreams
  (by both packages' ``merged_equals_union``), through the same seeded churn
  on both sides, and end with the same merged objects;
- a port ``RelayPlane`` in front of a JAX-package root, with ``codec: json``,
  re-broadcasts the root's frames byte for byte and encodes none itself;
- the port's analytics (on the CPU) and the JAX package's give the same
  summary and what-if verdicts over the same seeded three-cluster merge
  (exactly: the counts are integers).

The clusters are ``chip_smoke.FederatedFleet`` (phase 12's generator) at a
small size, made from a seed on both sides.
"""

import json
import random
import time

import pytest

import chip_smoke
from k8s_watcher_tpu.analytics import AnalyticsPlane as RefAnalyticsPlane
from k8s_watcher_tpu.config.schema import AnalyticsConfig as RefAnalyticsConfig
from k8s_watcher_tpu.config.schema import FederationConfig as RefFederationConfig
from k8s_watcher_tpu.federate import FederationPlane as RefFederationPlane
from k8s_watcher_tpu.federate import GlobalMerge as RefGlobalMerge
from k8s_watcher_tpu.federate import merged_equals_union as ref_merged_equals_union
from k8s_watcher_tpu.serve import FleetView as RefView
from k8s_watcher_tpu.serve import ServeServer as RefServer
from k8s_watcher_tpu.serve import SubscriptionHub as RefHub
from k8s_watcher_tpu_torch.analytics import AnalyticsPlane
from k8s_watcher_tpu_torch.config import AnalyticsConfig, FederationConfig, RelayConfig
from k8s_watcher_tpu_torch.federate import FederationPlane, FleetClient, GlobalMerge, merged_equals_union
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.relay import RelayPlane
from k8s_watcher_tpu_torch.serve import FleetView, ServeServer, SubscriptionHub

PACKAGES = {
    "ref": (RefView, RefHub, RefServer, RefFederationConfig, RefFederationPlane),
    "port": (FleetView, SubscriptionHub, ServeServer, FederationConfig, FederationPlane),
}
SIZES = {"jobsets": 60, "workers": 4, "nodes": 120}
WAIT_S = 30.0


def _wait(predicate, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def _objects(view):
    return json.loads(view.snapshot_bytes())["objects"]


def _upstreams(pkg, fleet):
    view_cls, hub_cls, server_cls, _, _ = PACKAGES[pkg]
    out = []
    for cluster in fleet.clusters:
        view = view_cls(compact_horizon=1 << 16)
        view.apply_batch(fleet.initial(cluster))
        server = server_cls(view, hub_cls(view), host="127.0.0.1", port=0, auth_token=f"{cluster}-token").start()
        out.append((cluster, view, server))
    return out


def _federator(pkg, upstreams, codec):
    view_cls, _, _, config_cls, plane_cls = PACKAGES[pkg]
    config = config_cls.from_raw({
        "enabled": True, "codec": codec, "stale_after_seconds": 5, "resync_backoff_seconds": 0.1,
        "upstreams": [{"name": c, "url": f"http://127.0.0.1:{s.port}", "token": f"{c}-token"}
                      for c, _, s in upstreams],
    })
    view = view_cls(compact_horizon=1 << 16)
    return view, plane_cls(config, view).start()


def _converged(view, plane, upstreams):
    """Every upstream applied up to its view's rv, and merged == union by
    both packages' check."""
    rvs = {u.name: u.subscriber.rv for u in plane.upstreams}
    if any(rvs[c] != v.rv for c, v, _ in upstreams):
        return False
    merged, union = _objects(view), {c: _objects(v) for c, v, _ in upstreams}
    return merged_equals_union(merged, union) and ref_merged_equals_union(merged, union)


@pytest.mark.parametrize("codec", ["json", "msgpack"])
def test_each_package_federates_the_other_to_the_same_merge(codec):
    """JAX upstreams into the port's federator, port upstreams into the JAX
    package's: both converge to the union after the snapshot and after the
    same seeded churn, and hold the same merged objects."""
    fleets = {"port": chip_smoke.FederatedFleet(5, **SIZES), "ref": chip_smoke.FederatedFleet(5, **SIZES)}
    upstream_pkg = {"port": "ref", "ref": "port"}  # federator package -> its upstreams' package
    ups = {fed: _upstreams(upstream_pkg[fed], fleets[fed]) for fed in fleets}
    feds = {fed: _federator(fed, ups[fed], codec) for fed in fleets}
    try:
        for fed, (view, plane) in feds.items():
            assert _wait(lambda: _converged(view, plane, ups[fed])), fed
        for _ in range(40):
            for fed, fleet in fleets.items():
                for cluster, view, _ in ups[fed]:
                    view.apply_batch(fleet.step(cluster))
        for fed, (view, plane) in feds.items():
            assert _wait(lambda: _converged(view, plane, ups[fed])), fed
            assert all(u.subscriber.checker.clean and u.subscriber.resyncs == 0 for u in plane.upstreams), fed
            assert {u.subscriber.client.active_codec for u in plane.upstreams} == {codec}, fed
        merged = {fed: sorted(json.dumps(o, sort_keys=True) for o in _objects(view) if o.get("cluster"))
                  for fed, (view, _) in feds.items()}
        assert merged["port"] == merged["ref"]
        assert len(merged["port"]) == sum(len(fleets["port"].objects(c)) for c in fleets["port"].clusters)
    finally:
        for view, plane in feds.values():
            plane.stop()
        for group in ups.values():
            for _, _, server in group:
                server.stop()


def _raw_deltas(port, rv, *, window=1.0):
    client = FleetClient(f"http://127.0.0.1:{port}", codec="json")
    out = []
    for batch in client.watch_batches(rv, window_seconds=window, raw=True):
        out.extend(raw for frame, raw in batch if frame.get("type") in ("UPSERT", "DELETE"))
    return out


def test_port_relay_of_a_jax_root_rebroadcasts_byte_equal_json_frames():
    fleet = chip_smoke.FederatedFleet(6, **SIZES)
    cluster = fleet.clusters[0]
    root_view = RefView(compact_horizon=1 << 16)
    root_view.apply_batch(fleet.initial(cluster))
    root = RefServer(root_view, RefHub(root_view), host="127.0.0.1", port=0).start()
    metrics = MetricsRegistry()
    config = RelayConfig.from_raw({"enabled": True, "codec": "json", "fresh": False, "backfill": 1 << 16,
                                   "stale_after_seconds": 5, "resync_backoff_seconds": 0.1,
                                   "upstream": {"name": "root", "url": f"http://127.0.0.1:{root.port}"}})
    view = FleetView(compact_horizon=1 << 16, metrics=metrics)
    relay = RelayPlane(config, view, metrics=metrics)
    server = ServeServer(view, SubscriptionHub(view), host="127.0.0.1", port=0, metrics=metrics).start()
    try:
        relay.start()
        assert relay.wait_synced(10) and view.instance == root_view.instance
        rv0 = root_view.rv
        for _ in range(15):  # 105 deltas: one uncompacted read
            root_view.apply_batch(fleet.step(cluster))
        assert _wait(lambda: view.rv == root_view.rv)
        via_relay, via_root = _raw_deltas(server.port, rv0), _raw_deltas(root.port, rv0)
        assert len(via_root) == root_view.rv - rv0 == 105 and via_relay == via_root
        assert relay.frame_encodes() == 0
        health = relay.health()
        assert health["healthy"] and health["depth"] == 1 and health["codec"] == "json"
        assert health["gaps"] == 0 and health["dups"] == 0
    finally:
        relay.stop()
        server.stop()
        root.stop()


def _merged(view_cls, merge_cls, fleet):
    view = view_cls()
    merge = merge_cls(view)
    for cluster in fleet.clusters:
        merge.reset_cluster(cluster, [obj for obj in fleet.objects(cluster).values()])
    return view


@pytest.mark.parametrize("seed", [0, 1])
def test_analytics_over_a_three_cluster_merge_match(seed):
    """Summary and a 32-scenario what-if (a drain of one upstream cluster,
    cordons across all three) over the same seeded merge: the port's torch
    backend on the CPU and the JAX package's analytics give equal bodies,
    backend name aside."""
    fleet = chip_smoke.FederatedFleet(seed, **SIZES)
    for _ in range(20):
        for cluster in fleet.clusters:
            fleet.step(cluster)
    port = AnalyticsPlane(AnalyticsConfig(enabled=True, max_scenarios=32), _merged(FleetView, GlobalMerge, fleet),
                          device="cpu")
    ref = RefAnalyticsPlane(RefAnalyticsConfig(enabled=True, max_scenarios=32),
                            _merged(RefView, RefGlobalMerge, fleet))
    nodes = [node for names in fleet.nodes.values() for node in names]
    raw = chip_smoke.draw_scenarios(random.Random(seed), nodes, drain=fleet.clusters[1])

    def strip(body):
        return {k: v for k, v in body.items() if k != "backend"}

    summary, whatif = port.summary(), port.evaluate(raw)
    assert strip(summary) == strip(ref.summary())
    assert strip(whatif) == strip(ref.evaluate(raw))
    assert summary["crosscheck"]["ok"] and len(whatif["scenarios"]) == 32
    drained = whatif["scenarios"][1]
    assert drained["scenario"] == {"kind": "drain_cluster", "cluster": fleet.clusters[1]}
    assert drained["slices_losing_quorum"]


def test_federated_fleet_churn_folds_to_its_own_state():
    """Phase 12's generator: a view fed the initial objects and the churn
    steps holds exactly ``objects()``; each step is seven deltas, and every
    slice names its current members."""
    fleet = chip_smoke.FederatedFleet(3, **SIZES)
    for cluster in fleet.clusters:
        view = FleetView()
        view.apply_batch(fleet.initial(cluster))
        rv = view.rv
        for _ in range(25):
            view.apply_batch(fleet.step(cluster))
        assert view.rv == rv + 25 * 7
        state = {(o["kind"], o["key"]): o for o in _objects(view)}
        assert state == fleet.objects(cluster)
        pods = {k: o for (kind, k), o in state.items() if kind == "pod"}
        for (kind, _), obj in state.items():
            if kind == "slice":
                assert {w["name"] for w in obj["workers"]} <= {p["name"] for p in pods.values()}
