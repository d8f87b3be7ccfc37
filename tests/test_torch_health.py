"""The port's health plane held against the JAX package's.

The JAX package's ``tests/test_health.py`` runs again through the port
(``test_torch_replay``), the freshness source over a federation plane
included. Then, on inputs made from a numpy seed:

- the same observation stream (peer groups, trend-judged stages and
  upstreams, direct evidence) gives the same tick summaries, snapshots,
  ``/healthz`` folds and labelled-gauge exposition from both detectors;
- the same synthetic probe reports (degraded nodes coming and going, two
  slices' reports in one tick) give the same verdicts from both planes;
- the same pod churn in both packages' ``FleetView`` gives the same phase
  verdicts, tick by tick, under one fake clock;
- a report of the port's own probe agent (on the CPU) reaches the detector
  and implicates nobody.
"""

import time
import types

import numpy as np
import pytest

import k8s_watcher_tpu.health.plane as ref_plane_mod
import k8s_watcher_tpu_torch.health.plane as plane_mod
from k8s_watcher_tpu.config.schema import HealthConfig as RefHealthConfig
from k8s_watcher_tpu.health import HealthDetector as RefDetector
from k8s_watcher_tpu.health import HealthPlane as RefPlane
from k8s_watcher_tpu.health import Observation as RefObservation
from k8s_watcher_tpu.health.synthetic import synthetic_link_report as ref_synthetic_link_report
from k8s_watcher_tpu.metrics import MetricsRegistry as RefRegistry
from k8s_watcher_tpu.serve.view import FleetView as RefView
from k8s_watcher_tpu_torch.config import HealthConfig, TpuConfig
from k8s_watcher_tpu_torch.health import HEALTHY, HealthDetector, HealthPlane, Observation
from k8s_watcher_tpu_torch.health.synthetic import synthetic_link_report
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent
from k8s_watcher_tpu_torch.serve.view import FleetView
from test_torch_replay import replay, replayed_tests

_REWRITES = [
    ("from k8s_watcher_tpu.config.schema import AppConfig, HealthConfig, SchemaError",
     "from k8s_watcher_tpu_torch.config import AppConfig, ConfigError as SchemaError, HealthConfig"),
    ("k8s_watcher_tpu.metrics.server", "k8s_watcher_tpu_torch.status"),
    # the port's status server binds every interface and takes no host
    ('self.liveness, host="127.0.0.1"', "self.liveness"),
]
globals().update(replayed_tests(replay("test_health.py", rewrites=_REWRITES)))

PACKAGES = {
    "ref": (RefDetector, RefObservation, RefRegistry, RefPlane, RefHealthConfig, ref_synthetic_link_report, RefView),
    "port": (HealthDetector, Observation, MetricsRegistry, HealthPlane, HealthConfig, synthetic_link_report,
             FleetView),
}


def observation_ticks(seed, ticks=40):
    """Per tick: ``(observations, evidence)`` as plain tuples. Four slices of
    five nodes with one drifting straggler each, a two-member and a
    one-member group (never scored), upstreams and stages with no peer group
    (trend-judged), and now and then direct evidence."""
    rng = np.random.default_rng(seed)
    slow = {f"s{g}": f"s{g}-n{int(rng.integers(5))}" for g in range(4)}
    out = []
    for t in range(ticks):
        obs = []
        for g in range(4):
            for i in range(5):
                name = f"s{g}-n{i}"
                value = float(rng.normal(1.0, 0.05))
                if name == slow[f"s{g}"] and (t // 6) % 2 == 1:
                    value *= float(rng.uniform(3.0, 9.0))
                obs.append(("node", name, "phase_latency_seconds", max(0.0, value), f"slice:s{g}", 0.25, "phase"))
        obs.append(("node", "pair-a", "link_rtt_ms", float(rng.uniform(0.1, 5.0)), "probe:pair", 0.05, "probe"))
        obs.append(("node", "pair-b", "link_rtt_ms", float(rng.uniform(0.1, 5.0)), "probe:pair", 0.05, "probe"))
        obs.append(("node", "alone", "link_rtt_ms", float(rng.uniform(0.1, 5.0)), "probe:alone", 0.05, "probe"))
        for u in ("ca", "cb"):
            age = float(rng.uniform(0.5, 1.5)) * (20.0 if u == "cb" and t >= 25 else 1.0)
            obs.append(("upstream", u, "watermark_age_seconds", age, None, 0.5, "freshness"))
        obs.append(("stage", "pipeline", "stage_mean_seconds",
                    float(rng.uniform(1e-3, 2e-3)) * (10.0 if t >= 30 else 1.0), None, 0.0, "trace"))
        evidence = {}
        if rng.random() < 0.3:
            evidence[("node", f"s{int(rng.integers(4))}-n{int(rng.integers(5))}")] = ["link probe: common endpoint"]
        out.append((obs, evidence))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_observations_same_verdicts(seed):
    ticks = observation_ticks(seed)
    runs = {}
    for pkg, (detector_cls, observation_cls, registry_cls, *_rest) in PACKAGES.items():
        metrics = registry_cls()
        detector = detector_cls(suspect_z=4.0, confirm_cycles=3, decay_cycles=2, metrics=metrics,
                                max_labeled_nodes=12)
        sent = []
        detector.sink = lambda payload, _sent=sent: _sent.append(
            {k: v for k, v in payload.items() if k != "event_timestamp"})
        summaries, snapshots, folds = [], [], []
        for obs, evidence in ticks:
            summaries.append(detector.tick([observation_cls(*o) for o in obs], evidence))
            snapshots.append(detector.snapshot())
            folds.append(detector.health())
        runs[pkg] = (summaries, snapshots, folds, sent, metrics.prometheus_text())
    assert runs["port"] == runs["ref"]
    summaries, snapshots, folds, sent, _text = runs["port"]
    assert any(s["escalated"] for s in summaries) and any(s["deescalated"] for s in summaries)
    assert sent and any(not f["healthy"] for f in folds)
    assert "upstream/cb" in snapshots[-1]["subjects"]


def report_ticks(seed, ticks=24):
    """Per tick: the synthetic reports drained by it (``(nodes, degraded,
    healthy_rtt)``), for two slices whose degraded node comes and goes."""
    rng = np.random.default_rng(seed)
    slices = [[f"a-{i}" for i in range(4)], [f"b-{i}" for i in range(6)]]
    out = []
    for t in range(ticks):
        drained = []
        for nodes in slices:
            if rng.random() < 0.8:
                degraded = nodes[int(rng.integers(len(nodes)))] if (t // 5) % 2 == 0 else None
                drained.append((nodes, degraded, float(rng.choice([0.1, 0.2, 2.0]))))
        out.append(drained)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_reports_same_verdicts(seed):
    ticks = report_ticks(seed)
    runs = {}
    for pkg, (_d, _o, registry_cls, plane_cls, config_cls, synthetic, _v) in PACKAGES.items():
        plane = plane_cls(config_cls(enabled=True, tick_seconds=60.0, suspect_z=4.0, confirm_cycles=2,
                                     decay_cycles=2, source_probe=True, source_phase=False,
                                     source_freshness=False, source_trace=False), metrics=registry_cls())
        states = []
        for drained in ticks:
            for nodes, degraded, rtt in drained:
                plane.observe_report(synthetic(nodes, degraded_node=degraded, healthy_rtt_ms=rtt))
            plane.tick()
            states.append((plane.snapshot(), plane.health()))
        runs[pkg] = states
    assert runs["port"] == runs["ref"]
    assert any(not fold["healthy"] for _snap, fold in runs["port"])


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now


@pytest.mark.parametrize("seed", [0, 1])
def test_same_pod_churn_same_phase_verdicts(monkeypatch, seed):
    """Pods of six 4-node slices and a few unsliced nodes start Pending, come
    up after seeded delays (one slow node per slice some of the time), get
    deleted and recreated; both planes read their own package's columnar
    view on one fake clock."""
    clock = FakeClock()
    fake_time = types.SimpleNamespace(monotonic=clock.monotonic, perf_counter=clock.perf_counter)
    monkeypatch.setattr(ref_plane_mod, "time", fake_time)
    monkeypatch.setattr(plane_mod, "time", fake_time)
    rng = np.random.default_rng(seed)
    nodes = {f"js-{s}": [f"n-{s}-{i}" for i in range(4)] for s in range(6)}
    loose = [f"loose-{i}" for i in range(3)]
    planes = {}
    for pkg, (_d, _o, registry_cls, plane_cls, config_cls, _syn, view_cls) in PACKAGES.items():
        view = view_cls(compact_horizon=1 << 16)
        metrics = registry_cls()
        plane = plane_cls(config_cls(enabled=True, tick_seconds=1.0, suspect_z=4.0, confirm_cycles=3,
                                     decay_cycles=2, source_probe=False, source_phase=True,
                                     source_freshness=False, source_trace=True), metrics=metrics, view=view)
        planes[pkg] = (view, plane, metrics)
    for slice_key, members in nodes.items():
        obj = {"kind": "slice", "key": slice_key, "slice": slice_key,
               "workers": [{"node": n, "name": f"{slice_key}-{i}"} for i, n in enumerate(members)]}
        for view, _p, _m in planes.values():
            view.apply("slice", slice_key, obj)
    all_nodes = [n for members in nodes.values() for n in members] + loose
    due = {}  # pod key -> tick it comes up
    generation = {n: 0 for n in all_nodes}
    history = {pkg: [] for pkg in planes}
    for t in range(30):
        steps = []
        for node in all_nodes:
            key = f"pod-{node}-{generation[node]}"
            if key not in due:
                slow = node.endswith("-2") and (t // 10) % 2 == 0
                due[key] = t + (int(rng.integers(6, 9)) if slow else int(rng.integers(0, 2)))
                steps.append(("pod", key, {"kind": "pod", "key": key, "phase": "Pending", "node": node}))
            elif due[key] == t:
                steps.append(("pod", key, {"kind": "pod", "key": key, "phase": "Running", "node": node}))
            elif due[key] < t and rng.random() < 0.1:
                steps.append(("pod", key, None))
                generation[node] += 1
        stage_values = [float(v) for v in rng.uniform(1e-3, 3e-3, size=4) * (8.0 if t > 20 else 1.0)]
        for pkg, (view, plane, metrics) in planes.items():
            view.apply_batch(steps)
            for v in stage_values:
                metrics.histogram("trace_stage_pipeline").record(v)
            plane.tick()
            history[pkg].append((plane.snapshot(), plane.health()))
        clock.now += 1.0
    assert history["port"] == history["ref"]
    subjects = history["port"][-1][0]["subjects"]
    assert "stage/pipeline" in subjects and any(k.startswith("node/n-") for k in subjects)
    assert any(not fold["healthy"] or fold["suspect"] for _snap, fold in history["port"])


def test_the_port_probe_report_reaches_the_detector(monkeypatch):
    """A cycle of the port's agent on the CPU: one rank, no link, healthy.
    The report is queued by ``observe_report`` and drained by the tick; it
    implicates nobody, so no subject leaves healthy."""
    monkeypatch.setenv("NODE_NAME", "cpu-node-0")
    agent = ProbeAgent(TpuConfig(probe_enabled=True, probe_payload_bytes=1 << 14, probe_matmul_size=64,
                                 probe_rtt_warn_ms=10_000.0, probe_hbm_bytes=1 << 22),
                       environment="test", sink=lambda n: None, expected_platform="cpu", device="cpu")
    plane = HealthPlane(HealthConfig(enabled=True, tick_seconds=60.0, source_probe=True, source_phase=False,
                                     source_freshness=False, source_trace=False), metrics=MetricsRegistry())
    agent.report_observer = plane.observe_report
    report = agent.run_once()
    assert report.healthy and report.hosts["0"]["node_name"] == "cpu-node-0"
    assert plane.reports_observed == 0  # queued, not yet drained
    t0 = time.monotonic()
    summary = plane.tick()
    assert time.monotonic() - t0 < 5.0
    assert plane.reports_observed == 1
    assert summary["escalated"] == [] and plane.health()["healthy"]
    assert all(s["state"] == HEALTHY for s in plane.snapshot()["subjects"].values())
