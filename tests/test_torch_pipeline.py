"""The port's event pipeline and slice tracker held against the JAX package's.

Seeded event corpora (pods built with the JAX package's ``build_pod``) go
through both ``EventPipeline``s with recording sinks, at batch sizes 1 and
128, under the ``development`` and ``production`` rules and for the TPU and
the GPU resource key. The notification lists (kind and payload, without the
``event_timestamp`` wall stamp), the per-event results, the ``PhaseTracker``
and ``SliceTracker`` snapshots, ``debug_snapshot`` and the pipeline counters
must be identical. ``tests/test_pipeline.py`` and ``tests/test_slices.py``
are replayed through the port as well.
"""

import copy
import dataclasses

import numpy as np
import pytest

from conftest import CONFIG_DIR
from k8s_watcher_tpu.config.loader import load_config as ref_load_config
from k8s_watcher_tpu.pipeline import filters as ref_filters
from k8s_watcher_tpu.pipeline.phase import PhaseTracker as RefPhaseTracker
from k8s_watcher_tpu.pipeline.pipeline import EventPipeline as RefPipeline
from k8s_watcher_tpu.slices.tracker import SliceTracker as RefSliceTracker
from k8s_watcher_tpu.watch.fake import build_pod
from k8s_watcher_tpu.watch.source import WatchEvent as RefWatchEvent
from k8s_watcher_tpu_torch.pipeline import filters
from k8s_watcher_tpu_torch.pipeline.phase import PhaseTracker
from k8s_watcher_tpu_torch.pipeline.pipeline import EventPipeline
from k8s_watcher_tpu_torch.slices.tracker import SliceTracker
from k8s_watcher_tpu_torch.watch.source import WatchEvent
from test_torch_replay import replay, replayed_tests

NAMESPACES = ("default", "production", "monitoring", "kube-system", "batch")
RESOURCE_KEYS = {"tpu": "google.com/tpu", "gpu": "nvidia.com/gpu"}
PACKAGES = {
    "ref": (RefPipeline, RefPhaseTracker, RefSliceTracker, ref_filters, RefWatchEvent),
    "port": (EventPipeline, PhaseTracker, SliceTracker, filters, WatchEvent),
}


def _pod(rng, name, uid, ns, backend, *, chips, phase, ready, restarts=0, slice_of=None, reason=None):
    """One pod in REST shape; ``slice_of = (jobset, worker index)``."""
    fields = {}
    if slice_of is not None:
        fields = {"jobset.sigs.k8s.io/jobset-name": slice_of[0],
                  "jobset.sigs.k8s.io/replicatedjob-name": "workers",
                  "apps.kubernetes.io/pod-index": slice_of[1]}
    containers = None
    tpu_chips = 0
    if chips and backend == "tpu":
        tpu_chips = chips
    elif chips:
        containers = [{"name": "main", "resources": {"requests": {RESOURCE_KEYS["gpu"]: str(chips)},
                                                     "limits": {RESOURCE_KEYS["gpu"]: str(chips)}}},
                      {"name": "sidecar", "resources": {"requests": {"cpu": "100m"}}}]
    statuses = [{"name": "main", "ready": ready, "restartCount": restarts}]
    if containers is not None:
        statuses.append({"name": "sidecar", "ready": ready, "restartCount": 0})
    return build_pod(
        name, ns, uid=uid, phase=phase, tpu_chips=tpu_chips, containers=containers,
        tpu_topology="2x2x2" if tpu_chips and slice_of is not None else None,
        gke_slice_fields=fields or None, node_name=f"node-{int(rng.integers(16))}",
        container_statuses=statuses, status_reason=reason,
    )


def corpus(seed, backend, *, n_slices=6, workers=2, n_plain=24, n_events=400):
    """A seeded event script: ``(type, pod, legacy_tombstone)`` triples.

    Slice workers (4 chips each, so a ``2x2x2`` TPU slice expects 2), lone
    accelerator pods and plain pods over five namespaces, then random phase,
    readiness and restart churn, preemptions, deletions with re-creation,
    bookmarks, error events and a legacy tombstone."""
    rng = np.random.default_rng(seed)
    live = {}
    for s in range(n_slices):
        ns = NAMESPACES[s % 4]
        for w in range(workers):
            uid = f"uid-js{s}-{w}"
            live[uid] = dict(name=f"js{s}-w{w}", ns=ns, chips=4, slice_of=(f"js{s}", w))
    for p in range(n_plain):
        uid = f"uid-p{p}"
        live[uid] = dict(name=f"p{p}", ns=NAMESPACES[int(rng.integers(5))],
                         chips=int(rng.choice([0, 0, 0, 8])), slice_of=None)
    state = {uid: dict(phase="Pending", ready=False, restarts=0) for uid in live}
    events = []

    def emit(kind, uid, reason=None):
        spec, st = live[uid], state[uid]
        pod = _pod(rng, spec["name"], uid, spec["ns"], backend, chips=spec["chips"], phase=st["phase"],
                   ready=st["ready"], restarts=st["restarts"], slice_of=spec["slice_of"], reason=reason)
        events.append((kind, pod, False))

    for uid in list(live):
        emit("ADDED", uid)
    generation = 0
    for _ in range(n_events):
        roll = rng.random()
        if roll < 0.03:
            events.append(("BOOKMARK", {"metadata": {"resourceVersion": str(len(events))}}, False))
            continue
        if roll < 0.05:
            events.append(("ERROR", {"metadata": {}}, False))
            continue
        uid = list(live)[int(rng.integers(len(live)))]
        st = state[uid]
        if roll < 0.10:
            reason = "Preempted" if rng.random() < 0.5 else None
            emit("DELETED", uid, reason)
            spec = live.pop(uid)
            state.pop(uid)
            generation += 1
            new_uid = f"{uid}-g{generation}"
            live[new_uid] = spec
            state[new_uid] = dict(phase="Pending", ready=False, restarts=0)
            emit("ADDED", new_uid)
            continue
        if roll < 0.45:
            st["phase"] = str(rng.choice(["Pending", "Running", "Running", "Running", "Failed", "Succeeded"]))
        elif roll < 0.75:
            st["ready"] = not st["ready"]
        elif roll < 0.85:
            st["restarts"] += 1
        emit("MODIFIED", uid)
    # a legacy-format tombstone: no resource spec, flagged past the filter
    events.append(("DELETED", {"metadata": {"name": "old", "namespace": "default", "uid": "uid-legacy"},
                               "spec": {}, "status": {"phase": "Running"}}, True))
    return events


def run_pipeline(pkg, events, environment, backend, batch):
    pipeline_cls, phase_cls, slice_cls, flt, event_cls = PACKAGES[pkg]
    config = ref_load_config(environment, CONFIG_DIR, env={})
    key = RESOURCE_KEYS[backend]
    sent = []
    slices = slice_cls(environment, resource_key=key)
    phases = phase_cls()
    pipe = pipeline_cls(
        environment=environment, sink=sent.append,
        namespace_filter=flt.NamespaceFilter(config.watcher.namespaces),
        resource_filter=flt.TpuResourceFilter(key),
        critical_gate=flt.CriticalEventGate(environment, config.watcher.critical_events_only),
        phase_tracker=phases, slice_tracker=slices, resource_key=key,
    )
    stream = [event_cls(type=t, pod=copy.deepcopy(pod), resource_version=str(i), legacy_tombstone=legacy)
              for i, (t, pod, legacy) in enumerate(events)]
    results = []
    for i in range(0, len(stream), batch):
        results.extend(pipe.process_batch(stream[i:i + batch]))
    notifications = []
    for n in sent:
        payload = dict(n.payload)
        payload.pop("event_timestamp", None)
        notifications.append((n.kind, payload, n.trace))
    counters = {k: v["count"] for k, v in pipe.metrics.dump().items()}
    return {
        "notifications": notifications,
        "results": [(r.notified, r.reason) for r in results],
        "phases": phases.snapshot(),
        "slices": slices.snapshot(),
        "debug": slices.debug_snapshot(),
        "counters": counters,
    }


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("environment", ["development", "production"])
@pytest.mark.parametrize("backend", ["tpu", "gpu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_same_notifications_and_state(seed, backend, environment, batch):
    events = corpus(seed, backend)
    want = run_pipeline("ref", events, environment, backend, batch)
    got = run_pipeline("port", events, environment, backend, batch)
    assert got == want
    # the corpus reaches every stage: notifications of both kinds, slices
    # tracked, and drops by each filter
    kinds = {kind for kind, _, _ in got["notifications"]}
    assert "slice" in kinds and got["debug"]
    reasons = {reason for _, reason in got["results"]}
    assert {"resource_filter", "bookmark", "error_event"} <= reasons
    if environment == "production":
        assert {"namespace_filter", "critical_gate"} <= reasons


def test_restore_then_continue_alike():
    """Trackers restored from one package's snapshots continue alike in both."""
    events = corpus(3, "tpu")
    half = len(events) // 2
    first = run_pipeline("ref", events[:half], "production", "tpu", 128)
    out = {}
    for pkg in ("ref", "port"):
        pipeline_cls, phase_cls, slice_cls, flt, event_cls = PACKAGES[pkg]
        phases, slices, sent = phase_cls(), slice_cls("production"), []
        phases.restore(dict(first["phases"]))
        slices.restore(copy.deepcopy(first["slices"]))
        pipe = pipeline_cls(environment="production", sink=sent.append, phase_tracker=phases, slice_tracker=slices,
                            critical_gate=flt.CriticalEventGate("production", True))
        stream = [event_cls(type=t, pod=copy.deepcopy(p), legacy_tombstone=lg) for t, p, lg in events[half:]]
        pipe.process_batch(stream)
        out[pkg] = ([(n.kind, {k: v for k, v in n.payload.items() if k != "event_timestamp"}) for n in sent],
                    phases.snapshot(), slices.snapshot(), slices.debug_snapshot())
    assert out["port"] == out["ref"]


def test_tracker_config_of_the_app_matches():
    """The trackers the app builds from a GPU config are configured alike."""
    config = ref_load_config("production", CONFIG_DIR, env={})
    tpu = dataclasses.replace(config.tpu, backend="gpu", resource_key="nvidia.com/gpu")
    ref = RefSliceTracker("production", resource_key=tpu.resource_key, topology_label=tpu.topology_label,
                          accelerator_label=tpu.accelerator_label)
    port = SliceTracker("production", resource_key=tpu.resource_key, topology_label=tpu.topology_label,
                        accelerator_label=tpu.accelerator_label)
    assert (port.environment, port.resource_key, port.topology_label, port.accelerator_label) == (
        ref.environment, ref.resource_key, ref.topology_label, ref.accelerator_label)


# the reference's pipeline and slice scenarios, run through the port (its
# churn from the port's own ChurnGenerator, faults/injection.py)
globals().update(replayed_tests(replay("test_pipeline.py")))
globals().update(replayed_tests(replay("test_slices.py")))
