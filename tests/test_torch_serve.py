"""The port's serving plane held against the JAX package's.

The JAX package's ``tests/test_serve.py`` and ``tests/test_columnar_view.py``
run again through the port whole (``test_torch_replay``). Then the same seeded churn goes into both
packages' ``FleetView`` (the columnar core and the dict core) and through both
pipelines' publish hook: the snapshot bodies and the wire frames must be
byte-equal in both codecs. Last, the JAX package's ``FleetClient`` and
``ResumeLoop`` read the port's ``/serve/fleet`` (long-poll and stream) and fold
to the port's snapshot: the wire is compatible both ways.
"""

import json
import random

import msgpack
import pytest

from k8s_watcher_tpu.federate.client import FleetClient, ResumeLoop, apply_wire_deltas, model_from_objects
from k8s_watcher_tpu.pipeline.pipeline import EventPipeline as RefPipeline
from k8s_watcher_tpu.serve.server import ServeServer as RefServer
from k8s_watcher_tpu.serve.view import FleetView as RefView
from k8s_watcher_tpu.serve.view import SubscriptionHub as RefHub
from k8s_watcher_tpu.watch.fake import build_pod as ref_build_pod
from k8s_watcher_tpu.watch.source import EventType as RefEventType
from k8s_watcher_tpu.watch.source import WatchEvent as RefWatchEvent
from k8s_watcher_tpu_torch.pipeline.pipeline import EventPipeline
from k8s_watcher_tpu_torch.serve import CODEC_JSON, CODEC_MSGPACK, FleetView, ServeServer, SubscriptionHub
from k8s_watcher_tpu_torch.watch.fake import build_pod
from k8s_watcher_tpu_torch.watch.source import EventType, WatchEvent

from test_torch_replay import replay, replayed_tests

_SCHEMA = [("from k8s_watcher_tpu.config.schema import", "from k8s_watcher_tpu_torch.config import")]

_serve = replay("test_serve.py",
                rewrites=_SCHEMA + [("SchemaError, ServeConfig", "ConfigError as SchemaError, ServeConfig")])
serve_http = _serve.serve_http  # the replayed HTTP tests' fixture
globals().update(replayed_tests(_serve))
globals().update(replayed_tests(replay("test_columnar_view.py", rewrites=_SCHEMA + [
    ("    SchemaError,\n", "    ConfigError as SchemaError,\n"),
])))

INSTANCE = "parity-view"


def _views(columnar):
    ref, port = RefView(compact_horizon=1 << 20, columnar=columnar), FleetView(compact_horizon=1 << 20,
                                                                                columnar=columnar)
    ref.instance = port.instance = INSTANCE
    return ref, port


def _churn(seed, n=1500):
    """(kind, key, obj_or_None) steps: inserts, updates, identical and
    reordered re-upserts, deletes of present and absent keys, slice churn."""
    rng = random.Random(seed)
    live, steps = {}, []
    for i in range(n):
        op = rng.random()
        if op < 0.55 or not live:
            key = f"ns-{i % 5}/pod-{i:05d}"
            obj = {"kind": "pod", "key": key, "name": key[6:], "namespace": key[:4],
                   "phase": rng.choice(["Pending", "Running", "Failed"]), "ready": rng.random() < 0.7,
                   "node": f"node-{rng.randrange(40)}" if rng.random() < 0.9 else None,
                   "pod_resource_version": str(i)}
            live[key] = obj
            steps.append(("pod", key, obj))
        elif op < 0.70:
            key = rng.choice(sorted(live))
            obj = dict(live[key], phase=rng.choice(["Running", "Succeeded"]), pod_resource_version=str(i))
            live[key] = obj
            steps.append(("pod", key, obj))
        elif op < 0.78:
            key = rng.choice(sorted(live))
            steps.append(("pod", key, {k: live[key][k] for k in reversed(list(live[key]))}))
        elif op < 0.88:
            key = rng.choice(sorted(live))
            del live[key]
            steps.append(("pod", key, None))
        elif op < 0.90:
            steps.append(("pod", f"absent-{i}", None))
        else:
            s = rng.randrange(12)
            obj = {"kind": "slice", "key": f"default/js-{s}", "ready_workers": rng.randrange(5), "rev": i}
            steps.append(("slice", obj["key"], None if rng.random() < 0.15 else obj))
    return steps


def _assert_same_wire(ref, port):
    assert port.rv == ref.rv and port.snapshot() == ref.snapshot()
    for codec in (CODEC_JSON, CODEC_MSGPACK):
        assert port.snapshot_bytes(codec) == ref.snapshot_bytes(codec)
        for fresh in (False, True):
            got = port.read_frames_since(0, max_deltas=1 << 30, codec=codec, fresh=fresh)
            want = ref.read_frames_since(0, max_deltas=1 << 30, codec=codec, fresh=fresh)
            assert [d.rv for d in got.deltas] == [d.rv for d in want.deltas]
            if fresh:  # the stamps are each view's own clock: compare the rest
                strip = (lambda f: {k: v for k, v in (json.loads(f[f.index(b"\n") + 1:-2]) if codec == CODEC_JSON
                                                      else msgpack.unpackb(f[f.index(b"\n") + 1:-2])).items()
                                    if k != "ts"})
                assert [strip(f) for f in got.frames] == [strip(f) for f in want.frames]
            else:
                assert got.frames == want.frames


@pytest.mark.parametrize("columnar", [True, False])
@pytest.mark.parametrize("seed", [3, 17])
def test_same_churn_same_bodies_and_frames(seed, columnar):
    ref, port = _views(columnar)
    steps = _churn(seed)
    for kind, key, obj in steps[:1000]:
        assert port.apply(kind, key, obj) == ref.apply(kind, key, obj)
    # the batched fold mints the same deltas as one apply per step
    assert port.apply_batch(steps[1000:]) == ref.apply_batch(steps[1000:])
    _assert_same_wire(ref, port)
    # paged and compacted pulls pick the same deltas
    for max_deltas, limit in ((16, None), (1 << 30, 7), (8, 3)):
        got = port.read_since(100, max_deltas=max_deltas, limit=limit)
        want = ref.read_since(100, max_deltas=max_deltas, limit=limit)
        assert (got.status, got.to_rv, got.compacted, [d.rv for d in got.deltas]) == \
            (want.status, want.to_rv, want.compacted, [d.rv for d in want.deltas])
    assert port.snapshot_tables()[1] == ref.snapshot_tables()[1]


def _events(pkg, seed):
    rng = random.Random(seed)
    make, wev, etype = (ref_build_pod, RefWatchEvent, RefEventType) if pkg == "ref" else \
        (build_pod, WatchEvent, EventType)
    events, phases = [], {}
    for i in range(300):
        n = rng.randrange(40)
        name = f"p{n}"
        if name in phases and rng.random() < 0.1:
            events.append(wev(etype.DELETED, make(name, uid=f"uid-{n}", phase=phases.pop(name), tpu_chips=4)))
            continue
        phase = rng.choice(["Pending", "Running", "Running", "Failed"])
        kind = etype.MODIFIED if name in phases else etype.ADDED
        phases[name] = phase
        chips = 4 if n % 7 else 0  # every seventh pod asks for no accelerator
        namespace = "batch" if n % 11 == 0 else "default"
        events.append(wev(kind, make(name, uid=f"uid-{n}", phase=phase, tpu_chips=chips,
                                     node_name=f"node-{rng.randrange(9)}", namespace=namespace)))
    return events


@pytest.mark.parametrize("environment", ["development", "production"])
def test_pipeline_publish_hook_folds_alike(environment):
    ref, port = _views(True)
    ref_pipe = RefPipeline(environment=environment, sink=lambda n: None, view=ref)
    port_pipe = EventPipeline(environment=environment, sink=lambda n: None, view=port)
    ref_events, port_events = _events("ref", 5), _events("port", 5)
    for i in range(0, len(ref_events), 16):
        ref_pipe.process_batch(ref_events[i:i + 16])
        port_pipe.process_batch(port_events[i:i + 16])
    assert port.rv == ref.rv > 0
    assert port.snapshot_bytes() == ref.snapshot_bytes()
    assert port.read_frames_since(0, max_deltas=1 << 30).frames == ref.read_frames_since(0, max_deltas=1 << 30).frames


@pytest.fixture
def port_server():
    view = FleetView(compact_horizon=64)
    hub = SubscriptionHub(view, max_subscribers=8, queue_depth=16)
    server = ServeServer(view, hub, host="127.0.0.1", port=0, auth_token="tok").start()
    try:
        yield view, f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()


@pytest.mark.parametrize("codec", ["json", "msgpack"])
def test_reference_client_folds_the_port_wire(port_server, codec):
    view, base = port_server
    steps = _churn(11, n=400)
    for kind, key, obj in steps[:150]:
        view.apply(kind, key, obj)
    loop = ResumeLoop(FleetClient(base, token="tok", codec=codec))
    loop.start()
    for start in range(150, 400, 50):
        for kind, key, obj in steps[start:start + 50]:
            view.apply(kind, key, obj)
        loop.poll(timeout=0.2)
    loop.drain()
    rv, objects = view.snapshot()
    assert loop.rv == rv and loop.model == model_from_objects(objects)
    assert loop.checker.clean and loop.client.active_codec == codec
    # and a ?watch=1 stream from a fresh snapshot's rv
    client = FleetClient(base, token="tok", codec=codec)
    snap = client.snapshot()
    model = model_from_objects(snap.objects)
    view.apply("pod", "late", {"kind": "pod", "key": "late", "phase": "Running"})
    for batch in client.watch_batches(snap.rv, view=snap.view, window_seconds=0.5):
        apply_wire_deltas(model, [f for f in batch if f["type"] in ("UPSERT", "DELETE")])
    assert model == model_from_objects(view.snapshot()[1])


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_time_travel_needs_history_in_both(pkg):
    view = (RefView if pkg == "ref" else FleetView)()
    server = (RefServer if pkg == "ref" else ServeServer)(
        view, (RefHub if pkg == "ref" else SubscriptionHub)(view), host="127.0.0.1", port=0).start()
    try:
        import urllib.error
        import urllib.request

        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{server.port}/serve/fleet?at=5", timeout=5)
        assert err.value.code == 400 and "history" in json.loads(err.value.read())["error"]
    finally:
        server.stop()
