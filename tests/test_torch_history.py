"""The port's history plane held against the JAX package's.

The JAX package's ``tests/test_history.py`` runs again through the port
(``test_torch_replay``): framing, rotation and retention, crash recovery,
resume tokens that survive a restart, ``?at=`` reads, replay, and the
``/debug/history`` route. Then the same seeded delta stream goes into both
packages' ``FleetView`` over a ``HistoryStore`` with small segments (so the
WAL rotates and retention drops segments): both WALs must replay to the same
digest and rebuild the same state at every sampled rv, each package must read
the other's WAL alike, and a view restored from either recovery must serve
the same snapshot.
"""

import numpy as np
import pytest

from k8s_watcher_tpu.history import HistoryStore as RefStore
from k8s_watcher_tpu.history import journal_deltas as ref_journal_deltas
from k8s_watcher_tpu.history import reconstruct_at as ref_reconstruct_at
from k8s_watcher_tpu.history import replay_digest as ref_replay_digest
from k8s_watcher_tpu.serve.view import FleetView as RefView
from k8s_watcher_tpu_torch.history import HistoryStore, journal_deltas, reconstruct_at, replay_digest
from k8s_watcher_tpu_torch.history.wal import codec, encode_record
from k8s_watcher_tpu_torch.serve.view import FleetView
from test_torch_replay import replay, replayed_tests

_REWRITES = [
    # the port's status server binds every interface and takes no host
    ('MetricsRegistry(), Liveness(), host="127.0.0.1", port=0,\n            history=store.stats,',
     'MetricsRegistry(), Liveness(), port=0,\n            history=store.stats,'),
    ('StatusServer(MetricsRegistry(), Liveness(), host="127.0.0.1", port=0)',
     'StatusServer(MetricsRegistry(), Liveness(), port=0)'),
    ("k8s_watcher_tpu.metrics.server", "k8s_watcher_tpu_torch.status"),
    ("from k8s_watcher_tpu.config.schema import ServeConfig", "from k8s_watcher_tpu_torch.config import ServeConfig"),
    ("from k8s_watcher_tpu.config.schema import HistoryConfig\n",
     "from k8s_watcher_tpu_torch.config import HistoryConfig\n"),
    ("from k8s_watcher_tpu.config.schema import HistoryConfig, SchemaError",
     "from k8s_watcher_tpu_torch.config import ConfigError as SchemaError, HistoryConfig"),
    ("from k8s_watcher_tpu.config.schema import AppConfig, SchemaError",
     "from k8s_watcher_tpu_torch.config import AppConfig, ConfigError as SchemaError"),
]
globals().update(replayed_tests(replay("test_history.py", rewrites=_REWRITES)))

INSTANCE = "parity-wal-0"


def delta_stream(seed, n=1500, keys=120):
    """Seeded ``(kind, key, obj_or_None)`` steps: inserts, updates, identical
    re-upserts (no-ops), deletes of present and absent keys, slices."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        roll = rng.random()
        k = int(rng.integers(keys))
        if roll < 0.08:
            out.append(("slice", f"js-{k % 9}", {"kind": "slice", "key": f"js-{k % 9}",
                                                 "phase": str(rng.choice(["Pending", "Ready", "Degraded"])),
                                                 "workers": [{"node": f"n-{k % 13}", "up": bool(k % 2)}]}))
        elif roll < 0.2:
            out.append(("pod", f"ns/p-{k}", None))
        else:
            out.append(("pod", f"ns/p-{k}", {"kind": "pod", "key": f"ns/p-{k}", "name": f"p-{k}",
                                              "namespace": "ns", "node": f"n-{k % 13}",
                                              "phase": str(rng.choice(["Pending", "Running", "Failed"])),
                                              "ready": bool(rng.random() < 0.6),
                                              "pod_resource_version": str(int(rng.integers(1 << 20)))}))
    return out


def write_wal(pkg, directory, steps, *, columnar, batch):
    store_cls, view_cls = (RefStore, RefView) if pkg == "ref" else (HistoryStore, FleetView)
    store = store_cls(directory, fsync="never", segment_max_bytes=4096, retain_segments=4)
    store.recover()
    view = view_cls(compact_horizon=64, columnar=columnar)
    view.instance = INSTANCE
    store.open(view.instance)
    view.attach_history(store)
    # one writer drain per chunk, so the segment layout follows the bytes
    # alone and both packages rotate at the same rvs
    for i in range(0, len(steps), 37):
        if batch:
            view.apply_batch(steps[i:i + 37])
        else:
            for kind, key, obj in steps[i:i + 37]:
                view.apply(kind, key, obj)
        assert store.flush(10.0)
    rv = view.rv
    stats = store.stats()
    store.close()
    return rv, stats


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("columnar", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_same_stream_same_digest_and_states(tmp_path, seed, columnar, batch):
    steps = delta_stream(seed)
    ref_rv, ref_stats = write_wal("ref", tmp_path / "ref", steps, columnar=columnar, batch=batch)
    rv, stats = write_wal("port", tmp_path / "port", steps, columnar=columnar, batch=batch)
    layout = [(g["first_rv"], g["last_rv"], g["records"]) for g in stats["segments"]]
    assert rv == ref_rv and len(layout) == 4
    assert layout == [(g["first_rv"], g["last_rv"], g["records"]) for g in ref_stats["segments"]]
    assert stats["retention_floor_rv"] == ref_stats["retention_floor_rv"] > 0
    want = ref_replay_digest(tmp_path / "ref")
    assert replay_digest(tmp_path / "port") == want and want["rv_mismatches"] == 0
    # each package reads the other's WAL alike
    assert replay_digest(tmp_path / "ref") == want == ref_replay_digest(tmp_path / "port")
    floor = stats["retention_floor_rv"]
    rng = np.random.default_rng(seed + 100)
    for at in sorted({floor, rv, *map(int, rng.integers(floor, rv + 1, size=6))}):
        got = reconstruct_at(tmp_path / "port", at)
        assert got == ref_reconstruct_at(tmp_path / "ref", at) and got[0] == "ok"
        assert got == ref_reconstruct_at(tmp_path / "port", at)
    assert reconstruct_at(tmp_path / "port", floor - 1)[0] == ref_reconstruct_at(tmp_path / "ref", floor - 1)[0]
    assert reconstruct_at(tmp_path / "port", rv + 1) == ref_reconstruct_at(tmp_path / "ref", rv + 1)


@pytest.mark.parametrize("seed", [2, 3])
def test_restored_views_serve_the_same_snapshot_and_journal(tmp_path, seed):
    steps = delta_stream(seed, n=600)
    write_wal("ref", tmp_path / "ref", steps, columnar=True, batch=True)
    write_wal("port", tmp_path / "port", steps, columnar=True, batch=True)
    views = {}
    for pkg, store_cls, view_cls, to_deltas in (("ref", RefStore, RefView, ref_journal_deltas),
                                               ("port", HistoryStore, FleetView, journal_deltas)):
        store = store_cls(tmp_path / pkg, fsync="never", segment_max_bytes=4096, retain_segments=4)
        recovered = store.recover(journal_limit=64)
        assert recovered.clean and recovered.instance == INSTANCE
        view = view_cls(compact_horizon=64)
        view.restore(instance=recovered.instance, rv=recovered.rv, objects=recovered.objects,
                     journal=to_deltas(recovered.journal))
        views[pkg] = view
    ref, port = views["ref"], views["port"]
    assert port.snapshot_bytes() == ref.snapshot_bytes()
    assert port.oldest_rv == ref.oldest_rv and port.rv == ref.rv
    got, want = port.read_frames_since(port.oldest_rv), ref.read_frames_since(ref.oldest_rv)
    assert got.frames == want.frames and got.to_rv == want.to_rv


def test_the_wal_codec_is_named():
    """``codec()`` names what the records are: msgpack maps, or JSON text."""
    record = encode_record({"t": "open", "wall": 1.0})
    assert codec() == ("json" if record.startswith(b"{") else "msgpack")


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_a_snapshot_past_the_segment_cap_rotates_on_every_drain(tmp_path, pkg):
    """Both packages rotate once a segment's bytes, its opening snapshot's
    included, reach ``segment_max_bytes``: when the snapshot alone outgrows
    the cap, every writer drain opens a new segment with a full snapshot.
    A federator's global view outgrows production's 16 MiB this way, so
    ``chip_smoke.py``'s phase 12 gives the federator a larger cap
    (``ROADMAP.md`` section C)."""
    store_cls, view_cls = (RefStore, RefView) if pkg == "ref" else (HistoryStore, FleetView)
    store = store_cls(tmp_path / pkg, fsync="never", segment_max_bytes=4096, retain_segments=64)
    store.recover()
    view = view_cls()
    view.instance = INSTANCE
    store.open(view.instance)
    view.attach_history(store)
    view.apply_batch([step for step in delta_stream(3, n=400) if step[2] is not None])
    assert store.flush(10.0)
    view.apply("pod", "ns/p-0", {"kind": "pod", "key": "ns/p-0", "seq": -1})
    assert store.flush(10.0)
    before = store.stats()["segments"]
    assert before[-1]["records"] <= 2 and before[-1]["bytes"] > 4096  # a snapshot past the cap opens it
    for i in range(8):
        view.apply("pod", "ns/p-0", {"kind": "pod", "key": "ns/p-0", "seq": i})
        assert store.flush(10.0)
    after = store.stats()["segments"]
    store.close()
    assert len(after) - len(before) == 8
