"""The port's checkpoint store held against the JAX package's.

The same seeded sequence of ``put``s, resourceVersion updates and flushes
goes to a ``CheckpointStore`` of each package, each in its own directory,
with ``known_pods`` and ``phases`` journaled as the watcher journals them
(and small compaction thresholds, so compaction runs too). After every flush
the two directories must hold byte-identical files under the same names.
Then each package loads the directory the other wrote: the state carried
across a restart must read back the same.
"""

import numpy as np
import pytest

from k8s_watcher_tpu.state.checkpoint import CheckpointStore as RefStore
from k8s_watcher_tpu_torch.state.checkpoint import CheckpointStore

STORES = {"ref": RefStore, "port": CheckpointStore}
JOURNALED = ("known_pods", "phases")
KEYS = ("resource_version", "slices") + JOURNALED


def open_store(pkg, directory, **opts):
    store = STORES[pkg](directory / "ck.json", interval_seconds=3600.0)
    for key in JOURNALED:
        store.attach_journaled_map(key, **opts)
    return store


def operations(seed, n=60):
    """A seeded script: ("rv", str) | ("put", key, value, changed) | ("flush",)."""
    rng = np.random.default_rng(seed)
    known, phases, ops = {}, {}, []
    for step in range(n):
        roll = rng.random()
        if roll < 0.25:
            ops.append(("rv", str(1000 + step)))
        elif roll < 0.55:
            changed = set()
            for _ in range(int(rng.integers(1, 6))):
                uid = f"uid-{int(rng.integers(40))}"
                changed.add(uid)
                if rng.random() < 0.25:
                    known.pop(uid, None)
                else:
                    known[uid] = {"metadata": {"name": uid[4:], "namespace": "default", "uid": uid,
                                               "resourceVersion": str(step)},
                                  "spec": {"nodeName": f"n{int(rng.integers(4))}"},
                                  "status": {"phase": str(rng.choice(["Pending", "Running"]))}}
            # sometimes no hint at all: the store must rewrite everything
            ops.append(("put", "known_pods", dict(known), changed if rng.random() < 0.8 else None))
        elif roll < 0.75:
            uid = f"uid-{int(rng.integers(40))}"
            if rng.random() < 0.3:
                phases.pop(uid, None)
            else:
                phases[uid] = str(rng.choice(["Pending", "Running", "Failed"]))
            ops.append(("put", "phases", dict(phases), {uid}))
        elif roll < 0.85:
            ops.append(("put", "slices", {f"ns/js{int(rng.integers(3))}": {
                "phase": str(rng.choice(["Forming", "Ready", "Degraded"])), "ever_ready": bool(rng.random() < 0.5)}},
                None))
        else:
            ops.append(("flush",))
    ops.append(("flush",))
    return ops


def apply(store, op):
    if op[0] == "rv":
        store.update_resource_version(op[1])
    elif op[0] == "put":
        store.put(op[1], op[2], changed_keys=op[3])
    else:
        store.flush()


def files(directory):
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir()) if p.is_file()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("compact", [{}, {"min_compact_entries": 4, "compact_slice_entries": 3}])
def test_same_puts_give_byte_identical_files(tmp_path, seed, compact):
    dirs = {pkg: tmp_path / pkg for pkg in STORES}
    for d in dirs.values():
        d.mkdir()
    stores = {pkg: open_store(pkg, dirs[pkg], **compact) for pkg in STORES}
    flushes = 0
    for op in operations(seed):
        for store in stores.values():
            apply(store, op)
        if op[0] == "flush":
            flushes += 1
            assert files(dirs["port"]) == files(dirs["ref"])
    assert flushes >= 2
    names = set(files(dirs["port"]))
    assert {"ck.json", "ck.json.known_pods.journal.jsonl"} <= names
    if compact:
        assert "ck.json.known_pods.base.json" in names


@pytest.mark.parametrize("writer, reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("seed", [3, 4])
def test_state_carries_across_packages(tmp_path, writer, reader, seed):
    store = open_store(writer, tmp_path, min_compact_entries=6)
    for op in operations(seed):
        apply(store, op)
    want = {key: store.get(key) for key in KEYS}
    want["resource_version"] = store.resource_version()
    loaded = open_store(reader, tmp_path, min_compact_entries=6)
    got = {key: loaded.get(key) for key in KEYS}
    got["resource_version"] = loaded.resource_version()
    assert got == want
    assert got["known_pods"] is not None and got["resource_version"] is not None


def test_legacy_single_file_section_migrates_alike(tmp_path):
    """A checkpoint whose known_pods still sit in the single file migrates
    into the journaled store the same way in both packages."""
    out = {}
    for pkg in STORES:
        d = tmp_path / pkg
        d.mkdir()
        plain = STORES[pkg](d / "ck.json", interval_seconds=0.0)
        plain.put("known_pods", {"u1": {"metadata": {"uid": "u1"}}, "u2": ["p", "ns", "Running"]})
        plain.flush()
        store = open_store(pkg, d)
        store.flush()
        out[pkg] = (files(d), store.get("known_pods"))
    assert out["port"] == out["ref"]
