"""The port's offline WAL replay (``python -m
k8s_watcher_tpu_torch.history_replay``) held against the JAX package's
``scripts/history_replay.py``.

One seeded fleet (JobSet slices of 1-8 workers over three clusters and
shared nodes, some workers down) churns through a ``FleetView`` with a
``HistoryStore`` behind it, once in each package: a WAL written by the port
and one written by the JAX package. On each WAL the reference script runs
as a subprocess under ``JAX_PLATFORMS=cpu`` and the port's CLI runs in
process with ``--device cpu``; both must print the same JSON for a plain
replay, ``--at`` a mid-capture rv, ``--verify``, ``--out`` (the written
snapshots byte-equal) and ``--analytics --scenarios`` with a
``drain_cluster`` and a ``cordon_nodes``. Counts and verdicts must be equal;
a float field may differ by 1e-6 relative. On the same bad inputs both exit
with the same code (2 for a missing directory, ``--scenarios`` without
``--analytics`` and bad scenarios; 1 for a capture whose slice counters
disagree with their workers).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from k8s_watcher_tpu.history import HistoryStore as RefHistoryStore
from k8s_watcher_tpu.serve.view import FleetView as RefFleetView
from k8s_watcher_tpu_torch import history_replay
from k8s_watcher_tpu_torch.history import HistoryStore
from k8s_watcher_tpu_torch.serve import FleetView

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "history_replay.py"
CLUSTERS = (None, "east", "west")
SCENARIOS = json.dumps([
    {"kind": "drain_cluster", "cluster": "east"},
    {"kind": "cordon_nodes", "nodes": ["n-3", "n-17", "n-40", "ghost-node"]},
])


def _slice(s, workers, cluster, expected, chips):
    prefix = f"{cluster}/" if cluster else ""
    key = f"{prefix}default/slice-{s}"
    ready = sum(1 for w in workers if w["phase"] == "Running" and w["ready"] and w["node_ready"])
    obj = {"kind": "slice", "key": key, "slice": key, "expected_workers": expected,
           "observed_workers": len(workers), "ready_workers": ready, "chips_per_worker": chips,
           "phase": "Ready" if expected is None or ready == expected else "Degraded", "workers": workers}
    if cluster:
        obj["cluster"] = cluster
    return key, obj


def _pod(w, cluster):
    prefix = f"{cluster}/" if cluster else ""
    obj = {"kind": "pod", "key": f"{prefix}{w['name']}", "phase": w["phase"], "ready": w["ready"], "node": w["node"]}
    if cluster:
        obj["cluster"] = cluster
    return obj["key"], obj


def seeded_deltas(seed=7, n_slices=40, churn=120):
    """``(kind, key, object or None)`` deltas: a seeded fleet, then churn
    (a worker fails or runs again, its slice follows; now and then a pod
    is deleted and its worker replaced under a new name)."""
    rng = np.random.default_rng(seed)
    fleet, deltas = {}, []
    for s in range(n_slices):
        cluster = CLUSTERS[s % len(CLUSTERS)]
        n = int(rng.integers(1, 9))
        up = rng.random(n) < 0.85
        workers = [{"name": f"s{s}-w{i}", "worker_index": i, "phase": "Running" if up[i] else "Pending",
                    "ready": bool(up[i]), "restarts": 0, "node": f"n-{(s * 3 + i) % 61}",
                    "node_ready": bool(rng.random() < 0.97)} for i in range(n)]
        fleet[s] = (cluster, None if s % 5 == 0 else n, int(rng.integers(1, 9)), workers)
        for w in workers:
            deltas.append(("pod", *_pod(w, cluster)))
        deltas.append(("slice", *_slice(s, workers, *fleet[s][:3])))
    for step in range(churn):
        s = int(rng.integers(0, n_slices))
        cluster, expected, chips, workers = fleet[s]
        i = int(rng.integers(0, len(workers)))
        w = dict(workers[i])
        if step % 9 == 8:  # the pod is deleted, its worker rescheduled under a new name
            deltas.append(("pod", _pod(w, cluster)[0], None))
            w.update(name=f"{w['name']}-r{step}", phase="Pending", ready=False, node=f"n-{int(rng.integers(0, 61))}")
        else:
            running = bool(rng.random() < 0.8)
            w.update(phase="Running" if running else "Failed", ready=running)
        workers[i] = w
        deltas.append(("pod", *_pod(w, cluster)))
        deltas.append(("slice", *_slice(s, workers, cluster, expected, chips)))
    return deltas


def write_wal(directory, view_cls, store_cls, deltas):
    view = view_cls()
    store = store_cls(str(directory), fsync="never")
    store.recover()
    store.open(view.instance)
    view.attach_history(store)
    for kind, key, obj in deltas:
        view.apply(kind, key, obj)
    store.close()
    return directory


@pytest.fixture(scope="module")
def wals(tmp_path_factory):
    deltas = seeded_deltas()
    root = tmp_path_factory.mktemp("wals")
    bad = [(k, key, dict(o, ready_workers=o["ready_workers"] + 1) if k == "slice" and key.endswith("slice-4") and o
            else o) for k, key, o in deltas]
    return {
        "port": write_wal(root / "port", FleetView, HistoryStore, deltas),
        "jax": write_wal(root / "jax", RefFleetView, RefHistoryStore, deltas),
        "miscounted": write_wal(root / "miscounted", FleetView, HistoryStore, bad),
    }


def reference(argv):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(SCRIPT), *argv], cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=240)
    return proc.returncode, proc.stdout, proc.stderr


def port(argv, capsys):
    capsys.readouterr()
    code = history_replay.main([*argv, "--device", "cpu"])
    out, err = capsys.readouterr()
    return code, out, err


def assert_close(got, want, path="$"):
    """Equal, but floats within 1e-6 relative."""
    if isinstance(want, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and isinstance(want, (int, float)), path
        assert math.isclose(got, want, rel_tol=1e-6, abs_tol=0.0) or got == want, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for key in want:
            assert_close(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_plain_at_and_out_print_the_reference_json(writer, wals, tmp_path, capsys):
    wal = str(wals[writer])
    rc, out, err = reference(["--wal", wal])
    assert rc == 0, err
    want = json.loads(out)
    code, got_out, _ = port(["--wal", wal], capsys)
    assert code == 0
    assert_close(json.loads(got_out), want)
    assert want["rv_mismatches"] == 0 and want["objects"] > 100 and want["deltas_applied"] > 300

    at = want["rv"] // 2
    ref_file, port_file = tmp_path / "ref.json", tmp_path / "port.json"
    rc, out, err = reference(["--wal", wal, "--at", str(at), "--out", str(ref_file)])
    assert rc == 0, err
    want = json.loads(out)
    code, got_out, _ = port(["--wal", wal, "--at", str(at), "--out", str(port_file)], capsys)
    assert code == 0
    got = json.loads(got_out)
    assert want["rv"] == at and want.pop("out") == str(ref_file) and got.pop("out") == str(port_file)
    assert_close(got, want)
    assert port_file.read_bytes() == ref_file.read_bytes()
    assert json.loads(port_file.read_bytes())["rv"] == at


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_verify_and_analytics_print_the_reference_json(writer, wals, capsys):
    argv = ["--wal", str(wals[writer]), "--verify", "--analytics", "--scenarios", SCENARIOS]
    rc, out, err = reference(argv)
    assert rc == 0, err
    want = json.loads(out)
    code, got_out, _ = port(argv, capsys)
    assert code == 0
    got = json.loads(got_out)
    assert_close(got, want)
    assert got["verified_deterministic"] is True and got["analytics"]["crosscheck"]["ok"] is True
    rows = got["analytics"]["scenarios"]
    assert [row["scenario"]["kind"] for row in rows] == ["drain_cluster", "cordon_nodes"]
    assert all(row["slices_losing_quorum"] for row in rows)


def test_both_writers_replay_to_the_same_snapshot(wals, tmp_path, capsys):
    """The two packages' WALs of the same churn hold the same objects."""
    digests = {}
    for writer in ("port", "jax"):
        out = tmp_path / f"{writer}.json"
        assert port(["--wal", str(wals[writer]), "--out", str(out)], capsys)[0] == 0
        digests[writer] = json.loads(out.read_bytes())["objects"]
    assert digests["port"] == digests["jax"]


@pytest.mark.parametrize("case", ["missing_dir", "scenarios_without_analytics", "bad_scenarios", "miscounted"])
def test_bad_inputs_exit_as_the_reference(case, wals, tmp_path, capsys):
    argv = {
        "missing_dir": ["--wal", str(tmp_path / "absent")],
        "scenarios_without_analytics": ["--wal", str(wals["port"]), "--scenarios", SCENARIOS],
        "bad_scenarios": ["--wal", str(wals["port"]), "--analytics", "--scenarios", '[{"kind": "explode"}]'],
        "miscounted": ["--wal", str(wals["miscounted"]), "--analytics"],
    }[case]
    rc, out, err = reference(argv)
    code, got_out, got_err = port(argv, capsys)
    assert code == rc == {"miscounted": 1}.get(case, 2), (err, got_err)
    # the first ERROR line of each (a handler an earlier test left behind may
    # print logging noise around it in process)
    errors = [next(line.split(":")[:2] for line in e.splitlines() if line.startswith("ERROR: ")) for e in (got_err, err)]
    assert errors[0] == errors[1], errors
    if case == "miscounted":
        assert_close(json.loads(got_out), json.loads(out))
        assert json.loads(got_out)["analytics"]["crosscheck"]["ok"] is False
