"""The port's analytics plane held against the JAX package's.

On seeded fleets of several sizes, the port's torch backend (on the CPU
here; ``tests/test_torch_cuda.py`` runs it on the card) gives exactly the
integers the JAX package's jax and numpy backends give: slice rollups,
batched what-ifs and per-cluster phase counts, including no scenarios, no
workers, and an out-of-range segment id (which must raise before any launch).
The port's ``AnalyticsPlane`` answers the same summary and scenario bodies as
the JAX package's on the same view contents, apart from the backend's name.
Then the JAX package's ``tests/test_analytics.py`` runs again through the
port, every backend on the CPU (the WAL replay analytics included, and the
JAX package's ``scripts/history_replay.py`` reading a WAL the port wrote),
less the tests of its JAX import probe.
"""

import numpy as np
import pytest

from k8s_watcher_tpu.analytics import AnalyticsPlane as RefPlane
from k8s_watcher_tpu.analytics import FleetEncoder as RefEncoder
from k8s_watcher_tpu.analytics import FleetKernels as RefKernels
from k8s_watcher_tpu.analytics import Scenario as RefScenario
from k8s_watcher_tpu.analytics import build_masks as ref_build_masks
from k8s_watcher_tpu.analytics import evaluate_scenarios as ref_evaluate
from k8s_watcher_tpu.analytics import resolve_backend as ref_resolve
from k8s_watcher_tpu.config.schema import AnalyticsConfig as RefAnalyticsConfig
from k8s_watcher_tpu.serve.view import FleetView as RefView
from k8s_watcher_tpu_torch.analytics import (
    AnalyticsPlane,
    FleetEncoder,
    FleetKernels,
    Scenario,
    build_masks,
    evaluate_scenarios,
    python_reference_verdicts,
    resolve_backend,
)
from k8s_watcher_tpu_torch.analytics.backend import check_segment_ids
from k8s_watcher_tpu_torch.config import AnalyticsConfig
from k8s_watcher_tpu_torch.serve import FleetView

from test_torch_replay import replay, replayed_tests


def seeded_tables(seed, n_slices=60, clusters=(None, "east", "west")):
    """A fleet of ``n_slices`` JobSet slices of 1-8 workers over a few
    clusters and shared nodes, some workers down, some slices without an
    expected size, and one pod object per worker."""
    rng = np.random.default_rng(seed)
    pods, slices = [], []
    for s in range(n_slices):
        cluster = clusters[s % len(clusters)]
        n_workers = int(rng.integers(1, 9))
        up = rng.random(n_workers) < 0.85
        prefix = f"{cluster}/" if cluster else ""
        workers = [{
            "name": f"s{s}-w{i}", "worker_index": i, "phase": "Running" if up[i] else "Pending",
            "ready": bool(up[i]), "restarts": 0, "node": f"n-{(s * 3 + i) % 97}",
            "node_ready": bool(rng.random() < 0.97),
        } for i in range(n_workers)]
        key = f"{prefix}default/slice-{s}"
        slices.append({
            "kind": "slice", "key": key, "slice": key,
            "expected_workers": None if s % 5 == 0 else n_workers, "observed_workers": n_workers,
            "ready_workers": sum(1 for w in workers if w["phase"] == "Running" and w["ready"] and w["node_ready"]),
            "chips_per_worker": int(rng.integers(1, 9)), "phase": "Ready", "workers": workers,
            **({"cluster": cluster} if cluster else {}),
        })
        for w in workers:
            pods.append({"kind": "pod", "key": f"{prefix}{w['name']}", "phase": w["phase"], "ready": w["ready"],
                         "node": w["node"], **({"cluster": cluster} if cluster else {})})
    return {"pod": pods, "slice": slices}


def scenarios_for(tables, seed, n=12):
    rng = np.random.default_rng(seed + 1)
    nodes = sorted({w["node"] for s in tables["slice"] for w in s["workers"]})
    out = [("baseline",), ("drain_cluster", "east"), ("drain_cluster", "")]
    for _ in range(n - len(out)):
        k = int(rng.integers(1, min(16, len(nodes)) + 1))
        out.append(("cordon_nodes", tuple(rng.choice(nodes, size=k, replace=False).tolist()) + ("ghost-node",)))
    return out


def _scenario(cls, spec):
    if spec[0] == "baseline":
        return cls("baseline")
    if spec[0] == "drain_cluster":
        return cls("drain_cluster", cluster=spec[1])
    return cls("cordon_nodes", nodes=spec[1])


def run_kernels(encoder_cls, kernels, scenario_cls, evaluate, masks_fn, tables, specs):
    encoder = encoder_cls()
    encoder.reset(tables)
    cols = encoder.columns()
    scenarios = [_scenario(scenario_cls, s) for s in specs]
    rollup = kernels.slice_rollup(cols)
    whatif = kernels.what_if(cols, masks_fn(cols, scenarios))
    return {
        "rollup": [a.tolist() for a in rollup],
        "whatif": [a.tolist() for a in whatif],
        "phase": kernels.pod_phase_counts(cols).tolist(),
        "verdicts": evaluate(cols, scenarios, kernels),
    }


@pytest.mark.parametrize("seed, n_slices", [(0, 1), (1, 17), (2, 60), (3, 240)])
def test_torch_equals_the_reference_backends(seed, n_slices):
    tables = seeded_tables(seed, n_slices)
    specs = scenarios_for(tables, seed)
    port = run_kernels(FleetEncoder, FleetKernels(resolve_backend("auto", device="cpu")), Scenario,
                       evaluate_scenarios, build_masks, tables, specs)
    assert port["whatif"][0] and all(isinstance(v, int) for v in port["whatif"][0][0])
    for name in ("jax", "numpy"):
        want = run_kernels(RefEncoder, RefKernels(ref_resolve(name)), RefScenario, ref_evaluate, ref_build_masks,
                           tables, specs)
        assert port == want, name
    # and the plain dict walk
    assert port["verdicts"] == python_reference_verdicts(tables, [_scenario(Scenario, s) for s in specs])


def test_no_scenarios_and_no_workers():
    kernels = FleetKernels(resolve_backend("jax", device="cpu"))
    encoder = FleetEncoder()
    encoder.reset(seeded_tables(4, 9))
    cols = encoder.columns()
    none = kernels.what_if(cols, build_masks(cols, []))
    assert [a.shape for a in none] == [(0, 9), (0, 9), (0,)]
    ref = RefKernels(ref_resolve("numpy")).what_if(cols, build_masks(cols, []))
    assert [a.tolist() for a in none] == [a.tolist() for a in ref]
    # slices whose workers are all gone, and an empty fleet
    for tables in ({"slice": [dict(s, workers=[]) for s in seeded_tables(5, 4)["slice"]], "pod": []}, {}):
        encoder = FleetEncoder()
        encoder.reset(tables)
        cols = encoder.columns()
        specs = [("baseline",), ("drain_cluster", "")]
        got = evaluate_scenarios(cols, [_scenario(Scenario, s) for s in specs], kernels)
        ref_encoder = RefEncoder()
        ref_encoder.reset(tables)
        assert got == ref_evaluate(ref_encoder.columns(), [_scenario(RefScenario, s) for s in specs],
                                   RefKernels(ref_resolve("jax")))
        assert kernels.pod_phase_counts(cols).sum() == 0


@pytest.mark.parametrize("bad", [-1, 5])
def test_out_of_range_segment_id_raises_before_launch(bad):
    backend = resolve_backend("auto", device="cpu")
    ids = np.array([0, 1, bad, 2], dtype=np.int32)
    with pytest.raises(ValueError, match="segment ids"):
        backend.segment_sum(np.ones(4, dtype=np.int32), ids, 5)
    with pytest.raises(ValueError, match="segment ids"):
        check_segment_ids(ids, 5)
    if bad < 0:  # numpy's own bincount raises too
        with pytest.raises(ValueError):
            resolve_backend("numpy").segment_sum(np.ones(4, dtype=np.int32), ids, 5)
    # a fleet column out of range raises in the kernels, not on the device
    encoder = FleetEncoder()
    encoder.reset(seeded_tables(6, 3))
    cols = encoder.columns()
    cols = cols._replace(w_slice=np.where(np.arange(cols.n_workers) == 0, bad if bad < 0 else 3, cols.w_slice)
                         .astype(np.int32))
    with pytest.raises(ValueError, match="segment ids"):
        FleetKernels(backend).slice_rollup(cols)


def test_segment_sum_is_int64_and_exact():
    backend = resolve_backend("auto", device="cpu")
    ids = np.array([0, 2, 0, 1], dtype=np.int32)
    data = np.array([[2**30, 2**30, 2**30, 1], [1, 0, 0, 0]], dtype=np.int32)
    out = backend.segment_sum(data, ids, 3)
    assert out.dtype.is_floating_point is False and str(out.dtype) == "torch.int64"
    assert backend.to_numpy(out).tolist() == [[2**31, 1, 2**30], [1, 0, 0]]


def test_auto_without_cuda_raises_and_never_degrades():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: auto resolves to the GPU")
    for preference in ("auto", "jax"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_backend(preference)
    config = AnalyticsConfig(enabled=True, backend="auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        AnalyticsPlane(config, FleetView())
    assert resolve_backend("numpy").name == "numpy"


@pytest.mark.parametrize("columnar", [True, False])
def test_plane_bodies_equal_the_reference_plane(columnar):
    tables = seeded_tables(7, 40)
    items = [("pod", o["key"], o) for o in tables["pod"]] + [("slice", o["key"], o) for o in tables["slice"]]
    ref_view, port_view = RefView(columnar=columnar), FleetView(columnar=columnar)
    ref_view.apply_batch(items)
    port_view.apply_batch(items)
    ref = RefPlane(RefAnalyticsConfig(enabled=True, max_scenarios=32), ref_view)
    port = AnalyticsPlane(AnalyticsConfig(enabled=True, max_scenarios=32), port_view, device="cpu")
    assert port.backend.name == "torch" and port.backend.device.type == "cpu"
    raw = [s.to_wire() for s in (_scenario(Scenario, spec) for spec in scenarios_for(tables, 7, n=32))]

    def strip(body):
        return {k: v for k, v in body.items() if k != "backend"}

    for _ in range(2):  # a second request reuses the columns (or folds no delta)
        assert strip(port.summary()) == strip(ref.summary())
        assert strip(port.evaluate(raw)) == strip(ref.evaluate(raw))
        assert port.summary()["crosscheck"]["ok"] is True
    port_view.apply("pod", "late", {"kind": "pod", "key": "late", "phase": "Pending", "node": "n-late"})
    ref_view.apply("pod", "late", {"kind": "pod", "key": "late", "phase": "Pending", "node": "n-late"})
    assert strip(port.summary()) == strip(ref.summary())


_REWRITES = [
    # every backend of the replay runs on the CPU here
    ("from k8s_watcher_tpu.analytics import backend as backend_mod\n",
     "from k8s_watcher_tpu.analytics import backend as backend_mod\n\n\n"
     "def resolve_backend(preference='auto'):\n"
     "    return backend_mod.resolve_backend(preference, device='cpu')\n"),
    # the replays of a WAL evaluate on the CPU here
    ("    batched_replay_verdicts,\n    comparable,\n", "    comparable,\n"),
    ("    sequential_replay_verdicts,\n    tables_from_objects,\n    verdicts_from_objects,\n)\n",
     "    sequential_replay_verdicts,\n    tables_from_objects,\n)\n"
     "from k8s_watcher_tpu.analytics import replay as _replay_mod\n\n\n"
     "def batched_replay_verdicts(*args, **kwargs):\n"
     "    return _replay_mod.batched_replay_verdicts(*args, device='cpu', **kwargs)\n\n\n"
     "def verdicts_from_objects(*args, **kwargs):\n"
     "    return _replay_mod.verdicts_from_objects(*args, device='cpu', **kwargs)\n"),
    ("from k8s_watcher_tpu.config.schema import AnalyticsConfig, AppConfig, SchemaError",
     "from k8s_watcher_tpu_torch.config import AnalyticsConfig, AppConfig, ConfigError as SchemaError"),
    # the port's device backend is torch; ``jax`` names it too
    ('be.name == ("jax" if backend_mod.jax_available() else "numpy")', 'be.name == "torch"'),
    ("        if not backend_mod.jax_available():\n"
     "            pytest.skip(\"jax not importable in this environment\")\n", ""),
]

globals().update(replayed_tests(
    replay("test_analytics.py", rewrites=_REWRITES),
    leave_out=(
        # the JAX import probe and its numpy fallback: the port has no jax to
        # probe and never falls back (test_auto_without_cuda_raises_and_never_degrades)
        "TestBackend.test_broken_jax_degrades_to_numpy",
        "TestBackendParity.test_numpy_path_equals_jax_results_when_jax_is_absent",
    ),
))
