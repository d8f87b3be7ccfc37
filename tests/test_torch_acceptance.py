"""The port's acceptance drill (``python -m
k8s_watcher_tpu_torch.acceptance_drill --cpu-ranks 8``) held to every gate of
the JAX package's ``scripts/acceptance_drill.py``.

The drill runs once for the module, for 8 s at the reference's 20 writes a
second (the reference script is never run: it writes a fixed path under
``artifacts/``). Its artifact must pass each of the reference's gates with
the reference's thresholds. The probe loop's verdict is held against the JAX
package: the same corrupt fault (the first device of the last slice) through
the JAX package's ``run_multislice_probe`` on its 8-device virtual mesh of 4
slices names slice 3, as the port's ranks do; with the fault moved to slice
1, the port's loop names slice 1 and decides on slice 1's node.

One difference is by design (``ROADMAP.md`` §C): a slice is a node on ranks,
so the decision names ``accept-tpu-node-3`` where the reference's names
``accept-tpu-node-0``.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from k8s_watcher_tpu.faults.ici import IciFaultSpec as RefFaultSpec
from k8s_watcher_tpu.parallel.mesh import hybrid_slice_mesh as ref_hybrid_slice_mesh
from k8s_watcher_tpu.probe.multislice import run_multislice_probe as ref_run_multislice_probe
from k8s_watcher_tpu_torch import acceptance_drill
from k8s_watcher_tpu_torch.drill_common import tpu_node
from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer, MockCluster
from k8s_watcher_tpu_torch.parallel.cpu_ranks import run_cpu_ranks

REPO = Path(__file__).resolve().parent.parent
RANK_ENV = ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
# the checksum verdicts are what is compared; pair latencies on a loaded CPU
# get a floor far above their jitter, as tests/test_torch_multislice.py does
COVERAGE_FLOOR_MS = 250.0


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    out = tmp_path_factory.mktemp("acceptance") / "acceptance.json"
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_watcher_tpu_torch.acceptance_drill", "--cpu-ranks", "8", "--seconds", "8",
         "--rate", "20", "--out", str(out)],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300,
    )
    return proc, json.loads(out.read_text()) if out.exists() else None


def test_the_drill_passes_every_gate(drill):
    proc, result = drill
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "acceptance drill: PASS" in proc.stdout
    assert result["ok"] is True and result["failures"] == []
    assert (result["devices"], result["slices"], result["offered_rate_per_sec"]) == (8, 4, 20.0)
    assert result["realized_events_per_min"] >= 1000.0
    assert result["preemptions"] >= 1 and result["reschedules"] >= 1
    tracers = result["tracers"]
    assert tracers["offered"] >= 10 and tracers["completed"] >= 0.9 * tracers["offered"]
    assert result["latency_ms"]["p50"] < 1000.0
    assert "preemption" in result["disruption_kinds_seen"]
    assert result["overflow_drops"] == 0


def test_the_last_slice_localized_and_decided_dry(drill):
    _, result = drill
    probe = result["probe"]
    assert probe["cycles"] >= 2
    assert [3] in probe["dcn_suspects_per_cycle"]
    decision = next(d for d in probe["decisions"] if d["ok"] and d["dry_run"])
    assert decision["node"] == acceptance_drill.node_name(3) == "accept-tpu-node-3"
    assert decision["action"] == "quarantine" and decision["applied"] is False
    assert "slice 3" in decision["reason"]


def test_the_reference_mesh_names_the_same_slice(drill):
    """The JAX package's probe on its 8-device mesh of 4 slices, with the
    drill's fault (``corrupt_device_id = (slices - 1) * per_slice``)."""
    _, result = drill
    ms = ref_run_multislice_probe(ref_hybrid_slice_mesh(n_slices=4), n_slices=4, iters=3, inner_iters=4,
                                  fault=RefFaultSpec(corrupt_device_id=3 * 2), pair_rtt_floor_ms=COVERAGE_FLOOR_MS)
    assert list(ms.dcn_suspect_slices) == [3]
    assert result["probe"]["dcn_suspects_per_cycle"][0] == list(ms.dcn_suspect_slices)


def test_the_fault_moved_to_slice_1_is_named_there(tmp_path):
    """The drill's probe loop on 8 ranks in 4 nodes with the fault in slice
    1, stopped as the drill stops it: by the stop file, once rank 0's
    progress shows a decision."""
    cluster = MockCluster()
    for i in range(4):
        cluster.add_node(tpu_node(acceptance_drill.node_name(i)))
    ranks = []
    with MockApiServer(cluster) as api:
        loop = threading.Thread(target=lambda: ranks.extend(run_cpu_ranks(
            f"{acceptance_drill.STAGE_MODULE}:probe_loop", 8,
            dict(api_url=api.url, n_slices=4, confirm_cycles=2, control_dir=str(tmp_path), device="cpu",
                 fault_slice=1),
            local_world_size=2,
        )))
        loop.start()
        deadline = time.monotonic() + 120
        while acceptance_drill.read_progress(str(tmp_path))["decisions"] < 1 and time.monotonic() < deadline:
            time.sleep(0.2)
        (tmp_path / acceptance_drill.STOP_FILE).touch()
        loop.join(180)
    state, *others = ranks
    assert state["cycles"] >= 2 and state["dcn_suspects"] == [[1]] * state["cycles"]
    assert {d["node"] for d in state["decisions"] if d["ok"] and d["dry_run"]} == {"accept-tpu-node-1"}
    assert others == [{}] * 7
    for i in range(4):
        spec = cluster.get_node(acceptance_drill.node_name(i)).get("spec") or {}
        assert not spec.get("unschedulable") and not spec.get("taints")
