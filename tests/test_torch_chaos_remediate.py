"""The port's remediation drill (``python -m
k8s_watcher_tpu_torch.chaos_remediate --cpu-ranks 8``) held against the JAX
package's ``scripts/chaos_remediate.py --cpu-mesh 8``.

Both run once for the module; the tests compare their verdicts, never their
times, so they hold on a loaded host. Each must pass all eight stages: the
same suspect (device 3, on the same two links), no act on cycle 1, the node
cordoned and tainted with the same key and effect after the confirming
cycle, release restoring it, and the DCN walk naming slice 3 with a
confirmed dry-run decision whose notification reaches the sink.

One difference is by design (``ROADMAP.md`` §C): a slice is a node on ranks,
so the port's DCN stage names slice 3's node ``drill-tpu-node-3`` where the
reference's one-node drill names ``drill-tpu-node-0``.

The reference runs with its link and pair walks given a 15 ms floor and a
6,000-matmul slow fault (~25 ms a hop on its virtual mesh; its defaults, a
0.05 ms link floor and 0.2 ms pair floor, flagged a healthy pair of the mesh
on a loaded host); the port's drill uses its own CPU-rank floors (50 ms) and
default fault (3,000 matmuls, ~85 ms a hop on one CPU thread).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from k8s_watcher_tpu.remediate.actuator import NodeActuator as RefActuator
from k8s_watcher_tpu_torch import chaos_remediate
from k8s_watcher_tpu_torch.remediate.actuator import NodeActuator

REPO = Path(__file__).resolve().parent.parent
RANK_ENV = ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
REF_FLOOR_MS = 15.0
REF_SLOW_ITERS = 6000
_REFERENCE = """
import functools, os, runpy, sys
import k8s_watcher_tpu.probe.links as links
import k8s_watcher_tpu.probe.multislice as multislice
links.run_link_probe = functools.partial(links.run_link_probe, rtt_floor_ms=%(floor)r)
multislice.run_multislice_probe = functools.partial(multislice.run_multislice_probe, pair_rtt_floor_ms=%(floor)r)
sys.argv = sys.argv[1:]
sys.path.insert(0, os.path.dirname(sys.argv[0]))
runpy.run_path(sys.argv[0], run_name="__main__")
""" % {"floor": REF_FLOOR_MS}
PASS = "remediation drill: PASS — ICI fault quarantined, DCN fault localized to a dry-run decision"


def _drill(jax_side):
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV + ("XLA_FLAGS",)}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    if jax_side:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        cmd = ["-c", _REFERENCE, str(REPO / "scripts" / "chaos_remediate.py"), "--cpu-mesh", "8",
               "--slow-iters", str(REF_SLOW_ITERS)]
    else:
        cmd = ["-m", "k8s_watcher_tpu_torch.chaos_remediate", "--cpu-ranks", "8"]
    proc = subprocess.run([sys.executable, *cmd], cwd=str(REPO), env=env, capture_output=True, text=True,
                          timeout=400)
    out = proc.stdout
    start = out.find("{\n")
    result = json.loads(out[start: out.rindex("}") + 1]) if start >= 0 else None
    return proc.returncode, result, out + proc.stderr[-3000:]


@pytest.fixture(scope="module")
def drills():
    return {"ref": _drill(jax_side=True), "port": _drill(jax_side=False)}


def test_both_drills_pass_every_stage(drills):
    for side in ("ref", "port"):
        rc, result, out = drills[side]
        assert rc == 0, (side, out[-4000:])
        assert result["failures"] == [], side
        assert PASS in out, side
    assert list(drills["port"][1]) == list(drills["ref"][1])
    assert drills["port"][1]["n_devices"] == drills["ref"][1]["n_devices"] == 8
    assert drills["port"][1]["injected_device"] == drills["ref"][1]["injected_device"] == 3


def test_same_suspect_on_the_same_links(drills):
    ref, got = drills["ref"][1], drills["port"][1]
    assert got["links_cycle1"] == ref["links_cycle1"]
    assert got["links_cycle1"] == {"suspect_devices": [3],
                                   "suspect_links": ["host0/chip2-chip3", "host0/chip3-chip4"]}


def test_no_act_on_cycle_1_then_the_same_quarantine(drills):
    ref, got = drills["ref"][1], drills["port"][1]
    # actions holds every action of the confirmation window: the one applied
    # by the confirming cycle, none by cycle 1
    assert len(got["actions"]) == len(ref["actions"]) == 1
    assert got["actions"] == ref["actions"]
    assert got["actions"][0]["node"] == chaos_remediate.node_name(0) == "drill-tpu-node-0"
    assert got["node_after"] == ref["node_after"] == {"unschedulable": True, "tainted": True}
    assert got["sink_remediation_payloads"] >= 1 and ref["sink_remediation_payloads"] >= 1


def test_same_taint_key_and_effect():
    """The drill's actuator takes the actuator defaults; the port's are the
    reference's."""
    for name in ("taint_key", "taint_value", "taint_effect", "cordon"):
        assert getattr(NodeActuator(client=None), name) == getattr(RefActuator(client=None), name), name
    assert NodeActuator(client=None).taint_key == "k8s-watcher-tpu/ici-fault"


def test_release_restores_the_node(drills):
    ref, got = drills["ref"][1], drills["port"][1]
    assert got["released"] == ref["released"] == {"ok": True, "unschedulable": False, "taints": []}


def test_dcn_slice_named_and_decided_dry(drills):
    ref, got = drills["ref"][1], drills["port"][1]
    assert got["dcn_cycle1"] == ref["dcn_cycle1"]
    assert got["dcn_cycle1"]["dcn_suspect_slices"] == [3]
    assert got["dcn_cycle1"]["suspect_pairs"] == ["slice0-slice3", "slice1-slice3", "slice2-slice3"]
    (decision,), (ref_decision,) = got["dcn_actions"], ref["dcn_actions"]
    for key in ("action", "ok", "dry_run", "applied"):
        assert decision[key] == ref_decision[key], key
    assert decision["dry_run"] is True and decision["applied"] is False
    assert ref_decision["node"] == "drill-tpu-node-0" and decision["node"] == "drill-tpu-node-3"
    assert "slice 3" in decision["reason"] and "slice 3" in ref_decision["reason"]
    assert got["sink_dcn_payloads"] >= 1 and ref["sink_dcn_payloads"] >= 1


def test_without_a_gpu_or_cpu_ranks_it_raises():
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "k8s_watcher_tpu_torch.chaos_remediate"], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "RuntimeError" in proc.stderr
    assert "torch.cuda.is_available() is False" in proc.stderr and "remediation drill" not in proc.stdout


@pytest.mark.parametrize("argv", [["--slow-device", "8"], ["--dcn-slice", "4"], ["--slow-device", "-1"]])
def test_a_fault_outside_the_run_is_refused(argv):
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-m", "k8s_watcher_tpu_torch.chaos_remediate", "--cpu-ranks", "8", *argv],
                          cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "is not a" in proc.stderr and proc.stdout == ""
