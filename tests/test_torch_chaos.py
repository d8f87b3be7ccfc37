"""The port's chaos drill (``python -m k8s_watcher_tpu_torch.chaos_probe``)
held against the JAX package's ``scripts/chaos_probe.py`` on the same fault.

The reference corrupts device 5 of its 8-device virtual CPU mesh; the port
corrupts rank 5 of 8 gloo ranks in CPU processes (``--cpu-ranks 8``). Both
must print the same keys, reach the same ``localized_correctly`` verdicts and
name the same suspect device and slice. Link names may differ with
``--slices``: the reference walks one host of 8 chips, the port one node per
slice (2 x 4).

Corruption fails checksums whatever the timing, but a link that a loaded host
stalls past the latency floor is flagged "slow", and beside the corrupt
device it implicates a healthy neighbour. The port's drill on CPU ranks has
a 50 ms floor (the JAX package's CPU dryrun floor); the reference script runs
with its link walk given the same floor (the script's default, 0.05 ms, is
for a TPU fabric and flagged a healthy chip here under load), and otherwise
as it is.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from k8s_watcher_tpu_torch import chaos_probe

REPO = Path(__file__).resolve().parent.parent
RANK_ENV = ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


CPU_FLOOR_MS = 50.0
# scripts/chaos_probe.py as it is, its link walk given CPU_FLOOR_MS
_REFERENCE = """
import functools, runpy, sys
import k8s_watcher_tpu.probe.links as links
links.run_link_probe = functools.partial(links.run_link_probe, rtt_floor_ms=%r)
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
""" % CPU_FLOOR_MS


def _drill(argv, jax_side):
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV + ("XLA_FLAGS",)}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    if jax_side:
        # the device count is fixed before the wrapper's first jax import
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        cmd = ["-c", _REFERENCE, str(REPO / "scripts" / "chaos_probe.py")]
    else:
        cmd = ["-m", "k8s_watcher_tpu_torch.chaos_probe"]
    proc = subprocess.run([sys.executable, *cmd, *argv], cwd=str(REPO), env=env, capture_output=True, text=True,
                          timeout=300)
    out = proc.stdout
    result = json.loads(out[: out.rindex("}") + 1]) if "}" in out else None
    return proc.returncode, result, out


@pytest.mark.parametrize("slices", [0, 2])
def test_corrupt_rank_is_localized_as_the_reference_localizes_it(slices):
    extra = ["--slices", str(slices)] if slices else []
    ref_rc, ref, ref_out = _drill(["--cpu-mesh", "8", "--corrupt-device", "5", *extra], jax_side=True)
    rc, got, out = _drill(["--cpu-ranks", "8", "--corrupt-device", "5", *extra], jax_side=False)
    assert ref_rc == 0, ref_out[-3000:]
    assert chaos_probe.RTT_FLOOR_MS["cpu"] == CPU_FLOOR_MS
    assert rc == ref_rc, out[-3000:]
    assert out.rstrip().endswith("chaos drill: PASS — fault detected and localized")
    assert list(got) == list(ref) and got["n_devices"] == ref["n_devices"] == 8
    assert got["injected"]["corrupt_rank"] == ref["injected"]["corrupt_device_id"] == 5
    assert list(got["aggregate"]) == list(ref["aggregate"])
    assert got["aggregate"]["detected"] is ref["aggregate"]["detected"] is True
    assert got["aggregate"]["checksum_ok"] is ref["aggregate"]["checksum_ok"] is False
    assert list(got["links"]) == list(ref["links"])
    assert got["links"]["suspect_devices"] == ref["links"]["suspect_devices"] == [5]
    assert got["links"]["localized_correctly"] is ref["links"]["localized_correctly"] is True
    if not slices:
        assert got["links"]["suspect_links"] == ref["links"]["suspect_links"]
        return
    assert list(got["multislice"]) == list(ref["multislice"])
    for key in ("suspect_slices", "per_slice_sums", "suspect_pairs", "dcn_suspect_slices", "localized_correctly"):
        assert got["multislice"][key] == ref["multislice"][key], key
    assert got["links"]["suspect_links"] == ["host1/chip0-chip1", "host1/chip1-chip2", "chip1/host0-host1"]


def test_no_fault_and_a_ragged_carve_are_refused():
    rc, _, _ = _drill(["--cpu-ranks", "8"], jax_side=False)
    assert rc == 2
    rc, _, _ = _drill(["--cpu-ranks", "8", "--corrupt-device", "1", "--slices", "3"], jax_side=False)
    assert rc == 2
