"""Runs of the benchmark's driver on the CPU at tiny sizes, for its tests:
the harness's look for a card skipped, the rest of a run as it is."""

from __future__ import annotations

import json
import tempfile
import time

from portbench import harness

# the CPU's GEMM readings swing by half between cycles: no trend alerts on them;
# hbm_bytes: two read blocks, the most the stage sweeps off the card
TINY_PROBE = {"matmul_size": 64, "payload_bytes": 4096, "trend_enabled": False, "hbm_bytes": 4 << 20}
SEED = 3000000019  # above 2**31, as the driver's seeds are


def tiny(cell: str, probe: dict = None):
    """``(config, workload)`` of ``cell``, cut to run on the CPU in seconds;
    ``probe`` replaces more of ``tpu.probe``."""
    workload = harness.load_json("workloads", f"{cell}.json")
    config = harness.load_json("configs", f"{workload['config']}.json")
    workload["overlay"] = {"tpu": {"probe": {**TINY_PROBE, **(probe or {})}}}
    return config, workload


def run_tiny(cell: str, seconds: float = 3.0, seed: int = SEED, probe: dict = None, control: bool = False):
    """One run of ``cell`` on the CPU: ``(the result line, parsed, outcome)``."""
    import torch

    start = time.monotonic()
    config, workload = tiny(cell, probe)
    bench = harness.benchmark()
    with tempfile.TemporaryDirectory() as workdir:
        run = harness.Run(cell, config, workload, seed, seconds, False, torch.device("cpu"), workdir, start,
                          expected_platform="cpu", control=control)
        outcome = harness.drive(run)
    e2e = harness.cell_metrics(bench, cell)[0]
    device = {"platform": "cpu", "kind": "cpu", "count": 1}
    line = json.dumps(harness.report(outcome, e2e, {}, bench, device, 0))
    return json.loads(line), outcome
