"""The watcher cell on the CPU at a tiny size, for its tests: a seeded
16-node, 300-pod cluster, 2,000 churn events at 1,000 a second, the probe at
``tiny.py``'s sizes with the link walk off; the harness's look for a card
skipped, the rest of a run as it is."""

from __future__ import annotations

import json
import tempfile
import time

from portbench import harness
from portbench.tests.tiny import SEED, TINY_PROBE

CELL = "watcher-churn-probe"
TINY_CLUSTER = {"nodes": 16, "pods": 300, "jobsets": 2, "workers": 8}
COMPARED = {"calls_off_plan", "read_sweep_gap", "block_sums_gap", "gemm_chain_gap", "verdicts_wrong", "node_patches",
            "trend_alerts", "payloads_wrong", "notifications_lost", "out_of_order"}
NEW = ("watch_batch_ms.watch", "egress_post_ms.watch", "events_taken_per_s.watch")


def run_tiny_watcher(seconds: float = 1.5, seed: int = SEED):
    """One run of the cell on the CPU: ``(parsed result line, outcome)``."""
    import torch

    start = time.monotonic()
    workload = harness.load_json("workloads", f"{CELL}.json")
    config = harness.load_json("configs", f"{workload['config']}.json")
    workload.update(overlay={"tpu": {"probe": dict(TINY_PROBE, links_enabled=False)}}, cluster=TINY_CLUSTER,
                    rate_per_s=1000, churn_events=2000, warm_seconds=0.5)
    bench = harness.benchmark()
    with tempfile.TemporaryDirectory() as workdir:
        run = harness.Run(CELL, config, workload, seed, seconds, False, torch.device("cpu"), workdir, start,
                          expected_platform="cpu")
        outcome = harness.drive(run)
    e2e = harness.cell_metrics(bench, CELL)[0]
    line = json.dumps(harness.report(outcome, e2e, {}, bench, {"platform": "cpu", "kind": "cpu", "count": 1}, 0))
    return json.loads(line), outcome


def failing(result) -> set:
    return {k for k, v in result["compared"].items() if v["value"] > v["limit"]}
