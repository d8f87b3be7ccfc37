"""The driver runs at a tiny size on the CPU, with the harness's look for a
card skipped, and its result line parses and says ``correct``."""

from __future__ import annotations

from portbench.tests.tiny import run_tiny

COMPARED = {"calls_off_plan", "read_sweep_gap", "block_sums_gap", "gemm_chain_gap", "verdicts_wrong", "node_patches"}


def test_probe_loop_runs_and_is_correct():
    result, outcome = run_tiny("node-probe-loop", seconds=1.5)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"probe_cycle_ms", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["compared"]) == COMPARED
    assert all(v["value"] == 0.0 for k, v in result["compared"].items() if k != "gemm_chain_gap")
    assert list(result)[-1] == "compared"
