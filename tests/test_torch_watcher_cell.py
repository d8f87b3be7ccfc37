"""The benchmark's watcher cell (``watcher-churn-probe``) at a tiny size on
the CPU, so the port's own test run guards it: production's ``WatcherApp``
with its in-process probe against a seeded 16-node, 300-pod cluster and 2,000
churn events, held to ``portbench/reference/watcher.py``. The faults that must
fail it are in ``portbench/tests/test_portbench_watcher.py``."""

from portbench.tests.watcher_tiny import COMPARED, run_tiny_watcher


def test_the_tiny_watcher_cell_is_correct_and_counts_every_event():
    result, outcome = run_tiny_watcher()
    assert result["correct"] is True and result["attempted"] >= 2, result
    assert set(result["compared"]) == COMPARED
    assert all(v["value"] == 0.0 for k, v in result["compared"].items() if k != "gemm_chain_gap")
    obs = outcome.observation
    assert obs["events_delivered"] == 2000 and obs["events_taken"] == 2000
