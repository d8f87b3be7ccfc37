"""``node-probe-4gpu``'s driver (``drivers/probe_ranks.py``) on four gloo
ranks on the CPU at tiny sizes: rank 0 in this process, ranks 1-3 in child
processes, as on the card. A sound run is correct and every rank stops after
the same cycle; each number the cell adds reads over its limit under a fault
put in rank 0 where it is produced; the control is not correct; a program
without the stop vote cannot run the cell. The control at the cell's own size
needs four cards."""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.devtrace import DeviceTrace
from portbench.drivers import probe_ranks
from portbench.tests.tiny import SEED, run_tiny

CELL = "node-probe-4gpu"
# limits far above a loaded CPU's jitter: only a fault may make a cycle unhealthy
QUIET = {"link_rtt_floor_ms": 250.0, "rtt_warn_ms": 1000.0}
NEW = {"allreduce_gap", "pair_gap", "gather_rows_off", "link_verdicts_wrong", "ranks_stopped_apart"}


def run(seconds: float = 1.0, control: bool = False):
    return run_tiny(CELL, seconds=seconds, probe=QUIET, control=control)


def failing(result) -> set:
    return {k for k, v in result["compared"].items() if v["value"] > v["limit"]}


def read(name, obs):
    return harness.load_reader(name)(obs)


def test_four_ranks_run_end_to_end_and_stop_together():
    result, outcome = run(seconds=3.0)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1, result
    assert set(result["metrics"]) == {"probe_cycle_ms", "setup_s"}
    assert NEW <= set(result["compared"]) and all(v["value"] == 0.0 for k, v in result["compared"].items()
                                                  if k != "gemm_chain_gap")
    obs = outcome.observation
    assert len(obs["rank_cycles"]) == 3 and all(obs["rank_cycles"])
    assert read("link_walk_ms.node4", obs) > 0.0
    assert read("rank_skew_ms.node4", obs) >= 0.0
    assert read("allreduce_busbw_pct.node4", obs) is None  # no device trace
    assert read("allreduce_busbw_pct.node4", dict(obs, device_trace=DeviceTrace([], {}, obs["window"]))) is None
    # no environment of the group is left behind in this process
    assert "WORLD_SIZE" not in os.environ and "MASTER_PORT" not in os.environ


def test_one_ranks_allreduce_input_altered(monkeypatch):
    import k8s_watcher_tpu_torch.probe.ici as ici

    real = ici.bandwidth_probe_input
    monkeypatch.setattr(ici, "bandwidth_probe_input", lambda mesh, n: real(mesh, n) * 2)
    result, _ = run()
    assert result["correct"] is False and "allreduce_gap" in failing(result)
    assert result["compared"]["allreduce_gap"]["value"] == 0.25  # (2 + 1 + 1 + 1 - 4) / 4


def test_one_pairs_return_corrupted(monkeypatch):
    import k8s_watcher_tpu_torch.probe.links as links

    real = links.make_pair_probe

    def corrupted(a, b, *args, **kwargs):
        fn, expected = real(a, b, *args, **kwargs)
        return ((lambda x: fn(x) + 1.0) if (a, b) == (0, 1) else fn), expected

    monkeypatch.setattr(links, "make_pair_probe", corrupted)
    result, _ = run()
    assert result["correct"] is False and {"pair_gap", "link_verdicts_wrong"} <= failing(result)


def test_one_gather_row_replaced(monkeypatch):
    import k8s_watcher_tpu_torch.probe.agent as agent

    real = agent.all_gather_rows
    monkeypatch.setattr(agent, "all_gather_rows", lambda raw, device=None: [
        b'["forged"]' if i == 1 else row for i, row in enumerate(real(raw, device))])
    result, _ = run()
    assert result["correct"] is False and "gather_rows_off" in failing(result)


def test_one_rank_left_running_after_the_stop(monkeypatch):
    """Rank 0 lets the group's first stop pass and runs one more cycle after
    its peers have left: every other rank's last cycle is not its."""
    import k8s_watcher_tpu_torch.probe.agent as agent

    real, passed = agent.ProbeAgent._stop_vote, []

    @functools.wraps(real)
    def vote(self):
        agreed = real(self)
        if agreed and not passed:
            passed.append(1)
            return False
        return agreed

    monkeypatch.setattr(agent.ProbeAgent, "_stop_vote", vote)
    result, _ = run()
    assert result["correct"] is False and result["compared"]["ranks_stopped_apart"]["value"] == 3.0


def test_the_control_through_the_harness_is_not_correct():
    """At the tiny size the float8 GEMM chain fails its limit; a float32 sum
    of small integers in bfloat16 is exact, so the collectives read as sound."""
    result, _ = run(control=True)
    assert result["correct"] is False and "gemm_chain_gap" in failing(result)
    assert result["compared"]["allreduce_gap"]["value"] == 0.0 and result["compared"]["pair_gap"]["value"] == 0.0


def test_a_program_without_the_stop_vote_cannot_run_the_cell(monkeypatch):
    import k8s_watcher_tpu_torch.probe.agent as agent

    real = agent.ProbeAgent.run_once
    monkeypatch.setattr(agent.ProbeAgent, "run_once", lambda self: real(self))
    config, workload = harness.load_json("configs", "h100-node-agent-4rank.json"), harness.load_json(
        "workloads", f"{CELL}.json")
    run0 = harness.Run(CELL, config, workload, SEED, 1.0, False, torch.device("cpu"), "/nonexistent",
                       time.monotonic(), expected_platform="cpu")
    with pytest.raises(harness.RunError, match="stop vote"):
        probe_ranks.setup(run0)


def test_on_the_card_only_the_first_cycle_calls_for_the_timed_collectives():
    """On the card each timed collective is a graph captured in the group's
    first cycle: later cycles make only the vote, the walk's agreement and
    the gathers; off the card every call is made every cycle."""
    from portbench.reference.ranks import CollectivePlan

    card, cpu = CollectivePlan(4, on_card=True), CollectivePlan(4)
    assert card.calls(0, first=False) == {"all_reduce": 2, "all_gather": 2, "exchange": 0}
    first = card.calls(0, first=True)
    assert first == {"all_reduce": 2 + 23 + 5, "all_gather": 3, "exchange": 2 * 21}
    later = cpu.calls(0, first=False)
    assert later["all_reduce"] == 2 + 110 + 4 and later["exchange"] == 2 * 54


def test_the_driver_and_its_reference_load_no_jax():
    code = ("import portbench.harness as h, portbench.drivers.probe_ranks, portbench.reference.ranks; "
            "import k8s_watcher_tpu_torch.probe_agent; print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(harness.PACKAGE_DIR))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_the_control_on_four_cards_is_not_correct():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs: the cell's group is four ranks, one a card")
    result, _ = harness.measure(CELL, SEED, 3.0, False, time.monotonic(), control=True)
    assert result["correct"] is False and {"block_sums_gap", "gemm_chain_gap"} <= failing(result)
