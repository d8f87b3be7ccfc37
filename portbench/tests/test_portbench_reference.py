"""The reference catches what it is there to catch: the cell's run with the
timed path broken underneath comes out not correct, once for each fault the
cell can have, and so does the control, through the harness's own path. The
control at the cell's own size needs the card."""

from __future__ import annotations

import functools
import time

import numpy as np
import pytest
import torch

from portbench.drivers.probe_loop import calls_off
from portbench.reference.probe import (
    block_sums,
    cycle_plan,
    gemm_chain,
    gemm_operands,
    read_totals,
    relative_norm_gap,
    worst_relative_gap,
)
from portbench.tests.tiny import SEED, run_tiny

SHIPPED = {"hbm_bytes": 268435456, "matmul_size": 1024, "matmul_inner_iters": 8}


def failing(result) -> set:
    return {k for k, v in result["compared"].items() if v["value"] > v["limit"]}


def test_fill_that_leaves_the_buffer_unchanged(monkeypatch):
    from k8s_watcher_tpu_torch.kernels import hbm

    real = hbm.fill
    monkeypatch.setattr(hbm, "fill", lambda seed, n, repeats, **kw: torch.zeros_like(real(seed, n, repeats, **kw)))
    result, _ = run_tiny("node-probe-loop", seconds=1.0)
    assert result["correct"] is False and "block_sums_gap" in failing(result)


def test_read_sweep_over_half_the_rows(monkeypatch):
    from k8s_watcher_tpu_torch.kernels import hbm

    real = hbm.read_sweep
    monkeypatch.setattr(hbm, "read_sweep", lambda x, repeats, **kw: real(x[: x.shape[0] // 2], repeats, **kw))
    result, _ = run_tiny("node-probe-loop", seconds=1.0)
    assert result["correct"] is False and "read_sweep_gap" in failing(result)


def test_read_stage_over_half_the_buffer(monkeypatch):
    """The stage sweeps a buffer half the configured size: its totals are
    right for that buffer, and wrong for the cycle's plan."""
    import k8s_watcher_tpu_torch.probe.agent as agent

    real = agent.run_hbm_probe
    monkeypatch.setattr(agent, "run_hbm_probe", functools.wraps(real)(lambda b, **kw: real(b // 2, **kw)))
    result, _ = run_tiny("node-probe-loop", seconds=1.0)
    assert result["correct"] is False and {"calls_off_plan", "read_sweep_gap"} <= failing(result)


def test_write_stage_over_half_the_buffer(monkeypatch):
    import k8s_watcher_tpu_torch.probe.agent as agent

    real = agent.run_hbm_write_probe
    monkeypatch.setattr(agent, "run_hbm_write_probe", functools.wraps(real)(lambda b, **kw: real(b // 2, **kw)))
    # off the card the write stage fills two blocks at most: a buffer of two, halved
    result, _ = run_tiny("node-probe-loop", seconds=1.0, probe={"hbm_bytes": 1 << 20})
    assert result["correct"] is False and {"calls_off_plan", "block_sums_gap"} <= failing(result)


def test_a_timed_launch_left_out(monkeypatch):
    import k8s_watcher_tpu_torch.probe.agent as agent

    real = agent.run_hbm_write_probe
    monkeypatch.setattr(agent, "run_hbm_write_probe", functools.wraps(real)(lambda b, **kw: real(b, iters=3, **kw)))
    result, _ = run_tiny("node-probe-loop", seconds=1.0)
    assert result["correct"] is False and failing(result) == {"calls_off_plan"}


def test_a_shorter_gemm_chain(monkeypatch):
    import k8s_watcher_tpu_torch.probe.ici as ici

    real = ici.mxu_chain
    monkeypatch.setattr(ici, "mxu_chain", lambda a, b, inner_iters, scale: real(a, b, inner_iters - 1, scale))
    result, _ = run_tiny("node-probe-loop", seconds=1.0)
    assert result["correct"] is False and failing(result) == {"gemm_chain_gap"}


def test_block_sum_altered_where_it_is_produced(monkeypatch):
    from k8s_watcher_tpu_torch.kernels import hbm

    real = hbm.blocksums

    def altered(x):
        out = real(x).clone()
        out[0, -1] += 1.0
        return out

    monkeypatch.setattr(hbm, "blocksums", altered)
    result, _ = run_tiny("node-probe-loop", seconds=1.0)
    assert result["correct"] is False and "block_sums_gap" in failing(result)


def test_verdict_altered_where_it_is_produced(monkeypatch):
    import k8s_watcher_tpu_torch.probe.agent as agent

    real = agent.run_hbm_probe

    @functools.wraps(real)
    def altered(*a, **kw):
        return {**real(*a, **kw), "ok": False, "integrity_ok": False}

    monkeypatch.setattr(agent, "run_hbm_probe", altered)
    result, _ = run_tiny("node-probe-loop", seconds=1.0)
    assert result["correct"] is False and failing(result) == {"verdicts_wrong"}


def test_the_control_through_the_harness_is_not_correct():
    """At the tiny size the block sums are exact in bfloat16 (two blocks):
    the float8 GEMM chain fails its limit."""
    result, _ = run_tiny("node-probe-loop", seconds=1.0, control=True)
    assert result["correct"] is False and "gemm_chain_gap" in failing(result)


@pytest.mark.cuda
def test_the_control_at_the_cells_size_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's size on the card")
    from portbench.harness import measure

    result, _ = measure("node-probe-loop", SEED, 3.0, False, time.monotonic(), control=True)
    assert result["correct"] is False and {"block_sums_gap", "gemm_chain_gap"} <= failing(result)


def test_the_plan_at_the_cells_size():
    plan = cycle_plan(SHIPPED, on_card=True)
    assert (plan.read_rows, plan.read_repeats, plan.write_blocks, plan.write_repeats) == (131072, 128, 512, 128)
    assert plan.calls == {"read_sweep": 5, "fill": 5, "blocksums": 1, "graph_launch": 5}
    assert plan.read_bytes == 256 * 2 ** 20 * (1 + 5 * 128) + 5 * 2048
    assert plan.write_bytes == 256 * 2 ** 20 * (5 * 128 + 1) + 4 * 512
    assert plan.gemm_flops == 5 * 8 * 2 * 1024 ** 3
    off = cycle_plan(SHIPPED, on_card=False)
    assert (off.read_rows, off.read_repeats, off.write_blocks, off.write_repeats) == (2048, 1, 2, 1)


def test_calls_off_the_plan_are_counted():
    plan = cycle_plan(SHIPPED, on_card=True)
    sweep, fill = (None, 131072, 128), (512, 128)
    whole = {"read_sweep": [sweep] * 5, "fill": [fill] * 5, "blocksums": [None], "graph_launch": [5]}
    assert calls_off(plan, whole) == 0
    assert calls_off(plan, {**whole, "read_sweep": [sweep] * 4 + [(None, 131072, 64)]}) == 2  # fewer passes
    assert calls_off(plan, {**whole, "fill": [fill] * 4}) == 1
    assert calls_off(plan, {**whole, "graph_launch": [4]}) == 1
    assert calls_off(plan, {**whole, "blocksums": []}) == 1


def test_reference_values():
    assert np.array_equal(read_totals(1024, 3), np.full(512, 3072.0))
    assert np.array_equal(block_sums(3), np.array([1.0, 2.0, 3.0]) * 131072)
    assert worst_relative_gap([1.0, 2.0], [1.0, 2.0]) == 0.0 and worst_relative_gap([1.0], [1.0, 2.0]) == 1.0
    a, b = gemm_operands(64, "cpu")
    want = gemm_chain(a, b, 8).numpy()
    assert relative_norm_gap(want, want) == 0.0 and relative_norm_gap(want[:1], want) == 1.0
    assert relative_norm_gap(gemm_chain(a, b, 8, fp8=True).double().numpy(), want) > 0.05
