"""The kept collective graphs of a group of CUDA ranks
(``probe/timing.py:CollectiveGraphs``), with the capture stood in for on the
CPU: a key is captured once and its input refreshed after; a capture that
fails on any member is refused on every member; a new default group drops
what was kept. Which groups are timed on the device: several CUDA ranks."""

from __future__ import annotations

import types

import pytest
import torch
import torch.distributed as dist

from k8s_watcher_tpu_torch.probe import timing


@pytest.fixture
def captures(monkeypatch):
    made = []

    def capture(fn, device):
        out = fn()
        made.append(out)
        return f"graph {len(made)}", out

    monkeypatch.setattr(timing, "capture_graph", capture)
    return made


def agreeing(votes: list, peer_ok: bool = True):
    def agree(ok: bool) -> bool:
        votes.append(ok)
        return ok and peer_ok

    return agree


def test_a_key_is_captured_once_and_reads_each_cycles_input(captures):
    graphs, votes = timing.CollectiveGraphs(), []
    x = torch.ones(3)
    kept = graphs.get(("chain",), lambda t: t * 2, x, lambda: None, agreeing(votes))
    assert kept.x is x and kept.graph == "graph 1" and kept.barrier == "graph 2"
    assert torch.equal(kept.out, torch.full((3,), 2.0)) and votes == [True]
    again = graphs.get(("chain",), lambda t: t * 2, torch.full((3,), 5.0), lambda: None, agreeing(votes))
    assert again is kept and len(captures) == 2 and votes == [True]
    assert torch.equal(kept.x, torch.full((3,), 5.0))  # the kept graph reads this cycle's input
    other = graphs.get(("pair", "host0/chip0-chip1"), lambda t: t + 1, torch.zeros(1), lambda: None,
                       agreeing(votes))
    assert other is not kept and len(captures) == 4 and votes == [True, True]


@pytest.mark.parametrize("fails_here", [True, False], ids=["here", "on-a-peer"])
def test_a_capture_that_fails_on_any_member_is_refused_on_every_member(captures, monkeypatch, fails_here):
    graphs, votes = timing.CollectiveGraphs(), []
    if fails_here:
        monkeypatch.setattr(timing, "capture_graph", lambda fn, device: (_ for _ in ()).throw(RuntimeError("no")))
    with pytest.raises(RuntimeError, match="not captured on every member"):
        graphs.get(("chain",), lambda t: t, torch.ones(1), lambda: None, agreeing(votes, peer_ok=fails_here))
    assert votes == [not fails_here]
    monkeypatch.setattr(timing, "capture_graph", lambda fn, device: ("graph", fn()))
    kept = graphs.get(("chain",), lambda t: t, torch.ones(1), lambda: None, agreeing(votes))
    assert kept.graph == "graph"  # nothing was kept: the next cycle captures anew


def test_a_new_default_group_drops_what_was_kept(captures, monkeypatch):
    graphs = timing.CollectiveGraphs()
    kept = []
    for world in (object(), object()):  # one default group, then the next
        monkeypatch.setattr(dist, "group", types.SimpleNamespace(WORLD=world))
        kept.append(graphs.get(("chain",), lambda t: t, torch.ones(1), lambda: None, lambda ok: ok))
        assert graphs.get(("chain",), lambda t: t, torch.ones(1), lambda: None, lambda ok: ok) is kept[-1]
    assert kept[0] is not kept[1] and len(captures) == 4


@pytest.mark.parametrize(
    "device, n, on_device",
    [("cpu", 4, False), ("cpu", 1, False), ("cuda", 1, False), ("cuda", 4, True)],
)
def test_only_a_group_of_several_cuda_ranks_is_timed_on_the_device(device, n, on_device):
    assert timing.times_on_device(torch.device(device, 0) if device == "cuda" else torch.device(device), n) \
        is on_device
