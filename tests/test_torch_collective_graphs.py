"""The kept collective graphs (``probe/timing.py:kept_collective_ms`` on the
one store, ``GRAPHS``), with the capture and the timed launches stood in for
on the CPU: a key is captured once and its input refreshed after; a capture
that fails on any member is refused on every member; a new default group
drops what was kept. Which devices are timed on the device: CUDA, at any
rank count."""

from __future__ import annotations

import types

import pytest
import torch
import torch.distributed as dist

from k8s_watcher_tpu_torch.probe import timing


class Graph:
    def __init__(self, name: str):
        self.name = name

    def replay(self):
        pass


@pytest.fixture
def captures(monkeypatch):
    made = []

    def capture(fn, device):
        out = fn()
        made.append(out)
        return Graph(f"graph {len(made)}"), out

    monkeypatch.setattr(timing, "capture_graph", capture)
    monkeypatch.setattr(timing, "GRAPHS", timing.GraphStore())
    monkeypatch.setattr(timing, "collective_times_ms",
                        lambda graph, out, barrier, iters, device: [(0.01, timing.read_scalar(out))] * iters)
    return made


def agreeing(votes: list, peer_ok: bool = True):
    def agree(ok: bool) -> bool:
        votes.append(ok)
        return ok and peer_ok

    return agree


def kept(key, fn, x, agree, barrier=lambda: None):
    """The stage's call: ``(warm, samples)`` of ``fn(x)`` kept for ``key``, and
    what the store holds for it."""
    warm, _, samples = timing.kept_collective_ms(key, fn, x, barrier, agree, 2, "probe.test")
    with timing.GRAPHS.hold((x.device.index,) + key, dist.group.WORLD) as held:
        return (warm, samples), held


def test_a_key_is_captured_once_and_reads_each_cycles_input(captures):
    votes = []
    x = torch.ones(3)
    (warm, samples), held = kept(("chain",), lambda t: t * 2, x, agreeing(votes))
    assert held.inputs[0] is x and held.graph.name == "graph 1" and held.barrier.name == "graph 2"
    assert torch.equal(held.out, torch.full((3,), 2.0)) and votes == [True]
    assert warm == 2.0 and samples == [(0.01, 2.0)] * 2
    (warm, _), again = kept(("chain",), lambda t: t * 2, torch.full((3,), 5.0), agreeing(votes))
    assert again is held and len(captures) == 2 and votes == [True]
    assert torch.equal(held.inputs[0], torch.full((3,), 5.0))  # the kept graph reads this cycle's input
    _, other = kept(("pair", "host0/chip0-chip1"), lambda t: t + 1, torch.zeros(1), agreeing(votes))
    assert other is not held and len(captures) == 4 and votes == [True, True]


@pytest.mark.parametrize("fails_here", [True, False], ids=["here", "on-a-peer"])
def test_a_capture_that_fails_on_any_member_is_refused_on_every_member(captures, monkeypatch, fails_here):
    votes = []
    if fails_here:
        monkeypatch.setattr(timing, "capture_graph", lambda fn, device: (_ for _ in ()).throw(RuntimeError("no")))
    with pytest.raises(RuntimeError, match="not captured on every member"):
        kept(("chain",), lambda t: t, torch.ones(1), agreeing(votes, peer_ok=fails_here))
    assert votes == [not fails_here]
    monkeypatch.setattr(timing, "capture_graph", lambda fn, device: (Graph("graph"), fn()))
    _, held = kept(("chain",), lambda t: t, torch.ones(1), agreeing(votes))
    assert held.graph.name == "graph"  # nothing was kept: the next cycle captures anew


def test_a_new_default_group_drops_what_was_kept(captures, monkeypatch):
    held = []
    for world in (object(), object()):  # one default group, then the next
        monkeypatch.setattr(dist, "group", types.SimpleNamespace(WORLD=world))
        held.append(kept(("chain",), lambda t: t, torch.ones(1), lambda ok: ok)[1])
        assert kept(("chain",), lambda t: t, torch.ones(1), lambda ok: ok)[1] is held[-1]
    assert held[0] is not held[1] and len(captures) == 4


@pytest.mark.parametrize(
    "device, n, on_device",
    [("cpu", 4, False), ("cpu", 1, False), ("cuda", 1, True), ("cuda", 4, True)],
)
def test_cuda_is_timed_on_the_device_at_any_rank_count(device, n, on_device):
    """``n``, the group's rank count, plays no part: the device decides."""
    assert timing.timed_on_device(torch.device(device, 0) if device == "cuda" else torch.device(device)) \
        is on_device
