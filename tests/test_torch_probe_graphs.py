"""The GEMM stage's kept CUDA graph (probe/timing.py:GRAPHS), on the CPU.

The CPU has no graphs, so the card's path is stood in for: the stage is
timed as on the device, a fake capture counts the capture in the open
cycle, as the real one does, and returns a token for the graph with the
chain's output, and a timed launch reads 0.01 ms. Each round runs the stage
(``run_mxu_probe``) against a store of its own.
"""

import sys
import threading
import time

import pytest
import torch

from k8s_watcher_tpu_torch.probe import ici, spans, timing

CPU = torch.device("cpu")
SIZE, INNER = 16, 2
KEY = (0, "gemm", SIZE, INNER)  # the stage's key: (device index, "gemm", size, inner iterations)


class Captures(list):
    """Every fake capture's graph token, in order; ``outputs`` maps each to
    the output it writes, ``launched`` lists the graphs launched timed."""

    def __init__(self):
        super().__init__()
        self.outputs, self.launched = {}, []


@pytest.fixture
def captures(monkeypatch):
    made = Captures()

    def fake_capture(fn, device):
        spans.count("graph_captures")
        graph = object()
        made.append(graph)
        made.outputs[graph] = fn()
        return graph, made.outputs[graph]

    def fake_launches(graph, device, iters):
        made.launched.append(graph)
        return [0.01] * iters

    monkeypatch.setattr(timing, "timed_on_device", lambda device: True)
    monkeypatch.setattr(timing, "capture_graph", fake_capture)
    monkeypatch.setattr(timing, "GRAPHS", timing.GraphStore())
    monkeypatch.setattr(ici, "graph_times_ms", fake_launches)
    return made


def one_round(captures, size=SIZE, inner=INNER, device=CPU):
    """One cycle's GEMM stage: its counters, spans, the graph it launched and
    its payload."""
    with spans.cycle():
        out = ici.run_mxu_probe(size, iters=2, inner_iters=inner, device=device)
    cycle = spans.RECORDER.last()
    graph = captures.launched[-1] if captures.launched else None
    return cycle.counters["graph_captures"], len(cycle.named("probe.mxu.capture")), graph, out


def test_one_key_is_captured_once_and_replayed_after(captures):
    rounds = [one_round(captures) for _ in range(3)]
    assert [r[:2] for r in rounds] == [(1, 1), (0, 0), (0, 0)]
    assert len(captures) == 1 and all(r[2] is captures[0] and r[3]["ok"] for r in rounds)


@pytest.mark.parametrize("change", [
    dict(size=2 * SIZE),
    dict(inner=INNER + 1),
    dict(device=torch.device("cpu", 1)),
], ids=["size", "inner_iters", "device"])
def test_another_key_captures_afresh(captures, change):
    one_round(captures)
    assert one_round(captures, **change)[:2] == (1, 1)
    assert one_round(captures, **change)[:2] == (0, 0)
    assert one_round(captures)[:2] == (0, 0)  # each key keeps its own graph
    assert len(captures) == 2


def test_a_stage_that_raised_drops_what_was_kept(captures, monkeypatch):
    one_round(captures)
    with spans.cycle():
        with pytest.raises(RuntimeError, match="the stage raised"):
            with timing.GRAPHS.hold(KEY):
                raise RuntimeError("the stage raised")
    counted, spanned, graph, _ = one_round(captures)
    assert (counted, spanned) == (1, 1) and graph is captures[1]
    real = ici.graph_times_ms
    monkeypatch.setattr(ici, "graph_times_ms", lambda graph, device, iters: (_ for _ in ()).throw(
        RuntimeError("a launch failed")))
    assert one_round(captures)[3] == {"ok": False, "size": SIZE, "error": "a launch failed"}  # raised on the kept graph
    monkeypatch.setattr(ici, "graph_times_ms", real)
    assert one_round(captures)[:2] == (1, 1) and len(captures) == 3


def test_a_graph_whose_output_is_not_finite_is_dropped(captures, monkeypatch):
    """A kept graph that wrote a non-finite output in its timed launches
    reads unhealthy, and the next cycle captures afresh."""
    one_round(captures)
    real = ici.graph_times_ms

    def corrupting(graph, device, iters):
        captures.outputs[graph].fill_(float("nan"))
        return real(graph, device, iters)

    monkeypatch.setattr(ici, "graph_times_ms", corrupting)
    counted, _, _, out = one_round(captures)
    assert counted == 0 and out["ok"] is False and out["finite"] is False
    monkeypatch.setattr(ici, "graph_times_ms", real)
    counted, _, graph, out = one_round(captures)
    assert counted == 1 and graph is captures[1] and out["ok"]


def test_the_redraw_in_place_matches_a_fresh_draw(captures):
    """The kept tensors read what the stage's definition draws every cycle:
    a generator seeded 0, ``randn``, then bf16."""
    one_round(captures)
    with timing.GRAPHS.hold(KEY) as kept:
        a, b = kept.inputs
    ptrs = (a.data_ptr(), b.data_ptr())
    a.fill_(float("nan"))
    b.view(torch.int16).bitwise_xor_(1)  # a flipped bit in every entry
    assert one_round(captures)[3]["ok"]
    with timing.GRAPHS.hold(KEY) as kept:
        a2, b2 = kept.inputs
    gen = torch.Generator(device=CPU).manual_seed(0)
    want_a = torch.randn((SIZE, SIZE), generator=gen, device=CPU).to(torch.bfloat16)
    want_b = torch.randn((SIZE, SIZE), generator=gen, device=CPU).to(torch.bfloat16)
    assert (a2.data_ptr(), b2.data_ptr()) == ptrs
    assert a2.dtype == b2.dtype == torch.bfloat16
    assert torch.equal(a2.view(torch.int16), want_a.view(torch.int16))
    assert torch.equal(b2.view(torch.int16), want_b.view(torch.int16))
    assert all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(ici.mxu_operands(SIZE, CPU), (want_a, want_b)))


def test_two_threads_never_capture_one_key_twice(monkeypatch):
    """Threads calling the stage at once (the loop and a ``--once``) each
    hold the key alone: one capture, and never two holders at a time."""
    made, inside, most = [], [0], [0]
    guard = threading.Lock()

    def slow_capture(fn, device):
        time.sleep(0.002)  # a window for another thread to capture too
        made.append(1)
        return object(), fn()

    monkeypatch.setattr(timing, "capture_graph", slow_capture)
    store = timing.GraphStore()
    errors = []

    def worker():
        try:
            for _ in range(20):
                with store.hold(KEY) as kept:
                    with guard:
                        inside[0] += 1
                        most[0] = max(most[0], inside[0])
                    kept.inputs = ici.mxu_operands(SIZE, CPU, out=kept.inputs or None)
                    a, b = kept.inputs
                    if kept.graph is None:
                        kept.capture(lambda: ici.mxu_chain(a, b, INNER, 0.25), CPU)
                    with guard:
                        inside[0] -= 1
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, daemon=True) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(made) == 1 and most[0] == 1
