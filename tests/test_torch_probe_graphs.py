"""The GEMM stage's kept CUDA graph (probe/ici.py:GemmGraphs), on the CPU.

The CPU has no graphs, so a fake capture stands in for ``capture_graph``:
it counts the capture in the open cycle, as the real one does, and returns a
token for the graph with the chain's output. Each round below does what the
stage does on the card: hold the key, redraw the operands, capture where no
graph is kept.
"""

import sys
import threading
import time

import pytest
import torch

from k8s_watcher_tpu_torch.probe import ici, spans

CPU = torch.device("cpu")
SIZE, INNER = 16, 2


@pytest.fixture
def captures(monkeypatch):
    """Every fake capture's graph token, in order."""
    made = []

    def fake_capture(fn, device):
        spans.count("graph_captures")
        graph = object()
        made.append(graph)
        return graph, fn()

    monkeypatch.setattr(ici, "capture_graph", fake_capture)
    return made


def one_round(store, size=SIZE, inner=INNER, device=CPU, fail=False):
    """One cycle's GEMM stage against ``store``: its counters, spans and graph."""
    with spans.cycle():
        with store.hold((device.index, size, inner)) as kept:
            a, b = kept.draw(size, device)
            graph, _ = kept.capture(lambda: ici.mxu_chain(a, b, inner, size**-0.5), device)
            if fail:
                raise RuntimeError("the stage raised")
    cycle = spans.RECORDER.last()
    return cycle.counters["graph_captures"], len(cycle.named("probe.mxu.capture")), graph


def test_one_key_is_captured_once_and_replayed_after(captures):
    store = ici.GemmGraphs()
    rounds = [one_round(store) for _ in range(3)]
    assert [r[:2] for r in rounds] == [(1, 1), (0, 0), (0, 0)]
    assert len(captures) == 1 and all(r[2] is captures[0] for r in rounds)


@pytest.mark.parametrize("change", [
    dict(size=2 * SIZE),
    dict(inner=INNER + 1),
    dict(device=torch.device("cpu", 1)),
], ids=["size", "inner_iters", "device"])
def test_another_key_captures_afresh(captures, change):
    store = ici.GemmGraphs()
    one_round(store)
    assert one_round(store, **change)[:2] == (1, 1)
    assert one_round(store, **change)[:2] == (0, 0)
    assert one_round(store)[:2] == (1, 1)  # one key is kept at a time
    assert len(captures) == 3


def test_a_stage_that_raised_drops_what_was_kept(captures):
    store = ici.GemmGraphs()
    one_round(store)
    with spans.cycle():
        with pytest.raises(RuntimeError, match="the stage raised"):
            with store.hold((None, SIZE, INNER)):
                raise RuntimeError("the stage raised")
    counted, spanned, graph = one_round(store)
    assert (counted, spanned) == (1, 1) and graph is captures[1]
    with pytest.raises(RuntimeError):
        one_round(store, fail=True)  # raised on the kept graph
    assert one_round(store)[:2] == (1, 1) and len(captures) == 3


def test_the_redraw_in_place_matches_a_fresh_draw():
    """The kept tensors read what the stage's definition draws every cycle:
    a generator seeded 0, ``randn``, then bf16."""
    kept = ici.KeptGraph((None, SIZE, INNER))
    a, b = kept.draw(SIZE, CPU)
    ptrs = (a.data_ptr(), b.data_ptr())
    a.fill_(float("nan"))
    b.view(torch.int16).bitwise_xor_(1)  # a flipped bit in every entry
    a2, b2 = kept.draw(SIZE, CPU)
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

    monkeypatch.setattr(ici, "capture_graph", slow_capture)
    store = ici.GemmGraphs()
    errors = []

    def worker():
        try:
            for _ in range(20):
                with store.hold((None, SIZE, INNER)) as kept:
                    with guard:
                        inside[0] += 1
                        most[0] = max(most[0], inside[0])
                    a, b = kept.draw(SIZE, CPU)
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
