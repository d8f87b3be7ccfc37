"""The watcher's spans and its ``watch_events`` counter (probe/spans.py), on
the CPU: a span the watcher opens outside any probe cycle is kept in a ring of
its own with every span its thread opens inside it, each inside its parent;
one opened inside a cycle is the cycle's; the count of events taken is stamped
at each outermost watcher span's end and read between two stamps; the ring is
bounded; the benchmark's readers window both.
"""

import sys
import threading
import time

from k8s_watcher_tpu_torch.probe import spans
from portbench import harness


def test_watcher_spans_are_kept_nested_and_counted_between_stamps():
    rec = spans.SpanRecorder()
    t0 = time.monotonic()
    with rec.watch_span("watch.batch") as batch:
        with rec.span("watch.inner") as inner:
            pass
        with rec.watch_span("notify.post") as post:
            pass
        rec.take(3)
    rec.take(2)  # taken after the batch's end: the next stamp counts them
    t1 = time.monotonic()
    with rec.watch_span("watch.batch") as later:
        rec.take(1)
    kept, events = rec.watch_between(t0, t1)
    assert [s.name for s in kept] == ["watch.inner", "notify.post", "watch.batch"]
    assert inner.parent is batch and post.parent is batch and batch.parent is None
    assert all(t0 <= s.start <= s.end <= t1 for s in kept)
    assert events == 3 and rec.taken() == 6
    kept, events = rec.watch_between(t0, later.end)
    assert kept[-1] is later and events == 6
    # a window that closes before the first batch's end holds nothing
    assert rec.watch_between(t0, batch.start) == ([], 0)


def test_a_watcher_span_in_a_cycle_is_the_cycles_and_a_plain_one_is_dropped():
    rec = spans.SpanRecorder()
    t0 = time.monotonic()
    with rec.cycle():
        with rec.watch_span("notify.post"):
            pass
    with rec.span("probe.alone"):
        pass
    assert [s.name for s in rec.last().spans] == ["notify.post", "probe.cycle"]
    assert rec.watch_between(t0, time.monotonic()) == ([], 0)


def test_the_ring_is_bounded_and_taken_counts_from_any_thread():
    rec = spans.SpanRecorder(watch_capacity=4)
    t0 = time.monotonic()
    for _ in range(10):
        with rec.watch_span("watch.batch"):
            pass
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # a lost update shows within a few thousand switches
    try:
        threads = [threading.Thread(target=lambda: [rec.take() for _ in range(1000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    with rec.watch_span("watch.batch"):
        pass
    kept, events = rec.watch_between(t0, time.monotonic())
    assert len(kept) == 4 and events == 8000 and rec.taken() == 8000
    traced = rec.traced("notify.post", keep=True)(lambda x: x + 1)
    assert traced(1) == 2 and rec.watch_between(t0, time.monotonic())[0][-1].name == "notify.post"


def test_the_benchmarks_readers_window_the_process_ring():
    t0 = time.monotonic()
    with spans.watch_span("watch.batch"):
        time.sleep(0.002)
        spans.take(50)
    with spans.watch_span("notify.post"):
        time.sleep(0.001)
    t1 = time.monotonic()
    obs = {"window": (t0, t1)}
    read = {name: harness.load_reader(name)(obs) for name in
            ("watch_batch_ms.watch", "egress_post_ms.watch", "events_taken_per_s.watch")}
    assert read["watch_batch_ms.watch"] >= 2.0 and read["egress_post_ms.watch"] >= 1.0
    assert abs(read["events_taken_per_s.watch"] - 50 / (t1 - t0)) < 1e-6
    assert all(harness.load_reader(name)({"window": None}) is None for name in read)
