"""The port's spans and counters inside the probe cycle (probe/spans.py), on the CPU.

One cycle gives each stage's span, its set-up, timed launches and readbacks,
each inside its parent on its own thread; a collection on any thread during a
cycle counts in its GC ms, and the GC hook is out between cycles; the ring is
bounded and queried by time; the fence baseline samples the readback the
timed launches take; ``record_function`` ranges are opened only under a
profiler, and there they sit at one offset from the spans' monotonic stamps;
the flight recorder carries each stage's ms; the report's payload keeps the
JAX package's keys.
"""

import gc
import json
import threading
import time

import jax
import pytest
import torch

from k8s_watcher_tpu.config.schema import TpuConfig as RefTpuConfig
from k8s_watcher_tpu.parallel.mesh import host_chip_mesh as ref_mesh
from k8s_watcher_tpu.probe.agent import ProbeAgent as RefAgent
from k8s_watcher_tpu_torch.config import TpuConfig
from k8s_watcher_tpu_torch.probe import spans, timing
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent

CONFIG = dict(
    probe_enabled=True, probe_payload_bytes=1 << 14, probe_matmul_size=64,
    probe_rtt_warn_ms=10_000.0, probe_hbm_bytes=1 << 22, probe_trend_enabled=False,
)
ALL_STAGES = dict(CONFIG, probe_links_enabled=True, probe_multislice_enabled=True)

# span -> the span it opens in; probe.sync may open in several
PARENTS = {
    "probe.inventory": "probe.cycle",
    "probe.ici": "probe.cycle", "probe.ici.setup": "probe.ici", "probe.ici.timed": "probe.ici",
    "probe.mxu": "probe.cycle", "probe.mxu.setup": "probe.mxu", "probe.mxu.timed": "probe.mxu",
    "probe.links": "probe.cycle", "probe.links.setup": "probe.links",
    "probe.multislice": "probe.cycle", "probe.multislice.setup": "probe.multislice",
    "probe.multislice.timed": "probe.multislice",
    "probe.hbm_read": "probe.cycle", "probe.hbm_read.setup": "probe.hbm_read",
    "probe.hbm_read.timed": "probe.hbm_read",
    "probe.hbm_write": "probe.cycle", "probe.hbm_write.setup": "probe.hbm_write",
    "probe.hbm_write.timed": "probe.hbm_write", "probe.hbm_write.verify": "probe.hbm_write",
    "probe.report": "probe.cycle", "probe.observer": "probe.report",
}


def agent(config=ALL_STAGES, **kwargs) -> ProbeAgent:
    return ProbeAgent(TpuConfig(**config), environment="test", sink=lambda n: None,
                      expected_platform="cpu", device="cpu", **kwargs)


def ancestors(span):
    parent = span.parent
    while parent is not None:
        yield parent
        parent = parent.parent


def looped_cycles(n: int = 2):
    """``n`` cycles of the agent's own loop thread."""
    done = threading.Event()
    seen = []

    def observer(report):
        seen.append(report)
        if len(seen) >= n:
            done.set()

    loop = agent(dict(ALL_STAGES, probe_interval_seconds=0.01))
    loop.report_observer = observer
    t0 = time.monotonic()
    loop.start()
    thread = loop._thread
    try:
        assert done.wait(60)
    finally:
        assert loop.stop()
    assert not thread.is_alive()
    cycles = [c for c in spans.cycles_between(t0, time.monotonic()) if c.span.thread == thread.native_id]
    assert len(cycles) >= n
    return loop, cycles


def test_a_cycle_gives_the_listed_spans_each_inside_its_parent():
    loop, cycles = looped_cycles()
    cycle = cycles[0]
    names = {s.name for s in cycle.spans}
    # the GEMM graph's capture runs on CUDA only
    assert names == set(PARENTS) | {"probe.cycle", "probe.sync"}
    assert cycle.spans[-1].name == "probe.cycle" and cycle.span is cycle.spans[-1]
    for s in cycle.spans:
        assert s.thread == cycle.span.thread and s.end >= s.start
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end, s
            assert s.parent.thread == s.thread
        if s.name in PARENTS:
            assert s.parent.name == PARENTS[s.name], s
        if s.name == "probe.sync":
            # a readback inside timed launches is the measurement: no span there
            assert not any(a.name.endswith(".timed") for a in ancestors(s)), s
            assert s.parent.name != "probe.cycle"
    # the read stage's set-up: its integrity read and the fence baseline's warm readback
    assert sum(s.parent.name == "probe.hbm_read.setup" for s in cycle.named("probe.sync")) == 2
    counters = cycle.counters
    assert counters["syncs"] == len(cycle.named("probe.sync")) > 0
    assert counters["graph_captures"] == 0 and "device_allocs" not in counters
    assert counters["gc_ms"] >= 0.0
    # the stages cover the cycle but for the loop's glue between them
    assert 0.0 <= cycle.self_ms() < 0.5 * cycle.span.ms


def test_a_collection_on_any_thread_counts_in_the_cycle_it_interrupts():
    """A collection during a cycle, on its thread or another (which holds the
    probe thread through the interpreter lock), counts in the cycle's GC ms;
    between cycles the hook is out and the process pays nothing for it."""
    other = threading.Event()

    def collect_elsewhere():
        gc.collect(2)
        other.set()

    recorder = spans.RECORDER
    with spans.cycle():
        assert recorder._on_gc in gc.callbacks
        with spans.span("probe.hbm_read"):
            thread = threading.Thread(target=collect_elsewhere)
            thread.start()
            assert other.wait(30)
            thread.join(30)
    theirs = recorder.last()
    assert theirs.gc_ms() > 0.0
    assert recorder._on_gc not in gc.callbacks
    total = recorder._gc_ms
    gc.collect(2)  # outside any cycle
    assert recorder._gc_ms == total
    with spans.cycle():
        with spans.span("probe.hbm_read"):
            gc.collect(2)
    mine = recorder.last()
    assert mine.gc_ms() > 0.0 and mine.counters["gc_ms"] == recorder._gc_ms - total
    assert mine.stages_ms().keys() == {"hbm_read", "self"}
    assert recorder._on_gc not in gc.callbacks


def test_the_ring_keeps_its_bound_and_is_queried_by_time():
    assert spans.RECORDER.capacity == spans.RING_CYCLES == 1024
    recorder = spans.SpanRecorder(capacity=4)
    marks = []
    for _ in range(6):
        marks.append(time.monotonic())
        with recorder.cycle():
            with recorder.span("probe.mxu"):
                time.sleep(0.002)
    assert recorder._on_gc not in gc.callbacks
    kept = recorder.cycles_between(float("-inf"), float("inf"))
    assert len(kept) == 4 and [c.start for c in kept] == sorted(c.start for c in kept)
    assert kept[0].start >= marks[2]  # the two oldest went
    assert [c.start for c in recorder.cycles_between(marks[4], float("inf"))] == [c.start for c in kept[2:]]
    assert recorder.cycles_between(marks[3], kept[2].end) == [kept[1], kept[2]]
    assert recorder.cycles_between(kept[-1].end + 1.0, kept[-1].end + 2.0) == []


def test_a_first_cycle_before_cuda_is_used_counts_from_zero():
    """Before CUDA's first use in a process torch keeps no allocator
    statistics: a cycle opened then counts its device allocations from 0
    (the card-only tests run such a first cycle); off CUDA nothing is counted."""
    assert not torch.cuda.is_initialized()
    assert spans._device_allocs(torch.device("cuda", 0)) == 0
    assert spans._device_allocs(torch.device("cpu")) is None and spans._device_allocs(None) is None


def test_spans_outside_a_cycle_are_dropped():
    recorder = spans.SpanRecorder(capacity=4)
    with recorder.span("probe.ici"):
        with recorder.sync():
            pass
    assert recorder.cycles_between(float("-inf"), float("inf")) == [] and recorder.last() is None


def test_the_fence_baseline_samples_the_readback_the_timed_launches_take(monkeypatch):
    """The fence baseline is subtracted from every fenced launch, so its
    samples and the timed launches end in the same bare readback: no span
    around either. Only the baseline's warm readback is a ``probe.sync``."""
    readbacks = []
    real = timing.read_scalar

    def counting(out):
        readbacks.append(out)
        return real(out)

    monkeypatch.setattr(timing, "read_scalar", counting)
    x = torch.ones(4)
    with spans.cycle():
        timing.fence_baseline_ms(samples=3)
        baseline_syncs = len(spans.RECORDER._local.cycle.spans)
        assert len(readbacks) == 4 and baseline_syncs == 1
        timing.timed_fenced(lambda t: t * 2.0, x, iters=5)
    cycle = spans.RECORDER.last()
    assert len(readbacks) == 9 and cycle.counters["syncs"] == 1
    from k8s_watcher_tpu_torch.probe import hbm, links

    # the HBM stages and the links time their launches through the same bare readback
    assert hbm.read_scalar is links.read_scalar is real


def test_no_record_function_range_without_a_profiler(monkeypatch):
    opened = []
    real = spans._Range

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(spans, "_Range", counting)
    agent(CONFIG).run_once()
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        agent(CONFIG).run_once()
    cycle = spans.RECORDER.last()
    assert sorted(opened) == sorted(s.name for s in cycle.spans)


def clock_offsets_us(probe, path) -> list:
    """One profiled cycle: for each span, its range's start and end in the
    profiler's chrome trace less its own monotonic stamps, in µs."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        probe.run_once()
    cycle = spans.RECORDER.last()
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("probe.")]
    offsets = []
    for name in {s.name for s in cycle.spans}:
        mine = sorted((s for s in cycle.spans if s.name == name), key=lambda s: s.start)
        ranges = sorted((e for e in events if e["name"] == name), key=lambda e: float(e["ts"]))
        assert len(ranges) == len(mine), name
        for s, e in zip(mine, ranges):
            ts, dur = float(e["ts"]), float(e["dur"])
            offsets += [ts - 1e6 * s.start, ts + dur - 1e6 * s.end]
    assert len(offsets) >= 2 * 20
    return offsets


def test_profiler_ranges_sit_at_one_offset_from_the_spans_stamps(tmp_path):
    """The shared clock: every span's range in the profiler's chrome trace
    starts and ends at one offset from the span's monotonic stamps, within
    0.2 ms over a cycle. A span's stamp and its range's are two reads a few
    µs apart, so a thread preempted between them on a loaded host reads one
    span off by a time slice: up to three cycles are tried for one whose
    every span holds."""
    probe = agent(CONFIG)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        probe.run_once()  # a process's first profiled cycle pays the profiler's own set-up
    spreads = []
    for attempt in range(3):
        offsets = clock_offsets_us(probe, tmp_path / f"trace{attempt}.json")
        spreads.append(max(offsets) - min(offsets))
        if spreads[-1] <= 200.0:
            break
    assert min(spreads) <= 200.0, spreads


def test_the_flight_recorder_entry_carries_each_stage():
    probe = agent()
    probe.run_once()
    cycle = spans.RECORDER.last()
    entry = probe.recent_cycles(1)[0]
    stages = entry["stages_ms"]
    assert set(stages) == {"inventory", "ici", "mxu", "links", "multislice", "hbm_read", "hbm_write", "report",
                           "self"}
    assert all(ms >= 0.0 for ms in stages.values())
    assert sum(stages.values()) == pytest.approx(cycle.span.ms, abs=0.01)
    assert entry["syncs"] == cycle.counters["syncs"] > 0
    assert entry["gc_ms"] >= 0.0 and entry["graph_captures"] == 0
    assert entry["device_allocs"] is None  # no caching allocator off CUDA
    json.dumps(entry)  # served as JSON at /debug/probes


@pytest.mark.parametrize("flags", [{}, {"probe_links_enabled": True}, {"probe_multislice_enabled": True}],
                         ids=["base", "links", "multislice"])
def test_the_payload_keeps_the_reference_keys(flags):
    config = dict(CONFIG, **flags)
    want = RefAgent(RefTpuConfig(**config), environment="test", sink=lambda n: None,
                    mesh=ref_mesh(jax.devices()[:1]), expected_platform="cpu").run_once().to_payload()
    got = agent(config).run_once().to_payload()
    assert set(got) == set(want)
    for part, value in want.items():
        if isinstance(value, dict):
            assert set(got[part]) == set(value), part
