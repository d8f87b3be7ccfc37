"""The readers of the program's own spans and counters (``program_spans.py``)
after a tiny run on the CPU: the GEMM stage's set-up and the GC pauses read
numbers, the device allocations read none off CUDA, and the set-up's idle
time, which needs the device trace too, reads none without one."""

from __future__ import annotations

from portbench import harness
from portbench.devtrace import DeviceTrace
from portbench.program_spans import cycles, outermost_setups
from portbench.tests.tiny import run_tiny

PROGRAM_SPAN_METRICS = ("gemm_setup_ms.probe", "setup_idle_ms.probe", "gc_pause_ms.probe",
                        "device_allocs_per_cycle.probe")


def read(name, obs):
    return harness.load_reader(name)(obs)


def test_program_span_readers_after_a_tiny_run():
    result, outcome = run_tiny("node-probe-loop", seconds=1.5)
    assert result["correct"] is True
    obs = outcome.observation
    assert obs["device_trace"] is None
    window = cycles(obs)
    # the window runs from one cycle's end to another's: every cycle inside it is the program's
    assert len(window) == result["attempted"]
    assert read("gemm_setup_ms.probe", obs) > 0.0
    assert read("gc_pause_ms.probe", obs) >= 0.0
    assert read("device_allocs_per_cycle.probe", obs) is None
    assert read("setup_idle_ms.probe", obs) is None
    # with a device trace that saw no device work, the set-up was idle throughout
    idle = read("setup_idle_ms.probe", dict(obs, device_trace=DeviceTrace([], {}, obs["window"])))
    setups = [sum(s.ms for s in outermost_setups(c)) for c in window]
    assert idle is not None and abs(idle - sum(setups) / len(setups)) < 1e-6
    names = {s.name for s in outermost_setups(window[0])}
    assert {"probe.ici.setup", "probe.mxu.setup", "probe.hbm_read.setup", "probe.hbm_write.setup"} <= names


def test_without_the_programs_ring_every_reader_reads_none():
    obs = {"window": None, "device_trace": None}
    assert all(read(name, obs) is None for name in PROGRAM_SPAN_METRICS)
    empty = {"window": (0.0, 1e-9), "device_trace": DeviceTrace([], {}, (0.0, 1e-9))}
    assert all(read(name, empty) is None for name in PROGRAM_SPAN_METRICS)


def test_the_entries_read_the_programs_spans():
    bench = harness.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in PROGRAM_SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span" and m["moves"] == "probe_cycle_ms" and m["better"] == "lower"
        assert m["workloads"] == ["node-probe-loop"]
    assert list(entries)[-4:] == list(PROGRAM_SPAN_METRICS)
