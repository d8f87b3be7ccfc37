"""The port's metrics registry held against the JAX package's.

The same sequence of ``inc``/``set``/``set_max``/``clear``/``record`` calls,
made from a seed with numpy, goes to both registries; their Prometheus text
must be byte-equal and their JSON dumps equal apart from the one-minute
rates (which depend on when the calls landed).
"""

import numpy as np
import pytest

from k8s_watcher_tpu.metrics import MetricsRegistry as RefRegistry
from k8s_watcher_tpu_torch.metrics import MetricsRegistry

# names the agent, the dispatcher and the actuator record, plus one that
# already ends in _seconds (the exposition must not double the suffix)
COUNTERS = ("probe_runs", "probe_unhealthy", "probe_errors", "dispatch_sent", "dispatch_enqueued",
            "remediation_actions", "adopt_scans")
GAUGES = ("probe_mxu_tflops_median", "probe_hbm_read_gbps", "probe_hbm_write_gbps",
          "dispatch_lane_high_water", "remediation_quarantined_nodes", "probe_link_suspects")
HISTOGRAMS = ("probe_psum_rtt", "event_to_notify_latency", "adopt_scan_duration", "cycle_seconds")


def operations(seed, n=300):
    """A seeded sequence of registry calls: (kind, name, value)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["inc", "set", "set_max", "clear", "record"])
        if kind == "inc":
            ops.append((kind, str(rng.choice(COUNTERS)), int(rng.integers(1, 5))))
        elif kind == "record":
            # log-uniform over 1 us .. 1000 s: below, inside and above the buckets
            ops.append((kind, str(rng.choice(HISTOGRAMS)), float(10 ** rng.uniform(-6, 3))))
        else:
            ops.append((kind, str(rng.choice(GAUGES)), float(rng.normal(100.0, 50.0))))
    return ops


def apply(registry, ops):
    for kind, name, value in ops:
        if kind == "inc":
            registry.counter(name).inc(value)
        elif kind == "record":
            registry.histogram(name).record(value)
        elif kind == "clear":
            registry.gauge(name).clear()
        else:
            getattr(registry.gauge(name), kind)(value)
    return registry


def without_rates(dump):
    return {name: {k: v for k, v in entry.items() if k != "per_minute"} for name, entry in dump.items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prometheus_text_is_byte_equal(seed):
    ops = operations(seed)
    want = apply(RefRegistry(), ops).prometheus_text()
    got = apply(MetricsRegistry(), ops).prometheus_text()
    assert got == want
    assert "k8s_watcher_cycle_seconds_bucket" in got and "cycle_seconds_seconds" not in got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dump_is_equal_apart_from_rates(seed):
    ops = operations(seed)
    want = apply(RefRegistry(), ops).dump()
    got = apply(MetricsRegistry(), ops).dump()
    assert list(got) == list(want)
    assert without_rates(got) == without_rates(want)


def test_prefix_and_empty_registry():
    assert MetricsRegistry().prometheus_text() == RefRegistry().prometheus_text() == "\n"
    ops = operations(7, n=40)
    assert (apply(MetricsRegistry(), ops).prometheus_text(prefix="x_")
            == apply(RefRegistry(), ops).prometheus_text(prefix="x_"))


def test_rates_count_the_last_minute():
    for registry in (RefRegistry(), MetricsRegistry()):
        registry.counter("probe_runs").inc(3)
        registry.counter("probe_runs").inc()
        assert registry.counter("probe_runs").rate_per_minute() == 4.0
        assert registry.dump()["probe_runs"] == {"count": 4, "per_minute": 4.0}


def test_set_max_keeps_the_high_water_mark():
    for registry in (RefRegistry(), MetricsRegistry()):
        gauge = registry.gauge("dispatch_lane_high_water")
        for value in (3, 1, 7, 2):
            gauge.set_max(value)
        assert gauge.read() == 7.0
        gauge.clear()
        assert gauge.read() is None
        gauge.set_max(-1.0)  # the first reading after a clear is the mark
        assert gauge.read() == -1.0


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_summaries_and_buckets(q):
    values = 10 ** np.random.default_rng(11).uniform(-6, 3, 500)
    ref, port = RefRegistry().histogram("h"), MetricsRegistry().histogram("h")
    assert port.quantile(q) is None and port.summary() == ref.summary() == {"count": 0}
    for v in values:
        ref.record(float(v))
        port.record(float(v))
    assert port.quantile(q) == ref.quantile(q)
    assert port.summary() == ref.summary()
    assert port.buckets() == ref.buckets()
    assert port.downsampled_buckets() == ref.downsampled_buckets()
