"""The port's SLO engine and labelled metrics held against the JAX package's.

The JAX package's ``tests/test_slo.py`` runs again through the port
(``test_torch_replay``), and so do ``TestLabeledMetrics`` and
``TestFreshnessAndSloRoutes`` of ``tests/test_observability.py``, the
process-labelled exposition (``fold_sample``) included. Then the same seeded traffic is recorded into
both packages' registries (a latency histogram, a counter pair, a labelled
gauge) and both engines tick on one fake clock: every tick's objectives, burn
rates and verdicts, the registries' samples (with their label series too) and
their exposition (the ``slo_burn_rate`` and ``slo_breaching`` children
included) must be equal.
"""

import types

import numpy as np
import pytest

import k8s_watcher_tpu.slo.engine as ref_engine_mod
import k8s_watcher_tpu_torch.slo.engine as engine_mod
from k8s_watcher_tpu.config.schema import SloConfig as RefSloConfig
from k8s_watcher_tpu.metrics import MetricsRegistry as RefRegistry
from k8s_watcher_tpu.slo import SLOPlane as RefSLOPlane
from k8s_watcher_tpu_torch.config import SloConfig
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.slo import SLOPlane
from test_torch_replay import replay, replayed_tests

globals().update(replayed_tests(replay("test_slo.py", rewrites=[
    ("from k8s_watcher_tpu.config.schema import SchemaError, SloConfig, SloObjective",
     "from k8s_watcher_tpu_torch.config import ConfigError as SchemaError, SloConfig, SloObjective"),
    ("from k8s_watcher_tpu.metrics.metrics import Histogram", "from k8s_watcher_tpu_torch.metrics import Histogram"),
])))

_observability = replay("test_observability.py", keep=("k8s_watcher_tpu.probe",),
                        rewrites=[("k8s_watcher_tpu.metrics.server", "k8s_watcher_tpu_torch.status")])
globals().update(replayed_tests(
    _observability,
    only=("TestLabeledMetrics", "TestFreshnessAndSloRoutes"),
))

RAW = {
    "enabled": True, "tick_seconds": 1.0, "ring_size": 64, "fast_window_seconds": 5.0,
    "slow_window_seconds": 20.0, "burn_threshold": 1.0,
    "objectives": [
        {"name": "local-propagation-p99", "histogram": "watch_to_local_view_seconds", "quantile": 0.99,
         "max_seconds": 1.0, "target": 0.99},
        {"name": "upstream-staleness", "gauge": "federation_upstream_watermark_age_seconds", "max": 30,
         "target": 0.99},
        {"name": "egress-success", "ratio_good": "dispatch_sent", "ratio_total": "dispatch_enqueued",
         "min_ratio": 0.999},
        {"name": "fleet-health", "gauge": "health_confirmed_subjects", "max": 0, "target": 0.99},
    ],
}


class FakeClock:
    def __init__(self):
        self.now = 500.0

    def monotonic(self):
        return self.now


def traffic(seed, ticks=60):
    """Per tick: latencies, (enqueued, sent), per-upstream ages, confirmed
    subjects; bursts of slow latencies, failed sends and a stale upstream."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        slow = 12 <= t % 30 < 20
        latencies = rng.lognormal(-4.0, 1.0, size=int(rng.integers(0, 40)))
        if slow:
            latencies = np.concatenate([latencies, rng.uniform(1.0, 4.0, size=int(rng.integers(1, 10)))])
        enqueued = int(rng.integers(0, 50))
        sent = enqueued - (int(rng.integers(0, 3)) if t % 17 < 6 else 0)
        ages = {u: float(rng.uniform(0.1, 5.0)) * (20.0 if u == "b" and 30 <= t < 44 else 1.0) for u in "abc"}
        out.append(([float(x) for x in latencies], enqueued, max(0, sent), ages, int(t % 23 == 0)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_samples_same_burn_rates(monkeypatch, seed):
    clock = FakeClock()
    fake = types.SimpleNamespace(monotonic=clock.monotonic)
    monkeypatch.setattr(ref_engine_mod, "time", fake)
    monkeypatch.setattr(engine_mod, "time", fake)
    runs = {}
    for pkg, registry_cls, config_cls, plane_cls in (("ref", RefRegistry, RefSloConfig, RefSLOPlane),
                                                     ("port", MetricsRegistry, SloConfig, SLOPlane)):
        metrics = registry_cls()
        plane = plane_cls(config_cls.from_raw(RAW), metrics)
        clock.now = 500.0
        ticks = []
        for latencies, enqueued, sent, ages, confirmed in traffic(seed):
            for x in latencies:
                metrics.histogram("watch_to_local_view_seconds").record(x)
            metrics.counter("dispatch_enqueued").inc(enqueued)
            metrics.counter("dispatch_sent").inc(sent)
            for u, age in ages.items():
                metrics.gauge("federation_upstream_watermark_age_seconds").labels(upstream=u).set(age)
            metrics.gauge("health_confirmed_subjects").set(confirmed)
            ticks.append((plane.tick(), plane.health(), metrics.sample()))
            clock.now += 1.0
        snapshot = plane.snapshot()
        runs[pkg] = (ticks, snapshot, metrics.prometheus_text(), metrics.dump()["slo_burn_rate"],
                     metrics.sample(include_series=True))
    assert runs["port"] == runs["ref"]
    ticks, snapshot, _text, burn, with_series = runs["port"]
    assert len(with_series["series"]["gauges"]["federation_upstream_watermark_age_seconds"]) == 3
    assert {r["name"] for r in snapshot["objectives"].values()} == {o["name"] for o in RAW["objectives"]}
    assert any(not health["healthy"] for _t, health, _s in ticks)
    assert any(w["burn_rate"] > 1.0 for results, _h, _s in ticks for r in results.values()
               for w in r["windows"].values())
    assert len(burn["series"]) == 2 * len(RAW["objectives"])
