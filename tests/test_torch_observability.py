"""The rest of the JAX package's ``tests/test_observability.py`` replayed
through the port (``TestLabeledMetrics`` and ``TestFreshnessAndSloRoutes``
replay in ``tests/test_torch_slo.py``).

The jax-free classes run with two rewrites: the port's status server binds
0.0.0.0 only and takes no ``host`` argument (``ROADMAP.md`` §C "By design"),
so the ``host="127.0.0.1"`` keyword is dropped and the tests still reach it on
127.0.0.1; and the config schema is the port's ``config`` module. The probe
classes run on the port's CPU probe: every ``ProbeAgent`` and HBM probe is
given ``device="cpu"`` (the port runs on the GPU unless asked), the
write-probe corruption adds to a torch tensor where the reference uses
``.at[].add``, and the profiler test looks for the ``torch.profiler`` chrome
trace the port writes (``probe-<stamp>.pt.trace.json`` in ``profile_dir``)
where the reference looks for ``*.xplane.pb`` run directories.
"""

from test_torch_replay import replay, replayed_tests

_HOST = 'host="127.0.0.1"'
_observability = replay("test_observability.py", rewrites=[
    ("k8s_watcher_tpu.metrics.server", "k8s_watcher_tpu_torch.status"),
    ("k8s_watcher_tpu.metrics.audit", "k8s_watcher_tpu_torch.audit"),
    ("k8s_watcher_tpu.config.schema", "k8s_watcher_tpu.config"),
    ("from k8s_watcher_tpu.config.loader import load_config",
     "from k8s_watcher_tpu.config import load_app_config as load_config"),
    ("from k8s_watcher_tpu.app import WatcherApp", "from test_torch_replay import CpuWatcherApp as WatcherApp"),
    (f", {_HOST}", ""),
    (f"{_HOST}, ", ""),
    ('expected_platform="cpu"', 'expected_platform="cpu", device="cpu"'),
    ("run_hbm_probe(1 << 22, iters=1)", 'run_hbm_probe(1 << 22, iters=1, device="cpu")'),
    ("run_hbm_write_probe(1 << 22, iters=1)", 'run_hbm_write_probe(1 << 22, iters=1, device="cpu")'),
    ("run_hbm_write_probe(1 << 23, iters=1, corrupt_hook=corrupt)",
     'run_hbm_write_probe(1 << 23, iters=1, corrupt_hook=corrupt, device="cpu")'),
    ("from k8s_watcher_tpu.probe.hbm import WRITE_BLOCK_ROWS, run_hbm_write_probe",
     "from k8s_watcher_tpu.kernels.hbm import WRITE_BLOCK_ROWS\n"
     "        from k8s_watcher_tpu.probe.hbm import run_hbm_write_probe"),
    ("return y.at[WRITE_BLOCK_ROWS + 7, 3].add(1e6)",
     "y = y.clone()\n            y[WRITE_BLOCK_ROWS + 7, 3] += 1e6\n            return y"),
    ("from k8s_watcher_tpu.probe.hbm import WRITE_BYTES_PER_BLOCK",
     "from k8s_watcher_tpu.kernels.hbm import WRITE_BYTES_PER_BLOCK"),
    ('traces = list(tmp_path.rglob("*.xplane.pb"))', 'traces = list(tmp_path.rglob("probe-*.pt.trace.json"))'),
    ('runs = [d for d in (tmp_path / "plugins" / "profile").iterdir() if d.is_dir()]',
     'runs = list(tmp_path.glob("probe-*.pt.trace.json"))'),
])
globals().update(replayed_tests(_observability, only=(
    "TestStatusServer", "TestStatusServerAuth", "TestDebugCheckpointRoute", "TestWatcherAppStatusEndpoint",
    "TestAuditRing", "TestPrometheusExposition", "TestDebugSlicesEndpoint", "TestLivenessFirstBeatGrace",
    "TestDebugTrendEndpoint", "TestHbmProbe", "TestHbmWriteProbe", "TestProbeProfiling",
)))
