"""The JAX package's ``tests/test_shutdown.py`` replayed through the port: the
port's ``cli.install_signal_handlers`` routes SIGTERM/SIGINT to
``WatcherApp.stop``, a blocked watch read is cut promptly, the Lease is
released and queued notifications drain, against the port's own mock
apiserver."""

from test_torch_replay import replay, replayed_tests

_shutdown = replay("test_shutdown.py", rewrites=[
    ("from k8s_watcher_tpu.app import WatcherApp", "from test_torch_replay import CpuWatcherApp as WatcherApp"),
    ("from k8s_watcher_tpu.config.loader import load_config",
     "from k8s_watcher_tpu.config import load_app_config as load_config"),
    ("from k8s_watcher_tpu.config.schema import LeaderElectionConfig",
     "from k8s_watcher_tpu.config import LeaderElectionConfig"),
])
mock_api, restore_signals = _shutdown.mock_api, _shutdown.restore_signals  # the replayed tests' fixtures
globals().update(replayed_tests(_shutdown))
