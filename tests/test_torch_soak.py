"""The JAX package's ``tests/test_soak.py`` replayed through the port: the
watcher against the port's own mock apiserver under sustained churn, its
status server and checkpoint included. Two rewrites, both §C "By design" in
``ROADMAP.md``: the status server is built without ``host=`` (the port's
binds 0.0.0.0 only), and the in-process agent's link walk has no edge (one
process is one rank, where the JAX package's holds an 8-device mesh with 8
links; the 8-rank walk is held by ``tests/test_torch_links.py``)."""

from test_torch_replay import replay, replayed_tests

globals().update(replayed_tests(replay("test_soak.py", rewrites=[
    ("from k8s_watcher_tpu.app import WatcherApp", "from test_torch_replay import CpuWatcherApp as WatcherApp"),
    ("from k8s_watcher_tpu.config.loader import load_config",
     "from k8s_watcher_tpu.config import load_app_config as load_config"),
    ("k8s_watcher_tpu.metrics.server", "k8s_watcher_tpu_torch.status"),
    # the port's status server binds 0.0.0.0 and takes no host (ROADMAP.md §C "By design")
    ('app.metrics, app.liveness, host="127.0.0.1",', "app.metrics, app.liveness,"),
    # the in-process agent is one rank, a grid with no edge; the JAX package's
    # process holds an 8-device mesh with 8 links
    ('probes[-1]["links"]["n_links"] == 8', 'probes[-1]["links"]["n_links"] == 0'),
])))
