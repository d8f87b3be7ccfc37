"""The port's reader-process observability held to the JAX package's tests:
``tests/test_proc_obs.py`` replayed through the port (the generation guard on
stale stats frames, process-labelled counters exact through a SIGKILL and a
respawn, worker traces imported into the parent ring, ``hottest_series``).
The spawned targets and factories come from ``test_torch_proc_factories``."""

from test_torch_replay import replay, replayed_tests

globals().update(replayed_tests(replay("test_proc_obs.py", rewrites=[
    ("from k8s_watcher_tpu.watch.source import WatchEvent\n",
     "from k8s_watcher_tpu.watch.source import WatchEvent\n"
     "from test_torch_proc_factories import (\n"
     "    obs_holdopen_factory as holdopen_factory,\n"
     "    obs_replay_factory as replay_factory,\n"
     "    obs_scripted_stale_entry as _scripted_stale_entry,\n"
     ")\n"),
    ("def holdopen_factory(plan):", "def _local_holdopen_factory(plan):"),
    ("def replay_factory(plan):", "def _local_replay_factory(plan):"),
    ("def _scripted_stale_entry(plan, conn):", "def _local_scripted_stale_entry(plan, conn):"),
    ("from k8s_watcher_tpu.trace.trace import Tracer", "from k8s_watcher_tpu.trace import Tracer"),
    ("from k8s_watcher_tpu.trace.trace import export_trace", "from k8s_watcher_tpu.trace import export_trace"),
])))
