"""The port's multi-process ingest tier held to the JAX package's tests:
``tests/test_ingest_procs.py`` replayed through the port (wire codec, plan
partition, deferred resourceVersion commits, and real spawned reader
processes through EOS, SIGKILL and respawn, SIGTERM drain and the stats
fold). The reader factories a spawned child resolves come from
``test_torch_proc_factories`` (the replayed module exists only in the parent)."""

from test_torch_replay import replay, replayed_tests

globals().update(replayed_tests(replay("test_ingest_procs.py", rewrites=[
    ("from k8s_watcher_tpu.watch.source import WatchEvent\n",
     "from k8s_watcher_tpu.watch.source import WatchEvent\n"
     "from test_torch_proc_factories import (\n"
     "    ingest_prefilter_factory as prefilter_factory,\n"
     "    ingest_replay_factory as replay_factory,\n"
     "    ingest_slow_holdopen_factory as slow_holdopen_factory,\n"
     ")\n"),
    # the file's own definitions stay in the replayed module under other
    # names; the plans carry the importable ones above
    ("def replay_factory(plan):", "def _local_replay_factory(plan):"),
    ("def slow_holdopen_factory(plan):", "def _local_slow_holdopen_factory(plan):"),
    ("def prefilter_factory(plan):", "def _local_prefilter_factory(plan):"),
    ("from k8s_watcher_tpu.config.schema import AppConfig", "from k8s_watcher_tpu.config import AppConfig"),
])))
