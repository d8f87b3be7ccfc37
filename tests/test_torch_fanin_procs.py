"""The port's sharded federation fan-in held to the JAX package's tests:
``tests/test_fanin_procs.py`` replayed whole through the port (the raw-frame
passthrough rewrite, the upstream partition over merge workers, the
sequencer's crash-replay watermark, the staleness owner, and real spawned
merge workers against live upstreams through a SIGKILL and its respawn)."""

from test_torch_replay import replay, replayed_tests

globals().update(replayed_tests(replay("test_fanin_procs.py", rewrites=[
    ("from k8s_watcher_tpu.config.schema import FederationConfig",
     "from k8s_watcher_tpu_torch.config import FederationConfig"),
    ("        from k8s_watcher_tpu.config.schema import AppConfig, SchemaError",
     "        from k8s_watcher_tpu_torch.config import AppConfig, ConfigError as SchemaError"),
])))
